// Block-sparse attention for Hopper (sm_90a), bf16 / fp16, head dim 64 or 128.
//
// Replaces the TPU kernels flash_attn_tpu/kernels/flash_blocksparse.py:
// _bs_kernel (the forward) and :_bs_bwd_kernel (the deterministic
// backward). Query tile i of bq rows attends the caller's key tiles
// kv_idx[i, :kv_num[i]] of bk keys each, in full, intersected with the
// bottom-right causal mask when causal; bq and bk are multiples of 64 (the
// wrapper, kernels/flash_blocksparse.py, resolves JAX's tile rule first).
//
//  - bs_fwd_kernel: one block of 4 warps per (64-row q tile, head, batch)
//    runs the tile loop of fwd_tile.cuh over the listed tiles, each as
//    bk / 64 key tiles of 64: the same tiles in the same order as that
//    loop's dense walk (B7's) where the list is the dense band, so the
//    same bits;
//  - bs_dkdv_kernel: one block per (64-key tile, head, batch) walks, in
//    ascending order, the q tiles that list its caller tile (the inverse
//    list, built on the device by the wrapper) with the dense dK/dV loop
//    (bwd_tile.cuh) and writes dK and dV once;
//  - bs_dq_kernel: one block per (64-row q tile, head, batch) walks the kv
//    list with the dense dQ loop and writes dQ once.
// No atomics and a fixed order: two runs give the same bits, as the TPU
// kernel's fixed q-tile order did for its full-length dK/dV accumulators.
// Gradients are written in fp32, as the TPU kernel returns them.
//
// What bounds it on this card: the listed pairs' flops, as in the dense
// kernels (4 d flops a pair forward, 10 d backward), while the bytes scale
// with the sequence, not the listed tiles: at a few tiles a row (a local
// window) the work per byte falls to the memory floor. The walk skips tiles
// wholly above the diagonal and indices outside [0, sk / bk) (which the TPU
// kernel would have read out of bounds), and reads each list entry once per
// 64-key tile from global memory (cached: every thread of a block reads the
// same entry).
//
// Conventions: softmax_scale natural (its log2 form for the forward), lse
// natural-log (b, h, sq), -inf and out 0 for a row that sees no key (its
// gradients 0); delta = rowsum(dO * O) in fp32 (b, h, sq). q/k/v/dout by
// element strides with the head dim contiguous; out (b, h, sq, d) and the
// gradients (b, h, s, d) contiguous; kv_num (b, nq), kv_idx (b, nq, nl),
// q_num (b, nk), q_idx (b, nk, ql) contiguous int32.

#include <climits>

#include "bwd_tile.cuh"
#include "fwd_tile.cuh"

namespace {

constexpr int NTHREADS = 128;
static_assert(fa::FWD_THREADS == NTHREADS && fa::BWD_THREADS == NTHREADS,
              "one block shape for the three kernels");
constexpr int TILE = 64;  // keys of a walked tile; rows of a fwd / dq tile

struct BsParams {
  const void* q;
  const void* k;
  const void* v;
  const void* dout;
  void* out;          // forward: (b, h, sq, d) in q's type
  float* lse;         // forward: written; backward: read
  const float* delta;
  float* dq;
  float* dk;
  float* dv;
  const int* kv_num;  // (b, nq)
  const int* kv_idx;  // (b, nq, nl)
  const int* q_num;   // (b, nk)
  const int* q_idx;   // (b, nk, ql)
  int64_t q_sb, q_sh, q_ss;
  int64_t k_sb, k_sh, k_ss;
  int64_t v_sb, v_sh, v_ss;
  int64_t do_sb, do_sh, do_ss;
  int h, sq, sk, bq, bk, nq, nl, ql;
  float scale, scale_log2;
  int causal;
};

// The listed key tiles of one q tile: entries idx[0, num) are caller tiles
// of bk keys, each walked as bk / 64 tiles of 64. An index outside
// [0, sk / bk) and, causal, a tile wholly above the diagonal (first key
// past col_hi) are skipped.
struct ListedKeys {
  const int* idx;
  int num, sub, bk, nk, col_hi;
  __device__ __forceinline__ int count() const { return num * sub; }
  __device__ __forceinline__ int first_key(int n) const {
    const int j = idx[n / sub];
    if (j < 0 || j >= nk) return -1;
    const int k0 = j * bk + (n % sub) * TILE;
    return k0 > col_hi ? -1 : k0;
  }
};

// The q tiles that list one caller key tile, ascending: entries idx[0,
// num) are caller tiles of bq rows, each walked as bq / bm tiles of bm
// rows. A tile past the last row and, causal, one whose last row sees no
// key of the dK/dV tile (below row_lo) are skipped.
struct ListingQs {
  const int* idx;
  int num, sub, bq, bm, sq, row_lo;
  __device__ __forceinline__ int count() const { return num * sub; }
  __device__ __forceinline__ int first_row(int n) const {
    const int m0 = idx[n / sub] * bq + (n % sub) * bm;
    if (m0 >= sq || min(m0 + bm, sq) - 1 < row_lo) return -1;
    return m0;
  }
};

// The kv list of the caller q tile that holds rows [m0, m0 + 64).
__device__ __forceinline__ ListedKeys listed_keys(const BsParams& p, int bb,
                                                  int m0) {
  const int i = m0 / p.bq;
  const int64_t row = (int64_t)bb * p.nq + i;
  const int num = max(0, min(p.kv_num[row], p.nl));
  const int col_hi =
      p.causal ? min(m0 + TILE, p.sq) - 1 + p.sk - p.sq : INT_MAX;
  return {p.kv_idx + row * p.nl, num, p.bk / TILE, p.bk, p.sk / p.bk, col_hi};
}

// Batch row bb, head hh as one sequence of the backward tile loops, its
// gradients in fp32.
template <typename T>
__device__ __forceinline__ fa::BwdSeq<T, float> bwd_seq(const BsParams& p,
                                                        int bb, int hh) {
  const int64_t bh = (int64_t)bb * p.h + hh;
  fa::BwdSeq<T, float> s;
  s.q = reinterpret_cast<const T*>(p.q) + bb * p.q_sb + hh * p.q_sh;
  s.dout = reinterpret_cast<const T*>(p.dout) + bb * p.do_sb + hh * p.do_sh;
  s.k = reinterpret_cast<const T*>(p.k) + bb * p.k_sb + hh * p.k_sh;
  s.v = reinterpret_cast<const T*>(p.v) + bb * p.v_sb + hh * p.v_sh;
  s.lse = p.lse + bh * p.sq;
  s.delta = p.delta + bh * p.sq;
  s.q_ss = p.q_ss;
  s.q_sh = p.q_sh;
  s.do_ss = p.do_ss;
  s.do_sh = p.do_sh;
  s.k_ss = p.k_ss;
  s.v_ss = p.v_ss;
  s.lse_sh = p.sq;
  s.sq = p.sq;
  s.sk = p.sk;
  return s;
}

__device__ __forceinline__ fa::BwdScalars scalars(const BsParams& p) {
  return {p.scale, p.scale_log2, p.causal, 1};
}

template <typename T, int D>
__global__ void __launch_bounds__(NTHREADS) bs_fwd_kernel(const BsParams p) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  const int hh = blockIdx.y;
  const int bb = blockIdx.z;
  const int64_t bh = (int64_t)bb * p.h + hh;
  fa::FwdTile<T> t;
  t.q = reinterpret_cast<const T*>(p.q) + bb * p.q_sb + hh * p.q_sh;
  t.out = reinterpret_cast<T*>(p.out) + bh * p.sq * D;
  t.lse = p.lse + bh * p.sq;
  t.q_ss = p.q_ss;
  t.o_ss = D;
  t.sq = p.sq;
  t.sk = p.sk;
  t.m0 = blockIdx.x * TILE;
  const fa::LinearKV<T, D> kv{
      reinterpret_cast<const T*>(p.k) + bb * p.k_sb + hh * p.k_sh,
      reinterpret_cast<const T*>(p.v) + bb * p.v_sb + hh * p.v_sh, p.k_ss,
      p.v_ss};
  fa::fwd_tile<T, D>(t, kv, listed_keys(p, bb, t.m0), p.scale_log2, p.causal,
                     smem_raw);
}

template <typename T, int D, int BM>
__global__ void __launch_bounds__(NTHREADS) bs_dkdv_kernel(const BsParams p) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  const int hh = blockIdx.y;
  const int bb = blockIdx.z;
  const int64_t bh = (int64_t)bb * p.h + hh;
  const int n0 = blockIdx.x * TILE;
  fa::BwdSeq<T, float> s = bwd_seq<T>(p, bb, hh);
  s.dk = p.dk + bh * p.sk * D;
  s.dv = p.dv + bh * p.sk * D;
  s.dk_ss = s.dv_ss = D;
  const int64_t col = (int64_t)bb * (p.sk / p.bk) + n0 / p.bk;
  const ListingQs walk{p.q_idx + col * p.ql, min(p.q_num[col], p.ql),
                       p.bq / BM, p.bq, BM, p.sq,
                       p.causal ? n0 - (p.sk - p.sq) : INT_MIN};
  fa::dkdv_tile<T, D, BM>(s, n0, walk, scalars(p), smem_raw);
}

template <typename T, int D>
__global__ void __launch_bounds__(NTHREADS) bs_dq_kernel(const BsParams p) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  const int hh = blockIdx.y;
  const int bb = blockIdx.z;
  const int m0 = blockIdx.x * TILE;
  fa::BwdSeq<T, float> s = bwd_seq<T>(p, bb, hh);
  s.dq = p.dq + ((int64_t)bb * p.h + hh) * p.sq * D;
  s.dq_ss = D;
  fa::dq_tile<T, D>(s, m0, listed_keys(p, bb, m0), scalars(p), smem_raw);
}

template <typename Kernel>
cudaError_t launch(Kernel kernel, dim3 grid, int smem, const BsParams& p,
                   cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  kernel<<<grid, NTHREADS, smem, stream>>>(p);
  return cudaGetLastError();
}

template <typename T, int D>
cudaError_t launch_fwd(const BsParams& p, int b, cudaStream_t st) {
  const dim3 grid((p.sq + TILE - 1) / TILE, p.h, b);
  return launch(bs_fwd_kernel<T, D>, grid, fa::fwd_smem_bytes<T, D>(), p, st);
}

template <typename T, int D>
cudaError_t launch_dkdv(const BsParams& p, int b, cudaStream_t st) {
  constexpr int BM = fa::dkdv_bm<D>();
  const dim3 grid(p.sk / TILE, p.h, b);
  return launch(bs_dkdv_kernel<T, D, BM>, grid,
                fa::dkdv_smem_bytes<T, D, BM>(), p, st);
}

template <typename T, int D>
cudaError_t launch_dq(const BsParams& p, int b, cudaStream_t st) {
  const dim3 grid((p.sq + TILE - 1) / TILE, p.h, b);
  return launch(bs_dq_kernel<T, D>, grid, fa::dq_smem_bytes<T, D>(), p, st);
}

// What every entry point checks of the shapes: the tiles the kernels are
// built for and whole caller key tiles.
bool shapes_ok(int b, int h, int sq, int sk, int d, int bq, int bk) {
  return b > 0 && h > 0 && sq > 0 && (d == 64 || d == 128) && bq > 0 &&
         bk > 0 && bq % TILE == 0 && bk % TILE == 0 && sk % bk == 0;
}

BsParams make_params(const void* q, const void* k, const void* v, int h,
                     int sq, int sk, int bq, int bk, int64_t q_sb,
                     int64_t q_sh, int64_t q_ss, int64_t k_sb, int64_t k_sh,
                     int64_t k_ss, int64_t v_sb, int64_t v_sh, int64_t v_ss,
                     float scale, int causal) {
  BsParams p = {};
  p.q = q;
  p.k = k;
  p.v = v;
  p.q_sb = q_sb; p.q_sh = q_sh; p.q_ss = q_ss;
  p.k_sb = k_sb; p.k_sh = k_sh; p.k_ss = k_ss;
  p.v_sb = v_sb; p.v_sh = v_sh; p.v_ss = v_ss;
  p.h = h;
  p.sq = sq;
  p.sk = sk;
  p.bq = bq;
  p.bk = bk;
  p.nq = (sq + bq - 1) / bq;
  p.scale = scale;
  p.scale_log2 = scale * FA_LOG2E;
  p.causal = causal;
  return p;
}

}  // namespace

// out (b, h, sq, d) in q's type and lse (b, h, sq) fp32 over the kv lists
// kv_num (b, nq) / kv_idx (b, nq, nl). Returns a cudaError_t (0 on
// success).
extern "C" int fa_blocksparse_fwd(
    const void* q, const void* k, const void* v, void* out, float* lse,
    const int* kv_num, const int* kv_idx, int b, int h, int sq, int sk, int d,
    int bq, int bk, int nl, int64_t q_sb, int64_t q_sh, int64_t q_ss,
    int64_t k_sb, int64_t k_sh, int64_t k_ss, int64_t v_sb, int64_t v_sh,
    int64_t v_ss, float scale, int causal, int is_bf16, void* stream) {
  if (!shapes_ok(b, h, sq, sk, d, bq, bk)) return (int)cudaErrorInvalidValue;
  BsParams p = make_params(q, k, v, h, sq, sk, bq, bk, q_sb, q_sh, q_ss, k_sb,
                           k_sh, k_ss, v_sb, v_sh, v_ss, scale, causal);
  p.out = out;
  p.lse = lse;
  p.kv_num = kv_num;
  p.kv_idx = kv_idx;
  p.nl = nl;
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  if (is_bf16) {
    if (d == 64) return launch_fwd<__nv_bfloat16, 64>(p, b, st);
    return launch_fwd<__nv_bfloat16, 128>(p, b, st);
  }
  if (d == 64) return launch_fwd<__half, 64>(p, b, st);
  return launch_fwd<__half, 128>(p, b, st);
}

// dK and dV (b, h, sk, d) fp32 over the inverse lists q_num (b, nk) /
// q_idx (b, nk, ql): for each caller key tile, the caller q tiles that list
// it, ascending.
extern "C" int fa_blocksparse_bwd_dkdv(
    const void* q, const void* k, const void* v, const void* dout,
    const float* lse, const float* delta, float* dk, float* dv,
    const int* q_num, const int* q_idx, int b, int h, int sq, int sk, int d,
    int bq, int bk, int ql, int64_t q_sb, int64_t q_sh, int64_t q_ss,
    int64_t k_sb, int64_t k_sh, int64_t k_ss, int64_t v_sb, int64_t v_sh,
    int64_t v_ss, int64_t do_sb, int64_t do_sh, int64_t do_ss, float scale,
    int causal, int is_bf16, void* stream) {
  if (!shapes_ok(b, h, sq, sk, d, bq, bk) || sk == 0)
    return (int)cudaErrorInvalidValue;  // an empty grid
  BsParams p = make_params(q, k, v, h, sq, sk, bq, bk, q_sb, q_sh, q_ss, k_sb,
                           k_sh, k_ss, v_sb, v_sh, v_ss, scale, causal);
  p.dout = dout;
  p.lse = const_cast<float*>(lse);
  p.delta = delta;
  p.dk = dk;
  p.dv = dv;
  p.q_num = q_num;
  p.q_idx = q_idx;
  p.ql = ql;
  p.do_sb = do_sb; p.do_sh = do_sh; p.do_ss = do_ss;
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  if (is_bf16) {
    if (d == 64) return launch_dkdv<__nv_bfloat16, 64>(p, b, st);
    return launch_dkdv<__nv_bfloat16, 128>(p, b, st);
  }
  if (d == 64) return launch_dkdv<__half, 64>(p, b, st);
  return launch_dkdv<__half, 128>(p, b, st);
}

// dQ (b, h, sq, d) fp32 over the kv lists, as fa_blocksparse_fwd reads them.
extern "C" int fa_blocksparse_bwd_dq(
    const void* q, const void* k, const void* v, const void* dout,
    const float* lse, const float* delta, float* dq, const int* kv_num,
    const int* kv_idx, int b, int h, int sq, int sk, int d, int bq, int bk,
    int nl, int64_t q_sb, int64_t q_sh, int64_t q_ss, int64_t k_sb,
    int64_t k_sh, int64_t k_ss, int64_t v_sb, int64_t v_sh, int64_t v_ss,
    int64_t do_sb, int64_t do_sh, int64_t do_ss, float scale, int causal,
    int is_bf16, void* stream) {
  if (!shapes_ok(b, h, sq, sk, d, bq, bk)) return (int)cudaErrorInvalidValue;
  BsParams p = make_params(q, k, v, h, sq, sk, bq, bk, q_sb, q_sh, q_ss, k_sb,
                           k_sh, k_ss, v_sb, v_sh, v_ss, scale, causal);
  p.dout = dout;
  p.lse = const_cast<float*>(lse);
  p.delta = delta;
  p.dq = dq;
  p.kv_num = kv_num;
  p.kv_idx = kv_idx;
  p.nl = nl;
  p.do_sb = do_sb; p.do_sh = do_sh; p.do_ss = do_ss;
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  if (is_bf16) {
    if (d == 64) return launch_dq<__nv_bfloat16, 64>(p, b, st);
    return launch_dq<__nv_bfloat16, 128>(p, b, st);
  }
  if (d == 64) return launch_dq<__half, 64>(p, b, st);
  return launch_dq<__half, 128>(p, b, st);
}
