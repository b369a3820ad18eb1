// Dense attention backward for Hopper (sm_90a) on wgmma and TMA, bf16 /
// fp16, head dim 64 or 128.
//
// Replaces the TPU kernels flash_attn_tpu/kernels/flash_bwd.py:_dkdv_kernel
// and :_dq_kernel (the deterministic two-kernel backward),
// flash_attn_tpu/kernels/flash_bwd_fused.py:_bwd_fused_kernel (the fused
// single pass) and flash_attn_tpu/kernels/flash_bwd_split.py:
// _bwd_diag_merge_kernel (the causal diagonal as a second launch), and the
// XLA op that computed delta before them (flash_bwd.py:406-413). Three
// kernels:
//
//  - preprocess_kernel: delta = rowsum(dO * O) in fp32 and lse in base 2,
//    one warp per (row, head), into (b, h, sq_pad) buffers padded to the
//    tiles (delta 0 and lse +inf past sq, so a padded row's P is 0); for the
//    fused path it also zeroes the fp32 dQ buffer;
//  - dkdv_kernel<ACCUM_DQ = false>: one block per (128 KV rows, KV head,
//    batch row) walks the group's query heads and the 64-row q tiles of its
//    causal band, keeps dK and dV in registers and writes them once
//    (deterministic); dq_kernel: one block per (128 q rows, head, batch row)
//    walks the 64-key tiles of its band and writes dQ once (deterministic);
//  - dkdv_kernel<ACCUM_DQ = true>: the fused single pass, which also adds
//    each q tile's dQ = dS K over the block's 128 keys into a zeroed fp32
//    buffer with vector reductions (red.global.add.v2.f32), each element
//    once a block; the order of the adds varies, so its last bits may vary
//    from run to run.
//
// What bounds it on this card: tensor cores. Per (q tile, KV tile) pair the
// two-kernel form runs 7 tile products (S and dP twice) and the fused form
// 5, against 2 in the forward: at the training shape (b = 4, s = 2048,
// h = 16, d = 128, causal) 172 GFLOP of useful products, 0.17 ms at 989
// TFLOP/s, while its bytes take 0.04 ms at 3.35 TB/s.
//
// What the design does about it: the dK/dV and dQ kernels run the
// backward tiles of csrc/bwd_sm90.cuh (every product a warpgroup wgmma, the
// resident K/V or Q/dO tiles and a two-stage TMA ring of the streamed ones;
// see its note) with the dense source below: 4D tensor maps over (b, s, h,
// d), whose boxes past sq or sk TMA fills with zeros. Each thread keeps
// 64 + 64 fp32 accumulators of dK and dV at d = 128 within the 255
// registers that a 256-thread block allows, so no register rebalancing
// (setmaxnreg) or separate producer warp is needed. One block barrier a
// tile keeps the two warpgroups in step: freeing each stage by mbarrier
// arrivals instead, a third stage, or issuing the next tile's products
// before the last one's end let them drift and made both kernels slower on
// the card (PERF.md §6). The fused form stages both warpgroups' dS^T
// (8 KB each; zeros from a warpgroup whose keys see no row of the tile, so
// that no product is skipped by a branch) in shared memory, and each
// warpgroup computes one 64-column half of dQ = dS K over all 128 keys:
// half the reductions of one partial a warpgroup. Only the
// tiles that cross the causal diagonal or the ragged end of the keys run
// the mask; rows past sq take P = 0 from their padded lse. Blocks are
// launched heaviest first (the first KV tiles, the last q tiles, under
// causal masking).
//
// Conventions: softmax_scale is natural; lse is natural-log (b, h, sq) and
// -inf for a row that sees no key (its P is 0). Causal masking is
// bottom-right aligned (shift = sk - sq). The tensor maps are encoded on the
// host for every call by cuTensorMapEncodeTiled, a CUDA driver API function
// reached with cudaGetDriverEntryPoint so that only the runtime is linked
// (sm90.cuh make_tile_map).

#include "bwd_sm90.cuh"

namespace {

using namespace fa::sm90;

constexpr int PRE_ROWS = 8;  // preprocess: rows (warps) a block

struct BwdParams {
  const float* lse2;   // (b, h, sq_pad): lse * log2(e), +inf for P = 0
  const float* delta;  // (b, h, sq_pad)
  void* dq;            // dq kernel: (b, sq, h, d) in q's type
  void* dk;
  void* dv;
  float* dq_accum;  // fused dkdv: (b, sq, h, d) fp32, zeroed
  int64_t dq_sb, dq_ss, dq_sh;
  int64_t dk_sb, dk_ss, dk_sh;
  int64_t dv_sb, dv_ss, dv_sh;
  int sq, sk, sq_pad, h, d;
  BwdArgs a;
};

// ---- preprocess -------------------------------------------------------------

template <typename T, int D>
__global__ void __launch_bounds__(PRE_ROWS * 32)
    preprocess_kernel(const T* __restrict__ dout, const T* __restrict__ out,
                      const float* __restrict__ lse, float* __restrict__ lse2,
                      float* __restrict__ delta, float* __restrict__ dq_accum,
                      int sq, int sq_pad, int h, int64_t do_sb, int64_t do_ss,
                      int64_t do_sh, int64_t o_sb, int64_t o_ss, int64_t o_sh) {
  constexpr int PER = D / 32;  // elements a lane
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * PRE_ROWS + (threadIdx.x >> 5);
  const int hh = blockIdx.y;
  const int bb = blockIdx.z;
  if (row >= sq_pad) return;
  const int64_t idx = ((int64_t)bb * h + hh) * sq_pad + row;
  if (row >= sq) {
    if (lane == 0) {
      delta[idx] = 0.f;
      lse2[idx] = INFINITY;
    }
    return;
  }
  const float acc = bwd_preprocess_row<T, D>(
      dout + bb * do_sb + row * do_ss + hh * do_sh + lane * PER,
      out + bb * o_sb + row * o_ss + hh * o_sh + lane * PER);
  if (lane == 0) {
    delta[idx] = acc;
    lse2[idx] = bwd_lse2(lse[((int64_t)bb * h + hh) * sq + row]);
  }
  if (dq_accum != nullptr) {
    float* dst = dq_accum + (((int64_t)bb * sq + row) * h + hh) * D + lane * PER;
#pragma unroll
    for (int i = 0; i < PER; i += 2) *reinterpret_cast<float2*>(dst + i) = make_float2(0.f, 0.f);
  }
}

// ---- the dense source -------------------------------------------------------

// Batch row bb of the (b, s, h, d) operands: 4D maps, the padded (b, h,
// sq_pad) lse2 / delta, the gradients by element strides.
template <typename T>
struct DenseSrc {
  static constexpr bool ZERO_TAIL = false;  // TMA zero-fills past sq and sk
  const BwdMaps* maps;
  const BwdParams* p;
  int bb, sq, sk;
  __device__ __forceinline__ DenseSrc(const BwdMaps& m, const BwdParams& prm, int b)
      : maps(&m), p(&prm), bb(b), sq(prm.sq), sk(prm.sk) {}
  __device__ __forceinline__ void load_q(void* dst, uint64_t* bar, int col, int row,
                                         int hq) const {
    tma_load_4d(dst, &maps->q, bar, col, row, hq, bb);
  }
  __device__ __forceinline__ void load_do(void* dst, uint64_t* bar, int col, int row,
                                          int hq) const {
    tma_load_4d(dst, &maps->dout, bar, col, row, hq, bb);
  }
  __device__ __forceinline__ void load_k(void* dst, uint64_t* bar, int col, int row,
                                         int hk) const {
    tma_load_4d(dst, &maps->k, bar, col, row, hk, bb);
  }
  __device__ __forceinline__ void load_v(void* dst, uint64_t* bar, int col, int row,
                                         int hk) const {
    tma_load_4d(dst, &maps->v, bar, col, row, hk, bb);
  }
  __device__ __forceinline__ const float* lse2(int hq, int row) const {
    return p->lse2 + ((int64_t)bb * p->h + hq) * p->sq_pad + row;
  }
  __device__ __forceinline__ const float* delta(int hq, int row) const {
    return p->delta + ((int64_t)bb * p->h + hq) * p->sq_pad + row;
  }
  __device__ __forceinline__ T* dk(int row, int hk) const {
    return reinterpret_cast<T*>(p->dk) + bb * p->dk_sb + row * p->dk_ss + hk * p->dk_sh;
  }
  __device__ __forceinline__ T* dv(int row, int hk) const {
    return reinterpret_cast<T*>(p->dv) + bb * p->dv_sb + row * p->dv_ss + hk * p->dv_sh;
  }
  __device__ __forceinline__ T* dq(int row, int hq) const {
    return reinterpret_cast<T*>(p->dq) + bb * p->dq_sb + row * p->dq_ss + hq * p->dq_sh;
  }
  __device__ __forceinline__ float* dq_accum(int row, int hq) const {
    return p->dq_accum + (((int64_t)bb * p->sq + row) * p->h + hq) * p->d;
  }
};

// ---- the kernels ------------------------------------------------------------

// dK/dV (and the fused dQ): one block per (KV head, batch row, 128 KV rows),
// KV tile 0 (the heaviest under causal masking) first.
template <typename T, int D, bool ACCUM_DQ>
__global__ void __launch_bounds__(BWD_THREADS, 1)
    dkdv_kernel(const __grid_constant__ BwdMaps maps, const BwdParams p) {
  extern __shared__ unsigned char smem_raw[];
  bwd_dkdv<T, D, ACCUM_DQ>(DenseSrc<T>(maps, p, blockIdx.y), p.a, blockIdx.x,
                           blockIdx.z * BWD_KV_ROWS, align_1024(smem_raw));
}

// dQ: one block per (head, batch row, 128 q rows), the last (heaviest)
// q tile first.
template <typename T, int D>
__global__ void __launch_bounds__(BWD_THREADS, 1)
    dq_kernel(const __grid_constant__ BwdMaps maps, const BwdParams p) {
  extern __shared__ unsigned char smem_raw[];
  bwd_dq<T, D>(DenseSrc<T>(maps, p, blockIdx.y), p.a, blockIdx.x,
               (gridDim.z - 1 - blockIdx.z) * BWD_Q_ROWS, align_1024(smem_raw));
}

// ---- host side --------------------------------------------------------------

// The tensor map of a (b, s, h, d) operand given by element strides (the
// head dim contiguous): boxes of 64 columns by `rows` rows of one head,
// 128-byte swizzle, rows past s zero-filled.
cudaError_t make_map(CUtensorMap* map, const void* ptr, bool bf16, int d, int s,
                     int h, int b, int64_t ss, int64_t sh, int64_t sb, int rows) {
  return make_tile_map<4>(map, ptr, bf16, {d, s, h, b}, {ss, sh, sb}, rows);
}

struct Operands {
  const void* q;
  const void* k;
  const void* v;
  const void* dout;
  int64_t q_sb, q_ss, q_sh, k_sb, k_ss, k_sh, v_sb, v_ss, v_sh, do_sb, do_ss, do_sh;
};

// Maps of q and dout with boxes of q_rows rows, k and v of kv_rows rows.
cudaError_t make_maps(BwdMaps* m, const Operands& o, bool bf16, int b, int sq, int sk,
                      int h, int h_k, int d, int q_rows, int kv_rows) {
  cudaError_t err;
  if ((err = make_map(&m->q, o.q, bf16, d, sq, h, b, o.q_ss, o.q_sh, o.q_sb, q_rows)) ||
      (err = make_map(&m->dout, o.dout, bf16, d, sq, h, b, o.do_ss, o.do_sh, o.do_sb,
                      q_rows)) ||
      (err = make_map(&m->k, o.k, bf16, d, sk, h_k, b, o.k_ss, o.k_sh, o.k_sb, kv_rows)) ||
      (err = make_map(&m->v, o.v, bf16, d, sk, h_k, b, o.v_ss, o.v_sh, o.v_sb, kv_rows)))
    return err;
  return cudaSuccess;
}

template <typename Kernel>
cudaError_t launch(Kernel kernel, dim3 grid, int smem, const BwdMaps& maps,
                   const BwdParams& p, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  kernel<<<grid, BWD_THREADS, smem, stream>>>(maps, p);
  return cudaGetLastError();
}

template <typename T, int D>
cudaError_t launch_dkdv(const BwdMaps& maps, const BwdParams& p, int b, int h_k,
                        cudaStream_t stream) {
  const dim3 grid(h_k, b, (p.sk + BWD_KV_ROWS - 1) / BWD_KV_ROWS);
  if (p.dq_accum != nullptr)
    return launch(dkdv_kernel<T, D, true>, grid, DkdvLayout<D, true>::SMEM, maps, p, stream);
  return launch(dkdv_kernel<T, D, false>, grid, DkdvLayout<D, false>::SMEM, maps, p, stream);
}

template <typename T, int D>
cudaError_t launch_dq(const BwdMaps& maps, const BwdParams& p, int b,
                      cudaStream_t stream) {
  const dim3 grid(p.h, b, (p.sq + BWD_Q_ROWS - 1) / BWD_Q_ROWS);
  return launch(dq_kernel<T, D>, grid, DqLayout<D>::SMEM, maps, p, stream);
}

BwdParams make_params(const float* lse2, const float* delta, int sq, int sk, int sq_pad,
                      int h, int h_k, int d, float scale, int causal) {
  BwdParams p = {};
  p.lse2 = lse2;
  p.delta = delta;
  p.sq = sq;
  p.sk = sk;
  p.sq_pad = sq_pad;
  p.h = h;
  p.d = d;
  p.a = {scale, scale * FA_LOG2E, causal, h / h_k};
  return p;
}

bool valid(int b, int sq, int sk, int sq_pad, int h, int h_k, int d) {
  return b > 0 && sq > 0 && sk > 0 && h_k > 0 && h % h_k == 0 && (d == 64 || d == 128) &&
         sq_pad % BWD_ROW_PAD == 0 && sq_pad >= sq;
}

}  // namespace

// delta = rowsum(dout * out) (b, h, sq_pad) fp32 and lse2 = lse * log2(e)
// (+inf where lse is -inf), delta 0 and lse2 +inf on the rows [sq, sq_pad);
// with dq_accum (b, sq, h, d) fp32 given, also zeroes it. dout/out (b, sq,
// h, d) by element strides with the head dim contiguous; lse (b, h, sq)
// contiguous fp32. Returns a cudaError_t (0 on success).
extern "C" int fa_bwd_preprocess(const void* dout, const void* out, const float* lse,
                                 float* lse2, float* delta, float* dq_accum, int b,
                                 int sq, int sq_pad, int h, int d, int64_t do_sb,
                                 int64_t do_ss, int64_t do_sh, int64_t o_sb,
                                 int64_t o_ss, int64_t o_sh, int is_bf16, void* stream) {
  if (!valid(b, sq, 1, sq_pad, h, 1, d)) return (int)cudaErrorInvalidValue;
  const dim3 grid((sq_pad + PRE_ROWS - 1) / PRE_ROWS, h, b);
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
#define FA_PRE(T, D)                                                              \
  preprocess_kernel<T, D><<<grid, PRE_ROWS * 32, 0, st>>>(                         \
      reinterpret_cast<const T*>(dout), reinterpret_cast<const T*>(out), lse, lse2, \
      delta, dq_accum, sq, sq_pad, h, do_sb, do_ss, do_sh, o_sb, o_ss, o_sh)
  if (is_bf16) {
    if (d == 64) FA_PRE(__nv_bfloat16, 64);
    else FA_PRE(__nv_bfloat16, 128);
  } else {
    if (d == 64) FA_PRE(__half, 64);
    else FA_PRE(__half, 128);
  }
#undef FA_PRE
  return (int)cudaGetLastError();
}

// dK and dV (and, with dq_accum given, dQ * scale added into it). q/dout
// (b, sq, h, d), k/v and dk/dv (b, sk, h_k, d), all by element strides with
// the head dim contiguous, 16-byte aligned starts and strides (TMA); lse2 and
// delta (b, h, sq_pad) from fa_bwd_preprocess; dq_accum (b, sq, h, d)
// contiguous fp32, zeroed. block_q/block_k must name the tile the kernel is
// compiled for (dispatch/config.py DENSE_BWD_TILES). Returns a cudaError_t.
extern "C" int fa_bwd_dkdv(const void* q, const void* k, const void* v,
                           const void* dout, const float* lse2,
                           const float* delta, void* dk, void* dv,
                           float* dq_accum, int b, int sq, int sk, int sq_pad,
                           int h, int h_k, int d, int block_q, int block_k,
                           int64_t q_sb, int64_t q_ss, int64_t q_sh,
                           int64_t k_sb, int64_t k_ss, int64_t k_sh,
                           int64_t v_sb, int64_t v_ss, int64_t v_sh,
                           int64_t do_sb, int64_t do_ss, int64_t do_sh,
                           int64_t dk_sb, int64_t dk_ss, int64_t dk_sh,
                           int64_t dv_sb, int64_t dv_ss, int64_t dv_sh,
                           float scale, int causal, int is_bf16, void* stream) {
  if (block_q != BWD_KV_BM || block_k != BWD_KV_ROWS || !valid(b, sq, sk, sq_pad, h, h_k, d))
    return (int)cudaErrorInvalidValue;
  const Operands o = {q, k, v, dout, q_sb, q_ss, q_sh, k_sb, k_ss, k_sh,
                      v_sb, v_ss, v_sh, do_sb, do_ss, do_sh};
  BwdMaps maps;
  cudaError_t err = make_maps(&maps, o, is_bf16, b, sq, sk, h, h_k, d, BWD_KV_BM, BWD_KV_ROWS);
  if (err != cudaSuccess) return (int)err;
  BwdParams p = make_params(lse2, delta, sq, sk, sq_pad, h, h_k, d, scale, causal);
  p.dk = dk;
  p.dv = dv;
  p.dq_accum = dq_accum;
  p.dk_sb = dk_sb; p.dk_ss = dk_ss; p.dk_sh = dk_sh;
  p.dv_sb = dv_sb; p.dv_ss = dv_ss; p.dv_sh = dv_sh;
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  if (is_bf16) {
    if (d == 64) return launch_dkdv<__nv_bfloat16, 64>(maps, p, b, h_k, st);
    return launch_dkdv<__nv_bfloat16, 128>(maps, p, b, h_k, st);
  }
  if (d == 64) return launch_dkdv<__half, 64>(maps, p, b, h_k, st);
  return launch_dkdv<__half, 128>(maps, p, b, h_k, st);
}

// dQ (b, sq, h, d) in q's type, written once. Layouts as fa_bwd_dkdv.
extern "C" int fa_bwd_dq(const void* q, const void* k, const void* v,
                         const void* dout, const float* lse2,
                         const float* delta, void* dq, int b, int sq, int sk,
                         int sq_pad, int h, int h_k, int d, int block_q, int block_k,
                         int64_t q_sb, int64_t q_ss, int64_t q_sh,
                         int64_t k_sb, int64_t k_ss, int64_t k_sh,
                         int64_t v_sb, int64_t v_ss, int64_t v_sh,
                         int64_t do_sb, int64_t do_ss, int64_t do_sh,
                         int64_t dq_sb, int64_t dq_ss, int64_t dq_sh,
                         float scale, int causal, int is_bf16, void* stream) {
  if (block_q != BWD_Q_ROWS || block_k != BWD_Q_BN || !valid(b, sq, sk, sq_pad, h, h_k, d))
    return (int)cudaErrorInvalidValue;
  const Operands o = {q, k, v, dout, q_sb, q_ss, q_sh, k_sb, k_ss, k_sh,
                      v_sb, v_ss, v_sh, do_sb, do_ss, do_sh};
  BwdMaps maps;
  cudaError_t err = make_maps(&maps, o, is_bf16, b, sq, sk, h, h_k, d, BWD_Q_ROWS, BWD_Q_BN);
  if (err != cudaSuccess) return (int)err;
  BwdParams p = make_params(lse2, delta, sq, sk, sq_pad, h, h_k, d, scale, causal);
  p.dq = dq;
  p.dq_sb = dq_sb; p.dq_ss = dq_ss; p.dq_sh = dq_sh;
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  if (is_bf16) {
    if (d == 64) return launch_dq<__nv_bfloat16, 64>(maps, p, b, st);
    return launch_dq<__nv_bfloat16, 128>(maps, p, b, st);
  }
  if (d == 64) return launch_dq<__half, 64>(maps, p, b, st);
  return launch_dq<__half, 128>(maps, p, b, st);
}
