// Packed varlen attention backward for Hopper (sm_90a), bf16 / fp16, head
// dim 64 or 128: the deterministic dK/dV and dQ kernels of B6. The forward
// (B6's and the persistent B7) runs the wgmma/TMA tile of fwd_sm90.cuh in
// flash_varlen_fwd.cu.
//
// Replaces the TPU kernels flash_attn_tpu/kernels/flash_varlen.py:
// _varlen_dkdv_stream_kernel and _varlen_dq_stream_kernel as
// varlen_dkdv_kernel, one block per (k tile, KV head) that walks its
// sequence's q band and sums the group's heads, and varlen_dq_kernel, one
// block per (q tile, head); each writes its gradient once, with no atomics,
// so the backward is deterministic.
//
// The TPU kernels tile the flat token axis with aligned blocks, because a DMA
// must be aligned, and rebuild the sequences from per-token segment ids.
// Here every tile belongs to one sequence: the wrapper builds work lists of
// (sequence, first local row) with torch ops on the device
// (dispatch/varlen_meta.py, q_tiles and k_tiles at 64 rows), and a block
// finds its sequence's origin in cu_seqlens and its length (seqused where
// given). The tile loops are the mma.sync loops of bwd_tile.cuh, whose only
// masks are the in-sequence causal mask and the ragged ends. Rows past a
// sequence's length and rows past cu_seqlens[-1] (the packed tail of
// unpad_input) are in no tile: the wrapper allocates them as zeros (dq, dk,
// dv).
//
// What bounds it on this card: per head, a sequence of sq rows over sk keys
// does 10 * sq * sk * d flops (about half under the causal mask: 2.5 x the
// forward's products) and moves q, k, v, dout, lse, delta and the three
// gradients once. What limits these simple kernels is how well they feed
// the tensor cores, as for the dense ones.

#include "bwd_tile.cuh"

namespace {

struct VarlenParams {
  const void* q;       // (total_q, h, d) by strides
  const void* k;       // (total_k, h_k, d) by strides
  const void* v;
  const void* dout;    // (total_q, h, d)
  const float* lse_in; // (h, total_q)
  const float* delta;  // (h, total_q)
  void* dq;
  void* dk;
  void* dv;
  const int* cu_q;     // (b + 1,) token offsets of the packed layouts
  const int* cu_k;
  const int* lens_q;   // (b,) query rows of each sequence (seqused_q)
  const int* lens_k;   // (b,) keys of each sequence (seqused_k)
  const int* tiles;    // (num_tiles, 2): sequence (-1: no tile), first row
  int num_tiles;
  int64_t q_st, q_sh, k_st, k_sh, v_st, v_sh;
  int64_t do_st, do_sh, dq_st, dq_sh, dk_st, dk_sh, dv_st, dv_sh;
  int total_q, h, group;
  float scale, scale_log2;
  int causal;
};

// Sequence `seq` as the tile loops see it: query-side pointers at head hq,
// KV-side ones at KV head hk.
template <typename T>
__device__ __forceinline__ fa::BwdSeq<T> seq_view(const VarlenParams& p,
                                                  int seq, int hq, int hk) {
  const int q0 = p.cu_q[seq];
  const int k0 = p.cu_k[seq];
  fa::BwdSeq<T> s;
  s.q = reinterpret_cast<const T*>(p.q) + (int64_t)q0 * p.q_st + hq * p.q_sh;
  s.dout = reinterpret_cast<const T*>(p.dout) + (int64_t)q0 * p.do_st + hq * p.do_sh;
  s.k = reinterpret_cast<const T*>(p.k) + (int64_t)k0 * p.k_st + hk * p.k_sh;
  s.v = reinterpret_cast<const T*>(p.v) + (int64_t)k0 * p.v_st + hk * p.v_sh;
  s.lse = p.lse_in + (int64_t)hq * p.total_q + q0;
  s.delta = p.delta + (int64_t)hq * p.total_q + q0;
  s.dq = p.dq ? reinterpret_cast<T*>(p.dq) + (int64_t)q0 * p.dq_st + hq * p.dq_sh
              : nullptr;
  s.dk = p.dk ? reinterpret_cast<T*>(p.dk) + (int64_t)k0 * p.dk_st + hk * p.dk_sh
              : nullptr;
  s.dv = p.dv ? reinterpret_cast<T*>(p.dv) + (int64_t)k0 * p.dv_st + hk * p.dv_sh
              : nullptr;
  s.q_ss = p.q_st;
  s.q_sh = p.q_sh;
  s.do_ss = p.do_st;
  s.do_sh = p.do_sh;
  s.k_ss = p.k_st;
  s.v_ss = p.v_st;
  s.dq_ss = p.dq_st;
  s.dk_ss = p.dk_st;
  s.dv_ss = p.dv_st;
  s.lse_sh = p.total_q;
  s.sq = p.lens_q[seq];
  s.sk = p.lens_k[seq];
  return s;
}

__device__ __forceinline__ fa::BwdScalars scalars(const VarlenParams& p) {
  return {p.scale, p.scale_log2, p.causal, p.group};
}

// B6 dK/dV: one block per (k tile of a sequence, KV head); `tiles` is the
// key-side work list.
template <typename T, int D, int BM>
__global__ void __launch_bounds__(fa::BWD_THREADS)
    varlen_dkdv_kernel(const VarlenParams p) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  const int seq = p.tiles[2 * blockIdx.x];
  if (seq < 0) return;
  const int hk = blockIdx.y;
  const fa::BwdSeq<T> s = seq_view<T>(p, seq, hk * p.group, hk);
  fa::dkdv_tile<T, D, BM>(s, p.tiles[2 * blockIdx.x + 1], scalars(p),
                                 smem_raw);
}

// B6 dQ: one block per (q tile, head).
template <typename T, int D>
__global__ void __launch_bounds__(fa::BWD_THREADS)
    varlen_dq_kernel(const VarlenParams p) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  const int seq = p.tiles[2 * blockIdx.x];
  if (seq < 0) return;
  const int hh = blockIdx.y;
  const fa::BwdSeq<T> s = seq_view<T>(p, seq, hh, hh / p.group);
  fa::dq_tile<T, D>(s, p.tiles[2 * blockIdx.x + 1], scalars(p), smem_raw);
}

template <typename Kernel>
cudaError_t set_smem(Kernel kernel, int smem) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              smem);
}

template <typename T, int D>
cudaError_t launch_dkdv(const VarlenParams& p, int h_k, cudaStream_t stream) {
  constexpr int BM = fa::dkdv_bm<D>();
  constexpr int smem = fa::dkdv_smem_bytes<T, D, BM>();
  cudaError_t err = set_smem(varlen_dkdv_kernel<T, D, BM>, smem);
  if (err != cudaSuccess) return err;
  varlen_dkdv_kernel<T, D, BM><<<dim3(p.num_tiles, h_k), fa::BWD_THREADS, smem, stream>>>(p);
  return cudaGetLastError();
}

template <typename T, int D>
cudaError_t launch_dq(const VarlenParams& p, cudaStream_t stream) {
  constexpr int smem = fa::dq_smem_bytes<T, D>();
  cudaError_t err = set_smem(varlen_dq_kernel<T, D>, smem);
  if (err != cudaSuccess) return err;
  varlen_dq_kernel<T, D><<<dim3(p.num_tiles, p.h), fa::BWD_THREADS, smem, stream>>>(p);
  return cudaGetLastError();
}

VarlenParams make_params(const int* cu_q, const int* cu_k, const int* lens_q,
                         const int* lens_k, const int* tiles, int num_tiles,
                         int total_q, int h, int h_k, float scale, int causal) {
  VarlenParams p = {};
  p.cu_q = cu_q;
  p.cu_k = cu_k;
  p.lens_q = lens_q;
  p.lens_k = lens_k;
  p.tiles = tiles;
  p.num_tiles = num_tiles;
  p.total_q = total_q;
  p.h = h;
  p.group = h / h_k;
  p.scale = scale;
  p.scale_log2 = scale * FA_LOG2E;
  p.causal = causal;
  return p;
}

// Run f<T, D>() for the element type and head dim of a call.
template <template <typename, int> class F, typename... Args>
int dispatch(int is_bf16, int d, Args&&... args) {
  if (is_bf16) {
    if (d == 64) return (int)F<__nv_bfloat16, 64>::run(args...);
    if (d == 128) return (int)F<__nv_bfloat16, 128>::run(args...);
  } else {
    if (d == 64) return (int)F<__half, 64>::run(args...);
    if (d == 128) return (int)F<__half, 128>::run(args...);
  }
  return (int)cudaErrorInvalidValue;
}

template <typename T, int D>
struct Dkdv {
  static cudaError_t run(const VarlenParams& p, int h_k, cudaStream_t st) {
    return launch_dkdv<T, D>(p, h_k, st);
  }
};

template <typename T, int D>
struct Dq {
  static cudaError_t run(const VarlenParams& p, cudaStream_t st) {
    return launch_dq<T, D>(p, st);
  }
};

}  // namespace

// dK, dV (total_k, h_k, d) in k's type over the key-side work list; rows in
// no tile are the wrapper's zeros. lse and delta (h, total_q) fp32. Layouts
// as fa_varlen_fwd (flash_varlen_fwd.cu); block_q/block_k name the dK/dV
// tile (dispatch/config.py get_bwd_config).
extern "C" int fa_varlen_bwd_dkdv(
    const void* q, const void* k, const void* v, const void* dout,
    const float* lse, const float* delta, void* dk, void* dv, const int* cu_q,
    const int* cu_k, const int* lens_q, const int* lens_k, const int* tiles,
    int num_tiles, int total_q, int h, int h_k, int d, int block_q,
    int block_k, int64_t q_st, int64_t q_sh, int64_t k_st, int64_t k_sh,
    int64_t v_st, int64_t v_sh, int64_t do_st, int64_t do_sh, int64_t dk_st,
    int64_t dk_sh, int64_t dv_st, int64_t dv_sh, float scale, int causal,
    int is_bf16, void* stream) {
  if (block_k != fa::KV_BN) return (int)cudaErrorInvalidValue;
  if (d == 64 && block_q != fa::dkdv_bm<64>()) return (int)cudaErrorInvalidValue;
  if (d == 128 && block_q != fa::dkdv_bm<128>()) return (int)cudaErrorInvalidValue;
  if (num_tiles == 0) return 0;
  VarlenParams p = make_params(cu_q, cu_k, lens_q, lens_k, tiles, num_tiles,
                               total_q, h, h_k, scale, causal);
  p.q = q;
  p.k = k;
  p.v = v;
  p.dout = dout;
  p.lse_in = lse;
  p.delta = delta;
  p.dk = dk;
  p.dv = dv;
  p.q_st = q_st; p.q_sh = q_sh;
  p.k_st = k_st; p.k_sh = k_sh;
  p.v_st = v_st; p.v_sh = v_sh;
  p.do_st = do_st; p.do_sh = do_sh;
  p.dk_st = dk_st; p.dk_sh = dk_sh;
  p.dv_st = dv_st; p.dv_sh = dv_sh;
  return dispatch<Dkdv>(is_bf16, d, p, h_k,
                        reinterpret_cast<cudaStream_t>(stream));
}

// dQ (total_q, h, d) in q's type over the query-side work list, written
// once. Layouts as fa_varlen_bwd_dkdv.
extern "C" int fa_varlen_bwd_dq(
    const void* q, const void* k, const void* v, const void* dout,
    const float* lse, const float* delta, void* dq, const int* cu_q,
    const int* cu_k, const int* lens_q, const int* lens_k, const int* tiles,
    int num_tiles, int total_q, int h, int h_k, int d, int block_q,
    int block_k, int64_t q_st, int64_t q_sh, int64_t k_st, int64_t k_sh,
    int64_t v_st, int64_t v_sh, int64_t do_st, int64_t do_sh, int64_t dq_st,
    int64_t dq_sh, float scale, int causal, int is_bf16, void* stream) {
  if (block_q != fa::DQ_BM || block_k != fa::DQ_BN) return (int)cudaErrorInvalidValue;
  if (num_tiles == 0) return 0;
  VarlenParams p = make_params(cu_q, cu_k, lens_q, lens_k, tiles, num_tiles,
                               total_q, h, h_k, scale, causal);
  p.q = q;
  p.k = k;
  p.v = v;
  p.dout = dout;
  p.lse_in = lse;
  p.delta = delta;
  p.dq = dq;
  p.q_st = q_st; p.q_sh = q_sh;
  p.k_st = k_st; p.k_sh = k_sh;
  p.v_st = v_st; p.v_sh = v_sh;
  p.do_st = do_st; p.do_sh = do_sh;
  p.dq_st = dq_st; p.dq_sh = dq_sh;
  return dispatch<Dq>(is_bf16, d, p, reinterpret_cast<cudaStream_t>(stream));
}
