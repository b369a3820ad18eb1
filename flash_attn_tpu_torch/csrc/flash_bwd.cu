// Dense attention backward for Hopper (sm_90a), bf16 / fp16, head dim 64 or 128.
//
// Replaces the TPU kernels flash_attn_tpu/kernels/flash_bwd.py:_dkdv_kernel
// and :_dq_kernel (the deterministic two-kernel backward),
// flash_attn_tpu/kernels/flash_bwd_fused.py:_bwd_fused_kernel (the fused
// single pass) and flash_attn_tpu/kernels/flash_bwd_split.py:
// _bwd_diag_merge_kernel (the causal diagonal as a second launch). Here:
//
//  - dkdv_kernel<ACCUM_DQ = false>: one block per (KV tile, KV head, batch)
//    loops over the group's query heads and the q tiles of its causal band,
//    keeps dK and dV in registers and writes them once (deterministic);
//  - dq_kernel: one block per (q tile, head, batch) loops over the KV tiles
//    of its band and writes dQ once (deterministic);
//  - dkdv_kernel<ACCUM_DQ = true>: the fused single pass, five products per
//    tile, dQ added into a zeroed fp32 buffer with atomics. Unlike the TPU's
//    fused kernel, which kept full-sequence accumulators in VMEM, this one is
//    not deterministic: the order of the atomic adds varies.
//
// Only the tiles that cross the causal diagonal or the ragged end of the
// sequences run the mask (what the TPU split into _bwd_diag_merge_kernel).
//
// What bounds it on this card: per (q tile, KV tile) pair the two-kernel
// form does 7 tile products (S and dP twice) and the fused form 5, against
// 2 in the forward, so the backward is tensor-core bound at the training
// shape (s = 2048: ~2.5 x the forward's flops). Registers bound the tile:
// the dK and dV accumulators of a warp's 16 KV rows take 2 x D / 2 fp32
// registers a thread (128 at D = 128), before S and dP.
//
// What the design does about it: the tile loops of bwd_tile.cuh (shared with
// the packed-varlen backward of flash_varlen.cu) compute the transposed
// scores S^T = K Q^T with the KV rows as the M dimension, so P^T and dS^T
// come out of the accumulators already in the A-operand layout of the next
// products, and keep every operand in swizzled shared memory; the q tile at
// D = 128 is 32 rows so that nothing spills (FA_BWD_BM_D128). wgmma, TMA and
// pipelining are left for later work.
//
// Conventions: softmax_scale is natural; lse is natural-log (b, h, sq) and
// -inf for a row that sees no key (its P is 0); delta = rowsum(dO * O) in
// fp32 (b, h, sq). Causal masking is bottom-right aligned (shift = sk - sq).

#include "bwd_tile.cuh"

namespace {

constexpr int NTHREADS = fa::BWD_THREADS;
constexpr int KV_BN = fa::KV_BN;
constexpr int DQ_BM = fa::DQ_BM;
constexpr int DQ_BN = fa::DQ_BN;

struct BwdParams {
  const void* q;
  const void* k;
  const void* v;
  const void* dout;
  const float* lse;    // (b, h, sq)
  const float* delta;  // (b, h, sq)
  void* dq;            // dq kernel: (b, sq, h, d) in q's type
  void* dk;
  void* dv;
  float* dq_accum;     // fused dkdv: (b, sq, h, d) fp32, zeroed
  int64_t q_sb, q_ss, q_sh;
  int64_t k_sb, k_ss, k_sh;
  int64_t v_sb, v_ss, v_sh;
  int64_t do_sb, do_ss, do_sh;
  int64_t dq_sb, dq_ss, dq_sh;
  int64_t dk_sb, dk_ss, dk_sh;
  int64_t dv_sb, dv_ss, dv_sh;
  int sq, sk, h, group;
  float scale, scale_log2;
  int causal;
};

// Batch row bb of the dense layout as one sequence of the tile loops: the
// query-side pointers at head hq, the KV-side ones at KV head hk.
template <typename T, int D>
__device__ __forceinline__ fa::BwdSeq<T> batch_row(const BwdParams& p, int bb,
                                                   int hq, int hk) {
  fa::BwdSeq<T> s;
  s.q = reinterpret_cast<const T*>(p.q) + bb * p.q_sb + hq * p.q_sh;
  s.dout = reinterpret_cast<const T*>(p.dout) + bb * p.do_sb + hq * p.do_sh;
  s.k = reinterpret_cast<const T*>(p.k) + bb * p.k_sb + hk * p.k_sh;
  s.v = reinterpret_cast<const T*>(p.v) + bb * p.v_sb + hk * p.v_sh;
  s.lse = p.lse + ((int64_t)bb * p.h + hq) * p.sq;
  s.delta = p.delta + ((int64_t)bb * p.h + hq) * p.sq;
  s.dq = p.dq ? reinterpret_cast<T*>(p.dq) + bb * p.dq_sb + hq * p.dq_sh : nullptr;
  s.dk = p.dk ? reinterpret_cast<T*>(p.dk) + bb * p.dk_sb + hk * p.dk_sh : nullptr;
  s.dv = p.dv ? reinterpret_cast<T*>(p.dv) + bb * p.dv_sb + hk * p.dv_sh : nullptr;
  s.dq_accum = p.dq_accum ? p.dq_accum + ((int64_t)bb * p.sq * p.h + hq) * D : nullptr;
  s.q_ss = p.q_ss;
  s.q_sh = p.q_sh;
  s.do_ss = p.do_ss;
  s.do_sh = p.do_sh;
  s.k_ss = p.k_ss;
  s.v_ss = p.v_ss;
  s.dq_ss = p.dq_ss;
  s.dk_ss = p.dk_ss;
  s.dv_ss = p.dv_ss;
  s.lse_sh = p.sq;
  s.dqa_ss = (int64_t)p.h * D;
  s.sq = p.sq;
  s.sk = p.sk;
  return s;
}

__device__ __forceinline__ fa::BwdScalars scalars(const BwdParams& p) {
  return {p.scale, p.scale_log2, p.causal, p.group};
}

// One block per (KV tile, KV head, batch row).
template <typename T, int D, int BM, bool ACCUM_DQ>
__global__ void __launch_bounds__(NTHREADS) dkdv_kernel(const BwdParams p) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  const int hk = blockIdx.y;
  const fa::BwdSeq<T> s = batch_row<T, D>(p, blockIdx.z, hk * p.group, hk);
  fa::dkdv_tile<T, D, BM, ACCUM_DQ>(s, blockIdx.x * KV_BN, scalars(p), smem_raw);
}

// One block per (q tile, head, batch row).
template <typename T, int D>
__global__ void __launch_bounds__(NTHREADS) dq_kernel(const BwdParams p) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  const int hh = blockIdx.y;
  const fa::BwdSeq<T> s = batch_row<T, D>(p, blockIdx.z, hh, hh / p.group);
  fa::dq_tile<T, D>(s, blockIdx.x * DQ_BM, scalars(p), smem_raw);
}

template <typename Kernel>
cudaError_t launch(Kernel kernel, dim3 grid, int smem, const BwdParams& p,
                   cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  kernel<<<grid, NTHREADS, smem, stream>>>(p);
  return cudaGetLastError();
}

template <typename T, int D>
cudaError_t launch_dkdv(const BwdParams& p, int b, int h_k, int accum_dq,
                        cudaStream_t stream) {
  constexpr int BM = fa::dkdv_bm<D>();
  const int smem = fa::dkdv_smem_bytes<T, D, BM>(accum_dq);
  const dim3 grid((p.sk + KV_BN - 1) / KV_BN, h_k, b);
  if (accum_dq) return launch(dkdv_kernel<T, D, BM, true>, grid, smem, p, stream);
  return launch(dkdv_kernel<T, D, BM, false>, grid, smem, p, stream);
}

template <typename T, int D>
cudaError_t launch_dq(const BwdParams& p, int b, cudaStream_t stream) {
  const int smem = fa::dq_smem_bytes<T, D>();
  const dim3 grid((p.sq + DQ_BM - 1) / DQ_BM, p.h, b);
  return launch(dq_kernel<T, D>, grid, smem, p, stream);
}

BwdParams make_params(const void* q, const void* k, const void* v,
                      const void* dout, const float* lse, const float* delta,
                      int sq, int sk, int h, int h_k, float scale, int causal) {
  BwdParams p = {};
  p.q = q;
  p.k = k;
  p.v = v;
  p.dout = dout;
  p.lse = lse;
  p.delta = delta;
  p.sq = sq;
  p.sk = sk;
  p.h = h;
  p.group = h / h_k;
  p.scale = scale;
  p.scale_log2 = scale * FA_LOG2E;
  p.causal = causal;
  return p;
}

}  // namespace

// dK and dV (and, with accum_dq, dQ * into dq_accum by atomics). q/dout
// (b, sq, h, d), k/v and dk/dv (b, sk, h_k, d), all by element strides with
// the head dim contiguous; lse and delta (b, h, sq) fp32; dq_accum (b, sq,
// h, d) contiguous fp32, zeroed by the caller. block_q/block_k must name the
// tile the kernel is compiled for (dispatch/config.py get_bwd_config).
// Returns a cudaError_t (0 on success).
extern "C" int fa_bwd_dkdv(const void* q, const void* k, const void* v,
                           const void* dout, const float* lse,
                           const float* delta, void* dk, void* dv,
                           float* dq_accum, int b, int sq, int sk, int h,
                           int h_k, int d, int block_q, int block_k,
                           int64_t q_sb, int64_t q_ss, int64_t q_sh,
                           int64_t k_sb, int64_t k_ss, int64_t k_sh,
                           int64_t v_sb, int64_t v_ss, int64_t v_sh,
                           int64_t do_sb, int64_t do_ss, int64_t do_sh,
                           int64_t dk_sb, int64_t dk_ss, int64_t dk_sh,
                           int64_t dv_sb, int64_t dv_ss, int64_t dv_sh,
                           float scale, int causal, int is_bf16, int accum_dq,
                           void* stream) {
  if (block_k != KV_BN) return (int)cudaErrorInvalidValue;
  if (d == 64 && block_q != fa::dkdv_bm<64>()) return (int)cudaErrorInvalidValue;
  if (d == 128 && block_q != fa::dkdv_bm<128>()) return (int)cudaErrorInvalidValue;
  if (accum_dq && dq_accum == nullptr) return (int)cudaErrorInvalidValue;
  BwdParams p = make_params(q, k, v, dout, lse, delta, sq, sk, h, h_k, scale, causal);
  p.dk = dk;
  p.dv = dv;
  p.dq_accum = dq_accum;
  p.q_sb = q_sb; p.q_ss = q_ss; p.q_sh = q_sh;
  p.k_sb = k_sb; p.k_ss = k_ss; p.k_sh = k_sh;
  p.v_sb = v_sb; p.v_ss = v_ss; p.v_sh = v_sh;
  p.do_sb = do_sb; p.do_ss = do_ss; p.do_sh = do_sh;
  p.dk_sb = dk_sb; p.dk_ss = dk_ss; p.dk_sh = dk_sh;
  p.dv_sb = dv_sb; p.dv_ss = dv_ss; p.dv_sh = dv_sh;
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  if (is_bf16) {
    if (d == 64) return launch_dkdv<__nv_bfloat16, 64>(p, b, h_k, accum_dq, st);
    if (d == 128) return launch_dkdv<__nv_bfloat16, 128>(p, b, h_k, accum_dq, st);
  } else {
    if (d == 64) return launch_dkdv<__half, 64>(p, b, h_k, accum_dq, st);
    if (d == 128) return launch_dkdv<__half, 128>(p, b, h_k, accum_dq, st);
  }
  return (int)cudaErrorInvalidValue;
}

// dQ (b, sq, h, d) in q's type, written once. Layouts as fa_bwd_dkdv.
extern "C" int fa_bwd_dq(const void* q, const void* k, const void* v,
                         const void* dout, const float* lse,
                         const float* delta, void* dq, int b, int sq, int sk,
                         int h, int h_k, int d, int block_q, int block_k,
                         int64_t q_sb, int64_t q_ss, int64_t q_sh,
                         int64_t k_sb, int64_t k_ss, int64_t k_sh,
                         int64_t v_sb, int64_t v_ss, int64_t v_sh,
                         int64_t do_sb, int64_t do_ss, int64_t do_sh,
                         int64_t dq_sb, int64_t dq_ss, int64_t dq_sh,
                         float scale, int causal, int is_bf16, void* stream) {
  if (block_q != DQ_BM || block_k != DQ_BN) return (int)cudaErrorInvalidValue;
  BwdParams p = make_params(q, k, v, dout, lse, delta, sq, sk, h, h_k, scale, causal);
  p.dq = dq;
  p.q_sb = q_sb; p.q_ss = q_ss; p.q_sh = q_sh;
  p.k_sb = k_sb; p.k_ss = k_ss; p.k_sh = k_sh;
  p.v_sb = v_sb; p.v_ss = v_ss; p.v_sh = v_sh;
  p.do_sb = do_sb; p.do_ss = do_ss; p.do_sh = do_sh;
  p.dq_sb = dq_sb; p.dq_ss = dq_ss; p.dq_sh = dq_sh;
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  if (is_bf16) {
    if (d == 64) return launch_dq<__nv_bfloat16, 64>(p, b, st);
    if (d == 128) return launch_dq<__nv_bfloat16, 128>(p, b, st);
  } else {
    if (d == 64) return launch_dq<__half, 64>(p, b, st);
    if (d == 128) return launch_dq<__half, 128>(p, b, st);
  }
  return (int)cudaErrorInvalidValue;
}
