// The dense attention backward's kernels and launches (see csrc/flash_bwd.cu
// for what they replace and how they are designed), shared by the sources
// that compile them: csrc/flash_bwd.cu (the C entry points, head dims 64
// and 128), csrc/flash_bwd_wide.cu (head dims 96 and 256), for the band
// instantiations (BAND: window, chunk and sinks) csrc/flash_bwd_band.cu (64
// and 128) and csrc/flash_bwd_band_wide.cu (96 and 256), and for the score
// instantiations (SCORE: softcap and ALiBi, with or without a band)
// csrc/flash_bwd_score.cu (64 and 128) and csrc/flash_bwd_score_wide.cu (96
// and 256), and at head dim 80 csrc/flash_bwd_80.cu (the preprocess, the
// band-free and the band instantiations) and csrc/flash_bwd_score_80.cu
// (the score ones), and at q/k head dim 192 beside v head dim 128
// csrc/flash_bwd_192.cu (the preprocess, dK/dV with and without the fused
// pass's dQ, and dQ, band-free), so that the heavy instantiations build
// side by side.
#pragma once

#include "bwd_sm90.cuh"

namespace fa {
namespace dense_bwd {

using namespace fa::sm90;

constexpr int PRE_ROWS = 8;  // preprocess: rows (warps) a block

struct BwdParams {
  const float* lse2;   // (b, h, sq_pad): lse * log2(e), +inf for P = 0
  const float* delta;  // (b, h, sq_pad)
  void* dq;            // dq kernel: (b, sq, h, d) in q's type
  void* dk;
  void* dv;            // (b, sk, h_k, dv)
  float* dq_accum;  // fused dkdv: (b, sq, h, d) fp32, zeroed
  int64_t dq_sb, dq_ss, dq_sh;
  int64_t dk_sb, dk_ss, dk_sh;
  int64_t dv_sb, dv_ss, dv_sh;
  int sq, sk, sq_pad, h, d;
  BwdArgs a;
  Band band;  // read by the BAND instantiations alone
  // read by the SCORE instantiations alone: the cap and the bias's form,
  // and the slopes (b, h) fp32 at slopes[bb * slope_sb + h] (slope_sb 0:
  // one slope a head), or none
  Score score;
  const float* slopes;
  int64_t slope_sb;
};

// The preprocess kernel's arguments (see fa_bwd_preprocess).
struct PreParams {
  const void* dout;
  const void* out;
  const float* lse;
  float* lse2;
  float* delta;
  float* dq_accum;
  int b, sq, sq_pad, h;
  int64_t do_sb, do_ss, do_sh, o_sb, o_ss, o_sh;
};

// ---- preprocess -------------------------------------------------------------

// delta over dO's and O's DV columns; the fused pass's fp32 dQ rows of D
// columns cleared (DV: D's unless given).
template <typename T, int D, int DV = D>
__global__ void __launch_bounds__(PRE_ROWS * 32) preprocess_kernel(const PreParams p) {
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * PRE_ROWS + (threadIdx.x >> 5);
  const int hh = blockIdx.y;
  const int bb = blockIdx.z;
  if (row >= p.sq_pad) return;
  const int64_t idx = ((int64_t)bb * p.h + hh) * p.sq_pad + row;
  if (row >= p.sq) {
    if (lane == 0) {
      p.delta[idx] = 0.f;
      p.lse2[idx] = INFINITY;
    }
    return;
  }
  const int e = bwd_lane_elem<DV>(lane);
  const float acc = bwd_preprocess_row<T, DV>(
      reinterpret_cast<const T*>(p.dout) + bb * p.do_sb + row * p.do_ss + hh * p.do_sh + e,
      reinterpret_cast<const T*>(p.out) + bb * p.o_sb + row * p.o_ss + hh * p.o_sh + e);
  if (lane == 0) {
    p.delta[idx] = acc;
    p.lse2[idx] = bwd_lse2(p.lse[((int64_t)bb * p.h + hh) * p.sq + row]);
  }
  if (p.dq_accum != nullptr) {
    float* dst = p.dq_accum + (((int64_t)bb * p.sq + row) * p.h + hh) * D;
    for (int i = 2 * lane; i < D; i += 64)
      *reinterpret_cast<float2*>(dst + i) = make_float2(0.f, 0.f);
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

// The batch row's slopes (h,) of a SCORE instantiation, or none.
__device__ __forceinline__ const float* row_slopes(const BwdParams& p, int bb) {
  return p.slopes != nullptr ? p.slopes + bb * p.slope_sb : nullptr;
}

// dK/dV (and the fused dQ): one block per (KV head, batch row, block of
// bwd_block_rows(D) KV rows), KV tile 0 (the heaviest under causal masking)
// first. BAND: the q tiles of the band (p.band) alone. SCORE (with BAND;
// p.band holds the causal bound): the scores mapped by p.score. DV: v's and
// dout's head dim, D's unless given (the band-free form alone beside
// another).
template <typename T, int D, bool ACCUM_DQ, bool BAND, bool SCORE, int DV = D>
__global__ void __launch_bounds__(BWD_THREADS, 1)
    dkdv_kernel(const __grid_constant__ BwdMaps maps, const BwdParams p) {
  extern __shared__ unsigned char smem_raw[];
  if constexpr (DV != D)
    bwd_dkdv<T, D, ACCUM_DQ, DV>(DenseSrc<T>(maps, p, blockIdx.y), p.a, blockIdx.x,
                                 blockIdx.z * BwdPlan<D>::ROWS, align_1024(smem_raw));
  else if constexpr (SCORE)
    bwd_dkdv_band<T, D, ACCUM_DQ, true>(DenseSrc<T>(maps, p, blockIdx.y), p.a, blockIdx.x,
                                        blockIdx.z * BwdPlan<D>::ROWS, align_1024(smem_raw),
                                        p.band, p.score, row_slopes(p, blockIdx.y));
  else if constexpr (BAND)
    bwd_dkdv_band<T, D, ACCUM_DQ>(DenseSrc<T>(maps, p, blockIdx.y), p.a, blockIdx.x,
                                  blockIdx.z * BwdPlan<D>::ROWS, align_1024(smem_raw), p.band);
  else
    bwd_dkdv<T, D, ACCUM_DQ>(DenseSrc<T>(maps, p, blockIdx.y), p.a, blockIdx.x,
                             blockIdx.z * BwdPlan<D>::ROWS, align_1024(smem_raw));
}

// dQ: one block per (head, batch row, block of bwd_block_rows(D) q rows),
// the last (heaviest) q block first. BAND: the key tiles of the band alone.
// SCORE and DV: as dkdv_kernel (the block's rows: DqPlan).
template <typename T, int D, bool BAND, bool SCORE, int DV = D>
__global__ void __launch_bounds__(BWD_THREADS, 1)
    dq_kernel(const __grid_constant__ BwdMaps maps, const BwdParams p) {
  extern __shared__ unsigned char smem_raw[];
  if constexpr (DV != D)
    bwd_dq<T, D, DV>(DenseSrc<T>(maps, p, blockIdx.y), p.a, blockIdx.x,
                     (gridDim.z - 1 - blockIdx.z) * DqPlan<D, DV>::ROWS, align_1024(smem_raw));
  else if constexpr (SCORE)
    bwd_dq_band<T, D, true>(DenseSrc<T>(maps, p, blockIdx.y), p.a, blockIdx.x,
                            (gridDim.z - 1 - blockIdx.z) * BwdPlan<D>::ROWS,
                            align_1024(smem_raw), p.band, p.score, row_slopes(p, blockIdx.y));
  else if constexpr (BAND)
    bwd_dq_band<T, D>(DenseSrc<T>(maps, p, blockIdx.y), p.a, blockIdx.x,
                      (gridDim.z - 1 - blockIdx.z) * BwdPlan<D>::ROWS, align_1024(smem_raw),
                      p.band);
  else
    bwd_dq<T, D>(DenseSrc<T>(maps, p, blockIdx.y), p.a, blockIdx.x,
                 (gridDim.z - 1 - blockIdx.z) * BwdPlan<D>::ROWS, align_1024(smem_raw));
}

// ---- launches ---------------------------------------------------------------

template <typename Kernel>
cudaError_t launch(Kernel kernel, dim3 grid, int smem, const BwdMaps& maps,
                   const BwdParams& p, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  kernel<<<grid, BWD_THREADS, smem, stream>>>(maps, p);
  return cudaGetLastError();
}

template <typename T, int D, int DV = D>
cudaError_t run_pre(const PreParams& p, cudaStream_t st) {
  const dim3 grid((p.sq_pad + PRE_ROWS - 1) / PRE_ROWS, p.h, p.b);
  preprocess_kernel<T, D, DV><<<grid, PRE_ROWS * 32, 0, st>>>(p);
  return cudaGetLastError();
}

template <typename T, int D>
struct Pre {
  static cudaError_t run(const PreParams& p, cudaStream_t st) { return run_pre<T, D>(p, st); }
};

template <typename T, int D, bool BAND, bool SCORE = false, int DV = D>
cudaError_t run_dkdv(const BwdMaps& maps, const BwdParams& p, int b, int h_k, cudaStream_t st) {
  constexpr int rows = BwdPlan<D>::ROWS;
  const dim3 grid(h_k, b, (p.sk + rows - 1) / rows);
  if (p.dq_accum != nullptr)
    return launch(dkdv_kernel<T, D, true, BAND, SCORE, DV>, grid,
                  DkdvLayout<D, true, DV>::SMEM, maps, p, st);
  return launch(dkdv_kernel<T, D, false, BAND, SCORE, DV>, grid,
                DkdvLayout<D, false, DV>::SMEM, maps, p, st);
}

template <typename T, int D, bool BAND, bool SCORE = false, int DV = D>
cudaError_t run_dq(const BwdMaps& maps, const BwdParams& p, int b, cudaStream_t st) {
  constexpr int rows = DqPlan<D, DV>::ROWS;
  const dim3 grid(p.h, b, (p.sq + rows - 1) / rows);
  return launch(dq_kernel<T, D, BAND, SCORE, DV>, grid, DqLayout<D, DV>::SMEM, maps, p, st);
}

template <typename T, int D>
struct Dkdv {
  static cudaError_t run(const BwdMaps& maps, const BwdParams& p, int b, int h_k,
                         cudaStream_t st) {
    return run_dkdv<T, D, false>(maps, p, b, h_k, st);
  }
};

template <typename T, int D>
struct Dq {
  static cudaError_t run(const BwdMaps& maps, const BwdParams& p, int b, cudaStream_t st) {
    return run_dq<T, D, false>(maps, p, b, st);
  }
};

template <typename T, int D>
struct DkdvBand {
  static cudaError_t run(const BwdMaps& maps, const BwdParams& p, int b, int h_k,
                         cudaStream_t st) {
    return run_dkdv<T, D, true>(maps, p, b, h_k, st);
  }
};

template <typename T, int D>
struct DqBand {
  static cudaError_t run(const BwdMaps& maps, const BwdParams& p, int b, cudaStream_t st) {
    return run_dq<T, D, true>(maps, p, b, st);
  }
};

template <typename T, int D>
struct DkdvScore {
  static cudaError_t run(const BwdMaps& maps, const BwdParams& p, int b, int h_k,
                         cudaStream_t st) {
    return run_dkdv<T, D, true, true>(maps, p, b, h_k, st);
  }
};

template <typename T, int D>
struct DqScore {
  static cudaError_t run(const BwdMaps& maps, const BwdParams& p, int b, cudaStream_t st) {
    return run_dq<T, D, true, true>(maps, p, b, st);
  }
};

// The launches at head dims 96 and 256 (csrc/flash_bwd_wide.cu), the
// band's at 64 and 128 (csrc/flash_bwd_band.cu) and at 96 and 256
// (csrc/flash_bwd_band_wide.cu), and the score map's at 64 and 128
// (csrc/flash_bwd_score.cu) and at 96 and 256 (csrc/flash_bwd_score_wide.cu).
cudaError_t run_pre_wide(bool bf16, int d, const PreParams& p, cudaStream_t st);
cudaError_t run_dkdv_wide(bool bf16, int d, const BwdMaps& maps, const BwdParams& p, int b,
                          int h_k, cudaStream_t st);
cudaError_t run_dq_wide(bool bf16, int d, const BwdMaps& maps, const BwdParams& p, int b,
                        cudaStream_t st);
cudaError_t run_dkdv_band(bool bf16, int d, const BwdMaps& maps, const BwdParams& p, int b,
                          int h_k, cudaStream_t st);
cudaError_t run_dq_band(bool bf16, int d, const BwdMaps& maps, const BwdParams& p, int b,
                        cudaStream_t st);
cudaError_t run_dkdv_band_wide(bool bf16, int d, const BwdMaps& maps, const BwdParams& p,
                               int b, int h_k, cudaStream_t st);
cudaError_t run_dq_band_wide(bool bf16, int d, const BwdMaps& maps, const BwdParams& p, int b,
                             cudaStream_t st);
cudaError_t run_dkdv_score(bool bf16, int d, const BwdMaps& maps, const BwdParams& p, int b,
                           int h_k, cudaStream_t st);
cudaError_t run_dq_score(bool bf16, int d, const BwdMaps& maps, const BwdParams& p, int b,
                         cudaStream_t st);
cudaError_t run_dkdv_score_wide(bool bf16, int d, const BwdMaps& maps, const BwdParams& p,
                                int b, int h_k, cudaStream_t st);
cudaError_t run_dq_score_wide(bool bf16, int d, const BwdMaps& maps, const BwdParams& p,
                              int b, cudaStream_t st);

// The launches at head dim 80: the preprocess and the band-free and band
// instantiations (`band`) in csrc/flash_bwd_80.cu, the score ones in
// csrc/flash_bwd_score_80.cu.
cudaError_t run_pre_80(bool bf16, int d, const PreParams& p, cudaStream_t st);
cudaError_t run_dkdv_80(bool bf16, int d, const BwdMaps& maps, const BwdParams& p, int b,
                        int h_k, bool band, cudaStream_t st);
cudaError_t run_dq_80(bool bf16, int d, const BwdMaps& maps, const BwdParams& p, int b,
                      bool band, cudaStream_t st);
cudaError_t run_dkdv_score_80(bool bf16, int d, const BwdMaps& maps, const BwdParams& p,
                              int b, int h_k, cudaStream_t st);
cudaError_t run_dq_score_80(bool bf16, int d, const BwdMaps& maps, const BwdParams& p, int b,
                            cudaStream_t st);

// The launches at q/k head dim 192 and v head dim 128 (csrc/flash_bwd_192.cu):
// the preprocess, dK/dV (the fused pass's with p.dq_accum) and dQ, without
// the band and the score map.
cudaError_t run_pre_192(bool bf16, const PreParams& p, cudaStream_t st);
cudaError_t run_dkdv_192(bool bf16, const BwdMaps& maps, const BwdParams& p, int b, int h_k,
                         cudaStream_t st);
cudaError_t run_dq_192(bool bf16, const BwdMaps& maps, const BwdParams& p, int b,
                       cudaStream_t st);

}  // namespace dense_bwd
}  // namespace fa
