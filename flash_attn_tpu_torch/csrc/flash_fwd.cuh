// The dense forward's kernel (B1, csrc/flash_fwd.cu) as templates over the
// element type, the head dim, BAND (the band masks) and SCORE (softcap and
// ALiBi), shared by flash_fwd.cu, which holds the C entry point and the
// instantiations without SCORE, flash_fwd_score.cu, which holds those
// with it, flash_fwd_80.cu, which holds every form at head dim 80, and
// flash_fwd_192.cu, which holds q/k head dim 192 beside v head dim 128, so
// that the four sources build side by side.
#pragma once

#include "fwd_sm90.cuh"

namespace fa {
namespace dense_fwd {

using namespace fa::sm90;

struct FwdParams {
  void* out;
  float* lse;  // (b, h, sq)
  int64_t o_sb, o_ss, o_sh;
  int sq, h, group;
  int sk;
  float scale_log2;
  int causal;
  Band band;  // read by the BAND instantiations alone
  // read by the SCORE instantiations alone: the cap and the bias's form
  // (score.slope is each block's own), the slopes (b, h) fp32 at
  // slopes[bb * slope_sb + h] (slope_sb 0: one slope a head), or none
  Score score;
  const float* slopes;
  int64_t slope_sb;
  const float* sink;  // (h,) fp32 learnable sink logits, or nullptr
};

// Q rows of query head hq and K/V rows of KV head hk of batch row bb.
struct DenseSrc {
  const CUtensorMap* q;
  const CUtensorMap* k;
  const CUtensorMap* v;
  int hq, hk, bb;
  __device__ __forceinline__ void load_q(void* dst, uint64_t* bar, int col, int row) const {
    tma_load_4d(dst, q, bar, col, row, hq, bb);
  }
  __device__ __forceinline__ void load_k(void* dst, uint64_t* bar, int col, int row) const {
    tma_load_4d(dst, k, bar, col, row, hk, bb);
  }
  __device__ __forceinline__ void load_v(void* dst, uint64_t* bar, int col, int row) const {
    tma_load_4d(dst, v, bar, col, row, hk, bb);
  }
};

// One block per (128-row query tile, head, batch row), the last q tile
// (the heaviest under causal masking) first. BAND: the band's key tiles
// alone, masked by p.band. SCORE: the scores mapped by p.score with the
// block's head's slope. p.sink: the head's sink in the epilogue. DV: v's
// and out's head dim, D's unless given (the band-free, score-free form
// alone beside another).
template <typename T, int D, bool BAND, bool SCORE, int DV = D>
__global__ void __launch_bounds__(FWD_THREADS, fwd_min_blocks<D>())
    fwd_kernel(const __grid_constant__ FwdMaps maps, const FwdParams p) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = align_1024(smem_raw);
  const int hh = blockIdx.x;
  const int bb = blockIdx.y;
  const DenseSrc src{&maps.q, &maps.k, &maps.v, hh, hh / p.group, bb};
  FwdRows<T> t;
  t.out = reinterpret_cast<T*>(p.out) + bb * p.o_sb + hh * p.o_sh;
  t.lse = p.lse + ((int64_t)bb * p.h + hh) * p.sq;
  t.o_ss = p.o_ss;
  t.sq = p.sq;
  t.sk = p.sk;
  t.m0 = (gridDim.z - 1 - blockIdx.z) * FWD_M;
  t.sink = p.sink != nullptr ? p.sink + hh : nullptr;
  if constexpr (SCORE) {
    static_assert(DV == D, "fwd_kernel: the score map at dv != d");
    Score sc = p.score;
    if (p.slopes != nullptr) sc.slope = p.slopes[bb * p.slope_sb + hh] * FA_LOG2E;
    fwd_tile<T, D, false, BAND, true>(src, t, p.scale_log2, p.causal, smem,
                                      score_band<BAND>(p.band, p.causal), sc);
  } else if constexpr (DV == D) {
    fwd_tile<T, D, false, BAND>(src, t, p.scale_log2, p.causal, smem, p.band);
  } else {
    static_assert(!BAND, "fwd_kernel: the band at dv != d");
    fwd_tile<T, D, false, false, false, DV>(src, t, p.scale_log2, p.causal, smem);
  }
}

template <typename T, int D, bool BAND, bool SCORE, int DV = D>
cudaError_t launch(const FwdMaps& maps, const FwdParams& p, int b, cudaStream_t stream) {
  constexpr int smem = FwdLayout<D, 1, DV>::SMEM;
  cudaError_t err = cudaFuncSetAttribute(
      fwd_kernel<T, D, BAND, SCORE, DV>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(p.h, b, (p.sq + FWD_M - 1) / FWD_M);
  fwd_kernel<T, D, BAND, SCORE, DV><<<grid, FWD_THREADS, smem, stream>>>(maps, p);
  return cudaGetLastError();
}

template <typename T, bool BAND, bool SCORE>
cudaError_t launch_d(const FwdMaps& maps, const FwdParams& p, int b, int d, cudaStream_t st) {
  switch (d) {
    case 64: return launch<T, 64, BAND, SCORE>(maps, p, b, st);
    case 96: return launch<T, 96, BAND, SCORE>(maps, p, b, st);
    case 128: return launch<T, 128, BAND, SCORE>(maps, p, b, st);
    default: return launch<T, 256, BAND, SCORE>(maps, p, b, st);
  }
}

// The SCORE instantiations' launch (csrc/flash_fwd_score.cu), with or
// without the band.
cudaError_t run_fwd_score(bool bf16, const FwdMaps& maps, const FwdParams& p, int b, int d,
                          bool band, cudaStream_t st);

// The head dim 80 instantiations' launch (csrc/flash_fwd_80.cu): every form
// the other head dims take, with or without the band and the score map.
cudaError_t run_fwd_80(bool bf16, const FwdMaps& maps, const FwdParams& p, int b, bool band,
                       bool score, cudaStream_t st);

// The instantiation at q/k head dim 192 and v head dim 128
// (csrc/flash_fwd_192.cu): without the band and the score map.
cudaError_t run_fwd_192(bool bf16, const FwdMaps& maps, const FwdParams& p, int b,
                        cudaStream_t st);

}  // namespace dense_fwd
}  // namespace fa
