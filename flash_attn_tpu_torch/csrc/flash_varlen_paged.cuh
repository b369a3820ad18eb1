// B8's kernel (csrc/flash_varlen_paged.cu) as templates over the element
// type, the head dim, BAND (a window) and SCORE (softcap), shared by
// flash_varlen_paged.cu, which holds the C entry point and the
// instantiations without SCORE, flash_varlen_paged_score.cu, which holds
// those with it, and flash_varlen_paged_80.cu, which holds every form at
// head dim 80, so that the three sources build side by side.
#pragma once

#include "fwd_sm90.cuh"

namespace fa {
namespace varlen_paged {

using namespace fa::sm90;

struct VarlenPagedParams {
  void* out;           // (total_q, h, d), zeroed by the wrapper
  float* lse;          // (h, total_q), -inf-filled by the wrapper
  const int* cu_q;     // (b + 1,) token offsets of the packed layout
  const int* lens_q;   // (b,) true query lengths (seqused_q, cut to cu deltas)
  const int* lens_k;   // (b,) key counts, the chunk included
  const int* table;    // (b, table_width) page ids
  const int* tile_ends;  // (b,) inclusive prefix sums of each sequence's tiles
  int64_t o_st, o_sh, t_sb;
  int b, num_tiles, total_q, h, group, page_size, box_rows, table_width, num_pages;
  float scale_log2;
  int causal;
  Band band;  // the window (left, right), read by the BAND instantiations alone
  Score score;  // the cap, read by the SCORE instantiations alone (no ALiBi)
  const float* qk_descale;  // (b, h_k) q_descale * k_descale, or nullptr (ones)
  const float* v_descale;   // (b, h_k), or nullptr (ones)
  const float* sink;        // (h,) fp32 learnable sink logits, or nullptr
};

// Q rows of one sequence from token q0 of the packed tensor at head hq; K/V
// rows of KV head hk through the sequence's pages.
struct PagedSrc {
  const CUtensorMap* q;
  const CUtensorMap* k;
  const CUtensorMap* v;
  PagedRows pages;
  int q0, hq, hk, box_rows;
  __device__ __forceinline__ void load_q(void* dst, uint64_t* bar, int col, int row) const {
    tma_load_3d(dst, q, bar, col, q0 + row, hq);
  }
};

// fwd_sm90.cuh's fwd_issue_kv for the paged source (the more specialised
// overload, found by argument-dependent lookup from fwd_tile): K/V tile n
// as boxes of box_rows keys, each box's page resolved once for K's and V's
// panels.
template <int D>
__device__ __forceinline__ void fwd_issue_kv(const PagedSrc& src, unsigned char* stage,
                                             uint64_t* bar, int n) {
  using L = FwdLayout<D>;
  mbar_expect_tx(bar, L::STAGE_BYTES);
  for (int j = 0; j < FWD_N / src.box_rows; ++j) {
    int pg, row;
    src.pages.locate(n * FWD_N + j * src.box_rows, pg, row);
    unsigned char* dst = stage + j * src.box_rows * 128;
#pragma unroll
    for (int c = 0; c < L::KT::PANELS; ++c) {
      tma_load_4d(dst + c * L::KT::PANEL_BYTES, src.k, bar, c * 64, row, src.hk, pg);
      tma_load_4d(dst + L::KT::BYTES + c * L::KT::PANEL_BYTES, src.v, bar, c * 64, row, src.hk,
                  pg);
    }
  }
}

// Item w = (head, i) = (w / num_tiles, w % num_tiles): head by head, and in
// a head the sequences' tiles in order, sequence s owning i in
// [tile_ends[s - 1], tile_ends[s]), its last tile (the longest causal band)
// first. Items past the last tile exit. BAND: the window's key tiles alone.
// SCORE: the scores capped by p.score. p.sink: the head's sink in the
// epilogue, with v_descale still scaling 1 / l'.
template <typename T, int D, bool BAND, bool SCORE>
__global__ void __launch_bounds__(FWD_THREADS, fwd_min_blocks<D>())
    varlen_paged_kernel(const __grid_constant__ FwdMaps maps, const VarlenPagedParams p) {
  extern __shared__ unsigned char smem_raw[];
  const int hh = blockIdx.x / p.num_tiles;
  const int i = blockIdx.x - hh * p.num_tiles;
  if (i >= p.tile_ends[p.b - 1]) return;
  int seq = 0;  // the first sequence whose tiles end past i
  for (int hi = p.b - 1; seq < hi;) {
    const int mid = (seq + hi) >> 1;
    if (p.tile_ends[mid] > i)
      hi = mid;
    else
      seq = mid + 1;
  }
  unsigned char* smem = align_1024(smem_raw);
  const int q0 = p.cu_q[seq];
  const PagedSrc src{&maps.q, &maps.k, &maps.v,
                     PagedRows{p.table + (int64_t)seq * p.t_sb, 0, p.page_size,
                               p.table_width, p.num_pages},
                     q0, hh, hh / p.group, p.box_rows};
  FwdRows<T> t;
  t.out = reinterpret_cast<T*>(p.out) + (int64_t)q0 * p.o_st + hh * p.o_sh;
  t.lse = p.lse + (int64_t)hh * p.total_q + q0;
  t.o_ss = p.o_st;
  t.sq = p.lens_q[seq];
  t.sk = p.lens_k[seq];
  t.m0 = (p.tile_ends[seq] - 1 - i) * FWD_M;
  // The descales of (sequence, KV head), runtime fields (JAX
  // flash_varlen_paged.py:225-241, :276-277): q_descale * k_descale scales
  // the scores, before the cap; v_descale scales O with 1 / l.
  const int64_t dix = (int64_t)seq * (p.h / p.group) + hh / p.group;
  float scale_log2 = p.scale_log2;
  Score score = p.score;
  if (p.qk_descale != nullptr) {
    scale_log2 *= p.qk_descale[dix];
    score.cap_in *= p.qk_descale[dix];
  }
  const float o_scale = p.v_descale == nullptr ? 1.f : p.v_descale[dix];
  t.sink = p.sink != nullptr ? p.sink + hh : nullptr;
  if constexpr (SCORE)
    fwd_tile<T, D, true, BAND, true>(src, t, scale_log2, p.causal, smem,
                                     score_band<BAND>(p.band, p.causal), score, o_scale);
  else
    fwd_tile<T, D, true, BAND>(src, t, scale_log2, p.causal, smem, p.band, Score{},
                               o_scale);
}

template <typename T, int D, bool BAND, bool SCORE>
cudaError_t launch(const FwdMaps& maps, const VarlenPagedParams& p, cudaStream_t stream) {
  constexpr int smem = FwdLayout<D>::SMEM;
  cudaError_t err = cudaFuncSetAttribute(varlen_paged_kernel<T, D, BAND, SCORE>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  varlen_paged_kernel<T, D, BAND, SCORE>
      <<<p.num_tiles * p.h, FWD_THREADS, smem, stream>>>(maps, p);
  return cudaGetLastError();
}

template <typename T, bool BAND, bool SCORE>
cudaError_t launch_d(const FwdMaps& maps, const VarlenPagedParams& p, int d, cudaStream_t st) {
  switch (d) {
    case 64: return launch<T, 64, BAND, SCORE>(maps, p, st);
    case 96: return launch<T, 96, BAND, SCORE>(maps, p, st);
    case 128: return launch<T, 128, BAND, SCORE>(maps, p, st);
    default: return launch<T, 256, BAND, SCORE>(maps, p, st);
  }
}

// The SCORE instantiations' launch (csrc/flash_varlen_paged_score.cu), with
// or without the window.
cudaError_t run_varlen_paged_score(bool bf16, const FwdMaps& maps, const VarlenPagedParams& p,
                                   int d, bool band, cudaStream_t st);

// The head dim 80 instantiations' launch (csrc/flash_varlen_paged_80.cu),
// with or without the window and the cap.
cudaError_t run_varlen_paged_80(bool bf16, const FwdMaps& maps, const VarlenPagedParams& p,
                                bool band, bool score, cudaStream_t st);

}  // namespace varlen_paged
}  // namespace fa
