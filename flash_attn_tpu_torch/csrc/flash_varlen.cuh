// The packed varlen attention backward's kernels and launches (B6; see
// csrc/flash_varlen.cu for what they replace and how they are designed),
// shared by the sources that compile them: csrc/flash_varlen.cu (the C
// entry points, head dims 64 and 128), csrc/flash_varlen_wide.cu (head dims
// 96 and 256), for the band instantiations (BAND: window and chunk)
// csrc/flash_varlen_band.cu (64 and 128) and csrc/flash_varlen_band_wide.cu
// (96 and 256), and for the score instantiations (SCORE: softcap and
// ALiBi) csrc/flash_varlen_score.cu (64 and 128) and
// csrc/flash_varlen_score_wide.cu (96 and 256), and at head dim 80
// csrc/flash_varlen_80.cu (the preprocess, the band-free and the band
// instantiations) and csrc/flash_varlen_score_80.cu (the score ones), so
// that the heavy instantiations build side by side.
#pragma once

#include "bwd_sm90.cuh"

namespace fa {
namespace varlen_bwd {

using namespace fa::sm90;

constexpr int PRE_WARPS = 8;        // preprocess: rows (warps) a block
constexpr int PRE_ROWS = 128;       // preprocess: rows of a q tile
constexpr int ZERO_ROWS = 128;      // zero-fill: packed rows a block
constexpr int SEQ_GAP = 132;        // padded rows a sequence adds (see padded_row)

// The first row of sequence `seq` in the padded (h, rows_pad) lse2 / delta
// buffers: cu rounded up to 4 rows, plus SEQ_GAP a sequence before it. The
// next sequence starts at least its length + 129 rows later, so whole
// 128-row tiles of each fit; the buffers hold total_q + SEQ_GAP * b rows.
__device__ __forceinline__ int64_t padded_row(int cu, int seq) {
  return (int64_t)((cu + 3) & ~3) + (int64_t)SEQ_GAP * seq;
}

struct VarlenParams {
  const float* lse2;   // (h, rows_pad)
  const float* delta;  // (h, rows_pad)
  void* dq;            // (total_q, h, d) by strides
  void* dk;            // (total_k, h_k, d)
  void* dv;
  const int* cu_q;     // (b + 1,) token offsets of the packed layouts
  const int* cu_k;
  const int* lens_q;   // (b,) query rows of each sequence (seqused_q)
  const int* lens_k;   // (b,) keys of each sequence (seqused_k)
  const int* tiles;    // (num_tiles, 2): sequence (-1: no tile), first row
  int64_t dq_st, dq_sh, dk_st, dk_sh, dv_st, dv_sh, rows_pad;
  int num_tiles, h, h_k;
  BwdArgs a;
  Band band;  // read by the BAND instantiations alone
  // read by the SCORE instantiations alone: the cap and the bias's form,
  // and the slopes (b, h) fp32 at slopes[seq * slope_sb + h] (slope_sb 0:
  // one slope a head), or none
  Score score;
  const float* slopes;
  int64_t slope_sb;
};

// Sequence seq's slopes (h,) of a SCORE instantiation, or none.
__device__ __forceinline__ const float* seq_slopes(const VarlenParams& p, int seq) {
  return p.slopes != nullptr ? p.slopes + seq * p.slope_sb : nullptr;
}

// Sequence `seq` of the packed operands: 3D maps, the padded lse2 / delta
// rows, the gradients by element strides.
template <typename T>
struct PackedSrc {
  static constexpr bool ZERO_TAIL = true;  // a box past the sequence holds its neighbour's rows
  const BwdMaps* maps;
  const VarlenParams* p;
  int q0, k0, sq, sk;
  int64_t pad;  // the sequence's first padded lse2 / delta row
  __device__ __forceinline__ PackedSrc(const BwdMaps& m, const VarlenParams& prm, int seq)
      : maps(&m),
        p(&prm),
        q0(prm.cu_q[seq]),
        k0(prm.cu_k[seq]),
        sq(prm.lens_q[seq]),
        sk(prm.lens_k[seq]),
        pad(padded_row(prm.cu_q[seq], seq)) {}
  __device__ __forceinline__ void load_q(void* dst, uint64_t* bar, int col, int row,
                                         int hq) const {
    tma_load_3d(dst, &maps->q, bar, col, q0 + row, hq);
  }
  __device__ __forceinline__ void load_do(void* dst, uint64_t* bar, int col, int row,
                                          int hq) const {
    tma_load_3d(dst, &maps->dout, bar, col, q0 + row, hq);
  }
  __device__ __forceinline__ void load_k(void* dst, uint64_t* bar, int col, int row,
                                         int hk) const {
    tma_load_3d(dst, &maps->k, bar, col, k0 + row, hk);
  }
  __device__ __forceinline__ void load_v(void* dst, uint64_t* bar, int col, int row,
                                         int hk) const {
    tma_load_3d(dst, &maps->v, bar, col, k0 + row, hk);
  }
  __device__ __forceinline__ const float* lse2(int hq, int row) const {
    return p->lse2 + hq * p->rows_pad + pad + row;
  }
  __device__ __forceinline__ const float* delta(int hq, int row) const {
    return p->delta + hq * p->rows_pad + pad + row;
  }
  __device__ __forceinline__ T* dk(int row, int hk) const {
    return reinterpret_cast<T*>(p->dk) + (int64_t)(k0 + row) * p->dk_st + hk * p->dk_sh;
  }
  __device__ __forceinline__ T* dv(int row, int hk) const {
    return reinterpret_cast<T*>(p->dv) + (int64_t)(k0 + row) * p->dv_st + hk * p->dv_sh;
  }
  __device__ __forceinline__ T* dq(int row, int hq) const {
    return reinterpret_cast<T*>(p->dq) + (int64_t)(q0 + row) * p->dq_st + hq * p->dq_sh;
  }
};

// ---- preprocess -------------------------------------------------------------

struct PreParams {
  const void* dout;    // (total_q, h, d) by strides
  const void* out;
  const float* lse;    // (h, total_q) natural-log
  float* lse2;         // (h, rows_pad)
  float* delta;
  void* dq;            // (total_q, h, d), (total_k, h_k, d): contiguous rows
  void* dk;
  void* dv;
  const int* cu_q;
  const int* cu_k;
  const int* lens_q;
  const int* lens_k;
  const int* tiles;    // the 128-row q tiles
  int64_t do_st, do_sh, o_st, o_sh, rows_pad;
  int num_tiles, b, total_q, total_k, h, h_k;
};

// Whether packed row t of one side (offsets cu (b + 1), lengths lens (b))
// lies in no sequence: before cu[0], past cu[b], or past its sequence's
// length (seqused) inside its slot.
__device__ __forceinline__ bool dead_row(const int* cu, const int* lens, int b, int t) {
  if (t < cu[0] || t >= cu[b]) return true;
  int lo = 0, hi = b;  // the last sequence s < b with cu[s] <= t
  while (hi - lo > 1) {
    const int mid = (lo + hi) >> 1;
    if (cu[mid] <= t) lo = mid;
    else hi = mid;
  }
  return t - cu[lo] >= lens[lo];
}

// Zeroes `elems` 2-byte elements (a multiple of 8) from `row` with the lanes
// of a warp.
__device__ __forceinline__ void zero_row(void* row, int elems, int lane) {
  uint4* r = reinterpret_cast<uint4*>(row);
  for (int c = lane; c < elems / 8; c += 32) r[c] = make_uint4(0, 0, 0, 0);
}

// Blocks [0, num_tiles * h): q tile blockIdx.x / h of head blockIdx.x % h,
// a warp a row (PRE_ROWS / PRE_WARPS rows each); the rest: ZERO_ROWS packed
// rows each of dq, dk and dv. (A block of PRE_WARPS rows, a warp a row,
// took 1.3-1.5x as long at BERT-large's packing and bench.py's mixed
// lengths: PERF.md §6, the varlen preprocess row.)
template <typename T, int D>
__global__ void __launch_bounds__(PRE_WARPS * 32)
    varlen_preprocess_kernel(const PreParams p) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int work = p.num_tiles * p.h;
  if ((int)blockIdx.x >= work) {
    const int r0 = (blockIdx.x - work) * ZERO_ROWS;
    for (int t = r0 + warp; t < r0 + ZERO_ROWS; t += PRE_WARPS) {
      if (t < p.total_q && dead_row(p.cu_q, p.lens_q, p.b, t))
        zero_row(reinterpret_cast<T*>(p.dq) + (int64_t)t * p.h * D, p.h * D, lane);
      if (t < p.total_k && dead_row(p.cu_k, p.lens_k, p.b, t)) {
        zero_row(reinterpret_cast<T*>(p.dk) + (int64_t)t * p.h_k * D, p.h_k * D, lane);
        zero_row(reinterpret_cast<T*>(p.dv) + (int64_t)t * p.h_k * D, p.h_k * D, lane);
      }
    }
    return;
  }
  const int tile = blockIdx.x / p.h;
  const int hh = blockIdx.x - tile * p.h;
  const int seq = p.tiles[2 * tile];
  if (seq < 0) return;
  const int m0 = p.tiles[2 * tile + 1];
  const int q0 = p.cu_q[seq];
  const int sq = p.lens_q[seq];
  const int64_t base = hh * p.rows_pad + padded_row(q0, seq) + m0;
  for (int r = warp; r < PRE_ROWS; r += PRE_WARPS) {
    const int row = m0 + r;
    if (row >= sq) {
      if (lane == 0) {
        p.delta[base + r] = 0.f;
        p.lse2[base + r] = INFINITY;
      }
      continue;
    }
    const int64_t tok = q0 + row;
    const int e = bwd_lane_elem<D>(lane);
    const float acc = bwd_preprocess_row<T, D>(
        reinterpret_cast<const T*>(p.dout) + tok * p.do_st + hh * p.do_sh + e,
        reinterpret_cast<const T*>(p.out) + tok * p.o_st + hh * p.o_sh + e);
    if (lane == 0) {
      p.delta[base + r] = acc;
      p.lse2[base + r] = bwd_lse2(p.lse[hh * (int64_t)p.total_q + tok]);
    }
  }
}

// ---- dK / dV and dQ ---------------------------------------------------------

// Blocks a work-list tile takes: its 128 rows are one block of the tiles'
// rows, or two of 64 at d = 256 (BwdPlan), each its own block.
template <int D>
__host__ __device__ constexpr int subtiles() { return BWD_KV_ROWS / BwdPlan<D>::ROWS; }

// Item x = (tile, KV head, sub-tile) of the key-side schedule, the
// heaviest tiles first; dead tiles (sorted last) and sub-tiles past the
// sequence's keys exit. BAND: the q tiles of the sequence's band alone.
// SCORE (with BAND; p.band holds the causal bound): the scores mapped by
// p.score with the sequence's slopes.
template <typename T, int D, bool BAND, bool SCORE = false>
__global__ void __launch_bounds__(BWD_THREADS, 1)
    varlen_dkdv_kernel(const __grid_constant__ BwdMaps maps, const VarlenParams p) {
  extern __shared__ unsigned char smem_raw[];
  const int x = blockIdx.x / subtiles<D>();
  const int sub = blockIdx.x - x * subtiles<D>();
  const int tile = x / p.h_k;
  const int seq = p.tiles[2 * tile];
  if (seq < 0) return;
  const PackedSrc<T> src(maps, p, seq);
  const int n0 = p.tiles[2 * tile + 1] + sub * BwdPlan<D>::ROWS;
  if (sub > 0 && n0 >= src.sk) return;
  if constexpr (SCORE)
    bwd_dkdv_band<T, D, false, true>(src, p.a, x - tile * p.h_k, n0, align_1024(smem_raw),
                                     p.band, p.score, seq_slopes(p, seq));
  else if constexpr (BAND)
    bwd_dkdv_band<T, D, false>(src, p.a, x - tile * p.h_k, n0, align_1024(smem_raw), p.band);
  else
    bwd_dkdv<T, D, false>(src, p.a, x - tile * p.h_k, n0, align_1024(smem_raw));
}

// Item x = (tile, head, sub-tile) of the query-side schedule. BAND: the key
// tiles of the sequence's band alone. SCORE: as varlen_dkdv_kernel.
template <typename T, int D, bool BAND, bool SCORE = false>
__global__ void __launch_bounds__(BWD_THREADS, 1)
    varlen_dq_kernel(const __grid_constant__ BwdMaps maps, const VarlenParams p) {
  extern __shared__ unsigned char smem_raw[];
  const int x = blockIdx.x / subtiles<D>();
  const int sub = blockIdx.x - x * subtiles<D>();
  const int tile = x / p.h;
  const int seq = p.tiles[2 * tile];
  if (seq < 0) return;
  const PackedSrc<T> src(maps, p, seq);
  const int m0 = p.tiles[2 * tile + 1] + sub * BwdPlan<D>::ROWS;
  if (sub > 0 && m0 >= src.sq) return;
  if constexpr (SCORE)
    bwd_dq_band<T, D, true>(src, p.a, x - tile * p.h, m0, align_1024(smem_raw), p.band,
                            p.score, seq_slopes(p, seq));
  else if constexpr (BAND)
    bwd_dq_band<T, D>(src, p.a, x - tile * p.h, m0, align_1024(smem_raw), p.band);
  else
    bwd_dq<T, D>(src, p.a, x - tile * p.h, m0, align_1024(smem_raw));
}

// ---- launches ---------------------------------------------------------------

template <typename Kernel>
cudaError_t launch(Kernel kernel, int64_t blocks, int threads, int smem, cudaStream_t stream,
                   const BwdMaps& maps, const VarlenParams& p) {
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         smem);
  if (err != cudaSuccess) return err;
  kernel<<<(unsigned)blocks, threads, smem, stream>>>(maps, p);
  return cudaGetLastError();
}

template <typename T, int D, bool BAND, bool SCORE = false>
cudaError_t run_dkdv(const BwdMaps& maps, const VarlenParams& p, cudaStream_t st) {
  return launch(varlen_dkdv_kernel<T, D, BAND, SCORE>,
                (int64_t)p.num_tiles * p.h_k * subtiles<D>(), BWD_THREADS,
                DkdvLayout<D, false>::SMEM, st, maps, p);
}

template <typename T, int D, bool BAND, bool SCORE = false>
cudaError_t run_dq(const BwdMaps& maps, const VarlenParams& p, cudaStream_t st) {
  return launch(varlen_dq_kernel<T, D, BAND, SCORE>, (int64_t)p.num_tiles * p.h * subtiles<D>(),
                BWD_THREADS, DqLayout<D>::SMEM, st, maps, p);
}

template <typename T, int D>
struct Dkdv {
  static cudaError_t run(const BwdMaps& maps, const VarlenParams& p, cudaStream_t st) {
    return run_dkdv<T, D, false>(maps, p, st);
  }
};

template <typename T, int D>
struct Dq {
  static cudaError_t run(const BwdMaps& maps, const VarlenParams& p, cudaStream_t st) {
    return run_dq<T, D, false>(maps, p, st);
  }
};

template <typename T, int D>
struct DkdvBand {
  static cudaError_t run(const BwdMaps& maps, const VarlenParams& p, cudaStream_t st) {
    return run_dkdv<T, D, true>(maps, p, st);
  }
};

template <typename T, int D>
struct DqBand {
  static cudaError_t run(const BwdMaps& maps, const VarlenParams& p, cudaStream_t st) {
    return run_dq<T, D, true>(maps, p, st);
  }
};

template <typename T, int D>
struct DkdvScore {
  static cudaError_t run(const BwdMaps& maps, const VarlenParams& p, cudaStream_t st) {
    return run_dkdv<T, D, true, true>(maps, p, st);
  }
};

template <typename T, int D>
struct DqScore {
  static cudaError_t run(const BwdMaps& maps, const VarlenParams& p, cudaStream_t st) {
    return run_dq<T, D, true, true>(maps, p, st);
  }
};

template <typename T, int D>
struct Pre {
  static cudaError_t run(const PreParams& p, cudaStream_t st) {
    const int64_t zero_blocks =
        ((p.total_q > p.total_k ? p.total_q : p.total_k) + ZERO_ROWS - 1) / ZERO_ROWS;
    varlen_preprocess_kernel<T, D>
        <<<(unsigned)((int64_t)p.num_tiles * p.h + zero_blocks), PRE_WARPS * 32, 0, st>>>(p);
    return cudaGetLastError();
  }
};

// The launches at head dims 96 and 256 (csrc/flash_varlen_wide.cu), the
// band's at 64 and 128 (csrc/flash_varlen_band.cu) and at 96 and 256
// (csrc/flash_varlen_band_wide.cu), and the score map's at 64 and 128
// (csrc/flash_varlen_score.cu) and at 96 and 256
// (csrc/flash_varlen_score_wide.cu).
cudaError_t run_pre_wide(bool bf16, int d, const PreParams& p, cudaStream_t st);
cudaError_t run_dkdv_wide(bool bf16, int d, const BwdMaps& maps, const VarlenParams& p,
                          cudaStream_t st);
cudaError_t run_dq_wide(bool bf16, int d, const BwdMaps& maps, const VarlenParams& p,
                        cudaStream_t st);
cudaError_t run_dkdv_band(bool bf16, int d, const BwdMaps& maps, const VarlenParams& p,
                          cudaStream_t st);
cudaError_t run_dq_band(bool bf16, int d, const BwdMaps& maps, const VarlenParams& p,
                        cudaStream_t st);
cudaError_t run_dkdv_band_wide(bool bf16, int d, const BwdMaps& maps, const VarlenParams& p,
                               cudaStream_t st);
cudaError_t run_dq_band_wide(bool bf16, int d, const BwdMaps& maps, const VarlenParams& p,
                             cudaStream_t st);
cudaError_t run_dkdv_score(bool bf16, int d, const BwdMaps& maps, const VarlenParams& p,
                           cudaStream_t st);
cudaError_t run_dq_score(bool bf16, int d, const BwdMaps& maps, const VarlenParams& p,
                         cudaStream_t st);
cudaError_t run_dkdv_score_wide(bool bf16, int d, const BwdMaps& maps, const VarlenParams& p,
                                cudaStream_t st);
cudaError_t run_dq_score_wide(bool bf16, int d, const BwdMaps& maps, const VarlenParams& p,
                              cudaStream_t st);

// The launches at head dim 80: the preprocess and the band-free and band
// instantiations (`band`) in csrc/flash_varlen_80.cu, the score ones in
// csrc/flash_varlen_score_80.cu.
cudaError_t run_pre_80(bool bf16, int d, const PreParams& p, cudaStream_t st);
cudaError_t run_dkdv_80(bool bf16, int d, const BwdMaps& maps, const VarlenParams& p,
                        bool band, cudaStream_t st);
cudaError_t run_dq_80(bool bf16, int d, const BwdMaps& maps, const VarlenParams& p, bool band,
                      cudaStream_t st);
cudaError_t run_dkdv_score_80(bool bf16, int d, const BwdMaps& maps, const VarlenParams& p,
                              cudaStream_t st);
cudaError_t run_dq_score_80(bool bf16, int d, const BwdMaps& maps, const VarlenParams& p,
                            cudaStream_t st);

}  // namespace varlen_bwd
}  // namespace fa
