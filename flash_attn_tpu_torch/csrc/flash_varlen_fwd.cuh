// The packed varlen forwards' kernels and launches (B6's one block per
// item, B7's persistent walk; see csrc/flash_varlen_fwd.cu for what they
// replace and how they are designed), shared by the sources that compile
// them: csrc/flash_varlen_fwd.cu (the C entry points and the band-free
// kernels), csrc/flash_varlen_fwd_band.cu (the band instantiations: BAND, a
// window and attention_chunk per sequence on fwd_sm90.cuh's band tile) and
// csrc/flash_varlen_fwd_score.cu (the score instantiations: SCORE, softcap
// and ALiBi with each sequence's slopes, BAND ones that take the causal
// bound as a band), and csrc/flash_varlen_fwd_80.cu (every form at head dim
// 80), so that they build side by side.
#pragma once

#include "fwd_sm90.cuh"

namespace fa {
namespace varlen_fwd {

using namespace fa::sm90;

struct VarlenFwdParams {
  void* out;           // (total_q, h, d), zeroed by the wrapper
  float* lse;          // (h, total_q), -inf-filled by the wrapper
  const int* cu_q;     // (b + 1,) token offsets of the packed layouts
  const int* cu_k;
  const int* lens_q;   // (b,) query rows of each sequence (seqused_q)
  const int* lens_k;   // (b,) keys of each sequence (seqused_k)
  const int* tiles;    // (num_tiles, 2): sequence (-1: no tile), first row
  int64_t o_st, o_sh;
  int num_tiles, total_q, h, group;
  float scale_log2;
  int causal;
  Band band;  // read by the BAND instantiations alone
  const float* sink;  // (h,) fp32 learnable sink logits, or nullptr
};

// A SCORE instantiation's parameters: the cap and the bias's form, and the
// slopes (b, h) fp32 at slopes[seq * slope_sb + h] (slope_sb 0: one slope a
// head), or none. The other kernels take VarlenFwdParams alone, whose
// parameter block stays what it was (a larger one changed their machine
// code).
struct VarlenFwdScoreParams : VarlenFwdParams {
  Score score;
  const float* slopes;
  int64_t slope_sb;
};

template <bool SCORE>
using FwdParamsOf = std::conditional_t<SCORE, VarlenFwdScoreParams, VarlenFwdParams>;

// The Score of sequence seq's query head hh: p.score with its slope.
__device__ __forceinline__ Score item_score(const VarlenFwdScoreParams& p, int seq, int hh) {
  Score sc = p.score;
  if (p.slopes != nullptr) sc.slope = p.slopes[seq * p.slope_sb + hh] * FA_LOG2E;
  return sc;
}

// Rows of one sequence of the packed tensors: Q from token q0 at head hq,
// K/V from token k0 at KV head hk.
struct PackedSrc {
  const CUtensorMap* q;
  const CUtensorMap* k;
  const CUtensorMap* v;
  int q0, k0, hq, hk;
  __device__ __forceinline__ void load_q(void* dst, uint64_t* bar, int col, int row) const {
    tma_load_3d(dst, q, bar, col, q0 + row, hq);
  }
  __device__ __forceinline__ void load_k(void* dst, uint64_t* bar, int col, int row) const {
    tma_load_3d(dst, k, bar, col, k0 + row, hk);
  }
  __device__ __forceinline__ void load_v(void* dst, uint64_t* bar, int col, int row) const {
    tma_load_3d(dst, v, bar, col, k0 + row, hk);
  }
};

// Item w = (head, tile) = (w / num_tiles, w % num_tiles) of the sorted
// work list: head by head, each head's longest bands first; dead tiles
// (sorted last) exit. BAND: the key tiles of the sequence's band alone.
// SCORE (with BAND; p.band holds the causal bound): the scores mapped by
// the sequence's Score. p.sink: the head's sink in the epilogue (the rows
// of no tile keep the wrapper's fill, the sink).
template <typename T, int D, bool BAND, bool SCORE = false>
__global__ void __launch_bounds__(FWD_THREADS, fwd_min_blocks<D>())
    varlen_fwd_kernel(const __grid_constant__ FwdMaps maps, const FwdParamsOf<SCORE> p) {
  static_assert(BAND || !SCORE, "varlen_fwd_kernel: SCORE masks by the band");
  extern __shared__ unsigned char smem_raw[];
  const int hh = blockIdx.x / p.num_tiles;
  const int tile = blockIdx.x - hh * p.num_tiles;
  const int seq = p.tiles[2 * tile];
  if (seq < 0) return;
  unsigned char* smem = align_1024(smem_raw);
  const int q0 = p.cu_q[seq];
  const PackedSrc src{&maps.q, &maps.k, &maps.v, q0, p.cu_k[seq], hh, hh / p.group};
  FwdRows<T> t;
  t.out = reinterpret_cast<T*>(p.out) + (int64_t)q0 * p.o_st + hh * p.o_sh;
  t.lse = p.lse + (int64_t)hh * p.total_q + q0;
  t.o_ss = p.o_st;
  t.sq = p.lens_q[seq];
  t.sk = p.lens_k[seq];
  t.m0 = p.tiles[2 * tile + 1];
  t.sink = p.sink != nullptr ? p.sink + hh : nullptr;
  if constexpr (SCORE)
    fwd_tile<T, D, true, true, true>(src, t, p.scale_log2, p.causal, smem, p.band,
                                     item_score(p, seq, hh));
  else
    fwd_tile<T, D, true, BAND>(src, t, p.scale_log2, p.causal, smem, p.band);
}

// B7's view of item w = (head, tile) = (w / num_tiles, w % num_tiles); w < 0:
// none. Every thread of a block computes the same items. `lo` is the first
// key tile of the band (BAND alone; 0 otherwise), `total` its tiles.
struct Item {
  int w, hh, m0, q0, k0, sq, sk, lo, total;
};

// The first item at or after w, stepping by the grid, whose tile is live and
// sees at least one key (BAND: of its band).
template <bool BAND>
__device__ __forceinline__ Item next_item(const VarlenFwdParams& p, int w) {
  Item it;
  const int items = p.num_tiles * p.h;
  for (; w < items; w += gridDim.x) {
    const int hh = w / p.num_tiles;
    const int tile = w - hh * p.num_tiles;
    const int seq = p.tiles[2 * tile];
    if (seq < 0) continue;  // the dead tiles that end each head's list
    it.m0 = p.tiles[2 * tile + 1];
    it.sq = p.lens_q[seq];
    it.sk = p.lens_k[seq];
    if constexpr (BAND) {
      const KeyRange<FWD_N> keys(it.m0, FWD_M, it.sq, it.sk, p.band);
      it.lo = keys.lo;
      it.total = keys.count();
    } else {
      it.total = KeyRange<FWD_N>(it.m0, FWD_M, it.sq, it.sk, p.causal).count();
    }
    if (it.total == 0) continue;
    it.w = w;
    it.hh = hh;
    it.q0 = p.cu_q[seq];
    it.k0 = p.cu_k[seq];
    return it;
  }
  it.w = -1;
  return it;
}

// Q tiles a B7 block keeps: with two, the next item's Q loads under this
// item's last K/V tile; at head dim 128 a second 32 KB Q tile would leave
// one block an SM (tools/fwd_ab.py timed it 10-12% slower there, PERF.md),
// and at 256 it would not fit beside the two 64 KB K/V stages.
__host__ __device__ constexpr int persistent_q_buffers(int d) { return d == 64 ? 2 : 1; }

// B7: a persistent block walks its items with a stride of the grid. BAND:
// each item over the key tiles of its band, from the band's first. SCORE
// and p.sink: as varlen_fwd_kernel (an item whose rows see no key is
// skipped: its rows keep the wrapper's fill).
template <typename T, int D, bool BAND, bool SCORE = false>
__global__ void __launch_bounds__(FWD_THREADS, fwd_min_blocks<D>())
    varlen_fwd_persistent_kernel(const __grid_constant__ FwdMaps maps,
                                 const FwdParamsOf<SCORE> p) {
  static_assert(BAND || !SCORE, "varlen_fwd_persistent_kernel: SCORE masks by the band");
  constexpr int QBUF = persistent_q_buffers(D);
  using L = FwdLayout<D, QBUF>;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = align_1024(smem_raw);
  uint64_t* q_bar = reinterpret_cast<uint64_t*>(smem + L::BAR_OFF);
  uint64_t* full = q_bar + QBUF;
  const int tid = threadIdx.x;
  auto q_tile = [&](int i) { return smem + L::Q_OFF + (i % QBUF) * L::QT::BYTES; };
  auto stage = [&](int g) {
    return smem + L::STAGE_OFF + (g % FWD_STAGES) * L::STAGE_BYTES;
  };
  auto source = [&](const Item& it) {
    return PackedSrc{&maps.q, &maps.k, &maps.v, it.q0, it.k0, it.hh, it.hh / p.group};
  };

  if (tid == 0) {
    for (int i = 0; i < QBUF; ++i) mbar_init(&q_bar[i], 1);
    for (int s = 0; s < FWD_STAGES; ++s) mbar_init(&full[s], 1);
    fence_barrier_init();
  }
  __syncthreads();
  // an item's first key tile
  auto first = [&](const Item& it) { return BAND ? it.lo : 0; };
  Item cur = next_item<BAND>(p, blockIdx.x);
  if (tid == 0 && cur.w >= 0) {
    fwd_issue_q<D>(source(cur), q_tile(0), &q_bar[0], cur.m0);
    fwd_issue_kv<D>(source(cur), stage(0), &full[0], first(cur));
  }
  // g counts the K/V tiles this block has taken, i its items: the ring's
  // stages and the barriers' phases follow them across items
  int g = 0;
  for (int i = 0; cur.w >= 0; ++i) {
    const Item nxt = next_item<BAND>(p, cur.w + gridDim.x);
    const PackedSrc src = source(cur);
    FwdRows<T> t;
    t.out = reinterpret_cast<T*>(p.out) + (int64_t)cur.q0 * p.o_st + cur.hh * p.o_sh;
    t.lse = p.lse + (int64_t)cur.hh * p.total_q + cur.q0;
    t.o_ss = p.o_st;
    t.sq = cur.sq;
    t.sk = cur.sk;
    t.m0 = cur.m0;
    t.sink = p.sink != nullptr ? p.sink + cur.hh : nullptr;
    unsigned char* Qs = q_tile(i);
    Score sc;  // SCORE: the item's sequence's, read from its tile's entry
    if constexpr (SCORE) sc = item_score(p, p.tiles[2 * (cur.w - cur.hh * p.num_tiles)], cur.hh);
    FwdAcc<D> a;
    a.init();
    mbar_wait(&q_bar[i % QBUF], (i / QBUF) & 1);
    for (int n = 0; n < cur.total; ++n, ++g) {
      // the stage of tile g + 1 was freed at g - 1, in this item or the last
      if (tid == 0) {
        const int nf = (g + 1) % FWD_STAGES;
        if (n + 1 < cur.total) {
          fwd_issue_kv<D>(src, stage(g + 1), &full[nf], first(cur) + n + 1);
        } else if (nxt.w >= 0) {
          fwd_issue_kv<D>(source(nxt), stage(g + 1), &full[nf], first(nxt));
          if constexpr (QBUF == 2)  // its Q tile was freed by item i - 1
            fwd_issue_q<D>(source(nxt), q_tile(i + 1), &q_bar[(i + 1) % QBUF], nxt.m0);
        }
      }
      mbar_wait(&full[g % FWD_STAGES], (g / FWD_STAGES) & 1);
      if constexpr (SCORE)
        fwd_step<T, D, true, true, true>(a, Qs, stage(g), (first(cur) + n) * FWD_N, t,
                                         p.scale_log2, p.causal, -1, p.band, sc);
      else
        fwd_step<T, D, true, BAND>(a, Qs, stage(g), (first(cur) + n) * FWD_N, t, p.scale_log2,
                                   p.causal, -1, p.band);
    }
    fwd_epilogue<T, D>(a, Qs, t);
    fence_proxy_async();  // the epilogue's stores to Qs before a TMA load there
    __syncthreads();      // every thread is done with this item and its Q tile
    if constexpr (QBUF == 1) {
      if (tid == 0 && nxt.w >= 0) fwd_issue_q<D>(source(nxt), Qs, &q_bar[0], nxt.m0);
    }
    cur = nxt;
  }
}

template <typename T, int D, bool BAND, bool SCORE = false>
cudaError_t run_fwd(const FwdMaps& maps, const FwdParamsOf<SCORE>& p, cudaStream_t stream) {
  constexpr int smem = FwdLayout<D>::SMEM;
  auto kernel = varlen_fwd_kernel<T, D, BAND, SCORE>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  kernel<<<p.num_tiles * p.h, FWD_THREADS, smem, stream>>>(maps, p);
  return cudaGetLastError();
}

template <typename T, int D, bool BAND, bool SCORE = false>
cudaError_t run_persistent(const FwdMaps& maps, const FwdParamsOf<SCORE>& p, int num_sms,
                           int* grid_out, cudaStream_t stream) {
  constexpr int smem = FwdLayout<D, persistent_q_buffers(D)>::SMEM;
  auto kernel = varlen_fwd_persistent_kernel<T, D, BAND, SCORE>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  int per_sm = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, FWD_THREADS, smem);
  if (err != cudaSuccess) return err;
  const int64_t items = (int64_t)p.num_tiles * p.h;
  const int64_t resident = (int64_t)num_sms * (per_sm > 0 ? per_sm : 1);
  const int grid = (int)(items < resident ? items : resident);
  if (grid_out) *grid_out = grid;
  kernel<<<grid, FWD_THREADS, smem, stream>>>(maps, p);
  return cudaGetLastError();
}

// The launches of each head dim (dispatch_dims), band-free and BAND.
template <typename T, int D>
struct Launch {
  static cudaError_t run(const FwdMaps& maps, const VarlenFwdParams& p, cudaStream_t stream) {
    return run_fwd<T, D, false>(maps, p, stream);
  }
};

template <typename T, int D>
struct LaunchPersistent {
  static cudaError_t run(const FwdMaps& maps, const VarlenFwdParams& p, int num_sms,
                         int* grid_out, cudaStream_t stream) {
    return run_persistent<T, D, false>(maps, p, num_sms, grid_out, stream);
  }
};

template <typename T, int D>
struct LaunchBand {
  static cudaError_t run(const FwdMaps& maps, const VarlenFwdParams& p, cudaStream_t stream) {
    return run_fwd<T, D, true>(maps, p, stream);
  }
};

template <typename T, int D>
struct LaunchPersistentBand {
  static cudaError_t run(const FwdMaps& maps, const VarlenFwdParams& p, int num_sms,
                         int* grid_out, cudaStream_t stream) {
    return run_persistent<T, D, true>(maps, p, num_sms, grid_out, stream);
  }
};

template <typename T, int D>
struct LaunchScore {
  static cudaError_t run(const FwdMaps& maps, const VarlenFwdScoreParams& p,
                         cudaStream_t stream) {
    return run_fwd<T, D, true, true>(maps, p, stream);
  }
};

template <typename T, int D>
struct LaunchPersistentScore {
  static cudaError_t run(const FwdMaps& maps, const VarlenFwdScoreParams& p, int num_sms,
                         int* grid_out, cudaStream_t stream) {
    return run_persistent<T, D, true, true>(maps, p, num_sms, grid_out, stream);
  }
};

using VarlenDims = Dims<64, 96, 128, 256>;

// The band instantiations' launches (csrc/flash_varlen_fwd_band.cu).
cudaError_t run_fwd_band(bool bf16, int d, const FwdMaps& maps, const VarlenFwdParams& p,
                         cudaStream_t stream);
cudaError_t run_persistent_band(bool bf16, int d, const FwdMaps& maps,
                                const VarlenFwdParams& p, int num_sms, int* grid_out,
                                cudaStream_t stream);
// The score instantiations' launches (csrc/flash_varlen_fwd_score.cu).
cudaError_t run_fwd_score(bool bf16, int d, const FwdMaps& maps,
                          const VarlenFwdScoreParams& p, cudaStream_t stream);
cudaError_t run_persistent_score(bool bf16, int d, const FwdMaps& maps,
                                 const VarlenFwdScoreParams& p, int num_sms, int* grid_out,
                                 cudaStream_t stream);
// The head dim 80 instantiations' launches (csrc/flash_varlen_fwd_80.cu):
// B6's forward and B7 in every form the other head dims take, with or
// without the band and the score map (VarlenDims stays as it is: a head dim
// added there would change the machine code of every kernel it lists).
cudaError_t run_fwd_80(bool bf16, const FwdMaps& maps, const VarlenFwdScoreParams& p, bool band,
                       bool score, cudaStream_t stream);
cudaError_t run_persistent_80(bool bf16, const FwdMaps& maps, const VarlenFwdScoreParams& p,
                              bool band, bool score, int num_sms, int* grid_out,
                              cudaStream_t stream);

}  // namespace varlen_fwd
}  // namespace fa

