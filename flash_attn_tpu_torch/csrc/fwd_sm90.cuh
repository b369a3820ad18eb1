// The attention forward tile for Hopper (sm_90a) on wgmma and TMA, shared by
// the dense forward (csrc/flash_fwd.cu, B1), the packed-varlen forwards
// (csrc/flash_varlen_fwd.cu, B6 and the persistent B7) and the paged varlen
// prefill (csrc/flash_varlen_paged.cu, B8): one block of two warpgroups
// computes 128 query rows of one sequence and head against the 64-key tiles
// of its causal band. fwd_tile runs one tile of rows in a block; B7 runs
// its pieces (fwd_issue_q / fwd_issue_kv, fwd_step a K/V tile,
// fwd_epilogue) over several tiles with the K/V ring carried across them,
// and the block-sparse forward (csrc/flash_blocksparse.cu, B10) over the
// key tiles of its lists, where a tile may belong to one warpgroup's rows
// alone (fwd_step's `owner`: the other warpgroup masks all of it).
//
// What it computes is what flash_attn_tpu/kernels/flash_fwd.py:_fwd_kernel
// computes, with the causal diagonal of flash_fwd_split.py:_diag_kernel:
// out = softmax(scale Q K^T) V per row under bottom-right causal masking
// (shift = sk - sq: row r sees key c <= r + shift), and the natural-log lse;
// a row that sees no key gets out 0 and lse -inf. The band instantiation
// (BAND, B1 and B8 with a window, a chunk or sinks: common.cuh's Band, the
// masks of flash_fwd.py:270-287) walks only the key tiles of its rows'
// band (KeyRange from the band's first tile, as _kv_block_bounds :360
// bounds the TPU grid) and masks the tiles that cross an edge of it. The softmax runs in base 2
// with scale * log2(e) folded into one multiply. The score instantiation
// (SCORE, B1 and B8 with softcap or ALiBi) maps each score between the
// product and the mask, in flash_fwd.py:180-247's order: the cap
// (tanh(s scale / cap) cap, in base 2), then ALiBi's bias (Score).
//
// Layout (csrc/sm90.cuh): Q comes once by TMA into a 128-row tile of
// 128B-swizzled panels; K and V tiles of 64 keys come through a two-stage
// ring, one thread issuing tile t + 1's loads as tile t starts. Each
// warpgroup runs S = Q K^T over its 64 rows by SS wgmma (both operands
// K-major) and the online softmax in registers (only the tiles that cross
// the diagonal or the ragged end of the keys run the mask), then packs P
// from the S accumulators (pack_a) into the register A operand of
// O += P V, with V read MN-major through the descriptor's transpose bit.
// One block barrier a tile keeps the warpgroups in step and frees the
// stage. A warpgroup whose rows see no key of a tile (the lower one, on the
// last tile of a causal band) still runs its products on P = 0, so that no
// wgmma sits behind a warpgroup-divergent branch. O takes 64 fp32 registers
// a thread at d = 128, S 32, within the 128 a thread that let two blocks
// share an SM (the kernels' __launch_bounds__(256, 2), no spills); shared
// memory holds 32 KB of Q and two stages of K + V at 32 KB each, 97 KB a
// block. With two blocks an SM one block's softmax runs while the other's
// products hold the tensor cores: measured faster than one block an SM with
// 64- or 128-key tiles, and than issuing tile t + 1's scores before tile t's
// softmax within a block, which spills at 128 registers (PERF.md §6).
// V may have a head dim of its own (DV; DeepSeek's non-absorbed MLA: q and
// k 192 = 128 + 64 rope columns, v 128): Q and K span D's panels (QK^T runs
// D / 16 depth slices), V and O DV's, and the epilogue stores DV columns.
// The epilogue stages the normalised O of each warpgroup in its own rows of
// the Q tile (swizzled, so the stores are free of bank conflicts) and
// writes it out in 16-byte row chunks, rows past sq skipped: 7% faster at
// the prefill's shape than 4-byte stores straight from the accumulators.
//
// Rows: TMA zero-fills rows past a tensor's end. In a packed tensor the
// rows past a sequence's end belong to the next one: their scores are
// masked to -inf (P = 0 exactly) and, with ZERO_TAIL, the V rows past the
// keys of the ragged tile are zeroed in shared memory, so that what a
// neighbour holds (a NaN even) cannot reach the output through 0 * V. Rows
// past sq are computed on whatever arrived and never stored. Every multiply
// that feeds an add is rounded explicitly (__fmul_rn, __fmaf_rn), so the
// kernels that inline this tile give the same bits for the same rows.
#pragma once

#include "sm90.cuh"

namespace fa {
namespace sm90 {

constexpr int FWD_M = 128;  // query rows a block (64 a warpgroup)
constexpr int FWD_N = 64;   // keys a K/V tile
constexpr int FWD_THREADS = 256;
constexpr int FWD_STAGES = 2;

// Blocks an SM holds at head dim D (the kernels' __launch_bounds__): two up
// to d = 128 (128 registers a thread), one at d = 256, whose 128 fp32 O
// accumulators a thread and 193 KB of shared memory leave room for one, and
// one at d = 192 beside dv = 128: 64 O accumulators as at 128, but Q (48 KB)
// and two stages of K (24 KB) + V (16 KB) take 128 KB of shared memory (a
// third stage, 168 KB, measured 0.6% slower at DeepSeek-V3's layer: PERF.md
// §6).
template <int D>
constexpr int fwd_min_blocks() { return D > 128 ? 1 : 2; }

// QBUF Q tiles (the persistent varlen forward may keep a second one), then
// the K/V stages, then the barriers: QBUF Q barriers, one a stage. DV: V's
// head dim (192 / 128: DeepSeek's non-absorbed MLA), D's unless given.
template <int D, int QBUF = 1, int DV = D>
struct FwdLayout {
  using QT = Tile<FWD_M, D>;
  using KT = Tile<FWD_N, D>;
  using VT = Tile<FWD_N, DV>;
  static constexpr int Q_OFF = 0;
  static constexpr int STAGE_OFF = QBUF * QT::BYTES;
  static constexpr int STAGE_BYTES = KT::BYTES + VT::BYTES;  // K then V
  static constexpr int BAR_OFF = STAGE_OFF + FWD_STAGES * STAGE_BYTES;
  static constexpr int BYTES = BAR_OFF + 8 * (QBUF + FWD_STAGES);
  // what a launch asks for: the base is rounded up to 1024 bytes
  static constexpr int SMEM = BYTES + 1024;
};

// The rows a block writes: out and lse at row 0 of the sequence and this
// query head (lse rows are consecutive floats); rows [m0, m0 + 128) of sq
// query rows over sk keys.
template <typename T>
struct FwdRows {
  T* out;
  float* lse;
  int64_t o_ss;  // out's row stride in elements
  int sq, sk, m0;
  // the learnable sink of the block's query head, a natural-log logit (JAX
  // flash_fwd.py:340-348), or none
  const float* sink = nullptr;
};

// What a thread carries through a tile's band: its share of O (the
// accumulators of its two rows), and their running max and sum. O spans
// the head dim in whole panels (DP columns: 128 at d = 96, whose last 32
// come from V's zero-filled columns and are never stored), as NBLK
// accumulator blocks of one P V product each (N = 64 at d = 64, else 128:
// wgmma_rs's widths); element i of the flat order at(i) sits at column
// 8 (i / 4) + 2 (lane % 4) + i % 2, the layout of one product over DP.
template <int D>
struct FwdAcc {
  static constexpr int DP = Tile<FWD_M, D>::PANELS * 64;
  static constexpr int NB = DP == 64 ? 64 : 128;
  static constexpr int NBLK = DP / NB;
  float o[NBLK][NB / 2];
  float m_r[2];  // running max of the scaled scores
  float l_r[2];  // this thread's share of the row sum
  __device__ __forceinline__ float& at(int i) { return o[i / (NB / 2)][i % (NB / 2)]; }
  __device__ __forceinline__ float at(int i) const { return o[i / (NB / 2)][i % (NB / 2)]; }
  __device__ __forceinline__ void init() {
#pragma unroll
    for (int i = 0; i < DP / 2; ++i) at(i) = 0.f;
    m_r[0] = m_r[1] = -INFINITY;
    l_r[0] = l_r[1] = 0.f;
  }
  __device__ __forceinline__ void fence() {
#pragma unroll
    for (int b = 0; b < NBLK; ++b) fence_regs(o[b]);
  }
};

// Issue the TMA loads of K/V tile n (keys [64 n, 64 n + 64)) of `src` into
// `stage`, counted on `bar`: one box a panel (K's D columns, V's DV). A
// source whose tiles are not one box a panel overloads fwd_issue_kv for its
// own type, found by argument-dependent lookup (B8's paged source copies a
// tile as boxes of one page's rows).
template <int D, int DV = D, typename Src>
__device__ __forceinline__ void fwd_issue_kv(const Src& src, unsigned char* stage,
                                             uint64_t* bar, int n) {
  using L = FwdLayout<D, 1, DV>;
  mbar_expect_tx(bar, L::STAGE_BYTES);
  if constexpr (DV == D) {
#pragma unroll
    for (int c = 0; c < L::KT::PANELS; ++c) {
      src.load_k(stage + c * L::KT::PANEL_BYTES, bar, c * 64, n * FWD_N);
      src.load_v(stage + L::KT::BYTES + c * L::KT::PANEL_BYTES, bar, c * 64, n * FWD_N);
    }
  } else {
#pragma unroll
    for (int c = 0; c < L::KT::PANELS; ++c)
      src.load_k(stage + c * L::KT::PANEL_BYTES, bar, c * 64, n * FWD_N);
#pragma unroll
    for (int c = 0; c < L::VT::PANELS; ++c)
      src.load_v(stage + L::KT::BYTES + c * L::VT::PANEL_BYTES, bar, c * 64, n * FWD_N);
  }
}

// Issue the TMA loads of the Q tile at row m0 of `src` into Qs.
template <int D, typename Src>
__device__ __forceinline__ void fwd_issue_q(const Src& src, unsigned char* Qs,
                                            uint64_t* bar, int m0) {
  using L = FwdLayout<D>;
  mbar_expect_tx(bar, L::QT::BYTES);
#pragma unroll
  for (int c = 0; c < L::QT::PANELS; ++c) src.load_q(Qs + c * L::QT::PANEL_BYTES, bar, c * 64, m0);
}

// Score a thread's S accumulators of one tile (keys from n0; its rows
// row_a and row_a + 8, the quad lane t4) into base 2 by `sc`. The bias is
// a whole number below 2^24, so it is exact in fp32: one FMA a score.
template <int BN>
__device__ __forceinline__ void score_map(float* s, const Score& sc, float scale_log2, int n0,
                                          int row_a, int t4, int sk, int shift) {
  if (sc.cap_in != 0.f) {
#pragma unroll
    for (int i = 0; i < BN / 2; ++i)
      s[i] = __fmul_rn(tanh_approx(__fmul_rn(s[i], sc.cap_in)), sc.cap_out);
  } else {
#pragma unroll
    for (int i = 0; i < BN / 2; ++i) s[i] = __fmul_rn(s[i], scale_log2);
  }
  if (sc.slope == 0.f) return;
  if (sc.causal) {
    const float base = (float)(n0 + 2 * t4 - (sk - 1));
#pragma unroll
    for (int j = 0; j < BN / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        s[4 * j + e] = __fmaf_rn(sc.slope, base + (float)(8 * j + (e & 1)), s[4 * j + e]);
  } else {
    float base[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) base[i] = (float)(row_a + 8 * i + shift - n0 - 2 * t4);
#pragma unroll
    for (int j = 0; j < BN / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        s[4 * j + e] = __fmaf_rn(-sc.slope, fabsf(base[e >> 1] - (float)(8 * j + (e & 1))),
                                 s[4 * j + e]);
  }
}

// The band a SCORE instantiation masks by: without BAND, the causal bound
// as a band of right extent 0 (none when not causal).
template <bool BAND>
__device__ __forceinline__ Band score_band(Band b, bool causal) {
  if constexpr (!BAND) b.right = causal ? 0 : BAND_NONE;
  return b;
}

// One K/V tile (keys [n0, n0 + 64), landed in `stage`) of the band of the
// rows of `t`, for the whole block: S = Q K^T, the masks, the online softmax
// and O += P V, then the block barrier that frees the stage. With owner >= 0
// the tile is warpgroup `owner`'s alone: the other one masks every score,
// which leaves its O, max and sum bitwise as they were. BAND: mask by
// `band` (common.cuh; its right bound stands for `causal`) instead of the
// causal bound; the band-free instantiation compiles to the code it was.
// SCORE: map the scores by `score` before the mask (score_map). DV: V's
// and O's head dim (FwdLayout), D's unless given.
template <typename T, int D, bool ZERO_TAIL, bool BAND = false, bool SCORE = false, int DV = D>
__device__ __forceinline__ void fwd_step(FwdAcc<DV>& a, const unsigned char* Qs,
                                         unsigned char* stage, int n0,
                                         const FwdRows<T>& t, float scale_log2,
                                         bool causal, int owner = -1,
                                         const Band& band = Band{},
                                         const Score& score = Score{}) {
  using L = FwdLayout<D, 1, DV>;
  constexpr int BN = FWD_N;
  const int tid = threadIdx.x;
  const int wg = tid >> 7;
  const int warp = (tid >> 5) & 3;
  const int lane = tid & 31;
  const int g = lane >> 2;
  const int t4 = lane & 3;
  const int shift = t.sk - t.sq;
  const int r0 = t.m0 + wg * 64;         // this warpgroup's rows
  const int row_a = r0 + warp * 16 + g;  // this thread's rows: row_a, row_a + 8
  const unsigned char* Ks = stage;
  unsigned char* Vs = stage + L::KT::BYTES;

  if constexpr (ZERO_TAIL) {
    if (n0 + BN > t.sk) {  // the same for the whole block
      zero_tile_rows<BN, DV>(Vs, t.sk - n0, FWD_THREADS);
      fence_proxy_async();  // before wgmma reads them
      __syncthreads();
    }
  }

  // S = Q K^T over this warpgroup's 64 rows (the head dim's own columns:
  // at d = 96 the zero-filled ones would add nothing)
  float s[BN / 2];
#pragma unroll
  for (int i = 0; i < BN / 2; ++i) s[i] = 0.f;
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk)
    wgmma_ss<T, BN, 0, 0>(s, L::QT::k_slice(Qs, wg * 64, kk), L::KT::k_slice(Ks, 0, kk),
                          kk > 0);
  wgmma_commit();
  wgmma_wait<0>();
  fence_regs(s);

  // scale into base 2; mask the diagonal and the ragged end of the keys,
  // and the other warpgroup's tile whole (its keys all count as past sk)
  const int sk = owner >= 0 && owner != wg ? n0 : t.sk;
  if constexpr (SCORE) {
    // the scores mapped into base 2 first (the band's loops below then
    // scale by 1); then the mask of the band, which stands for the causal
    // bound without BAND (score_band)
    score_map<BN>(s, score, scale_log2, n0, row_a, t4, t.sk, shift);
    scale_log2 = 1.f;
  }
  if constexpr (BAND || SCORE) {
    // the tile crosses the band's upper edge at the warpgroup's first row,
    // its lower edge at the last (sinks aside: a mask too many changes no
    // score), a chunk boundary of some row, or the end of the keys. The
    // masked and the unmasked tile take separate loops; a masked one tests
    // each score against its row's bounds, made once a tile: keys [lo, hi]
    // (the upper edge, the keys' end and the chunk) and the window's lower
    // edge wlo, which the first `sink` keys pass.
    const bool need_mask = n0 + BN > sk || band_cuts(band, r0, r0 + 63, n0, n0 + BN - 1, shift);
    if (need_mask) {
      int lo[2], hi[2], wlo[2];
#pragma unroll
      for (int i = 0; i < 2; ++i)
        band_row_keys(band, row_a + 8 * i + shift, sk, lo[i], hi[i], wlo[i]);
#pragma unroll
      for (int j = 0; j < BN / 8; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int col = n0 + 8 * j + 2 * t4 + (e & 1);
          const int i = e >> 1;
          const bool out = col > hi[i] || col < lo[i] || (col < wlo[i] && col >= band.sink);
          s[4 * j + e] = out ? -INFINITY : __fmul_rn(s[4 * j + e], scale_log2);
        }
      }
    } else {
#pragma unroll
      for (int i = 0; i < BN / 2; ++i) s[i] = __fmul_rn(s[i], scale_log2);
    }
  } else {
    const bool need_mask = (causal && n0 + BN - 1 > r0 + shift) || n0 + BN > sk;
#pragma unroll
    for (int j = 0; j < BN / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float x = __fmul_rn(s[4 * j + e], scale_log2);
        if (need_mask) {
          const int col = n0 + 8 * j + 2 * t4 + (e & 1);
          const int row = row_a + 8 * (e >> 1);
          if (col >= sk || (causal && col > row + shift)) x = -INFINITY;
        }
        s[4 * j + e] = x;
      }
    }
  }

  // online softmax, one row pair at a time
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    float mx = -INFINITY;
#pragma unroll
    for (int j = 0; j < BN / 8; ++j)
      mx = fmaxf(mx, fmaxf(s[4 * j + 2 * i], s[4 * j + 2 * i + 1]));
    mx = quad_max(mx);
    const float m_new = fmaxf(a.m_r[i], mx);
    // a row that has seen no key yet keeps m = -inf; exponentiate against
    // 0 so that it gives 0 and not NaN
    const float m_safe = m_new == -INFINITY ? 0.f : m_new;
    const float corr = exp2_ftz(a.m_r[i] - m_safe);
    a.m_r[i] = m_new;
    float rs = 0.f;
#pragma unroll
    for (int j = 0; j < BN / 8; ++j) {
      s[4 * j + 2 * i] = exp2_ftz(s[4 * j + 2 * i] - m_safe);
      s[4 * j + 2 * i + 1] = exp2_ftz(s[4 * j + 2 * i + 1] - m_safe);
      rs += s[4 * j + 2 * i] + s[4 * j + 2 * i + 1];
    }
    a.l_r[i] = __fmaf_rn(a.l_r[i], corr, rs);
#pragma unroll
    for (int j = 0; j < FwdAcc<DV>::DP / 8; ++j) {
      a.at(4 * j + 2 * i) = __fmul_rn(a.at(4 * j + 2 * i), corr);
      a.at(4 * j + 2 * i + 1) = __fmul_rn(a.at(4 * j + 2 * i + 1), corr);
    }
  }

  // O += P V, P packed from the S accumulators; one product a block of O's
  // columns (V's panels 2 b and 2 b + 1 at N = 128)
  using A = FwdAcc<DV>;
  uint32_t pa[BN / 16][4];
#pragma unroll
  for (int kk = 0; kk < BN / 16; ++kk) pack_a<T>(pa[kk], s, kk);
  a.fence();
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < BN / 16; ++kk)
#pragma unroll
    for (int b = 0; b < A::NBLK; ++b)
      wgmma_rs<T, A::NB, 1>(a.o[b], pa[kk],
                            L::VT::mn_slice(Vs + b * (A::NB / 64) * L::VT::PANEL_BYTES, 16 * kk), 1);
  wgmma_commit();
  wgmma_wait<0>();
  a.fence();
  __syncthreads();  // both warpgroups are done with the stage
}

// Normalise and write the rows of `t`: O in the input type goes through this
// warpgroup's rows of the Q tile Qs (its last product has read them) and
// out in 16-byte chunks of the head dim's D columns, rows past sq skipped;
// the natural-log lse. O is scaled by o_scale / l (o_scale: B8's v_descale,
// else 1). With t.sink, the sink is one more logit of every row's softmax,
// unscaled, uncapped and unbiased (JAX flash_fwd.py:340-356): in natural
// units m_tot = max(m ln 2, sink), l' = l e^(m ln 2 - m_tot) + e^(sink -
// m_tot), O = acc e^(m ln 2 - m_tot) o_scale / l', lse = m_tot + log l'; a row
// that sees no key gives out 0 and lse = sink.
template <typename T, int D>
__device__ __forceinline__ void fwd_epilogue(const FwdAcc<D>& a, unsigned char* Qs,
                                             const FwdRows<T>& t, float o_scale = 1.f) {
  using L = FwdLayout<D>;
  const int tid = threadIdx.x;
  const int wg = tid >> 7;
  const int warp = (tid >> 5) & 3;
  const int lane = tid & 31;
  const int g = lane >> 2;
  const int t4 = lane & 3;
  const int r0 = t.m0 + wg * 64;
  unsigned char* ow = Qs + wg * 64 * 128;
  const float sink = t.sink != nullptr ? *t.sink : 0.f;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = warp * 16 + g + 8 * i;
    const float l = quad_sum(a.l_r[i]);
    float inv = l == 0.f ? 0.f : o_scale / l;
    float lse_sink = 0.f;
    if (t.sink != nullptr) {
      const float m_nat = a.m_r[i] * FA_LN2;  // -inf for a row that saw no key
      const float m_tot = fmaxf(m_nat, sink);
      const float c = expf(m_nat - m_tot);
      const float l_tot = __fmaf_rn(l, c, expf(sink - m_tot));
      inv = o_scale * c / l_tot;
      lse_sink = m_tot + logf(l_tot);
    }
#pragma unroll
    for (int j = 0; j < D / 8; ++j)
      *reinterpret_cast<uint32_t*>(ow + (j / 8) * L::QT::PANEL_BYTES +
                                   swz128(r, 8 * (j % 8) + 2 * t4)) =
          Elem<T>::pack(a.at(4 * j + 2 * i) * inv, a.at(4 * j + 2 * i + 1) * inv);
    if (t4 == 0 && r0 + r < t.sq)
      t.lse[r0 + r] = t.sink != nullptr ? lse_sink
                      : l == 0.f        ? -INFINITY
                                        : __fmaf_rn(a.m_r[i], FA_LN2, logf(l));
  }
  named_barrier(1 + wg, 128);
  for (int i = tid & 127; i < 64 * (D / 8); i += 128) {
    const int r = i / (D / 8);
    const int ch = i % (D / 8);
    if (r0 + r >= t.sq) continue;
    *reinterpret_cast<uint4*>(t.out + (int64_t)(r0 + r) * t.o_ss + 8 * ch) =
        *reinterpret_cast<const uint4*>(ow + (ch / 8) * L::QT::PANEL_BYTES + r * 128 +
                                        (((ch ^ r) & 7) << 4));
  }
}

// Src: load_q / load_k / load_v(dst, bar, col, row) issue the TMA load of
// the box of 64 columns from `col` and 128 (Q) or 64 (K, V) rows from the
// sequence's row `row`, counted on `bar`. ZERO_TAIL: zero the V rows past
// sk of the ragged tile (a packed tensor's neighbour rows). One block, one
// tile of rows: the barriers are set up here and thread 0 issues the
// band's i + 1-th tile's loads as its i-th starts (its stage was freed at
// i - 1). BAND: the key tiles of `band` (KeyRange), from the first tile that
// holds a key some row sees; no tile at all (out 0, lse -inf) when no row
// sees any (with t.sink, lse = sink). SCORE: the scores mapped by `score`
// (fwd_step). o_scale: the epilogue's. DV: V's and O's head dim (128 beside
// D = 192: V's tiles two panels and O 64 accumulators a thread as at d =
// 128, beside Q's and K's three panels; the epilogue stores DV columns), D's
// unless given.
template <typename T, int D, bool ZERO_TAIL, bool BAND = false, bool SCORE = false, int DV = D,
          typename Src>
__device__ __forceinline__ void fwd_tile(const Src& src, const FwdRows<T>& t,
                                         float scale_log2, bool causal,
                                         unsigned char* smem,
                                         const Band& band = Band{},
                                         const Score& score = Score{},
                                         float o_scale = 1.f) {
  using L = FwdLayout<D, 1, DV>;
  unsigned char* Qs = smem + L::Q_OFF;
  uint64_t* q_bar = reinterpret_cast<uint64_t*>(smem + L::BAR_OFF);
  uint64_t* full = q_bar + 1;
  const int tid = threadIdx.x;
  const KeyRange<FWD_N> keys = [&] {
    if constexpr (BAND) return KeyRange<FWD_N>(t.m0, FWD_M, t.sq, t.sk, band);
    else return KeyRange<FWD_N>(t.m0, FWD_M, t.sq, t.sk, causal);
  }();
  const int n_lo = BAND ? keys.lo : 0;
  const int total = keys.count();
  auto stage = [&](int i) { return smem + L::STAGE_OFF + (i % FWD_STAGES) * L::STAGE_BYTES; };

  if (tid == 0) {
    mbar_init(q_bar, 1);
    for (int s = 0; s < FWD_STAGES; ++s) mbar_init(&full[s], 1);
    fence_barrier_init();
  }
  __syncthreads();
  // fwd_issue_kv<D> at DV = D, the call B8's paged source overloads
  if (tid == 0 && total > 0) {
    fwd_issue_q<D>(src, Qs, q_bar, t.m0);
    if constexpr (DV == D) fwd_issue_kv<D>(src, stage(0), &full[0], n_lo);
    else fwd_issue_kv<D, DV>(src, stage(0), &full[0], n_lo);
  }

  FwdAcc<DV> a;
  a.init();
  if (total > 0) mbar_wait(q_bar, 0);
  for (int i = 0; i < total; ++i) {
    if (tid == 0 && i + 1 < total) {
      if constexpr (DV == D)
        fwd_issue_kv<D>(src, stage(i + 1), &full[(i + 1) % FWD_STAGES], n_lo + i + 1);
      else
        fwd_issue_kv<D, DV>(src, stage(i + 1), &full[(i + 1) % FWD_STAGES], n_lo + i + 1);
    }
    mbar_wait(&full[i % FWD_STAGES], (i / FWD_STAGES) & 1);
    fwd_step<T, D, ZERO_TAIL, BAND, SCORE, DV>(a, Qs, stage(i), (n_lo + i) * FWD_N, t,
                                               scale_log2, causal, -1, band, score);
  }
  // O's DV columns go out through the Q tile's first panels (the
  // epilogue's layout is O's alone: its panels span 128 rows at any D)
  fwd_epilogue<T, DV>(a, Qs, t, o_scale);
}

// The maps of one forward call.
struct FwdMaps {
  CUtensorMap q, k, v;
};

}  // namespace sm90
}  // namespace fa
