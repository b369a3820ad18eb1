// The attention backward tiles for Hopper (sm_90a) on wgmma and TMA, shared
// by the dense backward (csrc/flash_bwd.cu: B3's dK/dV and dQ kernels and
// B2's fused pass) and the packed-varlen backward (csrc/flash_varlen.cu, B6):
//
//  - bwd_preprocess_row: delta = rowsum(dO * O) of one row in fp32, a warp a
//    row, the sum that both preprocess kernels take;
//  - bwd_dkdv: 128 KV rows (64 at d = 256, BwdPlan) of one sequence and KV
//    head walk the group's query heads and the 64-row q tiles of their
//    causal band, keep dK and dV in registers and write them once; with
//    ACCUM_DQ (B2's fused pass) each q tile also adds its dQ = dS K over the
//    block's keys into an fp32 buffer;
//  - bwd_dq: 128 query rows (64 at d = 256) of one sequence and head walk
//    the 64-key tiles of their band and write dQ once.
//
// The block-sparse backward (csrc/flash_blocksparse.cu, B10) runs the same
// two tiles over its lists with a walk policy (Walk): count() streamed
// tiles, the t-th at next(t, stage) for the thread that issues its loads
// and at at(t, stage) for every thread once its stage has landed (a
// WalkStep: its first row, its query head, and the warpgroup whose tile it
// is alone, or -1 for both). The dense walks (BandQWalk, BandKWalk) compute
// the causal band from t; a list walk reads its steps from shared memory.
// A warpgroup skips, as a whole, a tile that belongs to the other one.
//
// What the tiles compute is what flash_attn_tpu/kernels/flash_bwd.py
// (_dkdv_kernel, _dq_kernel) and flash_varlen.py (_varlen_dkdv_stream_kernel,
// _varlen_dq_stream_kernel) compute: with P = exp(scale S - lse) and
// dS = P (dP - delta), dV = P^T dO, dK = scale dS^T Q, dQ = scale dS K, under
// bottom-right causal masking (shift = sk - sq). lse arrives in base 2
// (lse2, +inf for a row that sees no key or lies past sq: its P is 0) and
// delta beside it, both from a preprocess kernel, in buffers padded per
// sequence to whole 128-row tiles so that each tile's bulk copies of them
// are whole and 16-byte aligned.
//
// Layout (csrc/sm90.cuh): every product is a warpgroup wgmma. Up to head
// dim 128 two warpgroups of 64 rows share a block; K and V (dK/dV) or Q and dO (dQ) are
// loaded once by TMA and stay in shared memory, and the streamed tiles run
// through a two-stage ring: one thread issues the TMA loads (and the bulk
// copies of lse2 and delta) of tile t + 1 as tile t starts. The transposed
// scores S^T = K Q^T put the KV rows in wgmma's M, so P^T and dS^T pack from
// the accumulators straight into the register A operand of dV += P^T dO and
// dK += dS^T Q (dQ += dS K likewise), and Q, dO and K are read transposed
// through the descriptors' transpose bit. One block barrier a tile keeps
// the warpgroups in step and frees the stage.
//
// The source (Src) says where a sequence's rows are: a batch row of (b, s,
// h, d) tensors (4D maps, the dense policy) or a sequence of the packed
// (total, h, d) tensors at cu_seqlens (3D maps, the varlen policy). It
// gives sq and sk; load_q / load_do (dst, bar, col, row, query head) and
// load_k / load_v (dst, bar, col, row, KV head), TMA boxes at the
// sequence's local row; lse2 / delta (query head, row), the padded buffers'
// rows; dk / dv (row, KV head) and dq (row, query head), the gradients'
// rows in T; dq_accum (row, query head), the fused pass's fp32 row. TMA
// zero-fills rows past a tensor's end: a dense box past sq or sk is zeros,
// a packed box past a sequence holds the next sequence's rows (a NaN even).
// With Src::ZERO_TAIL the tiles zero those rows in shared memory (the q
// rows past sq of a streamed dK/dV tile, the keys past sk of a streamed dQ
// tile), so that the products sum what the dense policy sums and two
// policies over the same rows give the same bits. The KV rows past sk of a
// dK/dV block and the q rows past sq of a dQ block are output rows of their
// own: they are computed on whatever arrived and never stored.
//
// Head dims (BwdPlan): a tile spans the head dim in whole 64-column panels.
// At d = 96 the maps keep the tensors' 96 columns and TMA fills the second
// panel's last 32 with zeros: S^T and dP^T run over the 96 true columns
// (6 slices of 16), dV, dK and dQ over both panels as at d = 128 (their
// columns 96-127 sum those zeros and are never stored), so the register
// plan is d = 128's. d = 80 runs on 96's plan: the second panel's last 48
// columns are zeros, S^T and dP^T run 5 slices, the epilogues store 80
// columns (10 16-byte chunks a bf16 row) and the fused pass's reductions
// the 16 columns of the second panel that the head dim holds. At d = 256
// a 128-row block does not fit: 64 + 64 KV rows a block would hold
// 2 x 64 x 256 fp32 accumulators a warpgroup (256 registers a thread
// before S^T and dP^T), and resident K and V of 128
// rows (128 KB) beside two stages of 64-row Q + dO (128 KB) exceed the
// 227 KB a block may use. So at 256 a block owns 64 rows (COL_SPLIT) and
// both warpgroups work on them: each computes S^T and dP^T (dQ: S and dP)
// over half of the streamed tile's 32 rows (wgmma N = 32), turns its half
// into P^T and dS^T and stores them in bf16 as shared A tiles of 64 x 64
// (8 KB each); after one barrier each warpgroup adds its own 128 columns
// of dV += P^T dO and dK += dS^T Q (dQ += dS K) over the whole tile from
// those tiles. So the block runs the four products of a (q tile, KV tile)
// pair once (dQ: three), as at d = 128, with 64 + 64 fp32 accumulators a
// thread for dK and dV (64 for dQ) beside 16 + 16 for the halves of S and
// dP. K and V of 64 rows (64 KB), two stages of Q + dO (128 KB), the two
// A tiles (16 KB) and lse2 / delta take 209 KB of shared memory (dQ: Q +
// dO 64 KB, two K + V stages 128 KB, one A tile: 201 KB), with one block
// an SM. V (and dO) may have a head dim of their own (DV: 128 beside q's
// and k's 192, BwdPlan's Q_SPLIT and DqPlan): a dK/dV block then owns 64
// KV rows whose warpgroups split each tile's q rows for all four products
// and sum their partial dK and dV at the end, and a dQ block 128 q rows of
// d = 128's plan over D's three panels. B10's walks, whose
// tiles may be one warpgroup's alone, stay at d <= 128.
//
// Every product sits on uniform control flow (ptxas crashed on a wgmma
// behind a warpgroup-divergent branch): a warpgroup whose rows see nothing
// of a tile skips its products as a whole, and the fused pass's dQ product
// runs on dS^T = 0 for it.
//
// The band masks (window, chunk, sinks: common.cuh's Band, the masks of
// flash_bwd.py:103-139 and flash_bwd_fused.py:363-383) run in the tiles'
// BAND instantiations, over the band walks (BandRangeQWalk, BandRangeKWalk,
// which carry the Band): a dK/dV block walks the q tiles of its keys' band
// (QueryRange) and a dQ block the key tiles of its rows' band (KeyRange),
// so a block whose band is empty writes zeros; a warpgroup skips a tile in
// which no pair of its rows and keys may lie inside the band (band_meets:
// a chunk's edge, a window's far edge), and a tile that crosses an edge of
// the band tests each score against per-key (dK/dV) or per-row (dQ) bounds
// made once a tile, in a loop of its own (one loop with the test behind a
// flag cost every tile: the band instantiation ran 1.21x the band-free
// kernels over the same causal tiles, PERF.md §6). The band-free
// instantiations take the walks above and compile to the code they were.
//
// softcap and ALiBi (Score, the forward's map: flash_bwd.py:55-101
// _scores_log2) run in the SCORE instantiations, which are BAND ones: the
// causal bound comes as a band of right extent 0 (dispatch/band.py
// band_args), so one instantiation serves the map with and without a
// window. Each rebuilt score is mapped before the band's mask, in the
// forward's order (the cap, base 2, ALiBi's bias in its last-key form, the
// form of the forward's lse, so that P = exp2(s2 - lse2) is the forward's),
// by bwd_score_map in the orientation of the tile (keys in wgmma's M for
// dK/dV); under a cap the tanh derivative of each score, 1 - t^2, is kept
// beside S as a half2 pair a register (16 registers a thread beside the
// 64-column tile of dK/dV's 228: fp32 would take 32 and spill) and
// multiplies dS = P (dP - delta) before it is packed for the products
// (flash_bwd.py:143-152 ds_chain), so dK = scale (dS dtanh)^T Q and dQ =
// scale (dS dtanh) K are still scaled once at the end. ALiBi changes no
// gradient; the slope is each query head's (dK/dV walks a GQA group's).
#pragma once

#include "sm90.cuh"

namespace fa {
namespace sm90 {

constexpr int BWD_THREADS = 256;  // two consumer warpgroups
constexpr int BWD_STAGES = 2;
constexpr int BWD_KV_ROWS = 128;  // dK/dV block up to d = 128: KV rows (64 a warpgroup)
constexpr int BWD_KV_BM = 64;     // dK/dV block: q rows of a streamed tile
constexpr int BWD_Q_ROWS = 128;   // dQ block up to d = 128: q rows (64 a warpgroup)
constexpr int BWD_Q_BN = 64;      // dQ block: keys of a streamed tile
constexpr int BWD_ROW_PAD = 128;  // lse2 / delta rows are padded to this

// The block plan at head dim D (see the note above): ROWS rows a block (KV
// rows of dK/dV, q rows of dQ), and the accumulator columns of a
// warpgroup, NACC (D's whole panels, or half of them under COL_SPLIT),
// of which it stores STORE from column col0(wg).
// Rows a dK/dV or dQ block owns at head dim d (host and device).
__host__ __device__ constexpr int bwd_block_rows(int d) { return d > 128 ? 64 : 128; }

// Rows a dQ block owns at q/k head dim d and v head dim dv (host and
// device): bwd_block_rows(d) at d = dv, 128 beside a dv of its own.
__host__ __device__ constexpr int bwd_dq_rows(int d, int dv) {
  return dv == d ? bwd_block_rows(d) : 128;
}

// DV: V's and dO's head dim, D's unless given. With a DV of its own (192 /
// 128, Q_SPLIT) the dK/dV block owns 64 KV rows as under COL_SPLIT, and
// its warpgroups split each streamed tile's q rows for all four products:
// a warpgroup computes S^T and dP^T over its 32 q rows (N = 32), then dV
// += P^T dO and dK += dS^T Q from its own registers at depth 32, over all
// of dV's 128 and dK's 192 columns (64 + 96 fp32 a thread beside 16 + 16
// of S^T and dP^T); the two partial sums meet once, at the block's end,
// through the idle stage ring. So every product is the same instruction
// in both warpgroups (no wgmma behind a warpgroup-divergent branch, which
// ptxas serialises), no A tile goes through shared memory mid-tile, and
// the tensor work splits evenly. A column split (COL_SPLIT's) would start
// one warpgroup's MN-major B operand at Q's column 96, inside a panel.
template <int D, int DV = D>
struct BwdPlan {
  static constexpr bool COL_SPLIT = D > 128;
  static constexpr bool Q_SPLIT = DV != D;
  static_assert(!Q_SPLIT || (D == 192 && DV == 128), "BwdPlan: (d, dv)");
  static constexpr int ROWS = bwd_block_rows(D);
  static constexpr int DP = Tile<64, D>::PANELS * 64;
  // dK's accumulator columns of a warpgroup (under Q_SPLIT all of D's),
  // and dV's (under Q_SPLIT all of DV's)
  static constexpr int NACC = Q_SPLIT ? DP : COL_SPLIT ? DP / 2 : DP;
  static constexpr int NACC_V = Q_SPLIT ? Tile<64, DV>::PANELS * 64 : NACC;
  static constexpr int STORE = COL_SPLIT ? NACC : D;
  // this warpgroup's first row in the block, and first column
  static __device__ __forceinline__ int row0(int wg) { return COL_SPLIT ? 0 : wg * 64; }
  static __device__ __forceinline__ int col0(int wg) {
    return COL_SPLIT && !Q_SPLIT ? wg * NACC : 0;
  }
};

// dQ's block plan: BwdPlan's at DV = D; beside a DV of its own 128 q rows,
// a warpgroup's 64 over all of D's columns (dQ 96 + S 32 + dP 32 fp32 a
// thread at 192 / 128), whose product runs as N = 128 over Q's first two
// panels and N = 64 over the third.
template <int D, int DV = D>
struct DqPlan {
  static constexpr bool COL_SPLIT = BwdPlan<D>::COL_SPLIT && DV == D;
  static constexpr int ROWS = bwd_dq_rows(D, DV);
  static constexpr int DP = BwdPlan<D>::DP;
  static constexpr int NACC = COL_SPLIT ? DP / 2 : DP;
  static constexpr int STORE = COL_SPLIT ? NACC : D;
  static __device__ __forceinline__ int row0(int wg) { return COL_SPLIT ? 0 : wg * 64; }
  static __device__ __forceinline__ int col0(int wg) { return COL_SPLIT ? wg * NACC : 0; }
};

// Registers [first, first + N / 2) of an accumulator array, as the
// accumulators of one product over N of its columns.
template <int N, int M>
__device__ __forceinline__ auto acc_part(float (&acc)[M], int first) -> float (&)[N / 2] {
  return *reinterpret_cast<float(*)[N / 2]>(acc + first);
}

struct BwdMaps {
  CUtensorMap q, k, v, dout;
};

// The scalars of a call.
struct BwdArgs {
  float scale, scale_log2;
  int causal, group;
};

template <typename T>
__device__ __forceinline__ void store_pair(T* dst, float lo, float hi) {
  *reinterpret_cast<uint32_t*>(dst) = Elem<T>::pack(lo, hi);
}

// fp32 gradients (the block-sparse backward's) are stored unrounded.
__device__ __forceinline__ void store_pair(float* dst, float lo, float hi) {
  *reinterpret_cast<float2*>(dst) = make_float2(lo, hi);
}

// Step t of a walk: the first row of its streamed tile (a q row for dK/dV,
// a key for dQ), its query head, and the warpgroup whose tile it is alone
// (-1: both warpgroups').
struct WalkStep {
  int row, head, owner;
};

// dK/dV's dense walk: the group's query heads in turn, each over the 64-row
// q tiles of the causal band of KV rows [n0, n0 + 128).
struct BandQWalk {
  int m_begin, n_m, group, hk;
  __device__ __forceinline__ BandQWalk(int sq, int sk, int n0, int causal, int grp, int h)
      : group(grp), hk(h) {
    // the first q row that sees key n0 is n0 - shift
    const int shift = sk - sq;
    m_begin = causal && n0 - shift > 0 ? (n0 - shift) / BWD_KV_BM : 0;
    n_m = max(0, (sq + BWD_KV_BM - 1) / BWD_KV_BM - m_begin);
  }
  __device__ __forceinline__ int count() const { return n_m * group; }
  __device__ __forceinline__ WalkStep at(int t, int) const {
    return {(m_begin + t % n_m) * BWD_KV_BM, hk * group + t / n_m, -1};
  }
  __device__ __forceinline__ WalkStep next(int t, int st) const { return at(t, st); }
};

// dK/dV's band walk: as BandQWalk over the q tiles of the QueryRange of KV
// rows [n0, n0 + rows) under `band`, which the BAND tiles read from it.
struct BandRangeQWalk {
  int m_begin, n_m, group, hk;
  Band band;
  __device__ __forceinline__ BandRangeQWalk(int sq, int sk, int n0, int rows, const Band& b,
                                            int grp, int h)
      : group(grp), hk(h), band(b) {
    const QueryRange<BWD_KV_BM> r(n0, rows, sq, sk, b);
    m_begin = r.lo;
    n_m = r.hi - r.lo;
  }
  __device__ __forceinline__ int count() const { return n_m * group; }
  __device__ __forceinline__ WalkStep at(int t, int) const {
    return {(m_begin + t % n_m) * BWD_KV_BM, hk * group + t / n_m, -1};
  }
  __device__ __forceinline__ WalkStep next(int t, int st) const { return at(t, st); }
};

// dQ's dense walk: the 64-key tiles of the causal band of q rows
// [m0, m0 + rows).
struct BandKWalk {
  int total, hh;
  __device__ __forceinline__ BandKWalk(int sq, int sk, int m0, int causal, int h, int rows)
      : hh(h) {
    total = (sk + BWD_Q_BN - 1) / BWD_Q_BN;
    if (causal) {
      const int col_hi = min(m0 + rows, sq) - 1 + sk - sq;
      total = col_hi < 0 ? 0 : min(total, col_hi / BWD_Q_BN + 1);
    }
  }
  __device__ __forceinline__ int count() const { return total; }
  __device__ __forceinline__ WalkStep at(int t, int) const { return {t * BWD_Q_BN, hh, -1}; }
  __device__ __forceinline__ WalkStep next(int t, int st) const { return at(t, st); }
};

// dQ's band walk: the 64-key tiles of the KeyRange of q rows [m0, m0 +
// rows) under `band`, from the band's first, which the BAND tiles read.
struct BandRangeKWalk {
  int lo, total, hh;
  Band band;
  __device__ __forceinline__ BandRangeKWalk(int sq, int sk, int m0, int rows, const Band& b,
                                            int h)
      : hh(h), band(b) {
    const KeyRange<BWD_Q_BN> r(m0, rows, sq, sk, b);
    lo = r.lo;
    total = r.count();
  }
  __device__ __forceinline__ int count() const { return total; }
  __device__ __forceinline__ WalkStep at(int t, int) const {
    return {(lo + t) * BWD_Q_BN, hh, -1};
  }
  __device__ __forceinline__ WalkStep next(int t, int st) const { return at(t, st); }
};

// The first element of a row that a lane takes in bwd_preprocess_row:
// D / 32 consecutive elements a lane, or at d = 80 and 96 the pair 2 lane
// and, for lanes below (D - 64) / 2 (8 at 80, 16 at 96), the pair 64 +
// 2 lane.
template <int D>
__device__ __forceinline__ int bwd_lane_elem(int lane) {
  return D % 64 == 0 ? lane * (D / 32) : 2 * lane;
}

// delta of one row: the lanes of a warp take their elements of dO and O
// (rows `dr` and `orow`, at the lane's first element, bwd_lane_elem) and
// sum across the warp; every lane returns the row's sum.
template <typename T, int D>
__device__ __forceinline__ float bwd_preprocess_row(const T* dr, const T* orow) {
  float acc = 0.f;
  auto pair = [&](int i) {
    const float2 a = Elem<T>::unpack(*reinterpret_cast<const uint32_t*>(dr + i));
    const float2 o = Elem<T>::unpack(*reinterpret_cast<const uint32_t*>(orow + i));
    acc = fmaf(a.x, o.x, acc);
    acc = fmaf(a.y, o.y, acc);
  };
  if constexpr (D % 64 == 0) {
#pragma unroll
    for (int i = 0; i < D / 32; i += 2) pair(i);
  } else {
    static_assert(D == 80 || D == 96, "bwd_preprocess_row: head dim");
    pair(0);
    if ((threadIdx.x & 31) < (D - 64) / 2) pair(64);
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) acc += __shfl_xor_sync(0xffffffff, acc, off);
  return acc;
}

// lse in base 2 as the tiles take it: +inf for a row that sees no key.
__device__ __forceinline__ float bwd_lse2(float lse) {
  return lse == -INFINITY ? INFINITY : lse * FA_LOG2E;
}

// The slope of query head hq times log2(e) from the sequence's (h,) row of
// slopes (none: 0), as the forward's kernels take it.
__device__ __forceinline__ float bwd_slope(const float* slopes, int hq) {
  return slopes != nullptr ? slopes[hq] * FA_LOG2E : 0.f;
}

// SCORE: map a thread's scores of one backward tile (N columns) into base 2
// as fwd_sm90.cuh's score_map does, by `sc` (its slope the tile's query
// head's): score 4 j + e sits at M index m_a + 8 (e >> 1) and N index n_a
// + 8 j + (e & 1) (n_a = the tile's first column + 2 (lane % 4)); the keys
// are M (KEYS_IN_M, dK/dV's S^T) or N (dQ's S). Under a cap, dt[i] keeps
// the tanh derivatives 1 - t^2 of scores 2 i and 2 i + 1 as a half2 pair.
template <int N, bool KEYS_IN_M>
__device__ __forceinline__ void bwd_score_map(float* s, uint32_t* dt, const Score& sc,
                                              float scale_log2, int m_a, int n_a, int sk,
                                              int shift) {
  if (sc.cap_in != 0.f) {
#pragma unroll
    for (int i = 0; i < N / 4; ++i) {
      const float t0 = tanh_approx(__fmul_rn(s[2 * i], sc.cap_in));
      const float t1 = tanh_approx(__fmul_rn(s[2 * i + 1], sc.cap_in));
      s[2 * i] = __fmul_rn(t0, sc.cap_out);
      s[2 * i + 1] = __fmul_rn(t1, sc.cap_out);
      dt[i] = Elem<__half>::pack(__fmaf_rn(-t0, t0, 1.f), __fmaf_rn(-t1, t1, 1.f));
    }
  } else {
#pragma unroll
    for (int i = 0; i < N / 2; ++i) s[i] = __fmul_rn(s[i], scale_log2);
  }
  if (sc.slope == 0.f) return;
  if (sc.causal) {
    // col - (sk - 1): a whole number below 2^24, exact in fp32
#pragma unroll
    for (int j = 0; j < N / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int key = KEYS_IN_M ? m_a + 8 * (e >> 1) : n_a + 8 * j + (e & 1);
        s[4 * j + e] = __fmaf_rn(sc.slope, (float)(key - (sk - 1)), s[4 * j + e]);
      }
  } else {
    // -|row + shift - col|
    float base[2];
#pragma unroll
    for (int i = 0; i < 2; ++i)
      base[i] = KEYS_IN_M ? (float)(n_a + shift - m_a - 8 * i)
                          : (float)(m_a + 8 * i + shift - n_a);
#pragma unroll
    for (int j = 0; j < N / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float off = (float)(8 * j + (e & 1));
        const float v = KEYS_IN_M ? base[e >> 1] + off : base[e >> 1] - off;
        s[4 * j + e] = __fmaf_rn(-sc.slope, fabsf(v), s[4 * j + e]);
      }
  }
}

// SCORE under a cap: dS times the tanh derivatives bwd_score_map kept, for
// the scores [4 j, 4 j + 4) of a thread (dt pairs 2 j and 2 j + 1).
__device__ __forceinline__ void bwd_dtanh4(float* ds, const uint32_t* dt, int j) {
  const float2 a = Elem<__half>::unpack(dt[2 * j]);
  const float2 b = Elem<__half>::unpack(dt[2 * j + 1]);
  ds[4 * j] *= a.x;
  ds[4 * j + 1] *= a.y;
  ds[4 * j + 2] *= b.x;
  ds[4 * j + 3] *= b.y;
}

// ---- dK / dV (and the fused dQ) --------------------------------------------

// K, V, two stages of Q + dO (then lse2 and delta), the A tiles, the
// barriers; DV: V's and dO's head dim (BwdPlan), D's unless given.
template <int D, bool ACCUM_DQ, int DV = D>
struct DkdvLayout {
  using KV = Tile<BwdPlan<D>::ROWS, D>;   // K
  using VT = Tile<BwdPlan<D>::ROWS, DV>;  // V
  using QT = Tile<BWD_KV_BM, D>;
  using OT = Tile<BWD_KV_BM, DV>;  // dO
  using DS = Tile<64, BWD_KV_BM>;  // 64 KV rows' dS^T (or P^T) x KV_BM q
  static constexpr bool SPLIT = BwdPlan<D>::COL_SPLIT;
  // dS^T tiles: the fused pass's, one a warpgroup; under COL_SPLIT one
  // that both warpgroups fill, and beside it P^T's
  static constexpr int DS_TILES = SPLIT ? 1 : ACCUM_DQ ? 2 : 0;
  static constexpr int K_OFF = 0;
  static constexpr int V_OFF = KV::BYTES;
  static constexpr int STAGE_OFF = KV::BYTES + VT::BYTES;
  static constexpr int STAGE_BYTES = QT::BYTES + OT::BYTES;  // Q then dO
  static constexpr int DS_OFF = STAGE_OFF + BWD_STAGES * STAGE_BYTES;
  static constexpr int PT_OFF = DS_OFF + DS_TILES * DS::BYTES;
  static constexpr int VEC_OFF = PT_OFF + (SPLIT ? DS::BYTES : 0);  // lse2 then delta a stage
  static constexpr int BAR_OFF = VEC_OFF + BWD_STAGES * 2 * BWD_KV_BM * 4;
  static constexpr int BYTES = BAR_OFF + 8 * (1 + BWD_STAGES);
  // what a launch asks for: the base is rounded up to 1024 bytes
  static constexpr int SMEM = BYTES + 1024;
  static constexpr uint32_t KV_TX = KV::BYTES + VT::BYTES;
  static constexpr uint32_t STAGE_TX = STAGE_BYTES + 2 * BWD_KV_BM * 4;
};

// dK and dV (and, with ACCUM_DQ, dQ * scale added into src.dq_accum) of KV
// rows [n0, n0 + BwdPlan<D>::ROWS) of KV head hk of the sequence `src` over the q tiles
// of `walk`. `smem` is the 1024-aligned base of DkdvLayout<D,
// ACCUM_DQ>::BYTES. BAND: mask by walk.band (its right bound stands for
// a.causal; a BandRangeQWalk) instead of the causal bound. SCORE (a BAND
// instantiation): map the scores by `score`, each query head's slope from
// `slopes` (the sequence's (h,) row, or none), and dS by the cap's dtanh.
// DV: V's and dO's head dim (BwdPlan's Q_SPLIT), D's unless given.
template <typename T, int D, bool ACCUM_DQ, bool BAND = false, bool SCORE = false, int DV = D,
          typename Src, typename Walk>
__device__ __forceinline__ void bwd_dkdv(const Src& src, BwdArgs a, int hk,
                                         int n0, unsigned char* smem, const Walk& walk,
                                         const Score& score = Score{},
                                         const float* slopes = nullptr) {
  static_assert(BAND || !SCORE, "bwd_dkdv: SCORE masks by the band");
  using L = DkdvLayout<D, ACCUM_DQ, DV>;
  using P = BwdPlan<D, DV>;
  static_assert(!P::Q_SPLIT || (!BAND && !Src::ZERO_TAIL),
                "bwd_dkdv: a DV of its own takes the dense, band-free form");
  constexpr int BM = BWD_KV_BM;
  unsigned char* Ks = smem + L::K_OFF;
  unsigned char* Vs = smem + L::V_OFF;
  uint64_t* kv_bar = reinterpret_cast<uint64_t*>(smem + L::BAR_OFF);
  uint64_t* full = kv_bar + 1;

  const int tid = threadIdx.x;
  const int wg = tid >> 7;
  const int warp = (tid >> 5) & 3;
  const int lane = tid & 31;
  const int g = lane >> 2;
  const int t4 = lane & 3;
  const int sq = src.sq;
  const int sk = src.sk;
  const int shift = sk - sq;
  const int total = walk.count();  // (query head, q tile) pairs in order

  auto issue = [&](int t) {
    const int st = t % BWD_STAGES;
    unsigned char* stage = smem + L::STAGE_OFF + st * L::STAGE_BYTES;
    float* vec = reinterpret_cast<float*>(smem + L::VEC_OFF) + st * 2 * BM;
    const WalkStep w = walk.next(t, st);
    const int hq = w.head;
    const int m0 = w.row;
    mbar_expect_tx(&full[st], L::STAGE_TX);
    if constexpr (DV == D) {
#pragma unroll
      for (int c = 0; c < L::QT::PANELS; ++c) {
        src.load_q(stage + c * L::QT::PANEL_BYTES, &full[st], c * 64, m0, hq);
        src.load_do(stage + L::QT::BYTES + c * L::QT::PANEL_BYTES, &full[st], c * 64, m0, hq);
      }
    } else {
#pragma unroll
      for (int c = 0; c < L::QT::PANELS; ++c)
        src.load_q(stage + c * L::QT::PANEL_BYTES, &full[st], c * 64, m0, hq);
#pragma unroll
      for (int c = 0; c < L::OT::PANELS; ++c)
        src.load_do(stage + L::QT::BYTES + c * L::OT::PANEL_BYTES, &full[st], c * 64, m0, hq);
    }
    bulk_load(vec, src.lse2(hq, m0), BM * 4, &full[st]);
    bulk_load(vec + BM, src.delta(hq, m0), BM * 4, &full[st]);
  };

  if (tid == 0) {
    mbar_init(kv_bar, 1);
    for (int s = 0; s < BWD_STAGES; ++s) mbar_init(&full[s], 1);
    fence_barrier_init();
  }
  __syncthreads();
  if (tid == 0) {
    mbar_expect_tx(kv_bar, L::KV_TX);
    if constexpr (DV == D) {
#pragma unroll
      for (int c = 0; c < L::KV::PANELS; ++c) {
        src.load_k(Ks + c * L::KV::PANEL_BYTES, kv_bar, c * 64, n0, hk);
        src.load_v(Vs + c * L::KV::PANEL_BYTES, kv_bar, c * 64, n0, hk);
      }
    } else {
#pragma unroll
      for (int c = 0; c < L::KV::PANELS; ++c)
        src.load_k(Ks + c * L::KV::PANEL_BYTES, kv_bar, c * 64, n0, hk);
#pragma unroll
      for (int c = 0; c < L::VT::PANELS; ++c)
        src.load_v(Vs + c * L::VT::PANEL_BYTES, kv_bar, c * 64, n0, hk);
    }
    if (total > 0) issue(0);
  }

  // under Q_SPLIT this warpgroup's partial sums over its q rows
  float dk[P::NACC / 2], dv[P::NACC_V / 2];
  if constexpr (P::Q_SPLIT) {
#pragma unroll
    for (int i = 0; i < P::NACC / 2; ++i) dk[i] = 0.f;
#pragma unroll
    for (int i = 0; i < P::NACC_V / 2; ++i) dv[i] = 0.f;
  } else {
#pragma unroll
    for (int i = 0; i < P::NACC / 2; ++i) dk[i] = dv[i] = 0.f;
  }

  const int kr = P::row0(wg);  // this warpgroup's KV rows in the block
  const int kv0 = n0 + kr;
  // this warpgroup's dK/dV columns: Q's and dO's panels from col0 / 64
  const int cpanel = P::col0(wg) / 64;
  mbar_wait(kv_bar, 0);
  for (int t = 0; t < total; ++t) {
    const int st = t % BWD_STAGES;
    if (tid == 0 && t + 1 < total) issue(t + 1);  // its stage was freed at t - 1
    unsigned char* Qs = smem + L::STAGE_OFF + st * L::STAGE_BYTES;
    unsigned char* dOs = Qs + L::QT::BYTES;
    const float* lse_s = reinterpret_cast<const float*>(smem + L::VEC_OFF) + st * 2 * BM;
    const float* delta_s = lse_s + BM;
    mbar_wait(&full[st], (t / BWD_STAGES) & 1);
    const WalkStep w = walk.at(t, st);
    const int m0 = w.row;
    const int hq = w.head;
    Score sc = score;
    if constexpr (SCORE) sc.slope = bwd_slope(slopes, hq);
    if constexpr (Src::ZERO_TAIL) {
      if (m0 + BM > sq) {  // the same for the whole block
        zero_tile_rows<BM, D>(Qs, sq - m0, BWD_THREADS);
        zero_tile_rows<BM, DV>(dOs, sq - m0, BWD_THREADS);
        fence_proxy_async();  // before wgmma reads them
        __syncthreads();
      }
    }

    // the fused pass: dQ[m0 : m0 + BM] += dS K over the block's keys, one
    // 64-column panel of dQ at a time, the warpgroups taking alternate
    // panels (at d = 64 the first alone), so that the block adds each dQ
    // element of the tile once; dS^T is in the DS tiles
    auto add_dq = [&]() {
      if constexpr (ACCUM_DQ) {
        for (int pn = wg; pn < L::KV::PANELS; pn += 2) {
          const unsigned char* kcol = Ks + pn * L::KV::PANEL_BYTES;
          float dq[32];
#pragma unroll
          for (int i = 0; i < 32; ++i) dq[i] = 0.f;
          wgmma_fence();
#pragma unroll
          for (int kk = 0; kk < P::ROWS / 16; ++kk)
            wgmma_ss<T, 64, 1, 1>(dq, L::DS::mn_slice(smem + L::DS_OFF + (kk / 4) * L::DS::BYTES,
                                                      16 * (kk % 4)),
                                  L::KV::mn_slice(kcol, 16 * kk), kk > 0);
          wgmma_commit();
          wgmma_wait<0>();
          fence_regs(dq);
          // the panel's columns that the head dim holds
          const int cols = min(64, D - pn * 64);
#pragma unroll
          for (int i = 0; i < 2; ++i) {
            const int row = m0 + warp * 16 + g + 8 * i;
            if (row >= sq) continue;
            float* dst = src.dq_accum(row, hq) + pn * 64 + 2 * t4;
#pragma unroll
            for (int j = 0; j < 8; ++j)
              if (8 * j < cols)
                atomicAdd(reinterpret_cast<float2*>(dst + 8 * j),
                          make_float2(dq[4 * j + 2 * i] * a.scale,
                                      dq[4 * j + 2 * i + 1] * a.scale));
          }
        }
      }
    };
    if constexpr (P::Q_SPLIT) {
      // both warpgroups own the block's 64 KV rows (`active` is the
      // block's), each the tile's q rows [q_off, q_off + 32) for all four
      // products: S^T and dP^T at N = 32, then dV += P^T dO and dK += dS^T
      // Q with P^T and dS^T packed from its own accumulators (depth 32)
      // over all of dV's and dK's columns (dK as N = 128 over Q's first two
      // panels and N = 64 over the third); the fused pass's dS^T halves go
      // to the shared tile for add_dq
      constexpr int HQ = BM / 2;
      const int q_off = wg * HQ;
      const bool active = kv0 < sk && (!a.causal || kv0 <= m0 + BM - 1 + shift);
      if (active) {
        float s[HQ / 2], dp[HQ / 2];
#pragma unroll
        for (int i = 0; i < HQ / 2; ++i) s[i] = dp[i] = 0.f;
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < D / 16; ++kk)
          wgmma_ss<T, HQ, 0, 0>(s, L::KV::k_slice(Ks, 0, kk), L::QT::k_slice(Qs, q_off, kk),
                                kk > 0);
        wgmma_commit();
#pragma unroll
        for (int kk = 0; kk < DV / 16; ++kk)
          wgmma_ss<T, HQ, 0, 0>(dp, L::VT::k_slice(Vs, 0, kk), L::OT::k_slice(dOs, q_off, kk),
                                kk > 0);
        wgmma_commit();
        wgmma_wait<1>();
        fence_regs(s);
        // P^T = exp2(S^T * scale_log2 - lse2), masked on the diagonal and
        // the ragged end of the keys
        const bool need_mask = (a.causal && kv0 + 63 > m0 + q_off + shift) || kv0 + 64 > sk;
#pragma unroll
        for (int j = 0; j < HQ / 8; ++j) {
          const float2 l = *reinterpret_cast<const float2*>(lse_s + q_off + 8 * j + 2 * t4);
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            float x = fmaf(s[4 * j + e], a.scale_log2, -((e & 1) ? l.y : l.x));
            if (need_mask) {
              const int kv = kv0 + warp * 16 + g + 8 * (e >> 1);
              const int qrow = m0 + q_off + 8 * j + 2 * t4 + (e & 1);
              if (kv >= sk || (a.causal && kv > qrow + shift)) x = -INFINITY;
            }
            s[4 * j + e] = exp2f(x);
          }
        }
        uint32_t pa[HQ / 16][4];
#pragma unroll
        for (int kk = 0; kk < HQ / 16; ++kk) pack_a<T>(pa[kk], s, kk);
        // dV += P^T dO over this warpgroup's q rows
        fence_regs(dv);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < HQ / 16; ++kk)
          wgmma_rs<T, P::NACC_V, 1>(dv, pa[kk], L::OT::mn_slice(dOs, q_off + 16 * kk), 1);
        wgmma_commit();
        wgmma_wait<1>();  // dP^T is in; dV may still run
        fence_regs(dp);
        // dS^T = P^T (dP^T - delta)
#pragma unroll
        for (int j = 0; j < HQ / 8; ++j) {
          const float2 dl = *reinterpret_cast<const float2*>(delta_s + q_off + 8 * j + 2 * t4);
#pragma unroll
          for (int e = 0; e < 4; ++e) s[4 * j + e] *= dp[4 * j + e] - ((e & 1) ? dl.y : dl.x);
        }
        uint32_t da[HQ / 16][4];
#pragma unroll
        for (int kk = 0; kk < HQ / 16; ++kk) pack_a<T>(da[kk], s, kk);
        // dK += dS^T Q (scaled once at the end)
        fence_regs(dk);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < HQ / 16; ++kk) {
          wgmma_rs<T, 128, 1>(acc_part<128>(dk, 0), da[kk],
                              L::QT::mn_slice(Qs, q_off + 16 * kk), 1);
          wgmma_rs<T, 64, 1>(acc_part<64>(dk, 64), da[kk],
                             L::QT::mn_slice(Qs + 2 * L::QT::PANEL_BYTES, q_off + 16 * kk), 1);
        }
        wgmma_commit();
        if constexpr (ACCUM_DQ) {
          // this warpgroup's columns of the shared dS^T tile (add_dq)
          unsigned char* DSs = smem + L::DS_OFF;
#pragma unroll
          for (int kk = 0; kk < HQ / 16; ++kk) {
#pragma unroll
            for (int i = 0; i < 4; ++i) {
              // da[kk][i]: row g + 8 (i & 1), columns 16 kk + 8 (i >> 1) + 2 t4
              const int row = warp * 16 + g + 8 * (i & 1);
              const int col = q_off + 16 * kk + 8 * (i >> 1) + 2 * t4;
              *reinterpret_cast<uint32_t*>(DSs + swz128(row, col)) = da[kk][i];
            }
          }
        }
        wgmma_wait<0>();
        fence_regs(dk);
        fence_regs(dv);
        if constexpr (ACCUM_DQ) {
          fence_proxy_async();
          named_barrier(1, BWD_THREADS);  // both halves of dS^T are in
          add_dq();
        }
      }
    } else if constexpr (P::COL_SPLIT) {
      // both warpgroups own the block's 64 KV rows (the same for both, so
      // `active` is the block's): each computes S^T and dP^T over its 32
      // of the tile's q rows (N = 32) and writes its half of P^T and dS^T
      // into the shared A tiles; then each adds its 128 columns of
      // dV += P^T dO and dK += dS^T Q over all 64 q rows
      constexpr int HQ = BM / 2;
      const int q_off = wg * HQ;
      unsigned char* PTs = smem + L::PT_OFF;
      unsigned char* DSs = smem + L::DS_OFF;
      bool active;
      if constexpr (BAND)
        active = kv0 < sk && band_meets(walk.band, m0, min(m0 + BM, sq) - 1, kv0,
                                        min(kv0 + 64, sk) - 1, shift);
      else
        active = kv0 < sk && (!a.causal || kv0 <= m0 + BM - 1 + shift);
      if (active) {
        float s[HQ / 2], dp[HQ / 2];
#pragma unroll
        for (int i = 0; i < HQ / 2; ++i) s[i] = dp[i] = 0.f;
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < D / 16; ++kk)
          wgmma_ss<T, HQ, 0, 0>(s, L::KV::k_slice(Ks, 0, kk), L::QT::k_slice(Qs, q_off, kk),
                                kk > 0);
        wgmma_commit();
#pragma unroll
        for (int kk = 0; kk < DV / 16; ++kk)
          wgmma_ss<T, HQ, 0, 0>(dp, L::VT::k_slice(Vs, 0, kk), L::OT::k_slice(dOs, q_off, kk),
                                kk > 0);
        wgmma_commit();
        wgmma_wait<1>();
        fence_regs(s);
        uint32_t dt[HQ / 4];  // SCORE under a cap: the tanh derivatives
        if constexpr (BAND) {
          float sl2 = a.scale_log2;
          if constexpr (SCORE) {
            // mapped into base 2 first; the band's loops then scale by 1
            bwd_score_map<HQ, true>(s, dt, sc, a.scale_log2, kv0 + warp * 16 + g,
                                    m0 + q_off + 2 * t4, sk, shift);
            sl2 = 1.f;
          }
          const bool need_mask =
              band_cuts(walk.band, m0 + q_off, m0 + q_off + HQ - 1, kv0, kv0 + 63, shift) ||
              kv0 + 64 > sk;
          if (need_mask) {
            // the q rows [rlo, rhi] that see each of this thread's two keys
            int rlo[2], rhi[2];
#pragma unroll
            for (int i = 0; i < 2; ++i)
              band_key_rows(walk.band, kv0 + warp * 16 + g + 8 * i, sk, shift, rlo[i], rhi[i]);
#pragma unroll
            for (int j = 0; j < HQ / 8; ++j) {
              const float2 l = *reinterpret_cast<const float2*>(lse_s + q_off + 8 * j + 2 * t4);
#pragma unroll
              for (int e = 0; e < 4; ++e) {
                float x = fmaf(s[4 * j + e], sl2, -((e & 1) ? l.y : l.x));
                const int qrow = m0 + q_off + 8 * j + 2 * t4 + (e & 1);
                if (qrow < rlo[e >> 1] || qrow > rhi[e >> 1]) x = -INFINITY;
                s[4 * j + e] = exp2f(x);
              }
            }
          } else {
#pragma unroll
            for (int j = 0; j < HQ / 8; ++j) {
              const float2 l = *reinterpret_cast<const float2*>(lse_s + q_off + 8 * j + 2 * t4);
#pragma unroll
              for (int e = 0; e < 4; ++e)
                s[4 * j + e] = exp2f(fmaf(s[4 * j + e], sl2, -((e & 1) ? l.y : l.x)));
            }
          }
        } else {
        const bool need_mask = (a.causal && kv0 + 63 > m0 + q_off + shift) || kv0 + 64 > sk;
#pragma unroll
        for (int j = 0; j < HQ / 8; ++j) {
          const float2 l = *reinterpret_cast<const float2*>(lse_s + q_off + 8 * j + 2 * t4);
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            float x = fmaf(s[4 * j + e], a.scale_log2, -((e & 1) ? l.y : l.x));
            if (need_mask) {
              const int kv = kv0 + warp * 16 + g + 8 * (e >> 1);
              const int qrow = m0 + q_off + 8 * j + 2 * t4 + (e & 1);
              if (kv >= sk || (a.causal && kv > qrow + shift)) x = -INFINITY;
            }
            s[4 * j + e] = exp2f(x);
          }
        }
        }
        wgmma_wait<0>();
        fence_regs(dp);
#pragma unroll
        for (int j = 0; j < HQ / 8; ++j) {
          const float2 dl = *reinterpret_cast<const float2*>(delta_s + q_off + 8 * j + 2 * t4);
#pragma unroll
          for (int e = 0; e < 4; ++e)
            dp[4 * j + e] = s[4 * j + e] * (dp[4 * j + e] - ((e & 1) ? dl.y : dl.x));
          if constexpr (SCORE) {
            if (sc.cap_in != 0.f) bwd_dtanh4(dp, dt, j);
          }
          // accumulator pairs (e = 0, 1) and (2, 3) at KV rows g and
          // g + 8 of the warp, q columns q_off + 8 j + 2 t4
#pragma unroll
          for (int hi = 0; hi < 2; ++hi) {
            const int off = swz128(warp * 16 + g + 8 * hi, q_off + 8 * j + 2 * t4);
            *reinterpret_cast<uint32_t*>(PTs + off) =
                Elem<T>::pack(s[4 * j + 2 * hi], s[4 * j + 2 * hi + 1]);
            *reinterpret_cast<uint32_t*>(DSs + off) =
                Elem<T>::pack(dp[4 * j + 2 * hi], dp[4 * j + 2 * hi + 1]);
          }
        }
        fence_proxy_async();
        named_barrier(1, BWD_THREADS);  // both halves of P^T and dS^T are in
        fence_regs(dv);
        fence_regs(dk);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < BM / 16; ++kk)
          wgmma_ss<T, P::NACC, 0, 1>(dv, L::DS::k_slice(PTs, 0, kk),
                                     L::QT::mn_slice(dOs + cpanel * L::QT::PANEL_BYTES, 16 * kk),
                                     1);
#pragma unroll
        for (int kk = 0; kk < BM / 16; ++kk)
          wgmma_ss<T, P::NACC, 0, 1>(dk, L::DS::k_slice(DSs, 0, kk),
                                     L::QT::mn_slice(Qs + cpanel * L::QT::PANEL_BYTES, 16 * kk),
                                     1);
        wgmma_commit();
        wgmma_wait<0>();
        fence_regs(dk);
        fence_regs(dv);
        if constexpr (ACCUM_DQ) add_dq();
      }
    } else {
      // does any key of this warpgroup see any row of the tile, and is it
      // this warpgroup's?
      bool active;
      if constexpr (BAND)
        active = kv0 < sk && band_meets(walk.band, m0, min(m0 + BM, sq) - 1, kv0,
                                        min(kv0 + 64, sk) - 1, shift);
      else
        active = kv0 < sk && (!a.causal || kv0 <= m0 + BM - 1 + shift) &&
                 (w.owner < 0 || w.owner == wg);
      if (active) {
        float s[BM / 2], dp[BM / 2];
#pragma unroll
        for (int i = 0; i < BM / 2; ++i) s[i] = dp[i] = 0.f;
        // S^T = K Q^T and dP^T = V dO^T (KV rows as M)
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < D / 16; ++kk)
          wgmma_ss<T, BM, 0, 0>(s, L::KV::k_slice(Ks, kr, kk),
                                L::QT::k_slice(Qs, 0, kk), kk > 0);
        wgmma_commit();
#pragma unroll
        for (int kk = 0; kk < D / 16; ++kk)
          wgmma_ss<T, BM, 0, 0>(dp, L::KV::k_slice(Vs, kr, kk),
                                L::QT::k_slice(dOs, 0, kk), kk > 0);
        wgmma_commit();
        wgmma_wait<1>();
        fence_regs(s);

        // P^T = exp2(S^T * scale_log2 - lse2), masked on the diagonal and the
        // ragged end of the keys; rows past sq have lse2 = +inf
        uint32_t dt[BM / 4];  // SCORE under a cap: the tanh derivatives
        if constexpr (BAND) {
          float sl2 = a.scale_log2;
          if constexpr (SCORE) {
            // mapped into base 2 first; the band's loops then scale by 1
            bwd_score_map<BM, true>(s, dt, sc, a.scale_log2, kv0 + warp * 16 + g, m0 + 2 * t4,
                                    sk, shift);
            sl2 = 1.f;
          }
          const bool need_mask =
              band_cuts(walk.band, m0, m0 + BM - 1, kv0, kv0 + 63, shift) || kv0 + 64 > sk;
          if (need_mask) {
            // the q rows [rlo, rhi] that see each of this thread's two keys
            int rlo[2], rhi[2];
#pragma unroll
            for (int i = 0; i < 2; ++i)
              band_key_rows(walk.band, kv0 + warp * 16 + g + 8 * i, sk, shift, rlo[i], rhi[i]);
#pragma unroll
            for (int j = 0; j < BM / 8; ++j) {
              const float2 l = *reinterpret_cast<const float2*>(lse_s + 8 * j + 2 * t4);
#pragma unroll
              for (int e = 0; e < 4; ++e) {
                float x = fmaf(s[4 * j + e], sl2, -((e & 1) ? l.y : l.x));
                const int qrow = m0 + 8 * j + 2 * t4 + (e & 1);
                if (qrow < rlo[e >> 1] || qrow > rhi[e >> 1]) x = -INFINITY;
                s[4 * j + e] = exp2f(x);
              }
            }
          } else {
#pragma unroll
            for (int j = 0; j < BM / 8; ++j) {
              const float2 l = *reinterpret_cast<const float2*>(lse_s + 8 * j + 2 * t4);
#pragma unroll
              for (int e = 0; e < 4; ++e)
                s[4 * j + e] = exp2f(fmaf(s[4 * j + e], sl2, -((e & 1) ? l.y : l.x)));
            }
          }
        } else {
        const bool need_mask = (a.causal && kv0 + 63 > m0 + shift) || kv0 + 64 > sk;
#pragma unroll
        for (int j = 0; j < BM / 8; ++j) {
          const float2 l = *reinterpret_cast<const float2*>(lse_s + 8 * j + 2 * t4);
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            float x = fmaf(s[4 * j + e], a.scale_log2, -((e & 1) ? l.y : l.x));
            if (need_mask) {
              const int kv = kv0 + warp * 16 + g + 8 * (e >> 1);
              const int qrow = m0 + 8 * j + 2 * t4 + (e & 1);
              if (kv >= sk || (a.causal && kv > qrow + shift)) x = -INFINITY;
            }
            s[4 * j + e] = exp2f(x);
          }
        }
        }
        uint32_t pa[BM / 16][4];
#pragma unroll
        for (int kk = 0; kk < BM / 16; ++kk) pack_a<T>(pa[kk], s, kk);

        // dV += P^T dO
        fence_regs(dv);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < BM / 16; ++kk)
          wgmma_rs<T, P::NACC, 1>(
              dv, pa[kk], L::QT::mn_slice(dOs + cpanel * L::QT::PANEL_BYTES, 16 * kk), 1);
        wgmma_commit();
        wgmma_wait<1>();  // dP^T is in; dV may still run
        fence_regs(dp);

        // dS^T = P^T (dP^T - delta)
#pragma unroll
        for (int j = 0; j < BM / 8; ++j) {
          const float2 dl = *reinterpret_cast<const float2*>(delta_s + 8 * j + 2 * t4);
#pragma unroll
          for (int e = 0; e < 4; ++e)
            s[4 * j + e] *= dp[4 * j + e] - ((e & 1) ? dl.y : dl.x);
          if constexpr (SCORE) {
            if (sc.cap_in != 0.f) bwd_dtanh4(s, dt, j);
          }
        }
        uint32_t da[BM / 16][4];
#pragma unroll
        for (int kk = 0; kk < BM / 16; ++kk) pack_a<T>(da[kk], s, kk);

        // dK += dS^T Q (scaled once at the end)
        fence_regs(dk);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < BM / 16; ++kk)
          wgmma_rs<T, P::NACC, 1>(
              dk, da[kk], L::QT::mn_slice(Qs + cpanel * L::QT::PANEL_BYTES, 16 * kk), 1);
        wgmma_commit();

        if constexpr (ACCUM_DQ) {
          // this warpgroup's dS^T goes to shared memory, the transposed A
          // operand of dQ = dS K (add_dq)
          unsigned char* dsw = smem + L::DS_OFF + wg * L::DS::BYTES;
#pragma unroll
          for (int kk = 0; kk < BM / 16; ++kk) {
#pragma unroll
            for (int i = 0; i < 4; ++i) {
              // da[kk][i]: row g + 8 (i & 1), columns 16 kk + 8 (i >> 1) + 2 t4
              const int row = warp * 16 + g + 8 * (i & 1);
              const int col = 16 * kk + 8 * (i >> 1) + 2 * t4;
              *reinterpret_cast<uint32_t*>(dsw + swz128(row, col)) = da[kk][i];
            }
          }
        }
        wgmma_wait<0>();
        fence_regs(dk);
        fence_regs(dv);
      } else if (ACCUM_DQ) {
        // a warpgroup whose keys see no row of the tile adds dS^T = 0
        uint4* dsw = reinterpret_cast<uint4*>(smem + L::DS_OFF + wg * L::DS::BYTES);
        for (int i = tid & 127; i < L::DS::BYTES / 16; i += 128) dsw[i] = make_uint4(0, 0, 0, 0);
      }
      if constexpr (ACCUM_DQ) {
        fence_proxy_async();
        named_barrier(1, BWD_THREADS);  // the dS^T slots are in shared memory
        add_dq();
      }
    }
    __syncthreads();  // both warpgroups are done with stage st
  }

  if constexpr (P::Q_SPLIT) {
    // the two warpgroups' partial sums meet in the idle stage ring, in the
    // accumulators' own order (thread t's register i of each at one
    // float): warpgroup 1 leaves its dK, warpgroup 0 its dV; then
    // warpgroup 0 stores dK (scaled) over D columns and warpgroup 1 dV over
    // DV, rows past sk skipped
    static_assert((P::NACC + P::NACC_V) / 2 * 128 * 4 <= BWD_STAGES * L::STAGE_BYTES,
                  "bwd_dkdv: the partial sums fit the stage ring");
    float* part = reinterpret_cast<float*>(smem + L::STAGE_OFF);
    const int lt = tid & 127;
    if (wg == 1) {
#pragma unroll
      for (int i = 0; i < P::NACC / 2; ++i) part[i * 128 + lt] = dk[i];
    } else {
#pragma unroll
      for (int i = 0; i < P::NACC_V / 2; ++i) part[(P::NACC / 2 + i) * 128 + lt] = dv[i];
    }
    __syncthreads();
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int row = kv0 + warp * 16 + g + 8 * i;
      if (row >= sk) continue;
      if (wg == 0) {
        auto* dkg = src.dk(row, hk);
#pragma unroll
        for (int j = 0; j < D / 8; ++j) {
          const int e = 4 * j + 2 * i;
          store_pair(dkg + 8 * j + 2 * t4, (dk[e] + part[e * 128 + lt]) * a.scale,
                     (dk[e + 1] + part[(e + 1) * 128 + lt]) * a.scale);
        }
      } else {
        auto* dvg = src.dv(row, hk);
        const float* pv = part + (P::NACC / 2) * 128;
#pragma unroll
        for (int j = 0; j < DV / 8; ++j) {
          const int e = 4 * j + 2 * i;
          store_pair(dvg + 8 * j + 2 * t4, dv[e] + pv[e * 128 + lt],
                     dv[e + 1] + pv[(e + 1) * 128 + lt]);
        }
      }
    }
  } else {
  // dK (scaled) and dV in the inputs' type, this warpgroup's STORE columns
  // from col0, rows past sk skipped
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = kv0 + warp * 16 + g + 8 * i;
    if (row >= sk) continue;
    auto* dkg = src.dk(row, hk) + P::col0(wg);
    auto* dvg = src.dv(row, hk) + P::col0(wg);
#pragma unroll
    for (int j = 0; j < P::STORE / 8; ++j) {
      store_pair(dkg + 8 * j + 2 * t4, dk[4 * j + 2 * i] * a.scale,
                 dk[4 * j + 2 * i + 1] * a.scale);
      store_pair(dvg + 8 * j + 2 * t4, dv[4 * j + 2 * i], dv[4 * j + 2 * i + 1]);
    }
  }
  }
}

// bwd_dkdv over the dense walk: the causal band of the group's query heads.
template <typename T, int D, bool ACCUM_DQ, int DV = D, typename Src>
__device__ __forceinline__ void bwd_dkdv(const Src& src, BwdArgs a, int hk,
                                         int n0, unsigned char* smem) {
  bwd_dkdv<T, D, ACCUM_DQ, false, false, DV>(
      src, a, hk, n0, smem, BandQWalk(src.sq, src.sk, n0, a.causal, a.group, hk));
}

// bwd_dkdv's BAND instantiation over the band walk of `band`; SCORE: with
// the score map (`score`, `slopes`).
template <typename T, int D, bool ACCUM_DQ, bool SCORE = false, typename Src>
__device__ __forceinline__ void bwd_dkdv_band(const Src& src, BwdArgs a, int hk, int n0,
                                              unsigned char* smem, Band band,
                                              const Score& score = Score{},
                                              const float* slopes = nullptr) {
  bwd_dkdv<T, D, ACCUM_DQ, true, SCORE>(
      src, a, hk, n0, smem,
      BandRangeQWalk(src.sq, src.sk, n0, BwdPlan<D>::ROWS, band, a.group, hk), score, slopes);
}

// ---- dQ ---------------------------------------------------------------------

// Q, dO, two stages of K + V, the A tile, lse2 and delta, the barriers;
// DV: V's and dO's head dim (DqPlan), D's unless given.
template <int D, int DV = D>
struct DqLayout {
  static constexpr int ROWS = DqPlan<D, DV>::ROWS;
  using QT = Tile<ROWS, D>;
  using OT = Tile<ROWS, DV>;  // dO
  using KT = Tile<BWD_Q_BN, D>;
  using VT = Tile<BWD_Q_BN, DV>;
  using DS = Tile<64, BWD_Q_BN>;  // under COL_SPLIT: dS, 64 q rows x the keys
  static constexpr int Q_OFF = 0;
  static constexpr int DO_OFF = QT::BYTES;
  static constexpr int STAGE_OFF = QT::BYTES + OT::BYTES;
  static constexpr int STAGE_BYTES = KT::BYTES + VT::BYTES;  // K then V
  static constexpr int DS_OFF = STAGE_OFF + BWD_STAGES * STAGE_BYTES;
  static constexpr int VEC_OFF =
      DS_OFF + (DqPlan<D, DV>::COL_SPLIT ? DS::BYTES : 0);  // lse2, delta
  static constexpr int BAR_OFF = VEC_OFF + 2 * ROWS * 4;
  static constexpr int BYTES = BAR_OFF + 8 * (1 + BWD_STAGES);
  static constexpr int SMEM = BYTES + 1024;
  static constexpr uint32_t Q_TX = QT::BYTES + OT::BYTES + 2 * ROWS * 4;
  static constexpr uint32_t STAGE_TX = STAGE_BYTES;
};

// dQ of query rows [m0, m0 + DqPlan<D, DV>::ROWS) of query head hh of the sequence `src`
// over the key tiles of `walk`, written once. `smem` is the 1024-aligned
// base of DqLayout<D, DV>::BYTES. BAND: mask by walk.band (a BandRangeKWalk),
// as bwd_dkdv. SCORE (a BAND instantiation): the score map, as bwd_dkdv.
// DV: V's and dO's head dim (DqPlan), D's unless given.
template <typename T, int D, bool BAND = false, bool SCORE = false, int DV = D, typename Src,
          typename Walk>
__device__ __forceinline__ void bwd_dq(const Src& src, BwdArgs a, int hh, int m0,
                                       unsigned char* smem, const Walk& walk,
                                       const Score& score = Score{},
                                       const float* slopes = nullptr) {
  static_assert(BAND || !SCORE, "bwd_dq: SCORE masks by the band");
  using L = DqLayout<D, DV>;
  using P = DqPlan<D, DV>;
  static_assert(DV == D || (!BAND && !Src::ZERO_TAIL && !P::COL_SPLIT && P::NACC == 192),
                "bwd_dq: a DV of its own takes the dense, band-free form at 192");
  constexpr int BN = BWD_Q_BN;
  constexpr int ROWS = P::ROWS;
  unsigned char* Qs = smem + L::Q_OFF;
  unsigned char* dOs = smem + L::DO_OFF;
  float* lse_s = reinterpret_cast<float*>(smem + L::VEC_OFF);
  float* delta_s = lse_s + ROWS;
  uint64_t* q_bar = reinterpret_cast<uint64_t*>(smem + L::BAR_OFF);
  uint64_t* full = q_bar + 1;

  const int hk = hh / a.group;
  const int tid = threadIdx.x;
  const int wg = tid >> 7;
  const int warp = (tid >> 5) & 3;
  const int lane = tid & 31;
  const int g = lane >> 2;
  const int t4 = lane & 3;
  const int sq = src.sq;
  const int sk = src.sk;
  const int shift = sk - sq;
  const int total = walk.count();

  auto issue = [&](int t) {
    const int st = t % BWD_STAGES;
    unsigned char* stage = smem + L::STAGE_OFF + st * L::STAGE_BYTES;
    const int n0 = walk.next(t, st).row;
    mbar_expect_tx(&full[st], L::STAGE_TX);
    if constexpr (DV == D) {
#pragma unroll
      for (int c = 0; c < L::KT::PANELS; ++c) {
        src.load_k(stage + c * L::KT::PANEL_BYTES, &full[st], c * 64, n0, hk);
        src.load_v(stage + L::KT::BYTES + c * L::KT::PANEL_BYTES, &full[st], c * 64, n0, hk);
      }
    } else {
#pragma unroll
      for (int c = 0; c < L::KT::PANELS; ++c)
        src.load_k(stage + c * L::KT::PANEL_BYTES, &full[st], c * 64, n0, hk);
#pragma unroll
      for (int c = 0; c < L::VT::PANELS; ++c)
        src.load_v(stage + L::KT::BYTES + c * L::VT::PANEL_BYTES, &full[st], c * 64, n0, hk);
    }
  };

  if (tid == 0) {
    mbar_init(q_bar, 1);
    for (int s = 0; s < BWD_STAGES; ++s) mbar_init(&full[s], 1);
    fence_barrier_init();
  }
  __syncthreads();
  if (tid == 0) {
    mbar_expect_tx(q_bar, L::Q_TX);
    if constexpr (DV == D) {
#pragma unroll
      for (int c = 0; c < L::QT::PANELS; ++c) {
        src.load_q(Qs + c * L::QT::PANEL_BYTES, q_bar, c * 64, m0, hh);
        src.load_do(dOs + c * L::QT::PANEL_BYTES, q_bar, c * 64, m0, hh);
      }
    } else {
#pragma unroll
      for (int c = 0; c < L::QT::PANELS; ++c)
        src.load_q(Qs + c * L::QT::PANEL_BYTES, q_bar, c * 64, m0, hh);
#pragma unroll
      for (int c = 0; c < L::OT::PANELS; ++c)
        src.load_do(dOs + c * L::OT::PANEL_BYTES, q_bar, c * 64, m0, hh);
    }
    bulk_load(lse_s, src.lse2(hh, m0), ROWS * 4, q_bar);
    bulk_load(delta_s, src.delta(hh, m0), ROWS * 4, q_bar);
    if (total > 0) issue(0);
  }

  float dq[P::NACC / 2];
#pragma unroll
  for (int i = 0; i < P::NACC / 2; ++i) dq[i] = 0.f;

  const int qr = P::row0(wg);  // this warpgroup's q rows in the block
  const int r0 = m0 + qr;
  // this warpgroup's dQ columns: K's panels from col0 / 64
  const int cpanel = P::col0(wg) / 64;
  mbar_wait(q_bar, 0);
  float lse2[2], delta[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    lse2[i] = lse_s[qr + warp * 16 + g + 8 * i];
    delta[i] = delta_s[qr + warp * 16 + g + 8 * i];
  }
  Score sc = score;
  if constexpr (SCORE) sc.slope = bwd_slope(slopes, hh);
  for (int t = 0; t < total; ++t) {
    const int st = t % BWD_STAGES;
    if (tid == 0 && t + 1 < total) issue(t + 1);  // its stage was freed at t - 1
    unsigned char* Ks = smem + L::STAGE_OFF + st * L::STAGE_BYTES;
    unsigned char* Vs = Ks + L::KT::BYTES;
    mbar_wait(&full[st], (t / BWD_STAGES) & 1);
    const WalkStep w = walk.at(t, st);
    const int n0 = w.row;
    if constexpr (Src::ZERO_TAIL) {
      if (n0 + BN > sk) {  // the same for the whole block
        zero_tile_rows<BN, D>(Ks, sk - n0, BWD_THREADS);
        zero_tile_rows<BN, DV>(Vs, sk - n0, BWD_THREADS);
        fence_proxy_async();  // before wgmma reads them
        __syncthreads();
      }
    }

    if constexpr (P::COL_SPLIT) {
      // both warpgroups own the block's 64 q rows (`active` is the
      // block's): each computes S and dP over its 32 of the tile's keys
      // (N = 32) and writes its half of dS into the shared A tile; then
      // each adds its 128 columns of dQ += dS K over all 64 keys
      constexpr int HK = BN / 2;
      const int k_off = wg * HK;
      unsigned char* DSs = smem + L::DS_OFF;
      bool active;
      if constexpr (BAND)
        active = r0 < sq && band_meets(walk.band, r0, min(r0 + 64, sq) - 1, n0,
                                       min(n0 + BN, sk) - 1, shift);
      else
        active = r0 < sq && (!a.causal || n0 <= r0 + 63 + shift);
      if (active) {
        float s[HK / 2], dp[HK / 2];
#pragma unroll
        for (int i = 0; i < HK / 2; ++i) s[i] = dp[i] = 0.f;
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < D / 16; ++kk)
          wgmma_ss<T, HK, 0, 0>(s, L::QT::k_slice(Qs, 0, kk), L::KT::k_slice(Ks, k_off, kk),
                                kk > 0);
        wgmma_commit();
#pragma unroll
        for (int kk = 0; kk < D / 16; ++kk)
          wgmma_ss<T, HK, 0, 0>(dp, L::QT::k_slice(dOs, 0, kk), L::KT::k_slice(Vs, k_off, kk),
                                kk > 0);
        wgmma_commit();
        wgmma_wait<1>();
        fence_regs(s);
        const int c0 = n0 + k_off;  // this warpgroup's first key
        uint32_t dt[HK / 4];        // SCORE under a cap: the tanh derivatives
        if constexpr (BAND) {
          float sl2 = a.scale_log2;
          if constexpr (SCORE) {
            // mapped into base 2 first; the band's loops then scale by 1
            bwd_score_map<HK, false>(s, dt, sc, a.scale_log2, r0 + warp * 16 + g, c0 + 2 * t4,
                                     sk, shift);
            sl2 = 1.f;
          }
          const bool need_mask =
              band_cuts(walk.band, r0, r0 + 63, c0, c0 + HK - 1, shift) || c0 + HK > sk;
          if (need_mask) {
            // the keys [klo, khi] this thread's two rows see, bar the
            // window's lower edge kwlo, which the first band.sink keys pass
            int klo[2], khi[2], kwlo[2];
#pragma unroll
            for (int i = 0; i < 2; ++i)
              band_row_keys(walk.band, r0 + warp * 16 + g + 8 * i + shift, sk, klo[i], khi[i],
                            kwlo[i]);
#pragma unroll
            for (int j = 0; j < HK / 8; ++j) {
#pragma unroll
              for (int e = 0; e < 4; ++e) {
                float x = fmaf(s[4 * j + e], sl2, -lse2[e >> 1]);
                const int col = c0 + 8 * j + 2 * t4 + (e & 1);
                const int i = e >> 1;
                if (col > khi[i] || col < klo[i] || (col < kwlo[i] && col >= walk.band.sink))
                  x = -INFINITY;
                s[4 * j + e] = exp2f(x);
              }
            }
          } else {
#pragma unroll
            for (int i = 0; i < HK / 2; ++i)
              s[i] = exp2f(fmaf(s[i], sl2, -lse2[(i >> 1) & 1]));
          }
        } else {
        const bool need_mask = (a.causal && c0 + HK - 1 > r0 + shift) || c0 + HK > sk;
#pragma unroll
        for (int j = 0; j < HK / 8; ++j) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            float x = fmaf(s[4 * j + e], a.scale_log2, -lse2[e >> 1]);
            if (need_mask) {
              const int col = c0 + 8 * j + 2 * t4 + (e & 1);
              const int row = r0 + warp * 16 + g + 8 * (e >> 1);
              if (col >= sk || (a.causal && col > row + shift)) x = -INFINITY;
            }
            s[4 * j + e] = exp2f(x);
          }
        }
        }
        wgmma_wait<0>();
        fence_regs(dp);
#pragma unroll
        for (int j = 0; j < HK / 8; ++j) {
          if constexpr (SCORE) {
            // dS (times the cap's dtanh) in place of dP
#pragma unroll
            for (int e = 0; e < 4; ++e) dp[4 * j + e] = s[4 * j + e] * (dp[4 * j + e] - delta[e >> 1]);
            if (sc.cap_in != 0.f) bwd_dtanh4(dp, dt, j);
#pragma unroll
            for (int hi = 0; hi < 2; ++hi)
              *reinterpret_cast<uint32_t*>(
                  DSs + swz128(warp * 16 + g + 8 * hi, k_off + 8 * j + 2 * t4)) =
                  Elem<T>::pack(dp[4 * j + 2 * hi], dp[4 * j + 2 * hi + 1]);
          } else {
#pragma unroll
          for (int hi = 0; hi < 2; ++hi)
            *reinterpret_cast<uint32_t*>(
                DSs + swz128(warp * 16 + g + 8 * hi, k_off + 8 * j + 2 * t4)) =
                Elem<T>::pack(s[4 * j + 2 * hi] * (dp[4 * j + 2 * hi] - delta[hi]),
                              s[4 * j + 2 * hi + 1] * (dp[4 * j + 2 * hi + 1] - delta[hi]));
          }
        }
        fence_proxy_async();
        named_barrier(1, BWD_THREADS);  // both halves of dS are in
        fence_regs(dq);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < BN / 16; ++kk)
          wgmma_ss<T, P::NACC, 0, 1>(dq, L::DS::k_slice(DSs, 0, kk),
                                     L::KT::mn_slice(Ks + cpanel * L::KT::PANEL_BYTES, 16 * kk),
                                     1);
        wgmma_commit();
        wgmma_wait<0>();
        fence_regs(dq);
      }
    } else {
      // does any row of this warpgroup see any key of the tile, and is it
      // this warpgroup's?
      bool active;
      if constexpr (BAND)
        active = r0 < sq && band_meets(walk.band, r0, min(r0 + 64, sq) - 1, n0,
                                       min(n0 + BN, sk) - 1, shift);
      else
        active = r0 < sq && (!a.causal || n0 <= r0 + 63 + shift) &&
                 (w.owner < 0 || w.owner == wg);
      if (active) {
        float s[BN / 2], dp[BN / 2];
#pragma unroll
        for (int i = 0; i < BN / 2; ++i) s[i] = dp[i] = 0.f;
        // S = Q K^T and dP = dO V^T
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < D / 16; ++kk)
          wgmma_ss<T, BN, 0, 0>(s, L::QT::k_slice(Qs, qr, kk),
                                L::KT::k_slice(Ks, 0, kk), kk > 0);
        wgmma_commit();
#pragma unroll
        for (int kk = 0; kk < DV / 16; ++kk)
          wgmma_ss<T, BN, 0, 0>(dp, L::OT::k_slice(dOs, qr, kk),
                                L::VT::k_slice(Vs, 0, kk), kk > 0);
        wgmma_commit();
        wgmma_wait<1>();
        fence_regs(s);

        // P = exp2(S * scale_log2 - lse2), masked on the diagonal and the
        // ragged end of the keys
        uint32_t dt[BN / 4];  // SCORE under a cap: the tanh derivatives
        if constexpr (BAND) {
          float sl2 = a.scale_log2;
          if constexpr (SCORE) {
            // mapped into base 2 first; the band's loops then scale by 1
            bwd_score_map<BN, false>(s, dt, sc, a.scale_log2, r0 + warp * 16 + g, n0 + 2 * t4,
                                     sk, shift);
            sl2 = 1.f;
          }
          const bool need_mask =
              band_cuts(walk.band, r0, r0 + 63, n0, n0 + BN - 1, shift) || n0 + BN > sk;
          if (need_mask) {
            // the keys [klo, khi] this thread's two rows see, bar the
            // window's lower edge kwlo, which the first band.sink keys pass
            int klo[2], khi[2], kwlo[2];
#pragma unroll
            for (int i = 0; i < 2; ++i)
              band_row_keys(walk.band, r0 + warp * 16 + g + 8 * i + shift, sk, klo[i], khi[i],
                            kwlo[i]);
#pragma unroll
            for (int j = 0; j < BN / 8; ++j) {
#pragma unroll
              for (int e = 0; e < 4; ++e) {
                float x = fmaf(s[4 * j + e], sl2, -lse2[e >> 1]);
                const int col = n0 + 8 * j + 2 * t4 + (e & 1);
                const int i = e >> 1;
                if (col > khi[i] || col < klo[i] || (col < kwlo[i] && col >= walk.band.sink))
                  x = -INFINITY;
                s[4 * j + e] = exp2f(x);
              }
            }
          } else {
#pragma unroll
            for (int i = 0; i < BN / 2; ++i)
              s[i] = exp2f(fmaf(s[i], sl2, -lse2[(i >> 1) & 1]));
          }
        } else {
        const bool need_mask = (a.causal && n0 + BN - 1 > r0 + shift) || n0 + BN > sk;
#pragma unroll
        for (int j = 0; j < BN / 8; ++j) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            float x = fmaf(s[4 * j + e], a.scale_log2, -lse2[e >> 1]);
            if (need_mask) {
              const int col = n0 + 8 * j + 2 * t4 + (e & 1);
              const int row = r0 + warp * 16 + g + 8 * (e >> 1);
              if (col >= sk || (a.causal && col > row + shift)) x = -INFINITY;
            }
            s[4 * j + e] = exp2f(x);
          }
        }
        }
        wgmma_wait<0>();
        fence_regs(dp);

        // dS = P (dP - delta); dQ += dS K (scaled once at the end)
#pragma unroll
        for (int i = 0; i < BN / 2; ++i) s[i] *= dp[i] - delta[(i >> 1) & 1];
        if constexpr (SCORE) {
          if (sc.cap_in != 0.f) {
#pragma unroll
            for (int j = 0; j < BN / 8; ++j) bwd_dtanh4(s, dt, j);
          }
        }
        uint32_t da[BN / 16][4];
#pragma unroll
        for (int kk = 0; kk < BN / 16; ++kk) pack_a<T>(da[kk], s, kk);
        fence_regs(dq);
        wgmma_fence();
        if constexpr (P::NACC == 192) {
          // over K's first two panels (N = 128) and its third (N = 64)
#pragma unroll
          for (int kk = 0; kk < BN / 16; ++kk) {
            wgmma_rs<T, 128, 1>(acc_part<128>(dq, 0), da[kk], L::KT::mn_slice(Ks, 16 * kk), 1);
            wgmma_rs<T, 64, 1>(acc_part<64>(dq, 64), da[kk],
                               L::KT::mn_slice(Ks + 2 * L::KT::PANEL_BYTES, 16 * kk), 1);
          }
        } else {
#pragma unroll
        for (int kk = 0; kk < BN / 16; ++kk)
          wgmma_rs<T, P::NACC, 1>(
              dq, da[kk], L::KT::mn_slice(Ks + cpanel * L::KT::PANEL_BYTES, 16 * kk), 1);
        }
        wgmma_commit();
        wgmma_wait<0>();
        fence_regs(dq);
      }
    }
    __syncthreads();  // both warpgroups are done with stage st
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = r0 + warp * 16 + g + 8 * i;
    if (row >= sq) continue;
    auto* dqg = src.dq(row, hh) + P::col0(wg);
#pragma unroll
    for (int j = 0; j < P::STORE / 8; ++j)
      store_pair(dqg + 8 * j + 2 * t4, dq[4 * j + 2 * i] * a.scale,
                 dq[4 * j + 2 * i + 1] * a.scale);
  }
}

// bwd_dq over the dense walk: the key tiles of the causal band.
template <typename T, int D, int DV = D, typename Src>
__device__ __forceinline__ void bwd_dq(const Src& src, BwdArgs a, int hh, int m0,
                                       unsigned char* smem) {
  bwd_dq<T, D, false, false, DV>(
      src, a, hh, m0, smem, BandKWalk(src.sq, src.sk, m0, a.causal, hh, DqPlan<D, DV>::ROWS));
}

// bwd_dq's BAND instantiation over the band walk of `band`; SCORE: with
// the score map (`score`, `slopes`).
template <typename T, int D, bool SCORE = false, typename Src>
__device__ __forceinline__ void bwd_dq_band(const Src& src, BwdArgs a, int hh, int m0,
                                            unsigned char* smem, Band band,
                                            const Score& score = Score{},
                                            const float* slopes = nullptr) {
  bwd_dq<T, D, true, SCORE>(src, a, hh, m0, smem,
                            BandRangeKWalk(src.sq, src.sk, m0, BwdPlan<D>::ROWS, band, hh),
                            score, slopes);
}

}  // namespace sm90
}  // namespace fa
