// The absorbed-MLA attention tile for Hopper (sm_90a) on wgmma and TMA,
// shared by the paged chunked prefill (csrc/flash_paged_prefill.cu, B8p) and
// the MLA route of split-KV decode (csrc/flash_decode_mla.cu): one block of
// two warpgroups computes 64 query rows of one sequence and KV head against
// a run of 64-key tiles of its cache, with a second query `qv` that scores
// against V, and a value width DV that differs from the key width D.
//
// Rows. A tile is PB positions by GB heads of the KV head's group, GB =
// gcd(group, 64), PB = 64 / GB, row p GB + j being position p0 + p of head
// hb + j (heads fastest). At DeepSeek's 128 heads on one KV head a tile is
// 64 heads of one position, so it has one causal limit and only its last
// key tile is masked; at GQA 8/2 it is 16 positions of 4 heads, masked per
// row on the tiles that cross a limit. Q and QV come once by TMA, a box of
// (64 columns, GB heads, PB positions) a panel, into 128B-swizzled 64-column
// panels (sm90.cuh): DQK / 64 panels, 9 at 64 + 512 and at 576. TMA
// zero-fills only past a tensor's end, so rows past the sequence's positions
// may hold a neighbour's rows: they are computed and never stored.
//
// Scores are S = [Q | QV] [K | V]^T, one product of depth DQK = D + DV over
// a key tile whose row is K's row followed by V's row. Without qv the tile
// takes DeepSeek's latent cache as it is stored (K 576 wide, V its first 512
// columns): the key tile holds K alone, DQK = D, and V is read from its
// first DV / 64 panels. Either way each key's bytes cross from device memory
// once and feed both products.
//
// Keys. One warp walks the block's keys through PagedRows (sm90.cuh: a
// paged cache with each page id clamped to the table and the pool, or a
// linear cache as one page of s_max rows a batch row) and copies each page's
// part of a tile as TMA boxes of gcd(page_size, 64) rows over 4D maps of the
// caches (pages, h_k, page_size, d or dv), a lane a box. Two stages, each
// with a full and an empty mbarrier; the Q load and the first two key tiles
// are issued together. Keys at or past sk are masked to -inf and their V
// rows zeroed in shared memory, so that a NaN in a page slot the sequence
// does not reach cannot reach the output.
//
// Products. Two consumer warpgroups take the key tiles in turn (FlashMLA's
// alternating layout, deepseek-ai/FlashMLA): warpgroup w computes S of the
// tiles n = w mod 2 once, at N = 64 with both operands K-major (SS wgmma),
// runs the online softmax on it and publishes its row maxima, its rescale
// factors and P (bf16, into a K panel of the tile that P V does not read:
// K's first panel with qv, the rope panel, columns 512-575, without) behind
// a `ready` mbarrier. The softmax is a chain (tile n starts from the maxima
// after tile n - 1, read from the other warpgroup), but each warpgroup's
// score product runs while the other's softmax does. Each warpgroup owns
// half of the DV output columns (a 64 x 256 fp32 half, 128 registers a
// thread at DV = 512) and applies every tile's P to it in order, rescaling
// first: O += P V by SS wgmma with P K-major and V MN-major through the
// transpose bit. Every wgmma sits on control flow that is uniform across the
// block's consumers: a warpgroup with no tile left in the last pair still
// runs its score product on the other's stage and drops it. Every multiply
// that feeds an add is rounded explicitly, so the two kernels give the same
// bits for the same rows over the same keys.
//
// Shared memory at 64 + 512 and at 576: Q 72 KB and two key stages of 72
// KB, 218 KB with the exchange arrays and barriers (and 1 KB to align the
// base), one block an SM. 256 threads: a producer warpgroup (384 threads)
// would cap ptxas at 168 registers a thread, setmaxnreg notwithstanding, and
// spill O; so the second warpgroup's first warp issues the copies between
// its products.
//
// Pieces: mla_mainloop runs a block's key tiles into an MlaAcc, and
// mla_row_sums adds up the two warpgroups' row sums; each kernel then writes
// its own output (B8p in the input type through the Q panels, decode an fp32
// split partial straight from the accumulators).
#pragma once

#include <limits.h>

#include "sm90.cuh"

namespace fa {
namespace sm90 {

constexpr int MLA_BM = 64;               // query rows a tile
constexpr int MLA_BN = 64;               // keys a key tile
constexpr int MLA_THREADS = 256;         // two warpgroups
constexpr int MLA_PANEL = MLA_BM * 128;  // one 64-column panel of 64 rows

// The (D, DV, qv) forms the kernels are compiled for.
template <int D_, int DV_, bool QV_>
struct MlaDims {
  static constexpr int D = D_;
  static constexpr int DV = DV_;
  static constexpr bool QV = QV_;
  static constexpr int DQK = QV ? D + DV : D;  // score depth = key-tile row width
  static constexpr int PANELS = DQK / 64;      // of Q and of a key tile
  static constexpr int V_PANEL = QV ? D / 64 : 0;      // V's first panel in a key tile
  static constexpr int P_PANEL = QV ? 0 : PANELS - 1;  // a K panel that P V does not read
  static constexpr int DVH = DV / 2;                   // output columns a warpgroup
  static constexpr int NB = DVH < 128 ? DVH : 128;     // width of one P V product
  static_assert(D % 64 == 0 && DV % 128 == 0, "64-column panels, halves of 64");
  static_assert(QV || DV + 64 <= D, "without qv, V is K's first DV columns and P needs another");
};

template <typename Dm>
struct MlaLayout {
  static constexpr int Q_OFF = 0;
  static constexpr int STAGE_OFF = Dm::PANELS * MLA_PANEL;
  static constexpr int STAGE_BYTES = Dm::PANELS * MLA_PANEL;  // K panels, then V's
  static constexpr int X_OFF = STAGE_OFF + 2 * STAGE_BYTES;
  // m_buf[2][64], c_buf[2][64] (row maxima and rescale factors of the last
  // tile of each stage), l_buf[2][64] (each warpgroup's row sums)
  static constexpr int BAR_OFF = X_OFF + 6 * MLA_BM * 4;
  // q_full, full[2], empty[2], ready[2]
  static constexpr int BYTES = BAR_OFF + 7 * 8;
  static constexpr int SMEM = BYTES + 1024;  // the base is rounded up to 1024
};

// Calls f(Form{}) for the one of `Forms` (MlaDims types) that matches (d,
// dv, qv) and returns its result; cudaErrorInvalidValue for a form not in
// the list. Each kernel passes its own list, so only those forms are
// compiled; the Python side lists the same forms (dispatch/config.py
// MLA_DECODE_DIMS, PAGED_PREFILL_DIMS).
template <typename... Forms, typename F>
cudaError_t mla_dispatch(int d, int dv, bool qv, F&& f) {
  cudaError_t err = cudaErrorInvalidValue;
  (void)((Forms::D == d && Forms::DV == dv && Forms::QV == qv ? (err = f(Forms{}), true)
                                                                : false) ||
         ...);
  return err;
}

// The rows of one block and the keys they see.
struct MlaRows {
  int p0;       // the tile's first position; row r is position p0 + r / gb
  int gb;       // heads a position in the tile
  int sq, sk;   // the sequence's query positions and keys; causal: position
                // p sees keys <= p + sk - sq
  int k_lo;     // the first key of the block's run, a multiple of MLA_BN
  int n_tiles;  // key tiles from k_lo
  int causal;
};

// Where the block's keys come from: the 4D maps of the caches (V's unused
// without qv), the pages of the sequence, the KV head, and the rows of one
// TMA box (gcd64 of the page size).
struct MlaKeys {
  const CUtensorMap* k;
  const CUtensorMap* v;
  PagedRows pages;
  int kh, box_rows;
};

// What a thread carries through the key tiles.
template <typename Dm>
struct MlaAcc {
  float o[Dm::DVH / Dm::NB][Dm::NB / 2];  // its share of its warpgroup's half of O
  float m_r[2];  // row maxima after the last tile applied
  float l_r[2];  // its share of its own tiles' row sums
};

// The block's key tiles into `a`. QSrc::load(dst, bar, c) issues the TMA
// load of panel c of the Q tile ([Q | QV]'s columns 64 c .. 64 c + 63),
// counted on `bar`. The barriers are set up here; with no key tile the
// accumulators stay empty (out 0 and lse -inf) and nothing is loaded.
template <typename T, typename Dm, typename QSrc>
__device__ __forceinline__ void mla_mainloop(MlaAcc<Dm>& a, const QSrc& qsrc, const MlaKeys& keys,
                                             const MlaRows& t, float scale_log2,
                                             unsigned char* smem) {
  using L = MlaLayout<Dm>;
  constexpr int BM = MLA_BM;
  constexpr int BN = MLA_BN;
  constexpr int PANEL = MLA_PANEL;
  constexpr int D = Dm::D;
  constexpr int DVH = Dm::DVH;
  constexpr int NB = Dm::NB;
  unsigned char* Qs = smem + L::Q_OFF;
  float* m_buf = reinterpret_cast<float*>(smem + L::X_OFF);
  float* c_buf = m_buf + 2 * BM;
  uint64_t* q_full = reinterpret_cast<uint64_t*>(smem + L::BAR_OFF);
  uint64_t* full = q_full + 1;
  uint64_t* empty = full + 2;
  uint64_t* ready = empty + 2;
  auto stage = [&](int s) { return smem + L::STAGE_OFF + s * L::STAGE_BYTES; };

  const int tid = threadIdx.x;
  if (tid == 0) {
    mbar_init(q_full, 1);
    for (int s = 0; s < 2; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], MLA_THREADS);
      mbar_init(&ready[s], 128);
    }
    fence_barrier_init();
  }
  __syncthreads();

#pragma unroll
  for (int b = 0; b < DVH / NB; ++b)
#pragma unroll
    for (int i = 0; i < NB / 2; ++i) a.o[b][i] = 0.f;
  a.m_r[0] = a.m_r[1] = -INFINITY;
  a.l_r[0] = a.l_r[1] = 0.f;
  const int n_tiles = t.n_tiles;
  if (n_tiles == 0) return;

  const int wg = tid >> 7;
  const int warp = (tid >> 5) & 3;
  const int lane = tid & 31;
  const int g = lane >> 2;
  const int t4 = lane & 3;
  // The key copies are issued by warpgroup 1's first warp, which releases
  // each stage last in the steady state: tile n + 2 goes into tile n's
  // stage once both warpgroups have released it, one lane a box.
  const bool issuer = wg == 1 && warp == 0;
  auto issue_keys = [&](int n) {
    const int s = n & 1;
    unsigned char* st = stage(s);
    if (lane == 0) mbar_expect_tx(&full[s], L::STAGE_BYTES);
    __syncwarp();
    for (int j = lane; j < BN / keys.box_rows; j += 32) {
      int pg, row;
      keys.pages.locate(t.k_lo + n * BN + j * keys.box_rows, pg, row);
      unsigned char* dst = st + j * keys.box_rows * 128;
#pragma unroll
      for (int c = 0; c < Dm::PANELS; ++c) {
        if (c < D / 64)
          tma_load_4d(dst + c * PANEL, keys.k, &full[s], c * 64, row, keys.kh, pg);
        else
          tma_load_4d(dst + c * PANEL, keys.v, &full[s], (c - D / 64) * 64, row, keys.kh, pg);
      }
    }
  };
  if (tid == 0) {
    mbar_expect_tx(q_full, Dm::PANELS * PANEL);
#pragma unroll
    for (int c = 0; c < Dm::PANELS; ++c) qsrc.load(Qs + c * PANEL, q_full, c);
  }
  if (issuer) {
    issue_keys(0);
    if (n_tiles > 1) issue_keys(1);
  }

  const int shift = t.sk - t.sq;
  int lim[2];  // the last key each of this thread's two rows may see
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = warp * 16 + g + 8 * i;
    lim[i] = t.causal ? t.p0 + r / t.gb + shift : INT_MAX - 1;
  }
  const int lim_first = t.causal ? t.p0 + shift : INT_MAX - 1;  // the tile's smallest

  mbar_wait(q_full, 0);
  for (int n0 = 0; n0 < n_tiles; n0 += 2) {
    const int own = n0 + wg;
    const bool has_own = own < n_tiles;
    // with no tile of its own, the score product runs on the even tile's
    // stage, which is held until both warpgroups release it, and is dropped
    const int st_s = has_own ? wg : 0;
    unsigned char* Ks = stage(st_s);
    mbar_wait(&full[st_s], (n0 >> 1) & 1);

    // S = [Q | QV] [K | V]^T over the tile's 64 keys at the full depth
    float s[BN / 2];
#pragma unroll
    for (int i = 0; i < BN / 2; ++i) s[i] = 0.f;
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < Dm::DQK / 16; ++kk)
      wgmma_ss<T, BN, 0, 0>(s, Tile<BM, Dm::DQK>::k_slice(Qs, 0, kk),
                            Tile<BN, Dm::DQK>::k_slice(Ks, 0, kk), kk > 0);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(s);

    float own_c[2] = {1.f, 1.f}, own_rs[2] = {0.f, 0.f};
    if (has_own) {
      const int kn = t.k_lo + own * BN;
      // the maxima after tile own - 1 (published by the other warpgroup, or
      // by this one two tiles ago and already applied)
      float m_prev[2] = {-INFINITY, -INFINITY};
      if (own > 0) {
        mbar_wait(&ready[(own - 1) & 1], ((own - 1) >> 1) & 1);
#pragma unroll
        for (int i = 0; i < 2; ++i) m_prev[i] = m_buf[((own - 1) & 1) * BM + warp * 16 + g + 8 * i];
      }
      const bool need_mask = kn + BN - 1 > lim_first || kn + BN > t.sk;
#pragma unroll
      for (int j = 0; j < BN / 8; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          float x = __fmul_rn(s[4 * j + e], scale_log2);
          if (need_mask) {
            const int col = kn + 8 * j + 2 * t4 + (e & 1);
            if (col >= t.sk || col > lim[e >> 1]) x = -INFINITY;
          }
          s[4 * j + e] = x;
        }
      }
      float m_new[2];
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        float mx = -INFINITY;
#pragma unroll
        for (int j = 0; j < BN / 8; ++j)
          mx = fmaxf(mx, fmaxf(s[4 * j + 2 * i], s[4 * j + 2 * i + 1]));
        m_new[i] = fmaxf(m_prev[i], quad_max(mx));
        // a row that has seen no key yet keeps m = -inf; exponentiate
        // against 0 so that it gives 0 and not NaN
        const float m_safe = m_new[i] == -INFINITY ? 0.f : m_new[i];
        own_c[i] = exp2_ftz(m_prev[i] - m_safe);
        float rs = 0.f;
#pragma unroll
        for (int j = 0; j < BN / 8; ++j) {
          s[4 * j + 2 * i] = exp2_ftz(s[4 * j + 2 * i] - m_safe);
          s[4 * j + 2 * i + 1] = exp2_ftz(s[4 * j + 2 * i + 1] - m_safe);
          rs += s[4 * j + 2 * i] + s[4 * j + 2 * i + 1];
        }
        own_rs[i] = rs;
      }
      // V rows past the keys of the ragged tile: zeros (whole 128-byte rows
      // of each V panel, so the swizzle does not matter)
      if (kn + BN > t.sk) {
        const int first = t.sk - kn;
        const int per_panel = (BN - first) * 8;  // 16-byte chunks
        for (int i = tid & 127; i < per_panel * (Dm::DV / 64); i += 128) {
          const int c = i / per_panel;
          const int r = first + (i - c * per_panel) / 8;
          *reinterpret_cast<uint4*>(Ks + (Dm::V_PANEL + c) * PANEL + r * 128 + (i & 7) * 16) =
              make_uint4(0, 0, 0, 0);
        }
      }
      // P into the tile's P panel, the maxima and factors beside it
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int r = warp * 16 + g + 8 * i;
#pragma unroll
        for (int j = 0; j < BN / 8; ++j)
          *reinterpret_cast<uint32_t*>(Ks + Dm::P_PANEL * PANEL + swz128(r, 8 * j + 2 * t4)) =
              Elem<T>::pack(s[4 * j + 2 * i], s[4 * j + 2 * i + 1]);
        if (t4 == 0) {
          m_buf[wg * BM + r] = m_new[i];
          c_buf[wg * BM + r] = own_c[i];
        }
      }
      fence_proxy_async();  // P and the zeroed rows before wgmma reads them
      mbar_arrive(&ready[wg]);
    }

    // O += P V for the pair's tiles in order, each rescaled first
#pragma unroll
    for (int k = 0; k < 2; ++k) {
      const int n = n0 + k;
      if (n >= n_tiles) break;
      unsigned char* Ps = stage(k);
      mbar_wait(&ready[k], (n >> 1) & 1);
      const bool mine = n == own;
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int r = warp * 16 + g + 8 * i;
        const float c = mine ? own_c[i] : c_buf[k * BM + r];
        a.m_r[i] = m_buf[k * BM + r];
        a.l_r[i] = __fmaf_rn(a.l_r[i], c, mine ? own_rs[i] : 0.f);
#pragma unroll
        for (int b = 0; b < DVH / NB; ++b)
#pragma unroll
          for (int j = 0; j < NB / 8; ++j) {
            a.o[b][4 * j + 2 * i] = __fmul_rn(a.o[b][4 * j + 2 * i], c);
            a.o[b][4 * j + 2 * i + 1] = __fmul_rn(a.o[b][4 * j + 2 * i + 1], c);
          }
      }
#pragma unroll
      for (int b = 0; b < DVH / NB; ++b) fence_regs(a.o[b]);
      wgmma_fence();
#pragma unroll
      for (int b = 0; b < DVH / NB; ++b) {
        const unsigned char* Vs = Ps + (Dm::V_PANEL + (wg * DVH + b * NB) / 64) * PANEL;
#pragma unroll
        for (int kk = 0; kk < BN / 16; ++kk)
          wgmma_ss<T, NB, 0, 1>(a.o[b], Tile<BM, 64>::k_slice(Ps + Dm::P_PANEL * PANEL, 0, kk),
                                desc_mn(Vs + 16 * kk * 128, PANEL), 1);
      }
      wgmma_commit();
      wgmma_wait<0>();
#pragma unroll
      for (int b = 0; b < DVH / NB; ++b) fence_regs(a.o[b]);
      mbar_arrive(&empty[k]);
      if (issuer && n + 2 < n_tiles) {
        mbar_wait(&empty[k], (n >> 1) & 1);  // both warpgroups are done with tile n
        issue_keys(n + 2);
      }
    }
  }
}

// The row sums over both warpgroups: l[i] for this thread's rows warp * 16 +
// g + 8 i. A block barrier: both warpgroups are then past their last
// product, so the Q panels and the stages are free.
template <typename Dm>
__device__ __forceinline__ void mla_row_sums(MlaAcc<Dm>& a, unsigned char* smem,
                                             float (&l)[2]) {
  float* l_buf = reinterpret_cast<float*>(smem + MlaLayout<Dm>::X_OFF) + 4 * MLA_BM;
  const int tid = threadIdx.x;
  const int wg = tid >> 7;
  const int warp = (tid >> 5) & 3;
  const int g = (tid & 31) >> 2;
  const int t4 = tid & 3;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    a.l_r[i] = quad_sum(a.l_r[i]);
    if (t4 == 0) l_buf[wg * MLA_BM + warp * 16 + g + 8 * i] = a.l_r[i];
  }
  __syncthreads();
#pragma unroll
  for (int i = 0; i < 2; ++i)
    l[i] = a.l_r[i] + l_buf[(wg ^ 1) * MLA_BM + warp * 16 + g + 8 * i];
}

}  // namespace sm90
}  // namespace fa
