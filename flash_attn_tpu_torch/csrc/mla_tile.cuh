// The absorbed-MLA tile loop shared by the MLA decode route
// (csrc/flash_decode_mla.cu) and the paged chunked prefill
// (csrc/flash_paged_prefill.cu): one block of 8 warps computes 64 packed
// query rows of one sequence and KV head against a range of its keys, with
// a second query `qv` that scores against V, and a value width DV that
// differs from the key width D.
//
// Rows are (query position, head) pairs with the heads fastest: row
// pos * group + j is position pos of query head kh * group + j (the GQA row
// packing of the TPU kernels). With DeepSeek's 128 heads on one KV head, a
// tile is 64 heads of one position, so the whole tile shares one causal
// limit.
//
// Scores are S = Q K^T + QV V^T, computed as one product of depth
// DQK = D + DV over a shared-memory key tile whose row is K's row followed
// by V's row ([q | qv] . [k | v]^T). Without qv the kernels take DeepSeek's
// latent cache as it is stored: K 576 wide and V its first 512 columns, so
// the key tile holds K alone and V is read from its first DV columns. Either
// way each key's bytes cross from device memory once (1,152 bytes a key at
// 64 + 512 in bf16) and feed both products.
//
// Work split: warps 2p and 2p + 1 own rows 16p .. 16p + 15. For S, warp
// 2p + hh takes keys 32 hh .. 32 hh + 31 of the tile at the full depth, so
// no score is computed twice; for O += P V it takes output columns
// hh * DV / 2 .. (hh + 1) * DV / 2 (a 16 x 256 fp32 accumulator, 128
// registers a thread at DV = 512). The pair exchanges its row maxima and
// its P fragments (bf16, already in the mma A-operand layout) through
// shared memory under a named barrier of 64 threads; each warp starts
// P V on its own keys before it waits for its partner's.
//
// Q stays in shared memory (its 16 x 576 fragments would not fit in
// registers beside O) and is read with ldmatrix at every key tile; the key
// tiles are double-buffered through cp.async, the next one in flight while
// the current one is used. At DQK = 576 the Q tile and two key tiles take
// 216 KB of the 227 KB a block may have. Both products run on the tensor
// cores with mma.sync.m16n8k16 in fp32; the online softmax uses exp2 with
// softmax_scale * log2(e) folded into one multiply, as fwd_tile.cuh does.
//
// Key rows load one per thread quad: four threads share a row and take its
// 16-byte chunks in turn, so each thread resolves its row's address (a
// linear cache row, or row key % page_size of page table[key / page_size])
// once per tile, whatever the page size.
#pragma once

#include <limits.h>

#include "common.cuh"

namespace fa {

constexpr int MLA_BM = 64;  // packed query rows per tile
constexpr int MLA_BN = 64;  // keys per key tile
constexpr int MLA_WARPS = 8;
constexpr int MLA_THREADS = MLA_WARPS * 32;

// The (D, DV, qv) forms the kernels are compiled for.
template <int D_, int DV_, bool QV_>
struct MlaDims {
  static constexpr int D = D_;
  static constexpr int DV = DV_;
  static constexpr bool QV = QV_;
  static constexpr int DQK = QV ? D + DV : D;  // score depth = tile row width
  static constexpr int V_OFF = QV ? D : 0;     // V's first column in a key row
  static constexpr int DVH = DV / 2;           // output columns per warp
  static_assert(QV || DV <= D, "without qv, V is K's first DV columns");
  static_assert(DQK % 64 == 0, "the swizzle wants rows of 8-chunk groups");
  static_assert(D % 32 == 0, "K and V chunks split on a quad boundary");
  static_assert(DVH % 16 == 0, "P V runs on 16-column pairs of n8 tiles");
};

template <typename Dims, typename T>
constexpr int mla_smem_bytes() {
  return (MLA_BM + 2 * MLA_BN) * Dims::DQK * (int)sizeof(T)  // Q, 2 key tiles
         + MLA_WARPS * 2 * 32 * 16                           // P exchange
         + MLA_WARPS * 16 * 4;                               // row exchange
}

// Calls f(Form{}) for the one of `Forms` (MlaDims types) that matches (d,
// dv, qv) and returns its result; cudaErrorInvalidValue for a form not in
// the list. Each kernel passes its own list, so only those forms are
// compiled; the Python side lists the same forms (dispatch/config.py
// MLA_DECODE_DIMS, PAGED_PREFILL_DIMS).
template <typename... Forms, typename F>
cudaError_t mla_dispatch(int d, int dv, bool qv, F&& f) {
  cudaError_t err = cudaErrorInvalidValue;
  (void)((Forms::D == d && Forms::DV == dv && Forms::QV == qv
              ? (err = f(Forms{}), true)
              : false) || ...);
  return err;
}

// One tile of work. The pointers sit at the first token of the sequence and
// at the KV head's first query head; row pos * group + j reads
// q + pos * q_st + j * q_sh and writes out + pos * o_st + j * o_sh and
// lse[pos * l_st + j * l_sh]. Rows at or past `rows` are neither read nor
// written.
template <typename T>
struct MlaTile {
  const T* q;
  const T* qv;  // QV only
  void* out;    // fp32 (the decode's split partials) or T
  float* lse;
  int64_t q_st, q_sh, qv_st, qv_sh, o_st, o_sh, l_st, l_sh;
  int group;  // query heads per KV head
  int rows;   // live rows of the sequence: query positions * group
  int m0;     // first row of the tile
  int shift;  // causal: position pos sees keys <= pos + shift
  int causal;
  int k_lo, k_hi;  // the block's keys; k_lo a multiple of MLA_BN
};

// Where key position `key` of one batch row and KV head lives: row key of
// linear cache row `bb`, or row key % page_size of page table_row[key /
// page_size] (the column clamped to the table, the page to the pool).
template <typename T>
struct MlaCache {
  const T* k;  // at the KV head of page (or batch row) 0
  const T* v;  // QV only
  int64_t k_sb, k_ss, v_sb, v_ss;  // page (or batch-row) and row strides
  const int* table_row;            // nullptr: a linear cache
  int bb, page_size, table_width, num_pages;

  __device__ __forceinline__ void locate(int key, int64_t& k_off,
                                         int64_t& v_off) const {
    if (table_row == nullptr) {
      k_off = bb * k_sb + (int64_t)key * k_ss;
      v_off = bb * v_sb + (int64_t)key * v_ss;
      return;
    }
    const int col = key / page_size;
    const int pg = min(max(table_row[min(col, table_width - 1)], 0),
                       num_pages - 1);
    const int row = key - col * page_size;
    k_off = pg * k_sb + (int64_t)row * k_ss;
    v_off = pg * v_sb + (int64_t)row * v_ss;
  }
};

__device__ __forceinline__ void pair_sync(int pair) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(1 + pair), "r"(64));
}

template <typename T, typename Dims, bool OUT_F32>
__device__ __forceinline__ void mla_tile(const MlaTile<T>& t,
                                         const MlaCache<T>& c,
                                         float scale_log2,
                                         unsigned char* smem) {
  using E = Elem<T>;
  constexpr int W = Dims::DQK;
  constexpr int D = Dims::D;
  constexpr int DVH = Dims::DVH;
  constexpr int CH_PER_THREAD = W / 32;  // 16-byte chunks of a row per thread
  T* Qs = reinterpret_cast<T*>(smem);
  T* Ks0 = Qs + MLA_BM * W;
  uint4* Xp = reinterpret_cast<uint4*>(Ks0 + 2 * MLA_BN * W);
  float* Xm = reinterpret_cast<float*>(Xp + MLA_WARPS * 2 * 32);

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int g = lane >> 2;
  const int t4 = lane & 3;
  const int pair = warp >> 1;
  const int hh = warp & 1;
  const int lr = tid >> 2;  // the tile row this thread's quad loads
  const int lc = tid & 3;   // its first chunk

  // The tile's keys: up to the causal limit of its last live row.
  const int r_end = min(t.m0 + MLA_BM, t.rows);
  const int lim_last = t.causal ? (r_end - 1) / t.group + t.shift : INT_MAX - 1;
  const int k_end = min(t.k_hi, lim_last + 1);
  const int n_tiles = k_end > t.k_lo ? (k_end - t.k_lo + MLA_BN - 1) / MLA_BN : 0;
  // the smallest limit in the tile (-1 if a row of it is dead)
  const int lim_first = r_end < t.m0 + MLA_BM ? -1
                        : t.causal ? t.m0 / t.group + t.shift : INT_MAX - 1;

  // Q tile: q's D columns, then qv's DV columns; dead rows zero-filled.
  {
    const int row = t.m0 + lr;
    const bool ok = row < t.rows;
    const int pos = ok ? row / t.group : 0;
    const int j = ok ? row % t.group : 0;
    const T* qrow = t.q + pos * t.q_st + j * t.q_sh;
    const T* qvrow = Dims::QV ? t.qv + pos * t.qv_st + j * t.qv_sh : t.q;
#pragma unroll
    for (int i = 0; i < CH_PER_THREAD; ++i) {
      const int ch = lc + 4 * i;
      const T* src = (!Dims::QV || 4 * i < D / 8) ? qrow + ch * 8
                                                   : qvrow + (ch - D / 8) * 8;
      cp_async_16(smem_addr(Qs + swz<W>(lr, ch)), ok ? src : t.q, ok ? 16 : 0);
    }
  }
  cp_async_commit();

  // Key tile n0 into stage `stage`: K's D columns, then (QV) V's DV columns;
  // keys at or past k_hi zero-filled (their V rows meet P = 0).
  auto load_keys = [&](int stage, int n0) {
    T* Ks = Ks0 + stage * MLA_BN * W;
    const int key = n0 + lr;
    const bool ok = key < t.k_hi;
    int64_t k_off = 0, v_off = 0;
    if (ok) c.locate(key, k_off, v_off);
    const T* krow = c.k + k_off;
    const T* vrow = Dims::QV ? c.v + v_off : c.k;
#pragma unroll
    for (int i = 0; i < CH_PER_THREAD; ++i) {
      const int ch = lc + 4 * i;
      const T* src = (!Dims::QV || 4 * i < D / 8) ? krow + ch * 8
                                                   : vrow + (ch - D / 8) * 8;
      cp_async_16(smem_addr(Ks + swz<W>(lr, ch)), ok ? src : c.k, ok ? 16 : 0);
    }
  };

  if (n_tiles > 0) load_keys(0, t.k_lo);
  cp_async_commit();

  int lim[2];  // the last key each of this lane's two rows may see
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = t.m0 + pair * 16 + g + 8 * i;
    lim[i] = row >= t.rows ? -1
             : t.causal ? row / t.group + t.shift : INT_MAX - 1;
  }

  float o[DVH / 8][4];
#pragma unroll
  for (int i = 0; i < DVH / 8; ++i) o[i][0] = o[i][1] = o[i][2] = o[i][3] = 0.f;
  float m_r[2] = {-INFINITY, -INFINITY};  // running max, base 2 (pair-wide)
  float l_r[2] = {0.f, 0.f};              // this lane's share of its keys' sum

  const int q_row = pair * 16 + (lane & 7) + ((lane >> 3) & 1) * 8;
  const int v_chunk0 = (Dims::V_OFF + hh * DVH) / 8;

  for (int n = 0; n < n_tiles; ++n) {
    const int n0 = t.k_lo + n * MLA_BN;
    cp_async_wait<0>();
    __syncthreads();  // tile n landed; every warp is done with tile n - 1
    if (n + 1 < n_tiles) load_keys((n + 1) & 1, n0 + MLA_BN);
    cp_async_commit();
    const T* Ks = Ks0 + (n & 1) * MLA_BN * W;

    // S for this warp's 16 rows and 32 keys, at the full depth.
    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i) s[i][0] = s[i][1] = s[i][2] = s[i][3] = 0.f;
#pragma unroll 4
    for (int kk = 0; kk < W / 16; ++kk) {
      uint32_t qa[4];
      ldmatrix_x4(qa, smem_addr(Qs + swz<W>(q_row, kk * 2 + (lane >> 4))));
#pragma unroll
      for (int np = 0; np < 2; ++np) {
        uint32_t kb[4];
        const int r = hh * 32 + np * 16 + (lane & 7) + (lane >> 4) * 8;
        ldmatrix_x4(kb, smem_addr(Ks + swz<W>(r, kk * 2 + ((lane >> 3) & 1))));
        E::mma(s[2 * np], qa, kb[0], kb[1]);
        E::mma(s[2 * np + 1], qa, kb[2], kb[3]);
      }
    }

    const int c0 = n0 + hh * 32;  // this warp's first key
    const bool need_mask = (n0 + MLA_BN - 1 > lim_first) || (n0 + MLA_BN > t.k_hi);
#pragma unroll
    for (int nb = 0; nb < 4; ++nb) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float x = __fmul_rn(s[nb][e], scale_log2);
        if (need_mask) {
          const int col = c0 + nb * 8 + 2 * t4 + (e & 1);
          x = (col < t.k_hi && col <= lim[e >> 1]) ? x : -INFINITY;
        }
        s[nb][e] = x;
      }
    }

    // Row maxima over the pair's 64 keys.
    float mx[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      float v = -INFINITY;
#pragma unroll
      for (int nb = 0; nb < 4; ++nb)
        v = fmaxf(v, fmaxf(s[nb][2 * i], s[nb][2 * i + 1]));
      mx[i] = quad_max(v);
    }
    if (t4 == 0) {
      Xm[warp * 16 + g] = mx[0];
      Xm[warp * 16 + g + 8] = mx[1];
    }
    pair_sync(pair);
#pragma unroll
    for (int i = 0; i < 2; ++i)
      mx[i] = fmaxf(mx[i], Xm[(warp ^ 1) * 16 + g + 8 * i]);

    // Online softmax: both warps of the pair hold the same running max.
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const float m_new = fmaxf(m_r[i], mx[i]);
      const float m_safe = m_new == -INFINITY ? 0.f : m_new;
      const float corr = exp2f(m_r[i] - m_safe);
      m_r[i] = m_new;
      float rs = 0.f;
#pragma unroll
      for (int nb = 0; nb < 4; ++nb) {
        s[nb][2 * i] = exp2f(s[nb][2 * i] - m_safe);
        s[nb][2 * i + 1] = exp2f(s[nb][2 * i + 1] - m_safe);
        rs += s[nb][2 * i] + s[nb][2 * i + 1];
      }
      l_r[i] = __fmaf_rn(l_r[i], corr, rs);
#pragma unroll
      for (int db = 0; db < DVH / 8; ++db) {
        o[db][2 * i] *= corr;
        o[db][2 * i + 1] *= corr;
      }
    }

    // P of this warp's keys as A fragments (2 k-steps of 16 keys), shared
    // with the partner.
    uint32_t pa[2][4];
#pragma unroll
    for (int kk = 0; kk < 2; ++kk) {
      pa[kk][0] = E::pack(s[2 * kk][0], s[2 * kk][1]);
      pa[kk][1] = E::pack(s[2 * kk][2], s[2 * kk][3]);
      pa[kk][2] = E::pack(s[2 * kk + 1][0], s[2 * kk + 1][1]);
      pa[kk][3] = E::pack(s[2 * kk + 1][2], s[2 * kk + 1][3]);
      Xp[(warp * 2 + kk) * 32 + lane] =
          make_uint4(pa[kk][0], pa[kk][1], pa[kk][2], pa[kk][3]);
    }

    // O += P V over this warp's keys, then over the partner's.
    auto pv = [&](const uint32_t* a, int key0) {
#pragma unroll
      for (int dp = 0; dp < DVH / 16; ++dp) {
        uint32_t vb[4];
        const int r = key0 + (lane & 7) + ((lane >> 3) & 1) * 8;
        ldmatrix_x4_trans(vb, smem_addr(Ks + swz<W>(r, v_chunk0 + dp * 2 + (lane >> 4))));
        E::mma(o[2 * dp], a, vb[0], vb[1]);
        E::mma(o[2 * dp + 1], a, vb[2], vb[3]);
      }
    };
#pragma unroll
    for (int kk = 0; kk < 2; ++kk) pv(pa[kk], hh * 32 + kk * 16);
    pair_sync(pair);
#pragma unroll
    for (int kk = 0; kk < 2; ++kk) {
      const uint4 u = Xp[((warp ^ 1) * 2 + kk) * 32 + lane];
      const uint32_t pb[4] = {u.x, u.y, u.z, u.w};
      pv(pb, (hh ^ 1) * 32 + kk * 16);
    }
  }
  cp_async_wait<0>();  // a tile without keys still started its Q copy

  // The row sums over the pair, then normalise and write.
  float l[2] = {quad_sum(l_r[0]), quad_sum(l_r[1])};
  if (t4 == 0) {
    Xm[warp * 16 + g] = l[0];
    Xm[warp * 16 + g + 8] = l[1];
  }
  pair_sync(pair);
#pragma unroll
  for (int i = 0; i < 2; ++i) l[i] += Xm[(warp ^ 1) * 16 + g + 8 * i];

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = t.m0 + pair * 16 + g + 8 * i;
    if (row >= t.rows) continue;
    const int pos = row / t.group;
    const int j = row % t.group;
    const float inv = l[i] == 0.f ? 0.f : 1.f / l[i];
    const int64_t off = pos * t.o_st + j * t.o_sh + hh * DVH + 2 * t4;
#pragma unroll
    for (int db = 0; db < DVH / 8; ++db) {
      const float a = o[db][2 * i] * inv, b = o[db][2 * i + 1] * inv;
      if constexpr (OUT_F32) {
        *reinterpret_cast<float2*>(reinterpret_cast<float*>(t.out) + off + db * 8) =
            make_float2(a, b);
      } else {
        *reinterpret_cast<uint32_t*>(reinterpret_cast<T*>(t.out) + off + db * 8) =
            E::pack(a, b);
      }
    }
    if (hh == 0 && t4 == 0)
      t.lse[pos * t.l_st + j * t.l_sh] =
          l[i] == 0.f ? -INFINITY : __fmaf_rn(m_r[i], FA_LN2, logf(l[i]));
  }
}

}  // namespace fa
