// The mma.sync backward tile loops of the block-sparse backward
// (csrc/flash_blocksparse.cu, B10); the dense and packed-varlen backward run
// on wgmma and TMA (csrc/bwd_sm90.cuh):
//
//  - dkdv_tile: 64 KV rows of one batch row and KV head loop over the
//    group's query heads and the q tiles of their listed band, keep dK and
//    dV in registers and write them once;
//  - dq_tile: 64 query rows of one batch row and head loop over the KV
//    tiles of their listed band and write dQ once.
//
// Each loop takes its tiles from a walk policy: the block-sparse kernel's
// lists.
//
// The transposed scores S^T = K Q^T are computed with the KV rows as the M
// dimension, so P^T and dS^T come out of the accumulators already in the
// A-operand layout of dV += P^T dO and dK += dS^T Q (the reuse the forward
// makes of S for P V). K, V, Q and dO stay in XOR-swizzled shared memory and
// reach the tensor cores through ldmatrix (.trans where the product needs
// the other orientation), so no operand is held in registers across the
// loop. Registers bound the tile: the dK and dV accumulators of a warp's 16
// KV rows take 2 x D / 2 fp32 registers a thread (128 at D = 128), before S
// and dP, so the q tile at D = 128 is 32 rows (FA_BWD_BM_D128).
// mma.sync.m16n8k16 with fp32 accumulation throughout. Only the tiles that
// cross the causal diagonal or the ragged end of the sequence run the mask.
//
// Conventions: softmax_scale is natural; lse is natural-log and -inf for a
// row that sees no key (its P is 0); delta = rowsum(dO * O) in fp32. Causal
// masking is bottom-right aligned (shift = sk - sq).
#pragma once

#include "common.cuh"

// q rows of a dK/dV tile at head dim 128. With 64, ptxas (CUDA 12.8) needs
// all 255 registers and spills 4-48 bytes; with 32 it uses 250-254 and
// spills nothing.
#ifndef FA_BWD_BM_D128
#define FA_BWD_BM_D128 32
#endif

namespace fa {

constexpr int BWD_THREADS = 128;
constexpr int KV_BN = 64;  // KV rows per dkdv tile (16 per warp)
constexpr int DQ_BM = 64;  // q rows per dq tile (16 per warp)
constexpr int DQ_BN = 64;  // keys per KV tile of the dq loop

template <int D>
constexpr int dkdv_bm() {
  return D == 128 ? FA_BWD_BM_D128 : 64;
}

template <typename T, int D, int BM>
constexpr int dkdv_smem_bytes() {
  return (2 * KV_BN + 2 * BM) * D * (int)sizeof(T) + 2 * BM * (int)sizeof(float);
}

template <typename T, int D>
constexpr int dq_smem_bytes() {
  return 2 * (DQ_BM + DQ_BN) * D * (int)sizeof(T);
}

// One batch row of sq query rows over sk keys. Pointers are at row 0 of
// the row: q, dout, dq, lse and delta at the first query head the tile
// works on, k, v, dk and dv at its KV head. Row strides are in elements; lse
// and delta rows are consecutive floats, their heads lse_sh apart. The
// gradients are written in TG (fp32 for the block-sparse backward).
template <typename T, typename TG = T>
struct BwdSeq {
  const T* q;
  const T* dout;
  const T* k;
  const T* v;
  const float* lse;
  const float* delta;
  TG* dq;
  TG* dk;
  TG* dv;
  int64_t q_ss, q_sh, do_ss, do_sh, k_ss, v_ss, dq_ss, dk_ss, dv_ss;
  int64_t lse_sh;
  int sq, sk;
};

struct BwdScalars {
  float scale, scale_log2;
  int causal, group;
};

// Copy rows [row0, row0 + ROWS) of one sequence and head into a swizzled
// shared tile; rows at or past `nrows` are zero-filled.
template <typename T, int D, int ROWS>
__device__ __forceinline__ void load_rows(T* tile, const T* base,
                                          int64_t row_stride, int row0,
                                          int nrows, int tid) {
  constexpr int CHUNKS = D / 8;
  static_assert(ROWS * CHUNKS % BWD_THREADS == 0, "tile / thread split");
#pragma unroll
  for (int i = 0; i < ROWS * CHUNKS / BWD_THREADS; ++i) {
    const int c = tid + i * BWD_THREADS;
    const int r = c / CHUNKS;
    const int ch = c % CHUNKS;
    const int gr = row0 + r;
    const bool ok = gr < nrows;
    const T* src = ok ? base + (int64_t)gr * row_stride + ch * 8 : base;
    cp_async_16(smem_addr(tile + swz<D>(r, ch)), src, ok ? 16 : 0);
  }
}

// A operand (16 x 16 at rows m0, depth k0) of a tile stored [m][k].
template <typename T, int D>
__device__ __forceinline__ void frag_a(uint32_t* r, const T* tile, int m0,
                                       int k0, int lane) {
  const int row = m0 + (lane & 7) + ((lane >> 3) & 1) * 8;
  ldmatrix_x4(r, smem_addr(tile + swz<D>(row, (k0 >> 3) + (lane >> 4))));
}

// B operands of the two n8 blocks n0..n0+15 at depth k0 of a tile stored
// [n][k] (B = tile^T): r[0..1] for n0, r[2..3] for n0 + 8.
template <typename T, int D>
__device__ __forceinline__ void frag_b(uint32_t* r, const T* tile, int n0,
                                       int k0, int lane) {
  const int row = n0 + (lane & 7) + (lane >> 4) * 8;
  ldmatrix_x4(r, smem_addr(tile + swz<D>(row, (k0 >> 3) + ((lane >> 3) & 1))));
}

// The same two B operands from a tile stored [k][n].
template <typename T, int D>
__device__ __forceinline__ void frag_b_trans(uint32_t* r, const T* tile, int k0,
                                             int n0, int lane) {
  const int row = k0 + (lane & 7) + ((lane >> 3) & 1) * 8;
  ldmatrix_x4_trans(r, smem_addr(tile + swz<D>(row, (n0 >> 3) + (lane >> 4))));
}

// Pack accumulator n8 blocks 2kk and 2kk + 1 into the A operand of a product
// over those 16 columns.
template <typename T>
__device__ __forceinline__ void acc_to_a(uint32_t* a, float (*c)[4], int kk) {
  using E = Elem<T>;
  a[0] = E::pack(c[2 * kk][0], c[2 * kk][1]);
  a[1] = E::pack(c[2 * kk][2], c[2 * kk][3]);
  a[2] = E::pack(c[2 * kk + 1][0], c[2 * kk + 1][1]);
  a[3] = E::pack(c[2 * kk + 1][2], c[2 * kk + 1][3]);
}

// Two adjacent gradient values, in the inputs' type or in fp32.
template <typename T>
__device__ __forceinline__ void store_pair(T* dst, float lo, float hi) {
  *reinterpret_cast<uint32_t*>(dst) = Elem<T>::pack(lo, hi);
}
__device__ __forceinline__ void store_pair(float* dst, float lo, float hi) {
  *reinterpret_cast<float2*>(dst) = make_float2(lo, hi);
}

// A q-tile walk (the block-sparse kernel's inverse list) gives count() q
// tiles in order, the n-th starting at row first_row(n), or at -1 for one
// the walk skips (the same for every thread of the block).

// lse in base 2 for the exponent; +inf for a row that sees no key or lies
// past the end, so that its P is exp2(-inf) = 0 and never NaN.
__device__ __forceinline__ float lse_log2(const float* lse_row, int row, int sq) {
  const float l = row < sq ? lse_row[row] : -INFINITY;
  return l == -INFINITY ? INFINITY : l * FA_LOG2E;
}

// dK and dV of KV rows [n0, n0 + 64) of one sequence and KV head, over the
// q tiles of `walk` (the block-sparse kernel's inverse list).
template <typename T, int D, int BM, typename TG, typename QWalk>
__device__ __forceinline__ void dkdv_tile(const BwdSeq<T, TG>& s, int n0,
                                          const QWalk& walk,
                                          const BwdScalars& c,
                                          unsigned char* smem) {
  using E = Elem<T>;
  constexpr int BN = KV_BN;
  T* Ks = reinterpret_cast<T*>(smem);
  T* Vs = Ks + BN * D;
  T* Qs = Vs + BN * D;
  T* dOs = Qs + BM * D;
  float* lse_s = reinterpret_cast<float*>(dOs + BM * D);
  float* delta_s = lse_s + BM;

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int g = lane >> 2;
  const int t4 = lane & 3;
  const int shift = s.sk - s.sq;
  const int kv_row0 = n0 + warp * 16 + g;  // rows kv_row0 and kv_row0 + 8

  load_rows<T, D, BN>(Ks, s.k, s.k_ss, n0, s.sk, tid);
  load_rows<T, D, BN>(Vs, s.v, s.v_ss, n0, s.sk, tid);
  cp_async_commit();

  const int m_tiles = walk.count();

  float dk[D / 8][4];
  float dv[D / 8][4];
#pragma unroll
  for (int i = 0; i < D / 8; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk[i][e] = dv[i][e] = 0.f;

  for (int gi = 0; gi < c.group; ++gi) {
    const T* qg = s.q + gi * s.q_sh;
    const T* dog = s.dout + gi * s.do_sh;
    const float* lse_g = s.lse + gi * s.lse_sh;
    const float* delta_g = s.delta + gi * s.lse_sh;

    for (int mt = 0; mt < m_tiles; ++mt) {
      const int m0 = walk.first_row(mt);
      if (m0 < 0) continue;
      __syncthreads();  // every warp is done with the previous Q/dO/dS tiles
      load_rows<T, D, BM>(Qs, qg, s.q_ss, m0, s.sq, tid);
      cp_async_commit();
      load_rows<T, D, BM>(dOs, dog, s.do_ss, m0, s.sq, tid);
      cp_async_commit();
      if (tid < BM) {
        lse_s[tid] = lse_log2(lse_g, m0 + tid, s.sq);
        delta_s[tid] = m0 + tid < s.sq ? delta_g[m0 + tid] : 0.f;
      }
      cp_async_wait<1>();  // K, V and Q have landed; dO may be in flight
      __syncthreads();

      // S^T = K Q^T: this warp's 16 KV rows by the tile's BM q columns.
      float sc[BM / 8][4];
#pragma unroll
      for (int i = 0; i < BM / 8; ++i) sc[i][0] = sc[i][1] = sc[i][2] = sc[i][3] = 0.f;
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        uint32_t ka[4];
        frag_a<T, D>(ka, Ks, warp * 16, kk * 16, lane);
#pragma unroll
        for (int np = 0; np < BM / 16; ++np) {
          uint32_t qb[4];
          frag_b<T, D>(qb, Qs, np * 16, kk * 16, lane);
          E::mma(sc[2 * np], ka, qb[0], qb[1]);
          E::mma(sc[2 * np + 1], ka, qb[2], qb[3]);
        }
      }

      // P^T = exp(S^T * scale - lse), masked on the diagonal and ragged tiles.
      const bool need_mask = (c.causal && n0 + BN - 1 > m0 + shift) ||
                             n0 + BN > s.sk || m0 + BM > s.sq;
#pragma unroll
      for (int nb = 0; nb < BM / 8; ++nb) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int col = nb * 8 + 2 * t4 + (e & 1);
          float x = fmaf(sc[nb][e], c.scale_log2, -lse_s[col]);
          if (need_mask) {
            const int kv = kv_row0 + (e >> 1) * 8;
            const int qrow = m0 + col;
            const bool ok = kv < s.sk && qrow < s.sq &&
                            (!c.causal || kv <= qrow + shift);
            x = ok ? x : -INFINITY;
          }
          sc[nb][e] = exp2f(x);
        }
      }

      cp_async_wait<0>();
      __syncthreads();

      // dV += P^T dO
#pragma unroll
      for (int kk = 0; kk < BM / 16; ++kk) {
        uint32_t pa[4];
        acc_to_a<T>(pa, sc, kk);
#pragma unroll
        for (int dp = 0; dp < D / 16; ++dp) {
          uint32_t ob[4];
          frag_b_trans<T, D>(ob, dOs, kk * 16, dp * 16, lane);
          E::mma(dv[2 * dp], pa, ob[0], ob[1]);
          E::mma(dv[2 * dp + 1], pa, ob[2], ob[3]);
        }
      }

      // dP^T = V dO^T
      float ds[BM / 8][4];
#pragma unroll
      for (int i = 0; i < BM / 8; ++i) ds[i][0] = ds[i][1] = ds[i][2] = ds[i][3] = 0.f;
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        uint32_t va[4];
        frag_a<T, D>(va, Vs, warp * 16, kk * 16, lane);
#pragma unroll
        for (int np = 0; np < BM / 16; ++np) {
          uint32_t ob[4];
          frag_b<T, D>(ob, dOs, np * 16, kk * 16, lane);
          E::mma(ds[2 * np], va, ob[0], ob[1]);
          E::mma(ds[2 * np + 1], va, ob[2], ob[3]);
        }
      }

      // dS^T = P^T (dP^T - delta)
#pragma unroll
      for (int nb = 0; nb < BM / 8; ++nb) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int col = nb * 8 + 2 * t4 + (e & 1);
          ds[nb][e] = sc[nb][e] * (ds[nb][e] - delta_s[col]);
        }
      }

      // dK += dS^T Q (scaled once at the end)
#pragma unroll
      for (int kk = 0; kk < BM / 16; ++kk) {
        uint32_t da[4];
        acc_to_a<T>(da, ds, kk);
#pragma unroll
        for (int dp = 0; dp < D / 16; ++dp) {
          uint32_t qb[4];
          frag_b_trans<T, D>(qb, Qs, kk * 16, dp * 16, lane);
          E::mma(dk[2 * dp], da, qb[0], qb[1]);
          E::mma(dk[2 * dp + 1], da, qb[2], qb[3]);
        }
      }
    }
  }
  cp_async_wait<0>();  // no copy is left in flight when no q tile was walked

  // Epilogue: dK (scaled) and dV in the inputs' type, rows past sk skipped.
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = kv_row0 + i * 8;
    if (row >= s.sk) continue;
    TG* dkg = s.dk + (int64_t)row * s.dk_ss;
    TG* dvg = s.dv + (int64_t)row * s.dv_ss;
#pragma unroll
    for (int db = 0; db < D / 8; ++db) {
      store_pair(dkg + db * 8 + 2 * t4, dk[db][2 * i] * c.scale,
                 dk[db][2 * i + 1] * c.scale);
      store_pair(dvg + db * 8 + 2 * t4, dv[db][2 * i], dv[db][2 * i + 1]);
    }
  }
}

// dQ of query rows [m0, m0 + 64) of one sequence and head, over the key
// tiles of `walk` (the block-sparse kernel's list).
template <typename T, int D, typename TG, typename Walk>
__device__ __forceinline__ void dq_tile(const BwdSeq<T, TG>& s, int m0,
                                        const Walk& walk,
                                        const BwdScalars& c,
                                        unsigned char* smem) {
  using E = Elem<T>;
  constexpr int BM = DQ_BM;
  constexpr int BN = DQ_BN;
  T* Qs = reinterpret_cast<T*>(smem);
  T* dOs = Qs + BM * D;
  T* Ks = dOs + BM * D;
  T* Vs = Ks + BN * D;

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int g = lane >> 2;
  const int t4 = lane & 3;
  const int shift = s.sk - s.sq;
  const int row0 = m0 + warp * 16 + g;  // rows row0 and row0 + 8

  load_rows<T, D, BM>(Qs, s.q, s.q_ss, m0, s.sq, tid);
  load_rows<T, D, BM>(dOs, s.dout, s.do_ss, m0, s.sq, tid);
  cp_async_commit();

  float lse2[2], delta[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = row0 + i * 8;
    lse2[i] = lse_log2(s.lse, row, s.sq);
    delta[i] = row < s.sq ? s.delta[row] : 0.f;
  }

  const int n_tiles = walk.count();

  float dq[D / 8][4];
#pragma unroll
  for (int i = 0; i < D / 8; ++i) dq[i][0] = dq[i][1] = dq[i][2] = dq[i][3] = 0.f;

  for (int n = 0; n < n_tiles; ++n) {
    const int n0 = walk.first_key(n);
    if (n0 < 0) continue;
    __syncthreads();  // every warp is done with the previous K/V tile
    load_rows<T, D, BN>(Ks, s.k, s.k_ss, n0, s.sk, tid);
    cp_async_commit();
    load_rows<T, D, BN>(Vs, s.v, s.v_ss, n0, s.sk, tid);
    cp_async_commit();
    cp_async_wait<1>();  // K (and Q, dO) have landed; V may be in flight
    __syncthreads();

    // S = Q K^T
    float sc[BN / 8][4];
#pragma unroll
    for (int i = 0; i < BN / 8; ++i) sc[i][0] = sc[i][1] = sc[i][2] = sc[i][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      uint32_t qa[4];
      frag_a<T, D>(qa, Qs, warp * 16, kk * 16, lane);
#pragma unroll
      for (int np = 0; np < BN / 16; ++np) {
        uint32_t kb[4];
        frag_b<T, D>(kb, Ks, np * 16, kk * 16, lane);
        E::mma(sc[2 * np], qa, kb[0], kb[1]);
        E::mma(sc[2 * np + 1], qa, kb[2], kb[3]);
      }
    }

    // P = exp(S * scale - lse), masked on the diagonal and ragged tiles.
    const bool need_mask = (c.causal && n0 + BN - 1 > m0 + shift) || n0 + BN > s.sk;
#pragma unroll
    for (int nb = 0; nb < BN / 8; ++nb) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float x = fmaf(sc[nb][e], c.scale_log2, -lse2[e >> 1]);
        if (need_mask) {
          const int col = n0 + nb * 8 + 2 * t4 + (e & 1);
          const int row = row0 + (e >> 1) * 8;
          const bool ok = col < s.sk && (!c.causal || col <= row + shift);
          x = ok ? x : -INFINITY;
        }
        sc[nb][e] = exp2f(x);
      }
    }

    cp_async_wait<0>();
    __syncthreads();

    // dP = dO V^T
    float ds[BN / 8][4];
#pragma unroll
    for (int i = 0; i < BN / 8; ++i) ds[i][0] = ds[i][1] = ds[i][2] = ds[i][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      uint32_t oa[4];
      frag_a<T, D>(oa, dOs, warp * 16, kk * 16, lane);
#pragma unroll
      for (int np = 0; np < BN / 16; ++np) {
        uint32_t vb[4];
        frag_b<T, D>(vb, Vs, np * 16, kk * 16, lane);
        E::mma(ds[2 * np], oa, vb[0], vb[1]);
        E::mma(ds[2 * np + 1], oa, vb[2], vb[3]);
      }
    }

    // dS = P (dP - delta); dQ += dS K
#pragma unroll
    for (int nb = 0; nb < BN / 8; ++nb) {
#pragma unroll
      for (int e = 0; e < 4; ++e) ds[nb][e] = sc[nb][e] * (ds[nb][e] - delta[e >> 1]);
    }
#pragma unroll
    for (int kk = 0; kk < BN / 16; ++kk) {
      uint32_t da[4];
      acc_to_a<T>(da, ds, kk);
#pragma unroll
      for (int dp = 0; dp < D / 16; ++dp) {
        uint32_t kb[4];
        frag_b_trans<T, D>(kb, Ks, kk * 16, dp * 16, lane);
        E::mma(dq[2 * dp], da, kb[0], kb[1]);
        E::mma(dq[2 * dp + 1], da, kb[2], kb[3]);
      }
    }
  }
  cp_async_wait<0>();  // no copy is left in flight when no KV tile was walked

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = row0 + i * 8;
    if (row >= s.sq) continue;
    TG* dqg = s.dq + (int64_t)row * s.dq_ss;
#pragma unroll
    for (int db = 0; db < D / 8; ++db) {
      store_pair(dqg + db * 8 + 2 * t4, dq[db][2 * i] * c.scale,
                 dq[db][2 * i + 1] * c.scale);
    }
  }
}

}  // namespace fa
