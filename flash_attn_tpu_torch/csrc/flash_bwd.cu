// Dense attention backward for Hopper (sm_90a), bf16 / fp16, head dim 64 or 128.
//
// Replaces the TPU kernels flash_attn_tpu/kernels/flash_bwd.py:_dkdv_kernel
// and :_dq_kernel (the deterministic two-kernel backward),
// flash_attn_tpu/kernels/flash_bwd_fused.py:_bwd_fused_kernel (the fused
// single pass) and flash_attn_tpu/kernels/flash_bwd_split.py:
// _bwd_diag_merge_kernel (the causal diagonal as a second launch). Here:
//
//  - dkdv_kernel<ACCUM_DQ = false>: one block per (KV tile, KV head, batch)
//    loops over the group's query heads and the q tiles of its causal band,
//    keeps dK and dV in registers and writes them once (deterministic);
//  - dq_kernel: one block per (q tile, head, batch) loops over the KV tiles
//    of its band and writes dQ once (deterministic);
//  - dkdv_kernel<ACCUM_DQ = true>: the fused single pass, five products per
//    tile, dQ added into a zeroed fp32 buffer with atomics. Unlike the TPU's
//    fused kernel, which kept full-sequence accumulators in VMEM, this one is
//    not deterministic: the order of the atomic adds varies.
//
// Only the tiles that cross the causal diagonal or the ragged end of the
// sequences run the mask (what the TPU split into _bwd_diag_merge_kernel).
//
// What bounds it on this card: per (q tile, KV tile) pair the two-kernel
// form does 7 tile products (S and dP twice) and the fused form 5, against
// 2 in the forward, so the backward is tensor-core bound at the training
// shape (s = 2048: ~2.5 x the forward's flops). Registers bound the tile:
// the dK and dV accumulators of a warp's 16 KV rows take 2 x D / 2 fp32
// registers a thread (128 at D = 128), before S and dP.
//
// What the design does about it: the transposed scores S^T = K Q^T are
// computed with the KV rows as the M dimension, so P^T and dS^T come out of
// the accumulators already in the A-operand layout of dV += P^T dO and
// dK += dS^T Q (the reuse the forward makes of S for P V). K, V, Q and dO
// stay in XOR-swizzled shared memory and reach the tensor cores through
// ldmatrix (.trans where the product needs the other orientation), so no
// operand is held in registers across the loop. The q tile at D = 128 is
// 32 rows so that nothing spills (FA_BWD_BM_D128). The fused form stages dS^T
// in padded shared memory and reads dS back with ldmatrix.trans for
// dQ = dS K. mma.sync.m16n8k16 with fp32 accumulation throughout; wgmma,
// TMA and pipelining are left for later work.
//
// Conventions: softmax_scale is natural; lse is natural-log (b, h, sq) and
// -inf for a row that sees no key (its P is 0); delta = rowsum(dO * O) in
// fp32 (b, h, sq). Causal masking is bottom-right aligned (shift = sk - sq).

#include "common.cuh"

// q rows of a dK/dV tile at head dim 128. With 64, ptxas (CUDA 12.8) needs
// all 255 registers and spills 4-48 bytes; with 32 it uses 250-254 and
// spills nothing.
#ifndef FA_BWD_BM_D128
#define FA_BWD_BM_D128 32
#endif

namespace {

constexpr int NWARPS = 4;
constexpr int NTHREADS = NWARPS * 32;
constexpr int KV_BN = 64;  // KV rows per dkdv block (16 per warp)
constexpr int DQ_BM = 64;  // q rows per dq block (16 per warp)
constexpr int DQ_BN = 64;  // keys per KV tile of the dq kernel

template <int D>
constexpr int dkdv_bm() {
  return D == 128 ? FA_BWD_BM_D128 : 64;
}

struct BwdParams {
  const void* q;
  const void* k;
  const void* v;
  const void* dout;
  const float* lse;    // (b, h, sq)
  const float* delta;  // (b, h, sq)
  void* dq;            // dq kernel: (b, sq, h, d) in q's type
  void* dk;
  void* dv;
  float* dq_accum;     // fused dkdv: (b, sq, h, d) fp32, zeroed
  int64_t q_sb, q_ss, q_sh;
  int64_t k_sb, k_ss, k_sh;
  int64_t v_sb, v_ss, v_sh;
  int64_t do_sb, do_ss, do_sh;
  int64_t dq_sb, dq_ss, dq_sh;
  int64_t dk_sb, dk_ss, dk_sh;
  int64_t dv_sb, dv_ss, dv_sh;
  int sq, sk, h, group;
  float scale, scale_log2;
  int causal;
};

// Copy rows [row0, row0 + ROWS) of one (batch, head) slice into a swizzled
// shared tile; rows at or past `nrows` are zero-filled.
template <typename T, int D, int ROWS>
__device__ __forceinline__ void load_tile(T* tile, const T* base,
                                          int64_t row_stride, int row0,
                                          int nrows, int tid) {
  constexpr int CHUNKS = D / 8;
  static_assert(ROWS * CHUNKS % NTHREADS == 0, "tile / thread split");
#pragma unroll
  for (int i = 0; i < ROWS * CHUNKS / NTHREADS; ++i) {
    const int c = tid + i * NTHREADS;
    const int r = c / CHUNKS;
    const int ch = c % CHUNKS;
    const int gr = row0 + r;
    const bool ok = gr < nrows;
    const T* src = ok ? base + (int64_t)gr * row_stride + ch * 8 : base;
    fa::cp_async_16(fa::smem_addr(tile + fa::swz<D>(r, ch)), src, ok ? 16 : 0);
  }
}

// A operand (16 x 16 at rows m0, depth k0) of a tile stored [m][k].
template <typename T, int D>
__device__ __forceinline__ void frag_a(uint32_t* r, const T* tile, int m0,
                                       int k0, int lane) {
  const int row = m0 + (lane & 7) + ((lane >> 3) & 1) * 8;
  fa::ldmatrix_x4(r, fa::smem_addr(tile + fa::swz<D>(row, (k0 >> 3) + (lane >> 4))));
}

// B operands of the two n8 blocks n0..n0+15 at depth k0 of a tile stored
// [n][k] (B = tile^T): r[0..1] for n0, r[2..3] for n0 + 8.
template <typename T, int D>
__device__ __forceinline__ void frag_b(uint32_t* r, const T* tile, int n0,
                                       int k0, int lane) {
  const int row = n0 + (lane & 7) + (lane >> 4) * 8;
  fa::ldmatrix_x4(r, fa::smem_addr(tile + fa::swz<D>(row, (k0 >> 3) + ((lane >> 3) & 1))));
}

// The same two B operands from a tile stored [k][n].
template <typename T, int D>
__device__ __forceinline__ void frag_b_trans(uint32_t* r, const T* tile, int k0,
                                             int n0, int lane) {
  const int row = k0 + (lane & 7) + ((lane >> 3) & 1) * 8;
  fa::ldmatrix_x4_trans(r, fa::smem_addr(tile + fa::swz<D>(row, (n0 >> 3) + (lane >> 4))));
}

// A operand (16 x 16 at rows m0, depth k0) of a padded tile stored [k][m].
template <typename T>
__device__ __forceinline__ void frag_a_trans(uint32_t* r, const T* tile,
                                             int stride, int k0, int m0,
                                             int lane) {
  const int row = k0 + (lane & 7) + (lane >> 4) * 8;
  const int col = m0 + ((lane >> 3) & 1) * 8;
  fa::ldmatrix_x4_trans(r, fa::smem_addr(tile + row * stride + col));
}

// Pack accumulator n8 blocks 2kk and 2kk + 1 into the A operand of a product
// over those 16 columns.
template <typename T>
__device__ __forceinline__ void acc_to_a(uint32_t* a, float (*c)[4], int kk) {
  using E = fa::Elem<T>;
  a[0] = E::pack(c[2 * kk][0], c[2 * kk][1]);
  a[1] = E::pack(c[2 * kk][2], c[2 * kk][3]);
  a[2] = E::pack(c[2 * kk + 1][0], c[2 * kk + 1][1]);
  a[3] = E::pack(c[2 * kk + 1][2], c[2 * kk + 1][3]);
}

// lse in base 2 for the exponent; +inf for a row that sees no key or lies
// past the end, so that its P is exp2(-inf) = 0 and never NaN.
__device__ __forceinline__ float lse_log2(const float* lse_row, int row, int sq) {
  const float l = row < sq ? lse_row[row] : -INFINITY;
  return l == -INFINITY ? INFINITY : l * FA_LOG2E;
}

template <typename T, int D, int BM, bool ACCUM_DQ>
__global__ void __launch_bounds__(NTHREADS) dkdv_kernel(const BwdParams p) {
  using E = fa::Elem<T>;
  constexpr int BN = KV_BN;
  constexpr int DS_STRIDE = BM + 8;  // padded rows: conflict-free ldmatrix
  extern __shared__ __align__(128) unsigned char smem_raw[];
  T* Ks = reinterpret_cast<T*>(smem_raw);
  T* Vs = Ks + BN * D;
  T* Qs = Vs + BN * D;
  T* dOs = Qs + BM * D;
  float* lse_s = reinterpret_cast<float*>(dOs + BM * D);
  float* delta_s = lse_s + BM;
  T* dSs = reinterpret_cast<T*>(delta_s + BM);  // dS^T [BN][DS_STRIDE]

  const int n0 = blockIdx.x * BN;
  const int hk = blockIdx.y;
  const int bb = blockIdx.z;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int g = lane >> 2;
  const int t4 = lane & 3;
  const int shift = p.sk - p.sq;
  const int kv_row0 = n0 + warp * 16 + g;  // rows kv_row0 and kv_row0 + 8

  const T* kg = reinterpret_cast<const T*>(p.k) + bb * p.k_sb + hk * p.k_sh;
  const T* vg = reinterpret_cast<const T*>(p.v) + bb * p.v_sb + hk * p.v_sh;
  load_tile<T, D, BN>(Ks, kg, p.k_ss, n0, p.sk, tid);
  load_tile<T, D, BN>(Vs, vg, p.v_ss, n0, p.sk, tid);
  fa::cp_async_commit();

  // q tiles of the causal band: the first row that sees key n0 is n0 - shift.
  int m_begin = 0;
  if (p.causal) m_begin = n0 - shift <= 0 ? 0 : (n0 - shift) / BM;
  const int m_tiles = (p.sq + BM - 1) / BM;

  float dk[D / 8][4];
  float dv[D / 8][4];
#pragma unroll
  for (int i = 0; i < D / 8; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk[i][e] = dv[i][e] = 0.f;

  for (int gi = 0; gi < p.group; ++gi) {
    const int hh = hk * p.group + gi;
    const T* qg = reinterpret_cast<const T*>(p.q) + bb * p.q_sb + hh * p.q_sh;
    const T* dog = reinterpret_cast<const T*>(p.dout) + bb * p.do_sb + hh * p.do_sh;
    const float* lse_g = p.lse + ((int64_t)bb * p.h + hh) * p.sq;
    const float* delta_g = p.delta + ((int64_t)bb * p.h + hh) * p.sq;

    for (int mt = m_begin; mt < m_tiles; ++mt) {
      const int m0 = mt * BM;
      __syncthreads();  // every warp is done with the previous Q/dO/dS tiles
      load_tile<T, D, BM>(Qs, qg, p.q_ss, m0, p.sq, tid);
      fa::cp_async_commit();
      load_tile<T, D, BM>(dOs, dog, p.do_ss, m0, p.sq, tid);
      fa::cp_async_commit();
      if (tid < BM) {
        lse_s[tid] = lse_log2(lse_g, m0 + tid, p.sq);
        delta_s[tid] = m0 + tid < p.sq ? delta_g[m0 + tid] : 0.f;
      }
      fa::cp_async_wait<1>();  // K, V and Q have landed; dO may be in flight
      __syncthreads();

      // S^T = K Q^T: this warp's 16 KV rows by the tile's BM q columns.
      float s[BM / 8][4];
#pragma unroll
      for (int i = 0; i < BM / 8; ++i) s[i][0] = s[i][1] = s[i][2] = s[i][3] = 0.f;
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        uint32_t ka[4];
        frag_a<T, D>(ka, Ks, warp * 16, kk * 16, lane);
#pragma unroll
        for (int np = 0; np < BM / 16; ++np) {
          uint32_t qb[4];
          frag_b<T, D>(qb, Qs, np * 16, kk * 16, lane);
          E::mma(s[2 * np], ka, qb[0], qb[1]);
          E::mma(s[2 * np + 1], ka, qb[2], qb[3]);
        }
      }

      // P^T = exp(S^T * scale - lse), masked on the diagonal and ragged tiles.
      const bool need_mask = (p.causal && n0 + BN - 1 > m0 + shift) ||
                             n0 + BN > p.sk || m0 + BM > p.sq;
#pragma unroll
      for (int nb = 0; nb < BM / 8; ++nb) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int col = nb * 8 + 2 * t4 + (e & 1);
          float x = fmaf(s[nb][e], p.scale_log2, -lse_s[col]);
          if (need_mask) {
            const int kv = kv_row0 + (e >> 1) * 8;
            const int qrow = m0 + col;
            const bool ok = kv < p.sk && qrow < p.sq &&
                            (!p.causal || kv <= qrow + shift);
            x = ok ? x : -INFINITY;
          }
          s[nb][e] = exp2f(x);
        }
      }

      fa::cp_async_wait<0>();
      __syncthreads();

      // dV += P^T dO
#pragma unroll
      for (int kk = 0; kk < BM / 16; ++kk) {
        uint32_t pa[4];
        acc_to_a<T>(pa, s, kk);
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
          ds[nb][e] = s[nb][e] * (ds[nb][e] - delta_s[col]);
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

      if constexpr (ACCUM_DQ) {
        // Stage dS^T in shared memory, then dQ[m0:m0+BM] += dS K * scale
        // into the fp32 buffer: warps split the tile's rows (16 each) and,
        // when BM < 64, the head dim.
#pragma unroll
        for (int nb = 0; nb < BM / 8; ++nb) {
#pragma unroll
          for (int i = 0; i < 2; ++i) {
            const int row = warp * 16 + g + i * 8;
            *reinterpret_cast<uint32_t*>(dSs + row * DS_STRIDE + nb * 8 + 2 * t4) =
                E::pack(ds[nb][2 * i], ds[nb][2 * i + 1]);
          }
        }
        __syncthreads();
        constexpr int MW = BM / 16;
        constexpr int DCOLS = D / (NWARPS / MW);
        static_assert(NWARPS % MW == 0 && DCOLS % 32 == 0, "dQ warp split");
        const int qr0 = (warp % MW) * 16;
        const int c_begin = (warp / MW) * DCOLS;
#pragma unroll
        for (int c0 = c_begin; c0 < c_begin + DCOLS; c0 += 32) {
          float acc[4][4];
#pragma unroll
          for (int i = 0; i < 4; ++i) acc[i][0] = acc[i][1] = acc[i][2] = acc[i][3] = 0.f;
#pragma unroll
          for (int kk = 0; kk < BN / 16; ++kk) {
            uint32_t a[4];
            frag_a_trans<T>(a, dSs, DS_STRIDE, kk * 16, qr0, lane);
#pragma unroll
            for (int np = 0; np < 2; ++np) {
              uint32_t kb[4];
              frag_b_trans<T, D>(kb, Ks, kk * 16, c0 + np * 16, lane);
              E::mma(acc[2 * np], a, kb[0], kb[1]);
              E::mma(acc[2 * np + 1], a, kb[2], kb[3]);
            }
          }
#pragma unroll
          for (int i = 0; i < 2; ++i) {
            const int row = m0 + qr0 + g + i * 8;
            if (row >= p.sq) continue;
            float* dst = p.dq_accum + (((int64_t)bb * p.sq + row) * p.h + hh) * D + c0 + 2 * t4;
#pragma unroll
            for (int nb = 0; nb < 4; ++nb) {
              atomicAdd(dst + nb * 8, acc[nb][2 * i] * p.scale);
              atomicAdd(dst + nb * 8 + 1, acc[nb][2 * i + 1] * p.scale);
            }
          }
        }
      }
    }
  }

  // Epilogue: dK (scaled) and dV in the inputs' type, rows past sk skipped.
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = kv_row0 + i * 8;
    if (row >= p.sk) continue;
    T* dkg = reinterpret_cast<T*>(p.dk) + bb * p.dk_sb + row * p.dk_ss + hk * p.dk_sh;
    T* dvg = reinterpret_cast<T*>(p.dv) + bb * p.dv_sb + row * p.dv_ss + hk * p.dv_sh;
#pragma unroll
    for (int db = 0; db < D / 8; ++db) {
      *reinterpret_cast<uint32_t*>(dkg + db * 8 + 2 * t4) =
          E::pack(dk[db][2 * i] * p.scale, dk[db][2 * i + 1] * p.scale);
      *reinterpret_cast<uint32_t*>(dvg + db * 8 + 2 * t4) =
          E::pack(dv[db][2 * i], dv[db][2 * i + 1]);
    }
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(NTHREADS) dq_kernel(const BwdParams p) {
  using E = fa::Elem<T>;
  constexpr int BM = DQ_BM;
  constexpr int BN = DQ_BN;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  T* Qs = reinterpret_cast<T*>(smem_raw);
  T* dOs = Qs + BM * D;
  T* Ks = dOs + BM * D;
  T* Vs = Ks + BN * D;

  const int m0 = blockIdx.x * BM;
  const int hh = blockIdx.y;
  const int bb = blockIdx.z;
  const int kh = hh / p.group;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int g = lane >> 2;
  const int t4 = lane & 3;
  const int shift = p.sk - p.sq;
  const int row0 = m0 + warp * 16 + g;  // rows row0 and row0 + 8

  const T* qg = reinterpret_cast<const T*>(p.q) + bb * p.q_sb + hh * p.q_sh;
  const T* dog = reinterpret_cast<const T*>(p.dout) + bb * p.do_sb + hh * p.do_sh;
  const T* kg = reinterpret_cast<const T*>(p.k) + bb * p.k_sb + kh * p.k_sh;
  const T* vg = reinterpret_cast<const T*>(p.v) + bb * p.v_sb + kh * p.v_sh;
  load_tile<T, D, BM>(Qs, qg, p.q_ss, m0, p.sq, tid);
  load_tile<T, D, BM>(dOs, dog, p.do_ss, m0, p.sq, tid);
  fa::cp_async_commit();

  const float* lse_g = p.lse + ((int64_t)bb * p.h + hh) * p.sq;
  const float* delta_g = p.delta + ((int64_t)bb * p.h + hh) * p.sq;
  float lse2[2], delta[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = row0 + i * 8;
    lse2[i] = lse_log2(lse_g, row, p.sq);
    delta[i] = row < p.sq ? delta_g[row] : 0.f;
  }

  int n_tiles = (p.sk + BN - 1) / BN;
  if (p.causal) {
    const int col_hi = min(m0 + BM, p.sq) - 1 + shift;
    n_tiles = col_hi < 0 ? 0 : min(n_tiles, col_hi / BN + 1);
  }

  float dq[D / 8][4];
#pragma unroll
  for (int i = 0; i < D / 8; ++i) dq[i][0] = dq[i][1] = dq[i][2] = dq[i][3] = 0.f;

  for (int n = 0; n < n_tiles; ++n) {
    const int n0 = n * BN;
    __syncthreads();  // every warp is done with the previous K/V tile
    load_tile<T, D, BN>(Ks, kg, p.k_ss, n0, p.sk, tid);
    fa::cp_async_commit();
    load_tile<T, D, BN>(Vs, vg, p.v_ss, n0, p.sk, tid);
    fa::cp_async_commit();
    fa::cp_async_wait<1>();  // K (and Q, dO) have landed; V may be in flight
    __syncthreads();

    // S = Q K^T
    float s[BN / 8][4];
#pragma unroll
    for (int i = 0; i < BN / 8; ++i) s[i][0] = s[i][1] = s[i][2] = s[i][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      uint32_t qa[4];
      frag_a<T, D>(qa, Qs, warp * 16, kk * 16, lane);
#pragma unroll
      for (int np = 0; np < BN / 16; ++np) {
        uint32_t kb[4];
        frag_b<T, D>(kb, Ks, np * 16, kk * 16, lane);
        E::mma(s[2 * np], qa, kb[0], kb[1]);
        E::mma(s[2 * np + 1], qa, kb[2], kb[3]);
      }
    }

    // P = exp(S * scale - lse), masked on the diagonal and ragged tiles.
    const bool need_mask = (p.causal && n0 + BN - 1 > m0 + shift) || n0 + BN > p.sk;
#pragma unroll
    for (int nb = 0; nb < BN / 8; ++nb) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float x = fmaf(s[nb][e], p.scale_log2, -lse2[e >> 1]);
        if (need_mask) {
          const int col = n0 + nb * 8 + 2 * t4 + (e & 1);
          const int row = row0 + (e >> 1) * 8;
          const bool ok = col < p.sk && (!p.causal || col <= row + shift);
          x = ok ? x : -INFINITY;
        }
        s[nb][e] = exp2f(x);
      }
    }

    fa::cp_async_wait<0>();
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
      for (int e = 0; e < 4; ++e) ds[nb][e] = s[nb][e] * (ds[nb][e] - delta[e >> 1]);
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

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = row0 + i * 8;
    if (row >= p.sq) continue;
    T* dqg = reinterpret_cast<T*>(p.dq) + bb * p.dq_sb + row * p.dq_ss + hh * p.dq_sh;
#pragma unroll
    for (int db = 0; db < D / 8; ++db) {
      *reinterpret_cast<uint32_t*>(dqg + db * 8 + 2 * t4) =
          E::pack(dq[db][2 * i] * p.scale, dq[db][2 * i + 1] * p.scale);
    }
  }
}

template <typename Kernel>
cudaError_t launch(Kernel kernel, dim3 grid, int smem, const BwdParams& p,
                   cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  kernel<<<grid, NTHREADS, smem, stream>>>(p);
  return cudaGetLastError();
}

template <typename T, int D>
cudaError_t launch_dkdv(const BwdParams& p, int b, int h_k, int accum_dq,
                        cudaStream_t stream) {
  constexpr int BM = dkdv_bm<D>();
  const int smem = (2 * KV_BN + 2 * BM) * D * (int)sizeof(T) +
                   2 * BM * (int)sizeof(float) +
                   (accum_dq ? KV_BN * (BM + 8) * (int)sizeof(T) : 0);
  const dim3 grid((p.sk + KV_BN - 1) / KV_BN, h_k, b);
  if (accum_dq) return launch(dkdv_kernel<T, D, BM, true>, grid, smem, p, stream);
  return launch(dkdv_kernel<T, D, BM, false>, grid, smem, p, stream);
}

template <typename T, int D>
cudaError_t launch_dq(const BwdParams& p, int b, cudaStream_t stream) {
  const int smem = 2 * (DQ_BM + DQ_BN) * D * (int)sizeof(T);
  const dim3 grid((p.sq + DQ_BM - 1) / DQ_BM, p.h, b);
  return launch(dq_kernel<T, D>, grid, smem, p, stream);
}

BwdParams make_params(const void* q, const void* k, const void* v,
                      const void* dout, const float* lse, const float* delta,
                      int sq, int sk, int h, int h_k, float scale, int causal) {
  BwdParams p = {};
  p.q = q;
  p.k = k;
  p.v = v;
  p.dout = dout;
  p.lse = lse;
  p.delta = delta;
  p.sq = sq;
  p.sk = sk;
  p.h = h;
  p.group = h / h_k;
  p.scale = scale;
  p.scale_log2 = scale * FA_LOG2E;
  p.causal = causal;
  return p;
}

}  // namespace

// dK and dV (and, with accum_dq, dQ * into dq_accum by atomics). q/dout
// (b, sq, h, d), k/v and dk/dv (b, sk, h_k, d), all by element strides with
// the head dim contiguous; lse and delta (b, h, sq) fp32; dq_accum (b, sq,
// h, d) contiguous fp32, zeroed by the caller. block_q/block_k must name the
// tile the kernel is compiled for (dispatch/config.py get_bwd_config).
// Returns a cudaError_t (0 on success).
extern "C" int fa_bwd_dkdv(const void* q, const void* k, const void* v,
                           const void* dout, const float* lse,
                           const float* delta, void* dk, void* dv,
                           float* dq_accum, int b, int sq, int sk, int h,
                           int h_k, int d, int block_q, int block_k,
                           int64_t q_sb, int64_t q_ss, int64_t q_sh,
                           int64_t k_sb, int64_t k_ss, int64_t k_sh,
                           int64_t v_sb, int64_t v_ss, int64_t v_sh,
                           int64_t do_sb, int64_t do_ss, int64_t do_sh,
                           int64_t dk_sb, int64_t dk_ss, int64_t dk_sh,
                           int64_t dv_sb, int64_t dv_ss, int64_t dv_sh,
                           float scale, int causal, int is_bf16, int accum_dq,
                           void* stream) {
  if (block_k != KV_BN) return (int)cudaErrorInvalidValue;
  if (d == 64 && block_q != dkdv_bm<64>()) return (int)cudaErrorInvalidValue;
  if (d == 128 && block_q != dkdv_bm<128>()) return (int)cudaErrorInvalidValue;
  if (accum_dq && dq_accum == nullptr) return (int)cudaErrorInvalidValue;
  BwdParams p = make_params(q, k, v, dout, lse, delta, sq, sk, h, h_k, scale, causal);
  p.dk = dk;
  p.dv = dv;
  p.dq_accum = dq_accum;
  p.q_sb = q_sb; p.q_ss = q_ss; p.q_sh = q_sh;
  p.k_sb = k_sb; p.k_ss = k_ss; p.k_sh = k_sh;
  p.v_sb = v_sb; p.v_ss = v_ss; p.v_sh = v_sh;
  p.do_sb = do_sb; p.do_ss = do_ss; p.do_sh = do_sh;
  p.dk_sb = dk_sb; p.dk_ss = dk_ss; p.dk_sh = dk_sh;
  p.dv_sb = dv_sb; p.dv_ss = dv_ss; p.dv_sh = dv_sh;
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  if (is_bf16) {
    if (d == 64) return launch_dkdv<__nv_bfloat16, 64>(p, b, h_k, accum_dq, st);
    if (d == 128) return launch_dkdv<__nv_bfloat16, 128>(p, b, h_k, accum_dq, st);
  } else {
    if (d == 64) return launch_dkdv<__half, 64>(p, b, h_k, accum_dq, st);
    if (d == 128) return launch_dkdv<__half, 128>(p, b, h_k, accum_dq, st);
  }
  return (int)cudaErrorInvalidValue;
}

// dQ (b, sq, h, d) in q's type, written once. Layouts as fa_bwd_dkdv.
extern "C" int fa_bwd_dq(const void* q, const void* k, const void* v,
                         const void* dout, const float* lse,
                         const float* delta, void* dq, int b, int sq, int sk,
                         int h, int h_k, int d, int block_q, int block_k,
                         int64_t q_sb, int64_t q_ss, int64_t q_sh,
                         int64_t k_sb, int64_t k_ss, int64_t k_sh,
                         int64_t v_sb, int64_t v_ss, int64_t v_sh,
                         int64_t do_sb, int64_t do_ss, int64_t do_sh,
                         int64_t dq_sb, int64_t dq_ss, int64_t dq_sh,
                         float scale, int causal, int is_bf16, void* stream) {
  if (block_q != DQ_BM || block_k != DQ_BN) return (int)cudaErrorInvalidValue;
  BwdParams p = make_params(q, k, v, dout, lse, delta, sq, sk, h, h_k, scale, causal);
  p.dq = dq;
  p.q_sb = q_sb; p.q_ss = q_ss; p.q_sh = q_sh;
  p.k_sb = k_sb; p.k_ss = k_ss; p.k_sh = k_sh;
  p.v_sb = v_sb; p.v_ss = v_ss; p.v_sh = v_sh;
  p.do_sb = do_sb; p.do_ss = do_ss; p.do_sh = do_sh;
  p.dq_sb = dq_sb; p.dq_ss = dq_ss; p.dq_sh = dq_sh;
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  if (is_bf16) {
    if (d == 64) return launch_dq<__nv_bfloat16, 64>(p, b, st);
    if (d == 128) return launch_dq<__nv_bfloat16, 128>(p, b, st);
  } else {
    if (d == 64) return launch_dq<__half, 64>(p, b, st);
    if (d == 128) return launch_dq<__half, 128>(p, b, st);
  }
  return (int)cudaErrorInvalidValue;
}
