// The mma.sync forward tile loop of the block-sparse forward (B10,
// csrc/flash_blocksparse.cu): one block of 4 warps computes 64 query rows of
// one sequence and head against the key tiles of a list (a walk policy; the
// dense causal band is common.cuh's KeyRange), with K/V rows a row stride
// apart (LinearKV). The dense forward (B1), the packed-varlen forwards (B6,
// B7) and the paged varlen prefill (B8) run the wgmma/TMA tile of
// fwd_sm90.cuh instead.
//
// Q stays in registers as mma fragments for the whole loop; 64-key K/V tiles
// arrive with cp.async into XOR-swizzled shared memory so the ldmatrix reads
// are free of bank conflicts, and the V copy overlaps the Q K^T product. Both
// products run on the tensor cores with mma.sync.m16n8k16 (fp32
// accumulation); P never leaves registers (the accumulator layout of S is the
// A-operand layout of P V). The online softmax keeps (m, l, acc) in fp32
// registers and uses exp2 with softmax_scale * log2(e) folded into one
// multiply.
//
// Masking is bottom-right aligned (shift = sk - sq): query row r sees key
// columns c <= r + shift. A row that sees no key gets out = 0, lse = -inf.
// Only the tiles that cross the causal diagonal or the end of the keys run
// the mask. Every multiply that feeds an add is rounded explicitly
// (__fmul_rn, __fmaf_rn), so the compiler cannot contract it differently
// where the loop is inlined into another kernel: the same tile gives the
// same bits in every caller.
#pragma once

#include "common.cuh"

namespace fa {

constexpr int FWD_BM = 64;  // query rows per tile
constexpr int FWD_BN = 64;  // keys per K/V tile
constexpr int FWD_THREADS = 128;

// One tile of work: rows [m0, m0 + 64) of a sequence of sq query rows over
// sk keys. The pointers are at row 0 of the sequence and this query head;
// lse rows are consecutive floats. Rows at or past sq are left untouched.
template <typename T>
struct FwdTile {
  const T* q;
  T* out;
  float* lse;
  int64_t q_ss, o_ss;  // row strides in elements
  int sq, sk, m0;
};

template <typename T, int D>
constexpr int fwd_smem_bytes() {
  return (FWD_BM + 2 * FWD_BN) * D * (int)sizeof(T);
}

// Copy rows [row0, row0 + 64) of one sequence and head into a swizzled shared
// tile; rows at or past `nrows` are zero-filled.
template <typename T, int D>
__device__ __forceinline__ void load_rows64(T* tile, const T* base,
                                            int64_t row_stride, int row0,
                                            int nrows, int tid) {
  constexpr int CHUNKS = D / 8;
  constexpr int PER_THREAD = 64 * CHUNKS / FWD_THREADS;
#pragma unroll
  for (int i = 0; i < PER_THREAD; ++i) {
    const int c = tid + i * FWD_THREADS;
    const int r = c / CHUNKS;
    const int ch = c % CHUNKS;
    const int gr = row0 + r;
    const bool ok = gr < nrows;
    const T* src = ok ? base + (int64_t)gr * row_stride + ch * 8 : base;
    cp_async_16(smem_addr(tile + swz<D>(r, ch)), src, ok ? 16 : 0);
  }
}

// K and V rows of one sequence and KV head, a row stride apart.
template <typename T, int D>
struct LinearKV {
  const T* k;
  const T* v;
  int64_t k_ss, v_ss;
  __device__ __forceinline__ void load_k(T* tile, int n0, int nkeys,
                                         int tid) const {
    load_rows64<T, D>(tile, k, k_ss, n0, nkeys, tid);
  }
  __device__ __forceinline__ void load_v(T* tile, int n0, int nkeys,
                                         int tid) const {
    load_rows64<T, D>(tile, v, v_ss, n0, nkeys, tid);
  }
};

// kv.load_k / load_v(tile, n0, nkeys, tid) copy key rows [n0, n0 + 64) into
// a swizzled shared tile, zero-filling rows at or past nkeys. Walk: the key
// tiles to visit (the block-sparse kernel's list of listed tiles; common.cuh
// KeyRange is the dense band), each masked as the dense loop masks it.
template <typename T, int D, typename Walk>
__device__ __forceinline__ void fwd_tile(const FwdTile<T>& t, const LinearKV<T, D>& kv,
                                         const Walk& walk, float scale_log2,
                                         bool causal, unsigned char* smem) {
  using E = Elem<T>;
  constexpr int BM = FWD_BM;
  constexpr int BN = FWD_BN;
  T* Qs = reinterpret_cast<T*>(smem);
  T* Ks = Qs + BM * D;
  T* Vs = Ks + BN * D;

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int g = lane >> 2;  // accumulator row within the warp's 16 (and +8)
  const int t4 = lane & 3;  // accumulator column pair
  const int m0 = t.m0;
  const int shift = t.sk - t.sq;

  const int n_tiles = walk.count();

  __syncthreads();  // a block that walks several tiles: the last is done
  load_rows64<T, D>(Qs, t.q, t.q_ss, m0, t.sq, tid);
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();

  uint32_t qa[D / 16][4];
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    const int r = warp * 16 + (lane & 7) + ((lane >> 3) & 1) * 8;
    ldmatrix_x4(qa[kk], smem_addr(Qs + swz<D>(r, kk * 2 + (lane >> 4))));
  }

  float o[D / 8][4];
#pragma unroll
  for (int i = 0; i < D / 8; ++i) o[i][0] = o[i][1] = o[i][2] = o[i][3] = 0.f;
  float m_r[2] = {-INFINITY, -INFINITY};  // running max, base 2
  float l_r[2] = {0.f, 0.f};              // this lane's share of the row sum
  const int row0 = m0 + warp * 16 + g;    // rows row0 and row0 + 8

  for (int n = 0; n < n_tiles; ++n) {
    const int n0 = walk.first_key(n);
    if (n0 < 0) continue;
    __syncthreads();  // every warp is done with the previous K/V tile
    kv.load_k(Ks, n0, t.sk, tid);
    cp_async_commit();
    kv.load_v(Vs, n0, t.sk, tid);
    cp_async_commit();
    cp_async_wait<1>();  // K has landed; V may still be in flight
    __syncthreads();

    float s[BN / 8][4];
#pragma unroll
    for (int i = 0; i < BN / 8; ++i) s[i][0] = s[i][1] = s[i][2] = s[i][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
#pragma unroll
      for (int np = 0; np < BN / 16; ++np) {
        uint32_t kb[4];
        const int r = np * 16 + (lane & 7) + (lane >> 4) * 8;
        ldmatrix_x4(kb, smem_addr(Ks + swz<D>(r, kk * 2 + ((lane >> 3) & 1))));
        E::mma(s[2 * np], qa[kk], kb[0], kb[1]);
        E::mma(s[2 * np + 1], qa[kk], kb[2], kb[3]);
      }
    }

    const bool need_mask =
        (causal && n0 + BN - 1 > m0 + shift) || (n0 + BN > t.sk);
#pragma unroll
    for (int nb = 0; nb < BN / 8; ++nb) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float x = __fmul_rn(s[nb][e], scale_log2);
        if (need_mask) {
          const int col = n0 + nb * 8 + 2 * t4 + (e & 1);
          const int row = row0 + (e >> 1) * 8;
          const bool ok = col < t.sk && (!causal || col <= row + shift);
          x = ok ? x : -INFINITY;
        }
        s[nb][e] = x;
      }
    }

    // Online softmax over the tile.
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      float mx = -INFINITY;
#pragma unroll
      for (int nb = 0; nb < BN / 8; ++nb)
        mx = fmaxf(mx, fmaxf(s[nb][2 * i], s[nb][2 * i + 1]));
      mx = quad_max(mx);
      const float m_new = fmaxf(m_r[i], mx);
      // A row that has seen no key yet keeps m = -inf; exponentiate
      // against 0 so that it gives 0 and not NaN.
      const float m_safe = m_new == -INFINITY ? 0.f : m_new;
      const float corr = exp2f(m_r[i] - m_safe);
      m_r[i] = m_new;
      float rs = 0.f;
#pragma unroll
      for (int nb = 0; nb < BN / 8; ++nb) {
        s[nb][2 * i] = exp2f(s[nb][2 * i] - m_safe);
        s[nb][2 * i + 1] = exp2f(s[nb][2 * i + 1] - m_safe);
        rs += s[nb][2 * i] + s[nb][2 * i + 1];
      }
      l_r[i] = __fmaf_rn(l_r[i], corr, rs);
#pragma unroll
      for (int db = 0; db < D / 8; ++db) {
        o[db][2 * i] *= corr;
        o[db][2 * i + 1] *= corr;
      }
    }

    cp_async_wait<0>();
    __syncthreads();

    // O += P V, with P taken straight from the S accumulators.
#pragma unroll
    for (int kk = 0; kk < BN / 16; ++kk) {
      uint32_t pa[4];
      pa[0] = E::pack(s[2 * kk][0], s[2 * kk][1]);
      pa[1] = E::pack(s[2 * kk][2], s[2 * kk][3]);
      pa[2] = E::pack(s[2 * kk + 1][0], s[2 * kk + 1][1]);
      pa[3] = E::pack(s[2 * kk + 1][2], s[2 * kk + 1][3]);
#pragma unroll
      for (int dp = 0; dp < D / 16; ++dp) {
        uint32_t vb[4];
        const int r = kk * 16 + (lane & 7) + ((lane >> 3) & 1) * 8;
        ldmatrix_x4_trans(vb, smem_addr(Vs + swz<D>(r, dp * 2 + (lane >> 4))));
        E::mma(o[2 * dp], pa, vb[0], vb[1]);
        E::mma(o[2 * dp + 1], pa, vb[2], vb[3]);
      }
    }
  }

  // Epilogue: normalise, write out in the input type and the natural-log lse.
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = row0 + i * 8;
    const float l = quad_sum(l_r[i]);
    if (row >= t.sq) continue;
    const float inv = l == 0.f ? 0.f : 1.f / l;
    T* og = t.out + (int64_t)row * t.o_ss;
#pragma unroll
    for (int db = 0; db < D / 8; ++db) {
      *reinterpret_cast<uint32_t*>(og + db * 8 + 2 * t4) =
          E::pack(o[db][2 * i] * inv, o[db][2 * i + 1] * inv);
    }
    if (t4 == 0) t.lse[row] = l == 0.f ? -INFINITY : __fmaf_rn(m_r[i], FA_LN2, logf(l));
  }
}

}  // namespace fa
