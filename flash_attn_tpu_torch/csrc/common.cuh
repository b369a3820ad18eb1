// Shared device helpers for the hand-written Hopper attention kernels:
// element-type traits (bf16 / fp16; their m16n8k16 mma.sync product serves
// the mma/exp2 overlap probe alone, csrc/probes.cu), the shared-memory
// address of a pointer, the band masks, the key tiles of a row tile's
// band, the query tiles of a key tile's band, the band's tile tests and
// per-key and per-row bounds, the score map's factors (softcap, ALiBi),
// and quad reductions.
#pragma once

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

#define FA_LOG2E 1.4426950408889634f
#define FA_LN2 0.6931471805599453f

namespace fa {

template <typename T>
struct Elem;

template <>
struct Elem<__nv_bfloat16> {
  using T2 = __nv_bfloat162;
  static __device__ __forceinline__ uint32_t pack(float lo, float hi) {
    T2 v = __floats2bfloat162_rn(lo, hi);
    return *reinterpret_cast<uint32_t*>(&v);
  }
  static __device__ __forceinline__ float2 unpack(uint32_t u) {
    T2 v = *reinterpret_cast<T2*>(&u);
    return __bfloat1622float2(v);
  }
  // D = A(16x16, row) * B(16x8, col) + D, fp32 accumulate.
  static __device__ __forceinline__ void mma(float* d, const uint32_t* a,
                                             uint32_t b0, uint32_t b1) {
    asm volatile(
        "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
        "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
  }
};

template <>
struct Elem<__half> {
  using T2 = __half2;
  static __device__ __forceinline__ uint32_t pack(float lo, float hi) {
    T2 v = __floats2half2_rn(lo, hi);
    return *reinterpret_cast<uint32_t*>(&v);
  }
  static __device__ __forceinline__ float2 unpack(uint32_t u) {
    T2 v = *reinterpret_cast<T2*>(&u);
    return __half22float2(v);
  }
  static __device__ __forceinline__ void mma(float* d, const uint32_t* a,
                                             uint32_t b0, uint32_t b1) {
    asm volatile(
        "mma.sync.aligned.m16n8k16.row.col.f32.f16.f16.f32 "
        "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
  }
};

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// The band masks beyond the causal bound (flash_attn_tpu/kernels/
// flash_fwd.py:270-287; dispatch/band.py): with shift = sk - sq, row r
// sees key c iff c <= r + shift + right (right 0 under causal masking),
// c >= r + shift - left or c < sink, and, with chunk > 0, c lies in
// [lo, lo + chunk) for lo = r + shift rounded down (floor) to a multiple of
// chunk. BAND_NONE for no bound: r + shift +- 2^30 neither overflows nor
// bounds any key of a sequence shorter than 2^30.
constexpr int BAND_NONE = 1 << 30;

struct Band {
  int left = BAND_NONE, right = BAND_NONE, sink = 0, chunk = 0;
  // the first key of rs's chunk (rs = r + shift, negative for the rows
  // past sk when sq > sk)
  __host__ __device__ __forceinline__ int chunk_lo(int rs) const {
    const int m = rs % chunk;
    return rs - (m < 0 ? m + chunk : m);
  }
};

// The BN-key tiles [lo, hi) of the causal band of rows [m0, m0 + bm), in
// order from key 0: all of them when not causal, none for a tile past the
// last row. With a Band, the tiles that hold a key some row of the tile
// sees (the bounds of flash_fwd.py:360 _kv_block_bounds, tighter where the
// chunk bounds the keys above too); a tile outside them is fully masked for
// every row, so skipping it changes no bit of the online softmax.
template <int BN>
struct KeyRange {
  int lo = 0, hi;
  __device__ __forceinline__ KeyRange(int m0, int bm, int sq, int sk,
                                      bool causal) {
    hi = m0 < sq ? (sk + BN - 1) / BN : 0;
    if (causal) {
      const int col_hi = min(m0 + bm, sq) - 1 + sk - sq;
      hi = col_hi < 0 ? 0 : min(hi, col_hi / BN + 1);
    }
  }
  __device__ __forceinline__ KeyRange(int m0, int bm, int sq, int sk,
                                      const Band& b) {
    hi = 0;
    if (m0 >= sq) return;
    const int shift = sk - sq;
    const int r_hi = min(m0 + bm, sq) - 1;
    int c_lo = 0, c_hi = sk - 1;
    if (b.right != BAND_NONE) c_hi = min(c_hi, r_hi + shift + b.right);
    if (b.left != BAND_NONE && b.sink == 0) c_lo = max(c_lo, m0 + shift - b.left);
    if (b.chunk > 0) {
      c_lo = max(c_lo, b.chunk_lo(m0 + shift));
      c_hi = min(c_hi, b.chunk_lo(r_hi + shift) + b.chunk - 1);
    }
    if (c_hi < c_lo) return;  // c_lo >= 0: no row of the tile sees a key
    lo = c_lo / BN;
    hi = c_hi / BN + 1;
  }
  __device__ __forceinline__ int count() const { return hi - lo; }
};

// The BM-row query tiles [lo, hi) of a Band that see some key of [n0, n0 +
// bn) (the mirror of KeyRange by rows, flash_bwd.py:157 _q_block_bounds):
// rows below the first are past the right extent (0 under causal masking)
// of every key of the tile, rows past the last past the left extent of its
// last key (no bound when the tile holds a sink key) or past its chunk.
// Empty (lo = hi = 0) when no row sees any key; a tile outside it is fully
// masked for every key, so skipping it changes no sum.
template <int BM>
struct QueryRange {
  int lo = 0, hi = 0;
  __device__ __forceinline__ QueryRange(int n0, int bn, int sq, int sk, const Band& b) {
    if (n0 >= sk) return;
    const int shift = sk - sq;
    const int c_hi = min(n0 + bn, sk) - 1;
    int r_lo = 0, r_hi = sq - 1;
    if (b.right != BAND_NONE) r_lo = max(r_lo, n0 - shift - b.right);
    if (b.left != BAND_NONE && n0 >= b.sink) r_hi = min(r_hi, c_hi - shift + b.left);
    if (b.chunk > 0) {
      r_lo = max(r_lo, b.chunk_lo(n0) - shift);
      r_hi = min(r_hi, b.chunk_lo(c_hi) + b.chunk - 1 - shift);
    }
    if (r_hi < r_lo) return;  // r_lo >= 0: no row sees a key of the tile
    lo = r_lo / BM;
    hi = r_hi / BM + 1;
  }
};

// Under a Band, for a tile of query rows [ra, rb] by keys [ca, cb] (shift =
// sk - sq): band_meets, whether some pair of them may lie inside the band
// (each edge tested alone: a tile that passes and holds none is masked
// whole, which adds nothing); band_cuts, whether some pair lies outside it
// (the tile runs the mask; sinks aside: a mask too many changes no score).
__device__ __forceinline__ bool band_meets(const Band& b, int ra, int rb, int ca, int cb,
                                           int shift) {
  if (ca > rb + shift + b.right) return false;
  if (cb < ra + shift - b.left && ca >= b.sink) return false;
  if (b.chunk > 0 &&
      (cb < b.chunk_lo(ra + shift) || ca > b.chunk_lo(rb + shift) + b.chunk - 1))
    return false;
  return true;
}

__device__ __forceinline__ bool band_cuts(const Band& b, int ra, int rb, int ca, int cb,
                                          int shift) {
  if (cb > ra + shift + b.right || ca < rb + shift - b.left) return true;
  if (b.chunk > 0) {
    const int lo = b.chunk_lo(ra + shift);
    return b.chunk_lo(rb + shift) != lo || ca < lo || cb > lo + b.chunk - 1;
  }
  return false;
}

// Under a Band: the query rows [lo, hi] that see key c of sk (empty, hi <
// lo, for a key past sk), the per-key bounds of a transposed score tile.
__device__ __forceinline__ void band_key_rows(const Band& b, int c, int sk, int shift, int& lo,
                                              int& hi) {
  lo = c - shift - b.right;
  hi = c < b.sink ? INT_MAX : c - shift + b.left;
  if (b.chunk > 0) {
    const int r0 = b.chunk_lo(c) - shift;
    lo = max(lo, r0);
    hi = min(hi, r0 + b.chunk - 1);
  }
  if (c >= sk) hi = INT_MIN;
}

// Under a Band: the keys [lo, hi] of sk that row r sees (rs = r + shift),
// bar the window's lower edge wlo, which the first b.sink keys pass: the
// per-row bounds of a score tile (the forward's, and the backward's dQ).
__device__ __forceinline__ void band_row_keys(const Band& b, int rs, int sk, int& lo, int& hi,
                                              int& wlo) {
  hi = min(sk - 1, rs + b.right);
  lo = INT_MIN;
  if (b.chunk > 0) {
    lo = b.chunk_lo(rs);
    hi = min(hi, lo + b.chunk - 1);
  }
  wlo = rs - b.left;
}

// The Band of a C entry point's arguments (dispatch/band.py band_args: -1
// for a missing window extent, right 0 under causal masking).
inline Band band_from_args(int left, int right, int sink, int chunk) {
  Band b;
  b.left = left < 0 ? BAND_NONE : left;
  b.right = right < 0 ? BAND_NONE : right;
  b.sink = sink;
  b.chunk = chunk;
  return b;
}

// The score map of softcap and ALiBi for one query head of one sequence
// (fwd_sm90.cuh score_map, bwd_sm90.cuh bwd_score_map): with a cap, score
// s (Q K^T, unscaled) becomes tanh(s cap_in) cap_out with cap_in = scale /
// cap and cap_out = cap log2(e), else s scale log2(e); then ALiBi adds
// slope (the head's slope times log2(e), 0 for none) times the bias, col -
// (sk - 1) under causal masking (relative to the last key, as
// flash_fwd.py:243-245: the lse keeps that form) and -|row + sk - sq - col|
// otherwise.
struct Score {
  float cap_in = 0.f, cap_out = 0.f;
  float slope = 0.f;
  int causal = 0;
};

// The Score of a C entry point's softcap (0: none) at scale * log2(e); the
// slope is each kernel's to set.
inline Score score_from_args(float scale_log2, float softcap, int causal) {
  Score s;
  s.cap_in = softcap > 0.f ? scale_log2 / (FA_LOG2E * softcap) : 0.f;
  s.cap_out = softcap * FA_LOG2E;
  s.causal = causal;
  return s;
}

// Reductions over the 4 lanes of a quad (the lanes that share one row of an
// mma accumulator tile).
__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffff, x, 1));
  x = fmaxf(x, __shfl_xor_sync(0xffffffff, x, 2));
  return x;
}

__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffff, x, 1);
  x += __shfl_xor_sync(0xffffffff, x, 2);
  return x;
}

}  // namespace fa
