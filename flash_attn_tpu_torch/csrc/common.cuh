// Shared device helpers for the hand-written Hopper attention kernels:
// element-type traits (bf16 / fp16; their m16n8k16 mma.sync product serves
// the mma/exp2 overlap probe alone, csrc/probes.cu), the shared-memory
// address of a pointer, the band masks, the key tiles of a row tile's
// band and quad reductions.
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
