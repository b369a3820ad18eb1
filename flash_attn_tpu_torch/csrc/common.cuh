// Shared device helpers for the hand-written Hopper attention kernels:
// element-type traits (bf16 / fp16), the m16n8k16 tensor-core product,
// ldmatrix and cp.async wrappers, and quad reductions.
#pragma once

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
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

// Element offset of 16-byte chunk `chunk` of row `row` in a [rows][D] shared
// tile, XOR-swizzled so that 8 consecutive rows put one logical chunk in 8
// different bank groups (ldmatrix reads free of bank conflicts).
template <int D>
__device__ __forceinline__ int swz(int row, int chunk) {
  return row * D + ((chunk ^ (row & 7)) << 3);
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t* r, uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t* r, uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

// 16-byte global->shared copy; src_bytes == 0 fills the destination with
// zeros (rows past the end of a sequence).
__device__ __forceinline__ void cp_async_16(uint32_t dst, const void* src,
                                            int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(src_bytes));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// The key tiles a tile of query rows walks, in order: count() of them, the
// n-th starting at key first_key(n), or at -1 for one the walk skips (the
// same for every thread of the block). KeyRange is the dense walk: every
// BN-key tile of the causal band of rows [m0, m0 + bm), all of them when
// not causal, none for a tile past the last row.
template <int BN>
struct KeyRange {
  int n_tiles;
  __device__ __forceinline__ KeyRange(int m0, int bm, int sq, int sk,
                                      bool causal) {
    n_tiles = m0 < sq ? (sk + BN - 1) / BN : 0;
    if (causal) {
      const int col_hi = min(m0 + bm, sq) - 1 + sk - sq;
      n_tiles = col_hi < 0 ? 0 : min(n_tiles, col_hi / BN + 1);
    }
  }
  __device__ __forceinline__ int count() const { return n_tiles; }
  __device__ __forceinline__ int first_key(int n) const { return n * BN; }
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
