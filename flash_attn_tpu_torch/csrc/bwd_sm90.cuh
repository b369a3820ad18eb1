// Hopper building blocks of the dense attention backward (csrc/flash_bwd.cu):
// mbarriers, TMA tile loads and bulk copies, wgmma with its shared-memory
// descriptors, and the layout of a tile in shared memory.
//
// Tile layout. A tile of R rows by D columns (D = 64 or 128 elements of 2
// bytes) is stored as D / 64 panels of 64 columns; a panel is R rows of 128
// bytes with the 128-byte swizzle (16-byte chunk c of row r at chunk
// c ^ (r % 8)), panels R * 128 bytes apart, every tile 1024-byte aligned.
// That is what one TMA load per panel with a {64, R} box and
// CU_TENSOR_MAP_SWIZZLE_128B writes, and what wgmma reads through a
// descriptor of layout type 1 (128B swizzle):
//
//  - "K-major" (the product's depth runs along a row, the tile's columns):
//    8-row groups 1024 bytes apart (SBO); a 16-deep slice starts 32 bytes
//    further along the row, the next panel R * 128 bytes further;
//  - "MN-major" (the depth runs down the rows; wgmma's transpose bit): 8-row
//    groups 1024 bytes apart (SBO), 64-column groups one panel apart (LBO); a
//    16-deep slice starts 16 rows (2048 bytes) further.
//
// wgmma accumulators (m64nN, fp32): thread t of the warpgroup holds, for
// n8 block j and e in 0..3, element [4 j + e] at row 16 (t / 32) + (t % 32)
// / 4 + 8 (e / 2), column 8 j + 2 (t % 4) + e % 2. The A operand of the
// register form (m64k16) has the m16n8k16 A layout of mma.sync per warp, so
// an accumulator's n8 blocks 2 kk and 2 kk + 1 pack straight into the A
// operand of a product over those 16 columns (pack_a).
#pragma once

#include <cuda.h>

#include <type_traits>

#include "common.cuh"

namespace fa {
namespace sm90 {

// ---- mbarriers -------------------------------------------------------------

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_addr(bar)),
               "r"(count)
               : "memory");
}

// Makes initialised barriers visible to the async proxy (TMA).
__device__ __forceinline__ void fence_barrier_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

// One arrival that also announces `bytes` of TMA traffic for this phase.
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
          smem_addr(bar)),
      "r"(bytes)
      : "memory");
}

// Spin until the phase of parity `parity` has completed. A phase that does
// not complete within about 10 s (a copy that was never issued) traps, so
// that the launch fails instead of holding the card.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, int parity) {
  const uint32_t addr = smem_addr(bar);
  uint32_t done = 0;
  uint64_t start = 0;
  for (uint32_t tries = 1; !done; ++tries) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
    if (!done && (tries & 0xFFFF) == 0) {
      uint64_t now;
      asm volatile("mov.u64 %0, %%globaltimer;\n" : "=l"(now));
      if (start == 0) start = now;
      else if (now - start > 10000000000ull) __trap();
    }
  }
}

// ---- asynchronous copies ---------------------------------------------------

// One box of a 4D tensor map (coordinates innermost first) into shared
// memory; completion is counted on `bar` in bytes. Rows past the tensor's
// end are zero-filled.
__device__ __forceinline__ void tma_load_4d(void* dst, const CUtensorMap* map,
                                            uint64_t* bar, int c0, int c1,
                                            int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::"
      "bytes [%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(smem_addr(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_addr(bar)), "r"(c0),
      "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

// `bytes` (a multiple of 16, 16-byte aligned ends) from global to shared
// memory, counted on `bar`.
__device__ __forceinline__ void bulk_load(void* dst, const void* src,
                                          uint32_t bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(smem_addr(dst)),
      "l"(src), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}

// Orders this thread's shared-memory stores before later async-proxy
// (wgmma) reads of them.
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// Barrier `id` (1..15) over `count` threads.
__device__ __forceinline__ void named_barrier(int id, int count) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(count) : "memory");
}

// ---- wgmma -----------------------------------------------------------------

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

// Wait until at most N committed groups are in flight.
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Keeps the compiler from moving uses of these registers across a wgmma
// fence or wait.
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

// Descriptor of a 128B-swizzled operand at `p` (see the layout note above):
// K-major, or MN-major with 64-column groups `group_bytes` apart.
__device__ __forceinline__ uint64_t desc_k(const void* p) {
  return (1ull << 62) | (64ull << 32) | (1ull << 16) |
         (uint64_t)((smem_addr(p) >> 4) & 0x3FFF);
}

__device__ __forceinline__ uint64_t desc_mn(const void* p, uint32_t group_bytes) {
  return (1ull << 62) | (64ull << 32) |
         ((uint64_t)((group_bytes >> 4) & 0x3FFF) << 16) |
         (uint64_t)((smem_addr(p) >> 4) & 0x3FFF);
}

#define FA_ACC4(d, i) "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3])
#define FA_ACC16(d, i) \
  FA_ACC4(d, i), FA_ACC4(d, i + 4), FA_ACC4(d, i + 8), FA_ACC4(d, i + 12)
#define FA_ACC32(d, i) FA_ACC16(d, i), FA_ACC16(d, i + 16)
#define FA_ACC64(d) FA_ACC32(d, 0), FA_ACC32(d, 32)

#define FA_R32                                                              \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, " \
  "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "  \
  "%30, %31}"
#define FA_R64                                                              \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, " \
  "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "  \
  "%30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, "  \
  "%44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, "  \
  "%58, %59, %60, %61, %62, %63}"

// d (64 x N, fp32) = A B + (scale_d ? d : 0), A and B from shared memory
// (N = 64, the width of every shared-memory product here).
#define FA_WGMMA_SS(N, TY, REGS, ACC, IA, IB, ISC, ITA, ITB)                \
  asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %" #ISC ", 0;\n"           \
               "wgmma.mma_async.sync.aligned.m64n" #N "k16.f32." TY "." TY \
               " " REGS ", %" #IA ", %" #IB ", p, 1, 1, %" #ITA ", %" #ITB \
               ";\n}\n"                                                     \
               : ACC                                                        \
               : "l"(da), "l"(db), "r"(scale_d), "n"(TA), "n"(TB))

template <typename T, int N, int TA, int TB>
__device__ __forceinline__ void wgmma_ss(float (&d)[N / 2], uint64_t da,
                                         uint64_t db, int scale_d) {
  static_assert(N == 64, "wgmma_ss: N");
  if constexpr (std::is_same<T, __nv_bfloat16>::value) {
    FA_WGMMA_SS(64, "bf16", FA_R32, FA_ACC32(d, 0), 32, 33, 34, 35, 36);
  } else {
    FA_WGMMA_SS(64, "f16", FA_R32, FA_ACC32(d, 0), 32, 33, 34, 35, 36);
  }
}

// d (64 x N, fp32) = A B + (scale_d ? d : 0), A (64 x 16) from registers
// in the layout of pack_a, B from shared memory.
template <typename T, int N, int TB>
__device__ __forceinline__ void wgmma_rs(float (&d)[N / 2],
                                         const uint32_t (&a)[4], uint64_t db,
                                         int scale_d) {
  static_assert(N == 64 || N == 128, "wgmma_rs: N");
  constexpr bool BF16 = std::is_same<T, __nv_bfloat16>::value;
  if constexpr (N == 64) {
    if constexpr (BF16) {
      asm volatile(
          "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
          "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " FA_R32
          ", {%32, %33, %34, %35}, %36, p, 1, 1, %38;\n}\n"
          : FA_ACC32(d, 0)
          : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d),
            "n"(TB));
    } else {
      asm volatile(
          "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
          "wgmma.mma_async.sync.aligned.m64n64k16.f32.f16.f16 " FA_R32
          ", {%32, %33, %34, %35}, %36, p, 1, 1, %38;\n}\n"
          : FA_ACC32(d, 0)
          : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d),
            "n"(TB));
    }
  } else {
    if constexpr (BF16) {
      asm volatile(
          "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
          "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 " FA_R64
          ", {%64, %65, %66, %67}, %68, p, 1, 1, %70;\n}\n"
          : FA_ACC64(d)
          : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d),
            "n"(TB));
    } else {
      asm volatile(
          "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
          "wgmma.mma_async.sync.aligned.m64n128k16.f32.f16.f16 " FA_R64
          ", {%64, %65, %66, %67}, %68, p, 1, 1, %70;\n}\n"
          : FA_ACC64(d)
          : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d),
            "n"(TB));
    }
  }
}

// Accumulator n8 blocks 2 kk and 2 kk + 1 of `c` as the A operand of a
// product over those 16 columns.
template <typename T, int N>
__device__ __forceinline__ void pack_a(uint32_t (&a)[4], const float (&c)[N],
                                       int kk) {
  using E = Elem<T>;
  a[0] = E::pack(c[8 * kk + 0], c[8 * kk + 1]);
  a[1] = E::pack(c[8 * kk + 2], c[8 * kk + 3]);
  a[2] = E::pack(c[8 * kk + 4], c[8 * kk + 5]);
  a[3] = E::pack(c[8 * kk + 6], c[8 * kk + 7]);
}

// ---- tiles -----------------------------------------------------------------

// A tile of ROWS rows by D columns of 2-byte elements in the panel layout.
template <int ROWS, int D>
struct Tile {
  static constexpr int PANEL_BYTES = ROWS * 128;
  static constexpr int BYTES = PANEL_BYTES * (D / 64);

  // K-major operand: rows [row0, row0 + 64 or N), depth slice [16 kk, +16).
  static __device__ __forceinline__ uint64_t k_slice(const unsigned char* t,
                                                     int row0, int kk) {
    return desc_k(t + (kk / 4) * PANEL_BYTES + row0 * 128 + (kk % 4) * 32);
  }
  // MN-major operand: depth rows [row0, row0 + 16), every column.
  static __device__ __forceinline__ uint64_t mn_slice(const unsigned char* t,
                                                      int row0) {
    return desc_mn(t + row0 * 128, PANEL_BYTES);
  }
};

// Byte offset of the 4-byte pair at (row, col), col even, in one 128B-swizzled
// panel of 64 columns.
__device__ __forceinline__ int swz128(int row, int col) {
  return row * 128 + ((((col >> 3) ^ row) & 7) << 4) + (col & 7) * 2;
}

// Rounds the dynamic shared-memory base up to 1024 bytes (the swizzle's
// period); the launch asks for 1024 bytes more than the layout needs.
__device__ __forceinline__ unsigned char* align_1024(unsigned char* p) {
  const uint32_t a = smem_addr(p);
  return p + (((a + 1023) & ~1023u) - a);
}

}  // namespace sm90
}  // namespace fa
