// Hopper building blocks of the forward tile (csrc/fwd_sm90.cuh), the
// backward tiles (csrc/bwd_sm90.cuh), the MLA tile (csrc/mla_sm90.cuh) and
// the d = dv decode route's ring (csrc/flash_decode.cu): mbarriers, TMA tile
// loads and bulk copies, wgmma with its shared-memory descriptors, the
// layout of a tile in shared memory, where a paged cache keeps a key, and
// the host-side encoding of the TMA tensor maps.
//
// Tile layout. A tile of R rows by D columns (elements of 2 bytes) is
// stored as ceil(D / 64) panels of 64 columns (a head dim of 96 takes two:
// the TMA box past the tensor's 96 columns fills zeros); a panel is R rows
// of 128 bytes with the 128-byte swizzle (16-byte chunk c of row r at chunk
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
// register form (m64k16) has the m16n8k16 A layout of a warp's product, so
// an accumulator's n8 blocks 2 kk and 2 kk + 1 pack straight into the A
// operand of a product over those 16 columns (pack_a).
#pragma once

#include <cuda.h>
#include <cudaTypedefs.h>

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

// One plain arrival.
__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_addr(bar)) : "memory");
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

// 2^x on the special-function unit (subnormal results flush to 0).
__device__ __forceinline__ float exp2_ftz(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// tanh on the special-function unit (relative error about 2^-11).
__device__ __forceinline__ float tanh_approx(float x) {
  float y;
  asm("tanh.approx.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// ---- asynchronous copies ---------------------------------------------------

// One box of a 3D tensor map (coordinates innermost first) into shared
// memory; completion is counted on `bar` in bytes. Rows past the tensor's
// end are zero-filled.
__device__ __forceinline__ void tma_load_3d(void* dst, const CUtensorMap* map,
                                            uint64_t* bar, int c0, int c1, int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::"
      "bytes [%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(smem_addr(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_addr(bar)), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}

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

#define FA_R16 \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}"
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
// (N = 64; 128 for the MLA tile's P V and the 256-wide backward's dV, dK
// and dQ; 32 for that backward's halves of S and dP).
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
  static_assert(N == 32 || N == 64 || N == 128, "wgmma_ss: N");
  constexpr bool BF16 = std::is_same<T, __nv_bfloat16>::value;
  if constexpr (N == 32) {
    if constexpr (BF16) {
      FA_WGMMA_SS(32, "bf16", FA_R16, FA_ACC16(d, 0), 16, 17, 18, 19, 20);
    } else {
      FA_WGMMA_SS(32, "f16", FA_R16, FA_ACC16(d, 0), 16, 17, 18, 19, 20);
    }
  } else if constexpr (N == 64) {
    if constexpr (BF16) {
      FA_WGMMA_SS(64, "bf16", FA_R32, FA_ACC32(d, 0), 32, 33, 34, 35, 36);
    } else {
      FA_WGMMA_SS(64, "f16", FA_R32, FA_ACC32(d, 0), 32, 33, 34, 35, 36);
    }
  } else {
    if constexpr (BF16) {
      FA_WGMMA_SS(128, "bf16", FA_R64, FA_ACC64(d), 64, 65, 66, 67, 68);
    } else {
      FA_WGMMA_SS(128, "f16", FA_R64, FA_ACC64(d), 64, 65, 66, 67, 68);
    }
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
  static constexpr int PANELS = (D + 63) / 64;
  static constexpr int PANEL_BYTES = ROWS * 128;
  static constexpr int BYTES = PANEL_BYTES * PANELS;

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

// ---- paged caches ----------------------------------------------------------

// Where the keys of one sequence live in a paged cache (num_pages, h_k,
// page_size, d): key `key` is row key % page_size of page table_row[key /
// page_size], the table column clamped to the table and the page id to the
// pool. A linear cache (b_c, h_k, s_max, d) is the same layout with one page
// of s_max rows a batch row: table_row is nullptr and every key is on page
// `page`. A copy of gcd64(page_size) keys that starts at a multiple of that
// count stays within one page, so a 64-key tile is 64 / that many TMA boxes
// over a 4D map of the cache, each box's page resolved once.
struct PagedRows {
  const int* table_row;  // this sequence's row of the block table, or nullptr
  int page;              // the page of a linear cache (its batch row)
  int page_size, table_width, num_pages;
  __device__ __forceinline__ void locate(int key, int& pg, int& row) const {
    const int col = key / page_size;
    pg = table_row == nullptr
             ? page
             : min(max(table_row[min(col, table_width - 1)], 0), num_pages - 1);
    row = key - col * page_size;
  }
};

// gcd(x, 64): the rows of one TMA box of a paged cache of pages of x rows,
// and the heads of one position in an MLA tile of a group of x heads.
inline int gcd64(int x) {
  int a = x, b = 64;
  while (b) {
    const int t = a % b;
    a = b;
    b = t;
  }
  return a;
}

// Zeroes rows [first, ROWS) of a tile of ROWS rows by D columns in the panel
// layout (whole 128-byte rows of each panel, so the swizzle does not
// matter), the block's `threads` threads sharing the stores. The caller
// fences (fence_proxy_async) and synchronises before wgmma reads them.
template <int ROWS, int D>
__device__ __forceinline__ void zero_tile_rows(unsigned char* tile, int first, int threads) {
  const int per_panel = (ROWS - first) * 8;  // 16-byte chunks
  for (int i = threadIdx.x; i < per_panel * Tile<ROWS, D>::PANELS; i += threads) {
    const int c = i / per_panel;
    const int r = first + (i - c * per_panel) / 8;
    *reinterpret_cast<uint4*>(tile + c * Tile<ROWS, D>::PANEL_BYTES + r * 128 + (i & 7) * 16) =
        make_uint4(0, 0, 0, 0);
  }
}

// Rounds the dynamic shared-memory base up to 1024 bytes (the swizzle's
// period); the launch asks for 1024 bytes more than the layout needs.
__device__ __forceinline__ unsigned char* align_1024(unsigned char* p) {
  const uint32_t a = smem_addr(p);
  return p + (((a + 1023) & ~1023u) - a);
}

// ---- host side: dispatch ---------------------------------------------------

// The head dims a source compiles, for dispatch_dims.
template <int... Ds>
struct Dims {};

// F<T, D>::run(args...) for the element type (bf16, else fp16) and the head
// dim d of a call, if d is one of Ds; cudaErrorInvalidValue otherwise.
template <template <typename, int> class F, int... Ds, typename... Args>
cudaError_t dispatch_dims(Dims<Ds...>, bool bf16, int d, const Args&... args) {
  cudaError_t err = cudaErrorInvalidValue;
  ((d == Ds ? (void)(err = bf16 ? F<__nv_bfloat16, Ds>::run(args...)
                                : F<__half, Ds>::run(args...))
            : (void)0),
   ...);
  return err;
}

// ---- host side: TMA tensor maps --------------------------------------------

// cuTensorMapEncodeTiled through the runtime's driver entry point, so that
// only the CUDA runtime is linked.
inline PFN_cuTensorMapEncodeTiled_v12000 encode_tiled() {
  static PFN_cuTensorMapEncodeTiled_v12000 fn = nullptr;
  if (fn == nullptr) {
    void* ptr = nullptr;
    cudaDriverEntryPointQueryResult found;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &ptr, cudaEnableDefault,
                                &found) == cudaSuccess &&
        found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<PFN_cuTensorMapEncodeTiled_v12000>(ptr);
  }
  return fn;
}

// The tensor map of a RANK-dimensional operand of `type`, elements of
// `elem_bytes`, whose innermost dim (the head dim, `dims[0]` elements) is
// contiguous: `dims` innermost first, `strides` the element strides of dims
// 1 .. RANK - 1. Boxes of `cols` columns by `rows` indices of dim 1 by
// `rows2` of dim 2 (RANK >= 3) and one index of every outer dim, zero fill
// past each dim's end; 64 columns of 2 bytes with the 128-byte swizzle (the
// panel layout above), or, with `swizzle` false, up to 256 columns stored
// row after row.
template <int RANK>
cudaError_t make_typed_map(CUtensorMap* map, const void* ptr, CUtensorMapDataType type,
                           int elem_bytes, const int64_t (&dims)[RANK],
                           const int64_t (&strides)[RANK - 1], int rows, int rows2 = 1,
                           int cols = 64, bool swizzle = true) {
  auto encode = encode_tiled();
  if (encode == nullptr) return cudaErrorNotSupported;
  cuuint64_t d[RANK], st[RANK - 1];
  cuuint32_t box[RANK], elem[RANK];
  for (int i = 0; i < RANK; ++i) {
    d[i] = (cuuint64_t)dims[i];
    box[i] = i == 0 ? (cuuint32_t)cols : i == 1 ? (cuuint32_t)rows : i == 2 ? (cuuint32_t)rows2 : 1;
    elem[i] = 1;
  }
  for (int i = 0; i < RANK - 1; ++i) st[i] = (cuuint64_t)strides[i] * elem_bytes;
  const CUresult r = encode(
      map, type, RANK,
      const_cast<void*>(ptr), d, st, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
      swizzle ? CU_TENSOR_MAP_SWIZZLE_128B : CU_TENSOR_MAP_SWIZZLE_NONE,
      CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
      CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

// make_typed_map for an operand of bf16 (else fp16) elements.
template <int RANK>
cudaError_t make_tile_map(CUtensorMap* map, const void* ptr, bool bf16,
                          const int64_t (&dims)[RANK], const int64_t (&strides)[RANK - 1],
                          int rows, int rows2 = 1, int cols = 64, bool swizzle = true) {
  return make_typed_map<RANK>(
      map, ptr, bf16 ? CU_TENSOR_MAP_DATA_TYPE_BFLOAT16 : CU_TENSOR_MAP_DATA_TYPE_FLOAT16, 2,
      dims, strides, rows, rows2, cols, swizzle);
}

}  // namespace sm90
}  // namespace fa
