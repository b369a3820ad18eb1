// The pages of a quantized KV cache that a paged prefill reaches, converted
// to bf16 / fp16 for Hopper (sm_90a): B11's conversion for the paged
// prefill B8 (kernels/kv_dequant.py).
//
// Replaces no TPU kernel of its own: it carries
// flash_attn_tpu/kernels/fp8_cast.py:28 fp8e4m3_to_bf16 (and int8's cast),
// which JAX's B8 calls on every loaded tile (flash_varlen_paged.py:62-63).
// B8's wgmma tile here stages K and V as swizzled 2-byte panels
// (fwd_sm90.cuh), which cannot take rows of 1-byte codes as they are; so
// before B8 this kernel converts exactly the pages each row of the call's
// block table reaches (those below its key count) into a pool of q's type
// under a compacted table, row s's page j at pool page s * width + j, and
// B8 runs over that pool unchanged. Pages past a row's key count are not
// written: B8 masks their keys.
//
// What bounds it on this card: it reads each reached page's codes once (1
// byte an element) and writes them once as 2-byte values, 3 bytes an
// element of K and V, a pure stream through device memory.
//
// What the design does about it: one block of 128 threads a (row, page,
// K or V, KV head) of the table; a block whose page lies past its row's key
// count exits at once. Each thread converts 16 codes a step: one 16-byte
// load, two 16-byte stores (kv8.cuh's conversion, the same as B4's: exact
// for every finite e4m3 code and every int8 value).

#include "common.cuh"
#include "kv8.cuh"

namespace {

using namespace fa;

constexpr int DQ_THREADS = 128;

struct DequantParams {
  const unsigned char* k;  // (num_pages, h_k, page_size, d) codes by strides
  const unsigned char* v;
  const int* table;        // (b, width) page ids
  const int* lens_k;       // (b,) key counts
  void* k_pool;            // (b * width, h_k, page_size, d) contiguous
  void* v_pool;
  int b, width, num_pages, h_k, page_size, d, code;
  int64_t k_sp, k_sh, k_ss, v_sp, v_sh, v_ss, t_sb;
};

// Block x: KV head x % h_k, K or V (x / h_k) % 2, table entry x / (2 h_k)
// = s * width + j.
template <typename T>
__global__ void __launch_bounds__(DQ_THREADS) kv_dequant_kernel(const DequantParams p) {
  const int kh = blockIdx.x % p.h_k;
  const int rest = blockIdx.x / p.h_k;
  const int is_v = rest & 1;
  const int sj = rest >> 1;
  const int s = sj / p.width;
  const int j = sj - s * p.width;
  if ((int64_t)j * p.page_size >= p.lens_k[s]) return;
  const int pg = min(max(p.table[(int64_t)s * p.t_sb + j], 0), p.num_pages - 1);
  const unsigned char* src = is_v ? p.v + pg * p.v_sp + kh * p.v_sh
                                  : p.k + pg * p.k_sp + kh * p.k_sh;
  const int64_t ss = is_v ? p.v_ss : p.k_ss;
  T* dst = reinterpret_cast<T*>(is_v ? p.v_pool : p.k_pool) +
           ((int64_t)sj * p.h_k + kh) * p.page_size * p.d;
  const int per_row = p.d / 16;
  for (int c = threadIdx.x; c < p.page_size * per_row; c += DQ_THREADS) {
    const int r = c / per_row;
    const int col = (c - r * per_row) * 16;
    const uint4 u = *reinterpret_cast<const uint4*>(src + r * ss + col);
    float f[16];
    kv8_to_float8(make_uint2(u.x, u.y), p.code, f);
    kv8_to_float8(make_uint2(u.z, u.w), p.code, f + 8);
    uint4 o[2];
    uint32_t* w = reinterpret_cast<uint32_t*>(o);
#pragma unroll
    for (int e = 0; e < 8; ++e) w[e] = Elem<T>::pack(f[2 * e], f[2 * e + 1]);
    uint4* out = reinterpret_cast<uint4*>(dst + (int64_t)r * p.d + col);
    out[0] = o[0];
    out[1] = o[1];
  }
}

}  // namespace

// Pages (num_pages, h_k, page_size, d) of codes (code KV_E4M3 or KV_INT8,
// kv8.cuh) by element strides (page, head, row), the head dim contiguous,
// d a multiple of 16, every start and stride 16-byte aligned; table (b,
// width) int32 by row stride t_sb; lens_k (b,) int32; the pools (b * width,
// h_k, page_size, d) contiguous of bf16 (else fp16). Returns a cudaError_t
// (0 on success).
extern "C" int fa_kv_dequant(const void* kp, const void* vp, const int* table,
                             const int* lens_k, void* k_pool, void* v_pool, int b,
                             int width, int num_pages, int h_k, int page_size, int d,
                             int code, int64_t k_sp, int64_t k_sh, int64_t k_ss,
                             int64_t v_sp, int64_t v_sh, int64_t v_ss, int64_t t_sb,
                             int is_bf16, void* stream) {
  if (b < 0 || width < 1 || num_pages < 1 || h_k < 1 || page_size < 1 || d < 16 || d % 16 ||
      (code != KV_E4M3 && code != KV_INT8) ||
      (int64_t)b * width * 2 * h_k > 0x7fffffff)
    return (int)cudaErrorInvalidValue;
  if (b == 0) return 0;
  DequantParams p;
  p.k = static_cast<const unsigned char*>(kp);
  p.v = static_cast<const unsigned char*>(vp);
  p.table = table;
  p.lens_k = lens_k;
  p.k_pool = k_pool;
  p.v_pool = v_pool;
  p.b = b;
  p.width = width;
  p.num_pages = num_pages;
  p.h_k = h_k;
  p.page_size = page_size;
  p.d = d;
  p.code = code;
  p.k_sp = k_sp; p.k_sh = k_sh; p.k_ss = k_ss;
  p.v_sp = v_sp; p.v_sh = v_sh; p.v_ss = v_ss;
  p.t_sb = t_sb;
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  const unsigned grid = (unsigned)((int64_t)b * width * 2 * h_k);
  if (is_bf16)
    kv_dequant_kernel<__nv_bfloat16><<<grid, DQ_THREADS, 0, st>>>(p);
  else
    kv_dequant_kernel<__half><<<grid, DQ_THREADS, 0, st>>>(p);
  return (int)cudaGetLastError();
}
