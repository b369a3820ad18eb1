// Cache elements of one byte (a quantized KV cache) as floats: B11's role,
// flash_attn_tpu/kernels/fp8_cast.py:28 fp8e4m3_to_bf16, which JAX's decode
// and paged prefill kernels call on every loaded tile
// (flash_decode.py:44-50, flash_varlen_paged.py:62-63).
//
// The TPU has no fp8 datapath, so JAX relocates the bits with integer ops;
// Hopper converts natively: cvt.rn.f16x2.e4m3x2 (through cuda_fp8.h's
// __nv_cvt_fp8x2_to_halfraw2) turns two e4m3 codes into two halves, then
// f16 -> f32. Every finite e4m3 value is exact in f16, and every int8 value
// in f32, so both conversions are exact and equal JAX's on 254 of the 256
// e4m3 codes and all 256 int8 codes. The two e4m3 NaN codes (0x7F, 0xFF)
// give NaN here, where JAX's bit relocation gives a large finite value; the
// port's store saturates at +-448 and never writes them
// (dispatch/kvquant.py quantize_kv).
#pragma once

#include <cuda_fp16.h>
#include <cuda_fp8.h>
#include <stdint.h>

namespace fa {

// The codes a C entry point takes for a cache's element type
// (dispatch/kvquant.py KV_CODES; 0: the cache has q's 2-byte type).
constexpr int KV_E4M3 = 1;
constexpr int KV_INT8 = 2;

// Two e4m3 codes, the low byte first, as two floats.
__device__ __forceinline__ float2 e4m3x2_to_float2(uint32_t pair) {
  const __half2_raw h = __nv_cvt_fp8x2_to_halfraw2((__nv_fp8x2_storage_t)pair, __NV_E4M3);
  return __half22float2(__half2(h));
}

// Four codes of `code`'s type, the low byte first, as floats.
__device__ __forceinline__ void kv8_to_float4(uint32_t u, int code, float* f) {
  if (code == KV_E4M3) {
    const float2 a = e4m3x2_to_float2(u & 0xffffu), b = e4m3x2_to_float2(u >> 16);
    f[0] = a.x; f[1] = a.y; f[2] = b.x; f[3] = b.y;
  } else {
    f[0] = (float)(int8_t)(u & 0xffu);
    f[1] = (float)(int8_t)((u >> 8) & 0xffu);
    f[2] = (float)(int8_t)((u >> 16) & 0xffu);
    f[3] = (float)(int8_t)(u >> 24);
  }
}

// Eight codes (an 8-byte lane load) as floats.
__device__ __forceinline__ void kv8_to_float8(const uint2& u, int code, float* f) {
  kv8_to_float4(u.x, code, f);
  kv8_to_float4(u.y, code, f + 4);
}

}  // namespace fa
