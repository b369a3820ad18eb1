// B4's d = dv route over caches of 1-byte codes (float8_e4m3fn or int8, the
// code a runtime field) with a bf16 q: the instantiations of
// csrc/flash_decode.cuh at KVB = 1, in a source of their own beside
// csrc/flash_decode.cu's, so that the two build side by side. Each staged
// row is read as 8-byte lane loads of codes and converted on load
// (kv8.cuh: Hopper's e4m3x2 -> f16x2 conversion, B11's role; int8 to
// float), the lane map unchanged; the rings keep their keys, each stage
// half the bytes. fa_decode calls this launch for a call with kv_code != 0.

#include "flash_decode.cuh"

namespace fa {
namespace decode {

cudaError_t run_decode_kv8(const CacheView& c, const DecodeParams& p, int cluster,
                           cudaStream_t st) {
  return launch_d<__nv_bfloat16, 1>(c, p, cluster, st);
}

}  // namespace decode
}  // namespace fa
