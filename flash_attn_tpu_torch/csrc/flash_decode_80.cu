// B4's d = dv route at head dim 80 (BTLM-3B-8K: 32 heads of 80; the kernel
// of csrc/flash_decode.cuh), over caches of q's type (bf16 / fp16) and of
// 1-byte codes (bf16 q), in a source of its own beside
// csrc/flash_decode.cu's and csrc/flash_decode_kv8.cu's, so that the
// kernels of the other head dims keep their machine code and the sources
// build side by side. A staged row is 128 columns, as at 96
// (staged_dim): the cache maps carry the true 80 columns (160 bytes a row,
// or 80 of codes), and the TMA box of 128 fills the rest with zeros, which
// add nothing to a score; 16 lanes share a key, lanes 10-15 hold those
// zeros and a q of zeros, and no lane writes a column past 80 of a split's
// partial. The rings, the band, the score map and the descales are those
// of every head dim. fa_decode calls this launch for every call at d = 80.

#include "flash_decode.cuh"

namespace fa {
namespace decode {

cudaError_t run_decode_80(const CacheView& c, const DecodeParams& p, int cluster,
                          cudaStream_t st) {
  if (p.kv_code != 0) return launch<__nv_bfloat16, 80, 1>(c, p, cluster, st);
  return c.is_bf16 ? launch<__nv_bfloat16, 80, 2>(c, p, cluster, st)
                   : launch<__half, 80, 2>(c, p, cluster, st);
}

}  // namespace decode
}  // namespace fa
