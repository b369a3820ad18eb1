// The dense forward's SCORE instantiations (softcap and ALiBi; B1's kernel
// of csrc/flash_fwd.cuh) at head dims 64, 96, 128 and 256, with and without
// the band, in a source of their own beside csrc/flash_fwd.cu's, so that
// the two build side by side. fa_fwd calls this launch for a call with a
// cap or slopes.

#include "flash_fwd.cuh"

namespace fa {
namespace dense_fwd {

cudaError_t run_fwd_score(bool bf16, const FwdMaps& maps, const FwdParams& p, int b, int d,
                          bool band, cudaStream_t st) {
  if (bf16)
    return band ? launch_d<__nv_bfloat16, true, true>(maps, p, b, d, st)
                : launch_d<__nv_bfloat16, false, true>(maps, p, b, d, st);
  return band ? launch_d<__half, true, true>(maps, p, b, d, st)
              : launch_d<__half, false, true>(maps, p, b, d, st);
}

}  // namespace dense_fwd
}  // namespace fa
