// B8's SCORE instantiations (softcap; the kernel of
// csrc/flash_varlen_paged.cuh) at head dims 64, 96, 128 and 256, with and
// without the window, in a source of their own beside
// csrc/flash_varlen_paged.cu's, so that the two build side by side.
// fa_varlen_paged calls this launch for a call with a cap.

#include "flash_varlen_paged.cuh"

namespace fa {
namespace varlen_paged {

cudaError_t run_varlen_paged_score(bool bf16, const FwdMaps& maps, const VarlenPagedParams& p,
                                   int d, bool band, cudaStream_t st) {
  if (bf16)
    return band ? launch_d<__nv_bfloat16, true, true>(maps, p, d, st)
                : launch_d<__nv_bfloat16, false, true>(maps, p, d, st);
  return band ? launch_d<__half, true, true>(maps, p, d, st)
              : launch_d<__half, false, true>(maps, p, d, st);
}

}  // namespace varlen_paged
}  // namespace fa
