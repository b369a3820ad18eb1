// The packed varlen forwards' band instantiations (B6's and B7's kernels
// with BAND, csrc/flash_varlen_fwd.cuh) at head dims 64, 96, 128 and 256,
// in a source of their own beside the band-free ones of
// csrc/flash_varlen_fwd.cu, so that the two build side by side. The C
// entry points in flash_varlen_fwd.cu call these launches for a call with
// a band.

#include "flash_varlen_fwd.cuh"

namespace fa {
namespace varlen_fwd {

cudaError_t run_fwd_band(bool bf16, int d, const FwdMaps& maps, const VarlenFwdParams& p,
                         cudaStream_t stream) {
  return dispatch_dims<LaunchBand>(VarlenDims{}, bf16, d, maps, p, stream);
}

cudaError_t run_persistent_band(bool bf16, int d, const FwdMaps& maps,
                                const VarlenFwdParams& p, int num_sms, int* grid_out,
                                cudaStream_t stream) {
  return dispatch_dims<LaunchPersistentBand>(VarlenDims{}, bf16, d, maps, p, num_sms, grid_out,
                                             stream);
}

}  // namespace varlen_fwd
}  // namespace fa
