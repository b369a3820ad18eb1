// The packed varlen forwards' score instantiations (B6's and B7's kernels
// with SCORE, csrc/flash_varlen_fwd.cuh: softcap and ALiBi, each sequence
// with its own slopes and keys, with or without a band) at head dims 64,
// 96, 128 and 256, in a source of their own so that they build beside the
// others. The C entry points in flash_varlen_fwd.cu call these launches
// for a call with a cap or slopes.

#include "flash_varlen_fwd.cuh"

namespace fa {
namespace varlen_fwd {

cudaError_t run_fwd_score(bool bf16, int d, const FwdMaps& maps,
                          const VarlenFwdScoreParams& p, cudaStream_t stream) {
  return dispatch_dims<LaunchScore>(VarlenDims{}, bf16, d, maps, p, stream);
}

cudaError_t run_persistent_score(bool bf16, int d, const FwdMaps& maps,
                                 const VarlenFwdScoreParams& p, int num_sms, int* grid_out,
                                 cudaStream_t stream) {
  return dispatch_dims<LaunchPersistentScore>(VarlenDims{}, bf16, d, maps, p, num_sms,
                                              grid_out, stream);
}

}  // namespace varlen_fwd
}  // namespace fa
