// The packed varlen backward's score instantiations at head dims 96 and 256
// (see csrc/flash_varlen_score.cu): the kernels of csrc/flash_varlen.cuh
// compiled here so that they build beside the other sources.

#include "flash_varlen.cuh"

namespace fa {
namespace varlen_bwd {

using ScoreWideDims = Dims<96, 256>;

cudaError_t run_dkdv_score_wide(bool bf16, int d, const BwdMaps& maps, const VarlenParams& p,
                                cudaStream_t st) {
  return dispatch_dims<DkdvScore>(ScoreWideDims{}, bf16, d, maps, p, st);
}

cudaError_t run_dq_score_wide(bool bf16, int d, const BwdMaps& maps, const VarlenParams& p,
                              cudaStream_t st) {
  return dispatch_dims<DqScore>(ScoreWideDims{}, bf16, d, maps, p, st);
}

}  // namespace varlen_bwd
}  // namespace fa
