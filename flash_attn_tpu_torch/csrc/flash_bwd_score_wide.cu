// The dense attention backward's score instantiations at head dims 96 and
// 256 (see csrc/flash_bwd_score.cu): the kernels of csrc/flash_bwd.cuh
// compiled here so that they build beside the other sources.

#include "flash_bwd.cuh"

namespace fa {
namespace dense_bwd {

using ScoreWideDims = Dims<96, 256>;

cudaError_t run_dkdv_score_wide(bool bf16, int d, const BwdMaps& maps, const BwdParams& p,
                                int b, int h_k, cudaStream_t st) {
  return dispatch_dims<DkdvScore>(ScoreWideDims{}, bf16, d, maps, p, b, h_k, st);
}

cudaError_t run_dq_score_wide(bool bf16, int d, const BwdMaps& maps, const BwdParams& p,
                              int b, cudaStream_t st) {
  return dispatch_dims<DqScore>(ScoreWideDims{}, bf16, d, maps, p, b, st);
}

}  // namespace dense_bwd
}  // namespace fa
