// The dense attention backward's score instantiations (SCORE: softcap and
// ALiBi, with or without a band) at head dim 80, BTLM-3B-8K's training
// path: the kernels of csrc/flash_bwd.cuh on the tile plan of
// csrc/flash_bwd_80.cu, in a source of their own so that they build beside
// the others. The C entry points in flash_bwd.cu call these launches for a
// call at d = 80 with a cap or slopes.

#include "flash_bwd.cuh"

namespace fa {
namespace dense_bwd {

using ScoreDims80 = Dims<80>;

cudaError_t run_dkdv_score_80(bool bf16, int d, const BwdMaps& maps, const BwdParams& p,
                              int b, int h_k, cudaStream_t st) {
  return dispatch_dims<DkdvScore>(ScoreDims80{}, bf16, d, maps, p, b, h_k, st);
}

cudaError_t run_dq_score_80(bool bf16, int d, const BwdMaps& maps, const BwdParams& p, int b,
                            cudaStream_t st) {
  return dispatch_dims<DqScore>(ScoreDims80{}, bf16, d, maps, p, b, st);
}

}  // namespace dense_bwd
}  // namespace fa
