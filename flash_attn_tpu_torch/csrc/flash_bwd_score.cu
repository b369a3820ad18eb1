// The dense attention backward's score instantiations (SCORE: softcap and
// ALiBi, with or without a band; csrc/bwd_sm90.cuh) at head dims 64 and
// 128: the kernels of csrc/flash_bwd.cuh compiled here, in a source of
// their own beside the band-free and the band ones, so that they build side
// by side. The C entry points in flash_bwd.cu call these launches for a
// call with a cap or slopes; csrc/flash_bwd_score_wide.cu compiles head
// dims 96 and 256.

#include "flash_bwd.cuh"

namespace fa {
namespace dense_bwd {

using ScoreDims = Dims<64, 128>;

cudaError_t run_dkdv_score(bool bf16, int d, const BwdMaps& maps, const BwdParams& p, int b,
                           int h_k, cudaStream_t st) {
  return dispatch_dims<DkdvScore>(ScoreDims{}, bf16, d, maps, p, b, h_k, st);
}

cudaError_t run_dq_score(bool bf16, int d, const BwdMaps& maps, const BwdParams& p, int b,
                         cudaStream_t st) {
  return dispatch_dims<DqScore>(ScoreDims{}, bf16, d, maps, p, b, st);
}

}  // namespace dense_bwd
}  // namespace fa
