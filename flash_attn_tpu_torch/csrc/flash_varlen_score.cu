// The packed varlen backward's score instantiations (B6; SCORE: softcap and
// ALiBi, each sequence with its own slopes and keys, with or without a
// band; csrc/bwd_sm90.cuh) at head dims 64 and 128: the kernels of
// csrc/flash_varlen.cuh compiled here, in a source of their own, so that
// they build beside the others. The C entry points in flash_varlen.cu call
// these launches for a call with a cap or slopes;
// csrc/flash_varlen_score_wide.cu compiles head dims 96 and 256.

#include "flash_varlen.cuh"

namespace fa {
namespace varlen_bwd {

using ScoreDims = Dims<64, 128>;

cudaError_t run_dkdv_score(bool bf16, int d, const BwdMaps& maps, const VarlenParams& p,
                           cudaStream_t st) {
  return dispatch_dims<DkdvScore>(ScoreDims{}, bf16, d, maps, p, st);
}

cudaError_t run_dq_score(bool bf16, int d, const BwdMaps& maps, const VarlenParams& p,
                         cudaStream_t st) {
  return dispatch_dims<DqScore>(ScoreDims{}, bf16, d, maps, p, st);
}

}  // namespace varlen_bwd
}  // namespace fa
