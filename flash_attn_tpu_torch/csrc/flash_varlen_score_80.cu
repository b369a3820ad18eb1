// The packed varlen backward's score instantiations (B6; SCORE: softcap and
// ALiBi, each sequence with its own slopes and keys, with or without a
// band) at head dim 80, on the tile plan of csrc/flash_varlen_80.cu, in a
// source of their own so that they build beside the others. The C entry
// points in flash_varlen.cu call these launches for a call at d = 80 with a
// cap or slopes.

#include "flash_varlen.cuh"

namespace fa {
namespace varlen_bwd {

using ScoreDims80 = Dims<80>;

cudaError_t run_dkdv_score_80(bool bf16, int d, const BwdMaps& maps, const VarlenParams& p,
                              cudaStream_t st) {
  return dispatch_dims<DkdvScore>(ScoreDims80{}, bf16, d, maps, p, st);
}

cudaError_t run_dq_score_80(bool bf16, int d, const BwdMaps& maps, const VarlenParams& p,
                            cudaStream_t st) {
  return dispatch_dims<DqScore>(ScoreDims80{}, bf16, d, maps, p, st);
}

}  // namespace varlen_bwd
}  // namespace fa
