// The packed varlen backward (B6) at head dim 80 (BTLM-3B-8K: 32 heads of
// 80): the preprocess, dK/dV and dQ, band-free and with the band (a window
// and attention_chunk per sequence), the kernels of csrc/flash_varlen.cuh
// in a source of their own beside csrc/flash_varlen.cu's and
// csrc/flash_varlen_wide.cu's, so that the kernels of the other head dims
// keep their machine code (the score instantiations at 80 are in
// csrc/flash_varlen_score_80.cu). The tiles run on the plan of head dim 96
// (csrc/bwd_sm90.cuh): two 64-column panels whose columns past 80 TMA fills
// with zeros, the epilogues storing the 80 columns alone. The C entry
// points in flash_varlen.cu call these launches for every call at d = 80.

#include "flash_varlen.cuh"

namespace fa {
namespace varlen_bwd {

using Dims80 = Dims<80>;

cudaError_t run_pre_80(bool bf16, int d, const PreParams& p, cudaStream_t st) {
  return dispatch_dims<Pre>(Dims80{}, bf16, d, p, st);
}

cudaError_t run_dkdv_80(bool bf16, int d, const BwdMaps& maps, const VarlenParams& p,
                        bool band, cudaStream_t st) {
  return band ? dispatch_dims<DkdvBand>(Dims80{}, bf16, d, maps, p, st)
              : dispatch_dims<Dkdv>(Dims80{}, bf16, d, maps, p, st);
}

cudaError_t run_dq_80(bool bf16, int d, const BwdMaps& maps, const VarlenParams& p, bool band,
                      cudaStream_t st) {
  return band ? dispatch_dims<DqBand>(Dims80{}, bf16, d, maps, p, st)
              : dispatch_dims<Dq>(Dims80{}, bf16, d, maps, p, st);
}

}  // namespace varlen_bwd
}  // namespace fa
