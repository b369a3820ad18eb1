// The dense attention backward's instantiations at head dim 80
// (BTLM-3B-8K: 32 heads of 80): the preprocess, dK/dV (with and without the
// fused pass's dQ) and dQ, band-free and with the band, in a source of
// their own beside csrc/flash_bwd.cu's and csrc/flash_bwd_wide.cu's, so
// that the kernels of the other head dims keep their machine code and the
// sources build side by side (the score instantiations at 80 are in
// csrc/flash_bwd_score_80.cu). The tiles run on the plan of head dim 96
// (csrc/bwd_sm90.cuh): Q, K, V and dO come as two 64-column panels whose
// columns past 80 TMA fills with zeros (the maps carry the tensors' true
// 80 columns), S^T and dP^T run the 5 depth slices of 16 that hold data,
// and the epilogues and the fused pass's fp32 reductions write the 80
// columns alone. The C entry points in flash_bwd.cu call these launches
// for every call at d = 80.

#include "flash_bwd.cuh"

namespace fa {
namespace dense_bwd {

using Dims80 = Dims<80>;

cudaError_t run_pre_80(bool bf16, int d, const PreParams& p, cudaStream_t st) {
  return dispatch_dims<Pre>(Dims80{}, bf16, d, p, st);
}

cudaError_t run_dkdv_80(bool bf16, int d, const BwdMaps& maps, const BwdParams& p, int b,
                        int h_k, bool band, cudaStream_t st) {
  return band ? dispatch_dims<DkdvBand>(Dims80{}, bf16, d, maps, p, b, h_k, st)
              : dispatch_dims<Dkdv>(Dims80{}, bf16, d, maps, p, b, h_k, st);
}

cudaError_t run_dq_80(bool bf16, int d, const BwdMaps& maps, const BwdParams& p, int b,
                      bool band, cudaStream_t st) {
  return band ? dispatch_dims<DqBand>(Dims80{}, bf16, d, maps, p, b, st)
              : dispatch_dims<Dq>(Dims80{}, bf16, d, maps, p, b, st);
}

}  // namespace dense_bwd
}  // namespace fa
