// The dense attention backward's band instantiations at head dims 96 and
// 256 (see csrc/flash_bwd_band.cu): the kernels of csrc/flash_bwd.cuh
// compiled here so that they build beside the other three sources.

#include "flash_bwd.cuh"

namespace fa {
namespace dense_bwd {

using BandWideDims = Dims<96, 256>;

cudaError_t run_dkdv_band_wide(bool bf16, int d, const BwdMaps& maps, const BwdParams& p,
                               int b, int h_k, cudaStream_t st) {
  return dispatch_dims<DkdvBand>(BandWideDims{}, bf16, d, maps, p, b, h_k, st);
}

cudaError_t run_dq_band_wide(bool bf16, int d, const BwdMaps& maps, const BwdParams& p, int b,
                             cudaStream_t st) {
  return dispatch_dims<DqBand>(BandWideDims{}, bf16, d, maps, p, b, st);
}

}  // namespace dense_bwd
}  // namespace fa
