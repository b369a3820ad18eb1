// The packed varlen backward's band instantiations at head dims 96 and 256
// (see csrc/flash_varlen_band.cu): the kernels of csrc/flash_varlen.cuh
// compiled here so that they build beside the other three sources.

#include "flash_varlen.cuh"

namespace fa {
namespace varlen_bwd {

using BandWideDims = Dims<96, 256>;

cudaError_t run_dkdv_band_wide(bool bf16, int d, const BwdMaps& maps, const VarlenParams& p,
                               cudaStream_t st) {
  return dispatch_dims<DkdvBand>(BandWideDims{}, bf16, d, maps, p, st);
}

cudaError_t run_dq_band_wide(bool bf16, int d, const BwdMaps& maps, const VarlenParams& p,
                             cudaStream_t st) {
  return dispatch_dims<DqBand>(BandWideDims{}, bf16, d, maps, p, st);
}

}  // namespace varlen_bwd
}  // namespace fa
