// The packed varlen backward's band instantiations (B6; BAND: window and
// chunk, per sequence, csrc/bwd_sm90.cuh) at head dims 64 and 128: the
// kernels of csrc/flash_varlen.cuh compiled here, in a source of their own
// beside the band-free ones of csrc/flash_varlen.cu, so that the two build
// side by side. The C entry points in flash_varlen.cu call these launches
// for a call with a band; csrc/flash_varlen_band_wide.cu compiles head dims
// 96 and 256.

#include "flash_varlen.cuh"

namespace fa {
namespace varlen_bwd {

using BandDims = Dims<64, 128>;

cudaError_t run_dkdv_band(bool bf16, int d, const BwdMaps& maps, const VarlenParams& p,
                          cudaStream_t st) {
  return dispatch_dims<DkdvBand>(BandDims{}, bf16, d, maps, p, st);
}

cudaError_t run_dq_band(bool bf16, int d, const BwdMaps& maps, const VarlenParams& p,
                        cudaStream_t st) {
  return dispatch_dims<DqBand>(BandDims{}, bf16, d, maps, p, st);
}

}  // namespace varlen_bwd
}  // namespace fa
