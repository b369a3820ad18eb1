// The packed varlen attention backward (B6) at head dims 96 and 256: the
// kernels of csrc/flash_varlen.cuh instantiated here, beside
// csrc/flash_varlen.cu's 64 and 128, so that the two sources compile side
// by side. The C entry points in flash_varlen.cu call these launches for
// those head dims.

#include "flash_varlen.cuh"

namespace fa {
namespace varlen_bwd {

using WideDims = Dims<96, 256>;

cudaError_t run_pre_wide(bool bf16, int d, const PreParams& p, cudaStream_t st) {
  return dispatch_dims<Pre>(WideDims{}, bf16, d, p, st);
}

cudaError_t run_dkdv_wide(bool bf16, int d, const BwdMaps& maps, const VarlenParams& p,
                          cudaStream_t st) {
  return dispatch_dims<Dkdv>(WideDims{}, bf16, d, maps, p, st);
}

cudaError_t run_dq_wide(bool bf16, int d, const BwdMaps& maps, const VarlenParams& p,
                        cudaStream_t st) {
  return dispatch_dims<Dq>(WideDims{}, bf16, d, maps, p, st);
}

}  // namespace varlen_bwd
}  // namespace fa
