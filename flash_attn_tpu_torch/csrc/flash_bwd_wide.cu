// The dense attention backward at head dims 96 and 256: the kernels of
// csrc/flash_bwd.cuh instantiated here, beside csrc/flash_bwd.cu's 64 and
// 128, so that the two sources compile side by side. The C entry points in
// flash_bwd.cu call these launches for those head dims; the tiles' plan at
// each (96 as two panels with TMA's zero fill, 256 as 64-row blocks whose
// warpgroups split the columns) is in csrc/bwd_sm90.cuh.

#include "flash_bwd.cuh"

namespace fa {
namespace dense_bwd {

using WideDims = Dims<96, 256>;

cudaError_t run_pre_wide(bool bf16, int d, const PreParams& p, cudaStream_t st) {
  return dispatch_dims<Pre>(WideDims{}, bf16, d, p, st);
}

cudaError_t run_dkdv_wide(bool bf16, int d, const BwdMaps& maps, const BwdParams& p, int b,
                          int h_k, cudaStream_t st) {
  return dispatch_dims<Dkdv>(WideDims{}, bf16, d, maps, p, b, h_k, st);
}

cudaError_t run_dq_wide(bool bf16, int d, const BwdMaps& maps, const BwdParams& p, int b,
                        cudaStream_t st) {
  return dispatch_dims<Dq>(WideDims{}, bf16, d, maps, p, b, st);
}

}  // namespace dense_bwd
}  // namespace fa
