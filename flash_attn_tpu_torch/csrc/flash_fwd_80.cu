// The dense forward's instantiations at head dim 80 (BTLM-3B-8K: 32 heads of
// 80; B1's kernel of csrc/flash_fwd.cuh), plain, with the band, with the
// score map and with both, in a source of their own beside
// csrc/flash_fwd.cu's and csrc/flash_fwd_score.cu's, so that the kernels of
// the other head dims keep their machine code and the sources build side
// by side. The tile is the one of head dim 96: Q, K and V come as two
// 64-column panels whose columns past 80 TMA fills with zeros (the maps
// carry the tensors' true 80 columns), the QK^T product runs the 5 depth
// slices of 16 that hold data, P V runs over all 128 columns (the last 48
// are zeros, never stored), and the epilogue writes 10 16-byte chunks a
// row. fa_fwd calls this launch for every call at d = 80.

#include "flash_fwd.cuh"

namespace fa {
namespace dense_fwd {

namespace {

template <typename T>
cudaError_t launch_80(const FwdMaps& maps, const FwdParams& p, int b, bool band, bool score,
                      cudaStream_t st) {
  if (score)
    return band ? launch<T, 80, true, true>(maps, p, b, st)
                : launch<T, 80, false, true>(maps, p, b, st);
  return band ? launch<T, 80, true, false>(maps, p, b, st)
              : launch<T, 80, false, false>(maps, p, b, st);
}

}  // namespace

cudaError_t run_fwd_80(bool bf16, const FwdMaps& maps, const FwdParams& p, int b, bool band,
                       bool score, cudaStream_t st) {
  return bf16 ? launch_80<__nv_bfloat16>(maps, p, b, band, score, st)
              : launch_80<__half>(maps, p, b, band, score, st);
}

}  // namespace dense_fwd
}  // namespace fa
