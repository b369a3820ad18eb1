// B8's instantiations at head dim 80 (the kernel of
// csrc/flash_varlen_paged.cuh), plain, with the window, under the cap and
// with both, in a source of their own beside csrc/flash_varlen_paged.cu's
// and csrc/flash_varlen_paged_score.cu's, so that the kernels of the other
// head dims keep their machine code and the sources build side by side.
// The tile is the one of head dim 96 (csrc/flash_fwd_80.cu says how): the
// maps of q and of the pages carry the true 80 columns, and TMA fills the
// panels' columns past them with zeros. Pages of 1-byte codes are
// converted first (csrc/kv_dequant.cu), as at every head dim, and the
// descales are the same runtime fields. fa_varlen_paged calls this launch
// for every call at d = 80.

#include "flash_varlen_paged.cuh"

namespace fa {
namespace varlen_paged {

namespace {

template <typename T>
cudaError_t launch_80(const FwdMaps& maps, const VarlenPagedParams& p, bool band, bool score,
                      cudaStream_t st) {
  if (score)
    return band ? launch<T, 80, true, true>(maps, p, st)
                : launch<T, 80, false, true>(maps, p, st);
  return band ? launch<T, 80, true, false>(maps, p, st)
              : launch<T, 80, false, false>(maps, p, st);
}

}  // namespace

cudaError_t run_varlen_paged_80(bool bf16, const FwdMaps& maps, const VarlenPagedParams& p,
                                bool band, bool score, cudaStream_t st) {
  return bf16 ? launch_80<__nv_bfloat16>(maps, p, band, score, st)
              : launch_80<__half>(maps, p, band, score, st);
}

}  // namespace varlen_paged
}  // namespace fa
