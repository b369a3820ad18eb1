// The packed varlen forwards at head dim 80 (BTLM-3B-8K: 32 heads of 80):
// B6's forward and the persistent B7 (csrc/flash_varlen_fwd.cuh), plain,
// with the band, with the score map and with both, in a source of their
// own beside csrc/flash_varlen_fwd.cu's, _band.cu's and _score.cu's, so
// that the kernels of the other head dims keep their machine code. The
// tile is B1's at 80 (csrc/flash_fwd_80.cu): two 64-column panels whose
// columns past 80 TMA fills with zeros, the epilogue writing 10 16-byte
// chunks a bf16 row of each sequence's rows alone. The C entry points in
// flash_varlen_fwd.cu call these launches for every call at d = 80.

#include "flash_varlen_fwd.cuh"

namespace fa {
namespace varlen_fwd {

namespace {

template <typename T>
cudaError_t fwd_80(const FwdMaps& maps, const VarlenFwdScoreParams& p, bool band, bool score,
                   cudaStream_t st) {
  const VarlenFwdParams& base = p;
  if (score) return run_fwd<T, 80, true, true>(maps, p, st);
  return band ? run_fwd<T, 80, true>(maps, base, st) : run_fwd<T, 80, false>(maps, base, st);
}

template <typename T>
cudaError_t persistent_80(const FwdMaps& maps, const VarlenFwdScoreParams& p, bool band,
                          bool score, int num_sms, int* grid_out, cudaStream_t st) {
  const VarlenFwdParams& base = p;
  if (score) return run_persistent<T, 80, true, true>(maps, p, num_sms, grid_out, st);
  return band ? run_persistent<T, 80, true>(maps, base, num_sms, grid_out, st)
              : run_persistent<T, 80, false>(maps, base, num_sms, grid_out, st);
}

}  // namespace

cudaError_t run_fwd_80(bool bf16, const FwdMaps& maps, const VarlenFwdScoreParams& p, bool band,
                       bool score, cudaStream_t stream) {
  return bf16 ? fwd_80<__nv_bfloat16>(maps, p, band, score, stream)
              : fwd_80<__half>(maps, p, band, score, stream);
}

cudaError_t run_persistent_80(bool bf16, const FwdMaps& maps, const VarlenFwdScoreParams& p,
                              bool band, bool score, int num_sms, int* grid_out,
                              cudaStream_t stream) {
  return bf16 ? persistent_80<__nv_bfloat16>(maps, p, band, score, num_sms, grid_out, stream)
              : persistent_80<__half>(maps, p, band, score, num_sms, grid_out, stream);
}

}  // namespace varlen_fwd
}  // namespace fa
