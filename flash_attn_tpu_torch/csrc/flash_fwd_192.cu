// The dense forward's instantiation at q/k head dim 192 and v head dim 128
// (DeepSeek-V3's attention when it is not absorbed: 128 "nope" + 64 rope
// columns of q and k, 128 of v; B1's kernel of csrc/flash_fwd.cuh), in a
// source of its own beside csrc/flash_fwd.cu's, so that the kernels of the
// other head dims keep their machine code and the sources build side by
// side. The tile (csrc/fwd_sm90.cuh, DV): Q and K as three 64-column panels
// (QK^T runs 12 depth slices of 16), V and O as two, as at d = 128, so a
// thread holds 64 O accumulators beside the 32 of S; Q (48 KB) and two
// stages of K (24 KB) + V (16 KB) take 128 KB of shared memory, one block
// an SM (fwd_min_blocks). The epilogue stores out's 128 columns. The
// causal bound, GQA and the learnable sink are runtime fields, so this one
// form takes them all; the band and the score map (template flags, each of
// which would double the instantiations) are not compiled here, and fa_fwd
// refuses them at these dims (the wrapper raises before that). fa_fwd
// calls this launch for every call at (d, dv) = (192, 128).

#include "flash_fwd.cuh"

namespace fa {
namespace dense_fwd {

cudaError_t run_fwd_192(bool bf16, const FwdMaps& maps, const FwdParams& p, int b,
                        cudaStream_t st) {
  return bf16 ? launch<__nv_bfloat16, 192, false, false, 128>(maps, p, b, st)
              : launch<__half, 192, false, false, 128>(maps, p, b, st);
}

}  // namespace dense_fwd
}  // namespace fa
