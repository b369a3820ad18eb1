// The dense attention backward's instantiations at q/k head dim 192 and v
// head dim 128 (DeepSeek-V3 trained without absorbing its MLA: 128 "nope"
// + 64 rope columns of q and k, 128 of v): the preprocess, dK/dV (with and
// without the fused pass's dQ) and dQ, band-free and without the score map,
// in a source of their own beside csrc/flash_bwd.cu's, so that the kernels
// of the other head dims keep their machine code and the sources build
// side by side. The C entry points in flash_bwd.cu call these launches for
// every call at (d, dv) = (192, 128); they refuse the band and the score
// map there (the wrappers raise before that).
//
// The plans (csrc/bwd_sm90.cuh, BwdPlan / DqPlan at DV = 128):
//
//  - dK/dV: 64 KV rows a block, as at d = 256 (128 would keep dK 96 + dV
//    64 + S^T 32 + dP^T 32 = 224 fp32 a thread before any address, and
//    spill). Each warpgroup takes half of the streamed tile's 64 q rows
//    for all four products: S^T (12 depth slices of 16) and dP^T (8) at
//    wgmma N = 32 (16 + 16 fp32 a thread), then dV += P^T dO and dK +=
//    dS^T Q from its own registers over all 128 and 192 columns (64 + 96
//    fp32 a thread), so both warpgroups issue the same products; their
//    partial dK and dV meet once, at the block's end, through the idle
//    stage ring. K (24 KB) + V (16 KB), two stages of Q (24 KB) + dO (16
//    KB) and the fused pass's dS^T tile: 137 KB of shared memory, one
//    block an SM. The fused pass (B2) adds dQ = dS K over the block's 64
//    keys into the fp32 buffer, K's panels 0 and 2 from warpgroup 0 and 1
//    from warpgroup 1. A first design split the gradients by role
//    (warpgroup 0 dK, warpgroup 1 dV) through shared A tiles: ptxas
//    serialised its products behind the warpgroup branch (C7520), and its
//    dK/dV kernel took 4.81-4.89 ms at DeepSeek-V3's layer against this
//    plan's 3.87-3.89 (tools/dv_ab.py, PERF.md §6).
//  - dQ: 128 q rows a block, a warpgroup's 64 over all 192 columns: dQ 96 +
//    S 32 + dP 32 fp32 a thread; Q (48 KB) and dO (32 KB) stay resident
//    beside two stages of K (24 KB) + V (16 KB): 161 KB, one block an SM.
//    dQ += dS K runs as N = 128 over K's first two panels and N = 64 over
//    the third.
//  - the preprocess: delta = rowsum(dO * O) over dv = 128 columns (the row
//    kernel of d = 128), the fused pass's fp32 dQ rows cleared over 192.

#include "flash_bwd.cuh"

namespace fa {
namespace dense_bwd {

cudaError_t run_pre_192(bool bf16, const PreParams& p, cudaStream_t st) {
  return bf16 ? run_pre<__nv_bfloat16, 192, 128>(p, st) : run_pre<__half, 192, 128>(p, st);
}

cudaError_t run_dkdv_192(bool bf16, const BwdMaps& maps, const BwdParams& p, int b, int h_k,
                         cudaStream_t st) {
  return bf16 ? run_dkdv<__nv_bfloat16, 192, false, false, 128>(maps, p, b, h_k, st)
              : run_dkdv<__half, 192, false, false, 128>(maps, p, b, h_k, st);
}

cudaError_t run_dq_192(bool bf16, const BwdMaps& maps, const BwdParams& p, int b,
                       cudaStream_t st) {
  return bf16 ? run_dq<__nv_bfloat16, 192, false, false, 128>(maps, p, b, st)
              : run_dq<__half, 192, false, false, 128>(maps, p, b, st);
}

}  // namespace dense_bwd
}  // namespace fa
