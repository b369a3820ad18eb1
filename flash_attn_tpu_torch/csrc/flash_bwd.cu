// Dense attention backward for Hopper (sm_90a) on wgmma and TMA, bf16 /
// fp16, head dims 64, 80, 96, 128 and 256, and q/k head dim 192 beside v
// head dim 128 (the kernels are in flash_bwd.cuh; this source compiles 64
// and 128 and holds the C entry points, flash_bwd_wide.cu compiles 96 and
// 256, flash_bwd_band.cu and flash_bwd_band_wide.cu the band
// instantiations, flash_bwd_score.cu and flash_bwd_score_wide.cu the score
// instantiations, flash_bwd_80.cu and flash_bwd_score_80.cu every form at
// 80, flash_bwd_192.cu the band-free, score-free form at 192 / 128).
//
// Replaces the TPU kernels flash_attn_tpu/kernels/flash_bwd.py:_dkdv_kernel
// and :_dq_kernel (the deterministic two-kernel backward),
// flash_attn_tpu/kernels/flash_bwd_fused.py:_bwd_fused_kernel (the fused
// single pass) and flash_attn_tpu/kernels/flash_bwd_split.py:
// _bwd_diag_merge_kernel (the causal diagonal as a second launch), and the
// XLA op that computed delta before them (flash_bwd.py:406-413). Three
// kernels:
//
//  - preprocess_kernel: delta = rowsum(dO * O) in fp32 and lse in base 2,
//    one warp per (row, head), into (b, h, sq_pad) buffers padded to the
//    tiles (delta 0 and lse +inf past sq, so a padded row's P is 0); for the
//    fused path it also zeroes the fp32 dQ buffer;
//  - dkdv_kernel<ACCUM_DQ = false>: one block per (128 KV rows, KV head,
//    batch row) walks the group's query heads and the 64-row q tiles of its
//    causal band, keeps dK and dV in registers and writes them once
//    (deterministic); dq_kernel: one block per (128 q rows, head, batch row)
//    walks the 64-key tiles of its band and writes dQ once (deterministic);
//  - dkdv_kernel<ACCUM_DQ = true>: the fused single pass, which also adds
//    each q tile's dQ = dS K over the block's 128 keys into a zeroed fp32
//    buffer with vector reductions (red.global.add.v2.f32), each element
//    once a block; the order of the adds varies, so its last bits may vary
//    from run to run.
//
// What bounds it on this card: tensor cores. Per (q tile, KV tile) pair the
// two-kernel form runs 7 tile products (S and dP twice) and the fused form
// 5, against 2 in the forward: at the training shape (b = 4, s = 2048,
// h = 16, d = 128, causal) 172 GFLOP of useful products, 0.17 ms at 989
// TFLOP/s, while its bytes take 0.04 ms at 3.35 TB/s.
//
// What the design does about it: the dK/dV and dQ kernels run the
// backward tiles of csrc/bwd_sm90.cuh (every product a warpgroup wgmma, the
// resident K/V or Q/dO tiles and a two-stage TMA ring of the streamed ones;
// see its note) with the dense source below: 4D tensor maps over (b, s, h,
// d), whose boxes past sq or sk TMA fills with zeros. Each thread keeps
// 64 + 64 fp32 accumulators of dK and dV at d = 128 within the 255
// registers that a 256-thread block allows, so no register rebalancing
// (setmaxnreg) or separate producer warp is needed. At d = 96 the tiles
// run as at 128 over TMA's zero-filled columns past 96 (and at d = 80,
// BTLM-3B-8K's, past 80, in instantiations of their own so that no other
// head dim's kernels change machine code); at d = 256 a block
// owns 64 rows, its warpgroups split S and dP by rows of the streamed tile
// and then the gradients' columns (bwd_sm90.cuh's note has the register
// and shared-memory plan). One block barrier a
// tile keeps the two warpgroups in step: freeing each stage by mbarrier
// arrivals instead, a third stage, or issuing the next tile's products
// before the last one's end let them drift and made both kernels slower on
// the card (PERF.md §6). The fused form stages both warpgroups' dS^T
// (8 KB each; zeros from a warpgroup whose keys see no row of the tile, so
// that no product is skipped by a branch) in shared memory, and each
// warpgroup computes one 64-column half of dQ = dS K over all 128 keys:
// half the reductions of one partial a warpgroup. Only the
// tiles that cross the causal diagonal or the ragged end of the keys run
// the mask; rows past sq take P = 0 from their padded lse. Blocks are
// launched heaviest first (the first KV tiles, the last q tiles, under
// causal masking).
//
// The band masks (window, chunk and sinks; flash_bwd.py:103-139, the same
// in flash_bwd_fused.py:363-383) run in their own instantiations (BAND)
// of all three products' kernels: a dK/dV block walks only the q tiles of
// its keys' band (common.cuh QueryRange, the mirror of flash_bwd.py:157
// _q_block_bounds, also past the TPU's sink rule: a key tile wholly past
// the sinks is bounded too) and a dQ block only the key tiles of its rows'
// band (KeyRange, as the forward); the tiles that cross an edge of the
// band test each score against per-key (dK/dV) or per-row (dQ) bounds made
// once a tile, in a loop apart from the unmasked tiles'. A 4096-key window
// over 8192 causal keys keeps 0.750 of the pairs, and the pair runs in
// about that share of the band-free pair's time. A call without a band
// runs the band-free instantiations, the kernels of the earlier releases,
// with the same bits and machine code.
//
// softcap and ALiBi (flash_bwd.py:55-101, the map flash_bwd_fused.py
// recomputes too, its slopes at :176-179) run in the score instantiations
// (SCORE) of all three products' kernels, which are band instantiations
// with the causal bound as a band of right extent 0: each rebuilt score is
// capped, taken to base 2 and biased by its query head's slope as the
// forward maps it (the last-key form of the forward's lse), then masked by
// the band; under a cap dS is multiplied by the tanh derivative, kept as a
// half2 pair a register (bwd_sm90.cuh bwd_score_map).
//
// Conventions: softmax_scale is natural; lse is natural-log (b, h, sq) and
// -inf for a row that sees no key (its P is 0). Causal masking is
// bottom-right aligned (shift = sk - sq). The tensor maps are encoded on the
// host for every call by cuTensorMapEncodeTiled, a CUDA driver API function
// reached with cudaGetDriverEntryPoint so that only the runtime is linked
// (sm90.cuh make_tile_map).

#include "flash_bwd.cuh"

namespace {

using namespace fa::sm90;
using namespace fa::dense_bwd;

// ---- host side --------------------------------------------------------------

// The tensor map of a (b, s, h, d) operand given by element strides (the
// head dim contiguous): boxes of 64 columns by `rows` rows of one head,
// 128-byte swizzle, rows past s zero-filled.
cudaError_t make_map(CUtensorMap* map, const void* ptr, bool bf16, int d, int s,
                     int h, int b, int64_t ss, int64_t sh, int64_t sb, int rows) {
  return make_tile_map<4>(map, ptr, bf16, {d, s, h, b}, {ss, sh, sb}, rows);
}

struct Operands {
  const void* q;
  const void* k;
  const void* v;
  const void* dout;
  int64_t q_sb, q_ss, q_sh, k_sb, k_ss, k_sh, v_sb, v_ss, v_sh, do_sb, do_ss, do_sh;
};

// Maps of q (d columns) and dout (dv) with boxes of q_rows rows, k (d) and
// v (dv) of kv_rows rows.
cudaError_t make_maps(BwdMaps* m, const Operands& o, bool bf16, int b, int sq, int sk,
                      int h, int h_k, int d, int dv, int q_rows, int kv_rows) {
  cudaError_t err;
  if ((err = make_map(&m->q, o.q, bf16, d, sq, h, b, o.q_ss, o.q_sh, o.q_sb, q_rows)) ||
      (err = make_map(&m->dout, o.dout, bf16, dv, sq, h, b, o.do_ss, o.do_sh, o.do_sb,
                      q_rows)) ||
      (err = make_map(&m->k, o.k, bf16, d, sk, h_k, b, o.k_ss, o.k_sh, o.k_sb, kv_rows)) ||
      (err = make_map(&m->v, o.v, bf16, dv, sk, h_k, b, o.v_ss, o.v_sh, o.v_sb, kv_rows)))
    return err;
  return cudaSuccess;
}

BwdParams make_params(const float* lse2, const float* delta, int sq, int sk, int sq_pad,
                      int h, int h_k, int d, float scale, int causal, const fa::Band& band,
                      float softcap, const float* slopes, int64_t slope_sb) {
  BwdParams p = {};
  p.lse2 = lse2;
  p.delta = delta;
  p.sq = sq;
  p.sk = sk;
  p.sq_pad = sq_pad;
  p.h = h;
  p.d = d;
  p.a = {scale, scale * FA_LOG2E, causal, h / h_k};
  p.band = band;
  p.score = fa::score_from_args(scale * FA_LOG2E, softcap, causal);
  p.slopes = slopes;
  p.slope_sb = slope_sb;
  return p;
}

// (d, dv) = (192, 128): the q/k and v head dims of flash_bwd_192.cu's form.
bool mla_dims(int d, int dv) { return d == 192 && dv == 128; }

bool valid(int b, int sq, int sk, int sq_pad, int h, int h_k, int d, int dv) {
  return b > 0 && sq > 0 && sk > 0 && h_k > 0 && h % h_k == 0 &&
         (mla_dims(d, dv) ||
          (dv == d && (d == 64 || d == 80 || d == 96 || d == 128 || d == 256))) &&
         sq_pad % BWD_ROW_PAD == 0 &&
         sq_pad >= sq;
}

// Whether the kernels take a call's band (dispatch/band.py band_args) and
// cap; `masked`: the call runs a band or score instantiation, which takes
// the causal bound as right = 0.
bool valid_band(int causal, int right, int sink, int chunk, int masked, float softcap) {
  return sink >= 0 && chunk >= 0 && !(causal && right != 0 && masked) && softcap >= 0.f;
}

// The head dims this source compiles; 96 and 256 go to flash_bwd_wide.cu,
// 80 to flash_bwd_80.cu.
using NarrowDims = Dims<64, 128>;
bool wide(int d) { return d == 96 || d == 256; }

}  // namespace

// delta = rowsum(dout * out) (b, h, sq_pad) fp32 and lse2 = lse * log2(e)
// (+inf where lse is -inf), delta 0 and lse2 +inf on the rows [sq, sq_pad);
// with dq_accum (b, sq, h, d) fp32 given, also zeroes it. dout/out (b, sq,
// h, dv) by element strides with the head dim contiguous; lse (b, h, sq)
// contiguous fp32. d is q's head dim (dq_accum's columns). Returns a
// cudaError_t (0 on success).
extern "C" int fa_bwd_preprocess(const void* dout, const void* out, const float* lse,
                                 float* lse2, float* delta, float* dq_accum, int b,
                                 int sq, int sq_pad, int h, int d, int dv, int64_t do_sb,
                                 int64_t do_ss, int64_t do_sh, int64_t o_sb,
                                 int64_t o_ss, int64_t o_sh, int is_bf16, void* stream) {
  if (!valid(b, sq, 1, sq_pad, h, 1, d, dv)) return (int)cudaErrorInvalidValue;
  const PreParams p = {dout, out, lse, lse2, delta, dq_accum, b, sq, sq_pad, h,
                       do_sb, do_ss, do_sh, o_sb, o_ss, o_sh};
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  if (mla_dims(d, dv)) return (int)run_pre_192(is_bf16, p, st);
  if (d == 80) return (int)run_pre_80(is_bf16, d, p, st);
  return (int)(wide(d) ? run_pre_wide(is_bf16, d, p, st)
                       : dispatch_dims<Pre>(NarrowDims{}, is_bf16, d, p, st));
}

// dK and dV (and, with dq_accum given, dQ * scale added into it). q (b, sq,
// h, d), dout (b, sq, h, dv), k and dk (b, sk, h_k, d), v and dv (b, sk,
// h_k, dv), all by element strides with
// the head dim contiguous, 16-byte aligned starts and strides (TMA); lse2 and
// delta (b, h, sq_pad) from fa_bwd_preprocess; dq_accum (b, sq, h, d)
// contiguous fp32, zeroed. block_q/block_k must name the tile the kernel is
// compiled for at head dim d (dispatch/config.py dense_bwd_tiles). The band
// (dispatch/band.py band_args): window extents left and right (-1: no
// bound; right 0 under causal masking), sink tokens and the chunk, read
// when `band` is set, which launches the band instantiation. softcap (0:
// none) and the ALiBi slopes (b, h) fp32 at slopes[bb * slope_sb + hh]
// (slope_sb 0 for one slope a head; nullptr: no ALiBi) launch the score
// instantiation, which reads the band always (band_args' form: no bound
// but the causal one when there is no band). (d, dv) = (192, 128) takes
// neither the band nor the score map. Returns a cudaError_t.
extern "C" int fa_bwd_dkdv(const void* q, const void* k, const void* v,
                           const void* dout, const float* lse2,
                           const float* delta, void* dk, void* dv,
                           float* dq_accum, int b, int sq, int sk, int sq_pad,
                           int h, int h_k, int d, int d_v, int block_q, int block_k,
                           int64_t q_sb, int64_t q_ss, int64_t q_sh,
                           int64_t k_sb, int64_t k_ss, int64_t k_sh,
                           int64_t v_sb, int64_t v_ss, int64_t v_sh,
                           int64_t do_sb, int64_t do_ss, int64_t do_sh,
                           int64_t dk_sb, int64_t dk_ss, int64_t dk_sh,
                           int64_t dv_sb, int64_t dv_ss, int64_t dv_sh,
                           float scale, int causal, int left, int right, int sink,
                           int chunk, int band, float softcap, const float* slopes,
                           int64_t slope_sb, int is_bf16, void* stream) {
  const bool score = softcap > 0.f || slopes != nullptr;
  if (block_q != BWD_KV_BM || block_k != bwd_block_rows(d) ||
      !valid(b, sq, sk, sq_pad, h, h_k, d, d_v) ||
      !valid_band(causal, right, sink, chunk, band || score, softcap) ||
      (mla_dims(d, d_v) && (band || score)))
    return (int)cudaErrorInvalidValue;
  const Operands o = {q, k, v, dout, q_sb, q_ss, q_sh, k_sb, k_ss, k_sh,
                      v_sb, v_ss, v_sh, do_sb, do_ss, do_sh};
  BwdMaps maps;
  cudaError_t err = make_maps(&maps, o, is_bf16, b, sq, sk, h, h_k, d, d_v, BWD_KV_BM,
                              bwd_block_rows(d));
  if (err != cudaSuccess) return (int)err;
  BwdParams p = make_params(lse2, delta, sq, sk, sq_pad, h, h_k, d, scale, causal,
                            fa::band_from_args(left, right, sink, chunk), softcap, slopes,
                            slope_sb);
  p.dk = dk;
  p.dv = dv;
  p.dq_accum = dq_accum;
  p.dk_sb = dk_sb; p.dk_ss = dk_ss; p.dk_sh = dk_sh;
  p.dv_sb = dv_sb; p.dv_ss = dv_ss; p.dv_sh = dv_sh;
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  if (mla_dims(d, d_v)) return (int)run_dkdv_192(is_bf16, maps, p, b, h_k, st);
  if (d == 80)
    return (int)(score ? run_dkdv_score_80(is_bf16, d, maps, p, b, h_k, st)
                       : run_dkdv_80(is_bf16, d, maps, p, b, h_k, band, st));
  if (score)
    return (int)(wide(d) ? run_dkdv_score_wide(is_bf16, d, maps, p, b, h_k, st)
                         : run_dkdv_score(is_bf16, d, maps, p, b, h_k, st));
  if (band)
    return (int)(wide(d) ? run_dkdv_band_wide(is_bf16, d, maps, p, b, h_k, st)
                         : run_dkdv_band(is_bf16, d, maps, p, b, h_k, st));
  return (int)(wide(d) ? run_dkdv_wide(is_bf16, d, maps, p, b, h_k, st)
                       : dispatch_dims<Dkdv>(NarrowDims{}, is_bf16, d, maps, p, b, h_k, st));
}

// dQ (b, sq, h, d) in q's type, written once. Layouts, the band and the
// score map as fa_bwd_dkdv; block_q names bwd_dq_rows(d, d_v).
extern "C" int fa_bwd_dq(const void* q, const void* k, const void* v,
                         const void* dout, const float* lse2,
                         const float* delta, void* dq, int b, int sq, int sk,
                         int sq_pad, int h, int h_k, int d, int d_v, int block_q, int block_k,
                         int64_t q_sb, int64_t q_ss, int64_t q_sh,
                         int64_t k_sb, int64_t k_ss, int64_t k_sh,
                         int64_t v_sb, int64_t v_ss, int64_t v_sh,
                         int64_t do_sb, int64_t do_ss, int64_t do_sh,
                         int64_t dq_sb, int64_t dq_ss, int64_t dq_sh,
                         float scale, int causal, int left, int right, int sink,
                         int chunk, int band, float softcap, const float* slopes,
                         int64_t slope_sb, int is_bf16, void* stream) {
  const bool score = softcap > 0.f || slopes != nullptr;
  if (block_q != bwd_dq_rows(d, d_v) || block_k != BWD_Q_BN ||
      !valid(b, sq, sk, sq_pad, h, h_k, d, d_v) ||
      !valid_band(causal, right, sink, chunk, band || score, softcap) ||
      (mla_dims(d, d_v) && (band || score)))
    return (int)cudaErrorInvalidValue;
  const Operands o = {q, k, v, dout, q_sb, q_ss, q_sh, k_sb, k_ss, k_sh,
                      v_sb, v_ss, v_sh, do_sb, do_ss, do_sh};
  BwdMaps maps;
  cudaError_t err = make_maps(&maps, o, is_bf16, b, sq, sk, h, h_k, d, d_v,
                              bwd_dq_rows(d, d_v), BWD_Q_BN);
  if (err != cudaSuccess) return (int)err;
  BwdParams p = make_params(lse2, delta, sq, sk, sq_pad, h, h_k, d, scale, causal,
                            fa::band_from_args(left, right, sink, chunk), softcap, slopes,
                            slope_sb);
  p.dq = dq;
  p.dq_sb = dq_sb; p.dq_ss = dq_ss; p.dq_sh = dq_sh;
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  if (mla_dims(d, d_v)) return (int)run_dq_192(is_bf16, maps, p, b, st);
  if (d == 80)
    return (int)(score ? run_dq_score_80(is_bf16, d, maps, p, b, st)
                       : run_dq_80(is_bf16, d, maps, p, b, band, st));
  if (score)
    return (int)(wide(d) ? run_dq_score_wide(is_bf16, d, maps, p, b, st)
                         : run_dq_score(is_bf16, d, maps, p, b, st));
  if (band)
    return (int)(wide(d) ? run_dq_band_wide(is_bf16, d, maps, p, b, st)
                         : run_dq_band(is_bf16, d, maps, p, b, st));
  return (int)(wide(d) ? run_dq_wide(is_bf16, d, maps, p, b, st)
                       : dispatch_dims<Dq>(NarrowDims{}, is_bf16, d, maps, p, b, st));
}
