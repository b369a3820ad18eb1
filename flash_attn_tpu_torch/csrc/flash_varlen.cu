// Packed varlen attention backward for Hopper (sm_90a) on wgmma and TMA,
// bf16 / fp16, head dims 64, 80, 96, 128 and 256: B6's preprocess, dK/dV
// and dQ kernels (in flash_varlen.cuh; this source compiles 64 and 128 and
// holds the C entry points, flash_varlen_wide.cu compiles 96 and 256,
// flash_varlen_80.cu and flash_varlen_score_80.cu every form at 80 on the
// tile plan of 96,
// flash_varlen_band.cu and flash_varlen_band_wide.cu the band
// instantiations: a window and attention_chunk per sequence, masked as
// B3's band instantiations mask them, flash_varlen.py:47-76;
// flash_varlen_score.cu and flash_varlen_score_wide.cu the score
// instantiations: softcap and ALiBi, each sequence with its own slopes and
// keys, mapped as B3's score instantiations map them, flash_varlen.py:
// 554-557 and :717-720).
// The forward (B6's and the persistent B7) runs the wgmma/TMA tile of
// fwd_sm90.cuh in flash_varlen_fwd.cu.
//
// Replaces the TPU kernels flash_attn_tpu/kernels/flash_varlen.py:
// _varlen_dkdv_stream_kernel and _varlen_dq_stream_kernel, and the XLA op
// that computed delta before them (flash_varlen.py:854-855):
//
//  - varlen_preprocess_kernel: delta = rowsum(dO * O) in fp32 and lse in
//    base 2, a warp a row, into (h, rows_pad) buffers padded per sequence
//    to whole 128-row tiles (delta 0 and lse2 +inf past the sequence's
//    rows); its other blocks zero the gradient rows that no tile writes
//    (rows past seqused, the packed tail past cu_seqlens[-1]);
//  - varlen_dkdv_kernel: one block per (128-key tile of a sequence, KV
//    head) walks the group's query heads and the 64-row q tiles of the
//    sequence's causal band in a fixed order and writes dK and dV once;
//  - varlen_dq_kernel: one block per (128-row q tile of a sequence, head)
//    walks the 64-key tiles of its band and writes dQ once.
//
// No atomics: each gradient element is written once, so two runs give the
// same bits.
//
// What bounds it on this card: per head, a sequence of sq rows over sk keys
// runs 8 (dK/dV: S, dP, dV, dK) + 6 (dQ: S, dP, dQ) flops per (row, key)
// pair and head-dim element, about half of them under the causal mask, and
// moves q, k, v, dout, lse, delta and the three gradients once. bench.py's
// mixed lengths (16 sequences of 2048-4096 at d = 128, causal) are tensor-
// core bound (2.3 ms at 989 TFLOP/s); BERT-large's packing (d = 64, 256-512
// rows, not causal) is near the line between the two (~0.05 ms of bytes).
//
// What the design does about it: the kernels run B3's tiles
// (csrc/bwd_sm90.cuh: every product a warpgroup wgmma, the resident K/V or
// Q/dO tiles and a two-stage TMA ring of the streamed ones) with the
// packed source below. The TPU kernels tile the flat token axis with
// aligned blocks, because a DMA must be aligned, and rebuild the sequences
// from per-token segment ids. Here every tile belongs to one sequence: the
// wrapper's work lists (dispatch/varlen_meta.py: k_schedule of 128-key
// tiles ordered by the q rows that see them, the schedule of 128-row q
// tiles ordered by their key band, heaviest first, as B3 launches its
// grid) give (sequence, first local row), and a block finds its sequence's
// origin in cu_seqlens and its lengths (seqused where given). At d = 256,
// where B3's blocks own 64 rows (bwd_sm90.cuh), a 128-row tile of the lists
// is two blocks of 64, so that the lists stay those of every head dim.
//
// What TMA changes for packed rows: the maps are 3D over the packed (total,
// h, d) tensors, so a box that runs past a sequence's rows loads the next
// sequence's (TMA zero-fills only past the tensor's end). The tiles zero
// those rows in shared memory where they would reach a sum (ZERO_TAIL: the
// q rows past sq of a streamed dK/dV tile, the keys past sk of a streamed
// dQ tile), lse2 is +inf and delta 0 on the padded rows, and no row outside
// the sequence is stored: the sums are those of B3 over the same rows, so
// b equal-length sequences packed give B3's bits. A sequence's lse2 and
// delta rows start at padded_row(cu_q[s], s), a multiple of 4 floats (the
// bulk copies' 16-byte alignment) that leaves each sequence room for whole
// 128-row tiles before the next.

#include "flash_varlen.cuh"

namespace {

using namespace fa::sm90;
using namespace fa::varlen_bwd;

// ---- host side --------------------------------------------------------------

// The head dims this source compiles; 96 and 256 go to
// flash_varlen_wide.cu, 80 to flash_varlen_80.cu.
using NarrowDims = Dims<64, 128>;
bool wide(int d) { return d == 96 || d == 256; }

// Whether the kernels take a call's shapes: rows_pad whole 4-row groups
// that hold the padded rows of b sequences.
bool takes(int b, int total_q, int total_k, int h, int h_k, int d, int num_tiles,
           int64_t rows_pad) {
  return b > 0 && total_q > 0 && total_k > 0 && h_k > 0 && h % h_k == 0 &&
         (d == 64 || d == 80 || d == 96 || d == 128 || d == 256) && rows_pad % 4 == 0 &&
         rows_pad >= (int64_t)total_q + (int64_t)SEQ_GAP * b &&
         (int64_t)num_tiles * h * (BWD_KV_ROWS / bwd_block_rows(d)) <= 0x7fffffff;
}

// Whether the kernels take a call's band (no sinks on the varlen route)
// and cap; `masked`: a band or score instantiation, which takes the causal
// bound as right = 0.
bool valid_band(int causal, int right, int chunk, int masked, float softcap) {
  return chunk >= 0 && !(causal && right != 0 && masked) && softcap >= 0.f;
}

// The maps (q/dout boxes of q_rows rows, k/v boxes of kv_rows) and the
// parameters of one kernel's launch; see fa_varlen_bwd_dkdv.
cudaError_t setup(BwdMaps* maps, VarlenParams* p, const void* q, const void* k,
                  const void* v, const void* dout, const float* lse2, const float* delta,
                  const int* cu_q, const int* cu_k, const int* lens_q, const int* lens_k,
                  const int* tiles, int num_tiles, int b, int total_q, int total_k, int h,
                  int h_k, int d, int64_t rows_pad, int64_t q_st, int64_t q_sh,
                  int64_t k_st, int64_t k_sh, int64_t v_st, int64_t v_sh, int64_t do_st,
                  int64_t do_sh, float scale, int causal, const fa::Band& band, float softcap,
                  const float* slopes, int64_t slope_sb, int is_bf16, int q_rows,
                  int kv_rows) {
  if (!takes(b, total_q, total_k, h, h_k, d, num_tiles, rows_pad))
    return cudaErrorInvalidValue;
  cudaError_t err;
  if ((err = make_tile_map<3>(&maps->q, q, is_bf16, {d, total_q, h}, {q_st, q_sh}, q_rows)) ||
      (err = make_tile_map<3>(&maps->dout, dout, is_bf16, {d, total_q, h}, {do_st, do_sh},
                              q_rows)) ||
      (err = make_tile_map<3>(&maps->k, k, is_bf16, {d, total_k, h_k}, {k_st, k_sh},
                              kv_rows)) ||
      (err = make_tile_map<3>(&maps->v, v, is_bf16, {d, total_k, h_k}, {v_st, v_sh},
                              kv_rows)))
    return err;
  *p = {};
  p->lse2 = lse2;
  p->delta = delta;
  p->cu_q = cu_q;
  p->cu_k = cu_k;
  p->lens_q = lens_q;
  p->lens_k = lens_k;
  p->tiles = tiles;
  p->rows_pad = rows_pad;
  p->num_tiles = num_tiles;
  p->h = h;
  p->h_k = h_k;
  p->a = {scale, scale * FA_LOG2E, causal, h / h_k};
  p->band = band;
  p->score = fa::score_from_args(scale * FA_LOG2E, softcap, causal);
  p->slopes = slopes;
  p->slope_sb = slope_sb;
  return cudaSuccess;
}

}  // namespace

// delta = rowsum(dout * out) and lse2 = lse * log2(e) (+inf where lse is
// -inf) into (h, rows_pad) fp32 buffers, each sequence's rows from
// padded_row in whole 128-row tiles of the q-side work list `tiles` (delta
// 0, lse2 +inf past the sequence); zeroes the rows of dq (total_q, h, d)
// and dk, dv (total_k, h_k, d), all contiguous, that lie in no sequence.
// dout/out (total_q, h, d) by element strides, the head dim contiguous; lse
// (h, total_q) contiguous fp32; cu_q, cu_k (b + 1,), lens_q, lens_k (b,)
// and tiles (num_tiles, 2) int32; rows_pad >= total_q + 132 b, a multiple
// of 4. Returns a cudaError_t (0 on success).
extern "C" int fa_varlen_bwd_preprocess(
    const void* dout, const void* out, const float* lse, float* lse2, float* delta,
    void* dq, void* dk, void* dv, const int* cu_q, const int* cu_k, const int* lens_q,
    const int* lens_k, const int* tiles, int num_tiles, int b, int total_q, int total_k,
    int h, int h_k, int d, int64_t rows_pad, int64_t do_st, int64_t do_sh, int64_t o_st,
    int64_t o_sh, int is_bf16, void* stream) {
  if (!takes(b, total_q, total_k, h, h_k, d, num_tiles, rows_pad))
    return (int)cudaErrorInvalidValue;
  const PreParams p = {dout,   out,    lse,     lse2,    delta,   dq,      dk,
                       dv,     cu_q,   cu_k,    lens_q,  lens_k,  tiles,   do_st,
                       do_sh,  o_st,   o_sh,    rows_pad, num_tiles, b,    total_q,
                       total_k, h,     h_k};
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  if (d == 80) return (int)run_pre_80(is_bf16, d, p, st);
  return (int)(wide(d) ? run_pre_wide(is_bf16, d, p, st)
                       : dispatch_dims<Pre>(NarrowDims{}, is_bf16, d, p, st));
}

// dK, dV (total_k, h_k, d) in k's type over the key-side work list `tiles`
// (num_tiles, 2) of block_k-key tiles; rows in no tile are zeroed by
// fa_varlen_bwd_preprocess. q/dout (total_q, h, d) and k/v (total_k, h_k,
// d) by element strides (token, head), the head dim contiguous, 16-byte
// aligned starts and strides (TMA); lse2 and delta (h, rows_pad) from
// fa_varlen_bwd_preprocess; cu_q, cu_k (b + 1,) and lens_q, lens_k (b,)
// int32. block_q/block_k must name the tiles the kernels are compiled for
// (dispatch/config.py VARLEN_BWD_TILE). The band (dispatch/band.py
// band_args, no sinks): window extents left and right (-1: no bound; right
// 0 under causal masking) and the chunk, read when `band` is set, which
// launches the band instantiation. softcap (0: none) and the ALiBi slopes
// (b, h) fp32 at slopes[seq * slope_sb + hh] (slope_sb 0 for one slope a
// head; nullptr: no ALiBi) launch the score instantiation, which reads the
// band always (band_args' form). Returns a cudaError_t (0 on success).
extern "C" int fa_varlen_bwd_dkdv(
    const void* q, const void* k, const void* v, const void* dout, const float* lse2,
    const float* delta, void* dk, void* dv, const int* cu_q, const int* cu_k,
    const int* lens_q, const int* lens_k, const int* tiles, int num_tiles, int b,
    int total_q, int total_k, int h, int h_k, int d, int block_q, int block_k,
    int64_t rows_pad, int64_t q_st, int64_t q_sh, int64_t k_st, int64_t k_sh, int64_t v_st,
    int64_t v_sh, int64_t do_st, int64_t do_sh, int64_t dk_st, int64_t dk_sh, int64_t dv_st,
    int64_t dv_sh, float scale, int causal, int left, int right, int chunk, int band,
    float softcap, const float* slopes, int64_t slope_sb, int is_bf16, void* stream) {
  const bool score = softcap > 0.f || slopes != nullptr;
  if (block_q != BWD_Q_ROWS || block_k != BWD_KV_ROWS ||
      !valid_band(causal, right, chunk, band || score, softcap))
    return (int)cudaErrorInvalidValue;
  BwdMaps maps;
  VarlenParams p;
  cudaError_t err = setup(&maps, &p, q, k, v, dout, lse2, delta, cu_q, cu_k, lens_q, lens_k,
                          tiles, num_tiles, b, total_q, total_k, h, h_k, d, rows_pad, q_st,
                          q_sh, k_st, k_sh, v_st, v_sh, do_st, do_sh, scale, causal,
                          fa::band_from_args(left, right, 0, chunk), softcap, slopes,
                          slope_sb, is_bf16, BWD_KV_BM, bwd_block_rows(d));
  if (err != cudaSuccess) return (int)err;
  p.dk = dk;
  p.dv = dv;
  p.dk_st = dk_st; p.dk_sh = dk_sh;
  p.dv_st = dv_st; p.dv_sh = dv_sh;
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  if (d == 80)
    return (int)(score ? run_dkdv_score_80(is_bf16, d, maps, p, st)
                       : run_dkdv_80(is_bf16, d, maps, p, band, st));
  if (score)
    return (int)(wide(d) ? run_dkdv_score_wide(is_bf16, d, maps, p, st)
                         : run_dkdv_score(is_bf16, d, maps, p, st));
  if (band)
    return (int)(wide(d) ? run_dkdv_band_wide(is_bf16, d, maps, p, st)
                         : run_dkdv_band(is_bf16, d, maps, p, st));
  return (int)(wide(d) ? run_dkdv_wide(is_bf16, d, maps, p, st)
                       : dispatch_dims<Dkdv>(NarrowDims{}, is_bf16, d, maps, p, st));
}

// dQ (total_q, h, d) in q's type over the query-side work list `tiles` of
// block_q-row tiles, written once. Layouts, the band and the score map as
// fa_varlen_bwd_dkdv.
extern "C" int fa_varlen_bwd_dq(
    const void* q, const void* k, const void* v, const void* dout, const float* lse2,
    const float* delta, void* dq, const int* cu_q, const int* cu_k, const int* lens_q,
    const int* lens_k, const int* tiles, int num_tiles, int b, int total_q, int total_k,
    int h, int h_k, int d, int block_q, int block_k, int64_t rows_pad, int64_t q_st,
    int64_t q_sh, int64_t k_st, int64_t k_sh, int64_t v_st, int64_t v_sh, int64_t do_st,
    int64_t do_sh, int64_t dq_st, int64_t dq_sh, float scale, int causal, int left, int right,
    int chunk, int band, float softcap, const float* slopes, int64_t slope_sb, int is_bf16,
    void* stream) {
  const bool score = softcap > 0.f || slopes != nullptr;
  if (block_q != BWD_Q_ROWS || block_k != BWD_KV_ROWS ||
      !valid_band(causal, right, chunk, band || score, softcap))
    return (int)cudaErrorInvalidValue;
  BwdMaps maps;
  VarlenParams p;
  cudaError_t err = setup(&maps, &p, q, k, v, dout, lse2, delta, cu_q, cu_k, lens_q, lens_k,
                          tiles, num_tiles, b, total_q, total_k, h, h_k, d, rows_pad, q_st,
                          q_sh, k_st, k_sh, v_st, v_sh, do_st, do_sh, scale, causal,
                          fa::band_from_args(left, right, 0, chunk), softcap, slopes,
                          slope_sb, is_bf16, bwd_block_rows(d), BWD_Q_BN);
  if (err != cudaSuccess) return (int)err;
  p.dq = dq;
  p.dq_st = dq_st; p.dq_sh = dq_sh;
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  if (d == 80)
    return (int)(score ? run_dq_score_80(is_bf16, d, maps, p, st)
                       : run_dq_80(is_bf16, d, maps, p, band, st));
  if (score)
    return (int)(wide(d) ? run_dq_score_wide(is_bf16, d, maps, p, st)
                         : run_dq_score(is_bf16, d, maps, p, st));
  if (band)
    return (int)(wide(d) ? run_dq_band_wide(is_bf16, d, maps, p, st)
                         : run_dq_band(is_bf16, d, maps, p, st));
  return (int)(wide(d) ? run_dq_wide(is_bf16, d, maps, p, st)
                       : dispatch_dims<Dq>(NarrowDims{}, is_bf16, d, maps, p, st));
}
