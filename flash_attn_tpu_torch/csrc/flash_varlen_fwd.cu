// Packed varlen attention forward for Hopper (sm_90a) on wgmma and TMA,
// bf16 / fp16, head dims 64, 80, 96, 128 and 256: B6's forward (one block
// per work item) and B7 (a persistent grid that walks the same items), on
// the forward tile that B1 runs at the same head dims (fwd_sm90.cuh: 80 and
// 96 as two zero-filled panels, 80 in csrc/flash_varlen_fwd_80.cu, 256 with
// one block an SM).
//
// Replaces the TPU kernels flash_attn_tpu/kernels/flash_varlen.py:
// _varlen_fwd_stream_kernel (B6) and flash_attn_tpu/kernels/
// flash_varlen_persistent.py:_varlen_fwd_persistent_kernel (B7). The TPU
// kernels tile the flat token axis with aligned blocks, because a DMA must
// be aligned, and rebuild the sequences from per-token segment ids. Here
// every tile belongs to one sequence: the wrapper builds a work list of
// 128-row tiles (sequence, first local row) with torch ops on the device
// (dispatch/varlen_meta.py, the schedule at block_q = 128), ordered by the
// length of each tile's KV band, longest first. The items are (tile, head),
// head by head, each head's tiles in that order: the blocks in flight then
// read one head's K and V, which stay in L2 (head-major ran bench.py's mixed
// lengths 1.33x faster than the heads of a tile side by side, PERF.md). An
// item finds its sequence's origin in cu_seqlens and its lengths (seqused
// where given) and runs the forward tile of fwd_sm90.cuh; B6 and B7 run it
// with the same arithmetic, so they give the same bits.
//
// B6 runs one block per item. B7 runs a grid of (SM count x resident blocks
// an SM) blocks; block i walks items i, i + grid, ..., skipping the dead
// tiles that end each head's list and the tiles that see no key. Its K/V
// ring and its barriers' phases carry across the items: when the block
// issues the last K/V tile of an item, it issues the next item's first K/V
// tile into the stage that frees next (and, at head dim 64, where a block
// keeps a second Q tile, the next item's Q), so those loads run under this
// item's softmax tail and epilogue, which one block per item cannot
// overlap. With one Q tile (head dim 128) the next Q loads once the
// epilogue, which stages O in the Q tile, is out.
//
// What bounds it on this card: per head, a sequence of sq rows over sk keys
// does 4 * sq * sk * d flops (about half under the causal mask) and moves
// q, k, v and out once; bench.py's mixed lengths (16 sequences of 2048-4096
// at d = 128, causal) are tensor-core bound (~0.66 ms), BERT-large's packing
// (d = 64, 256-512 tokens) is memory bound (~0.03 ms), where each item's
// first loads are a large share of its time: what B7's walk goes at.
//
// What TMA changes for packed rows: the tensor maps are 3D over the packed
// (total, h, d) tensors, so a box that runs past a sequence's rows loads the
// next sequence's (TMA zero-fills only past the tensor's end). The tile
// masks the scores of keys at or past the sequence's length to -inf, so that
// their P is 0 exactly, and zeroes those V rows of the ragged tile in shared
// memory; query rows past the length are computed on the neighbour's rows
// and never stored. Rows in no tile (past seqused, the packed tail past
// cu_seqlens[-1]) and rows that see no key keep the wrapper's zeros (out)
// and -inf (lse). Each output element is written once: two runs give the
// same bits.
//
// The band masks (a window and attention_chunk per sequence;
// flash_varlen.py:47-76 _varlen_mask_and_bias) run in the band
// instantiations (csrc/flash_varlen_fwd_band.cu) over fwd_sm90.cuh's band
// tile, as B1's do: an item walks the key tiles of its band (KeyRange),
// from the band's first, so B6 and B7 give B1's bits under a band too.
// softcap and ALiBi (flash_varlen.py:181-187, _varlen_mask_and_bias's
// bias) run in the score instantiations (csrc/flash_varlen_fwd_score.cu),
// which are band ones with the causal bound as a band of right extent 0:
// each item maps its scores by fwd_sm90.cuh's score_map with its
// sequence's slope and keys (the bias relative to the sequence's last key
// under causal masking), so B6 and B7 give B1's score instantiation's bits
// over the same rows. The kernels are in csrc/flash_varlen_fwd.cuh.

#include "flash_varlen_fwd.cuh"
#include "fwd_sm90.cuh"

namespace {

using namespace fa;
using namespace fa::sm90;
using namespace fa::varlen_fwd;

// The maps and parameters of one call (see fa_varlen_fwd).
cudaError_t setup(FwdMaps* maps, VarlenFwdScoreParams* p, const void* q, const void* k,
                  const void* v, void* out, float* lse, const int* cu_q, const int* cu_k,
                  const int* lens_q, const int* lens_k, const int* tiles, int num_tiles,
                  int total_q, int total_k, int h, int h_k, int d, int64_t q_st,
                  int64_t q_sh, int64_t k_st, int64_t k_sh, int64_t v_st, int64_t v_sh,
                  int64_t o_st, int64_t o_sh, float scale, int causal, const Band& band,
                  float softcap, const float* slopes, int64_t slope_sb, const float* sink,
                  int is_bf16) {
  cudaError_t err;
  if ((err = make_tile_map<3>(&maps->q, q, is_bf16, {d, total_q, h}, {q_st, q_sh}, FWD_M)) ||
      (err = make_tile_map<3>(&maps->k, k, is_bf16, {d, total_k, h_k}, {k_st, k_sh}, FWD_N)) ||
      (err = make_tile_map<3>(&maps->v, v, is_bf16, {d, total_k, h_k}, {v_st, v_sh}, FWD_N)))
    return err;
  p->out = out;
  p->lse = lse;
  p->cu_q = cu_q;
  p->cu_k = cu_k;
  p->lens_q = lens_q;
  p->lens_k = lens_k;
  p->tiles = tiles;
  p->o_st = o_st;
  p->o_sh = o_sh;
  p->total_q = total_q;
  p->num_tiles = num_tiles;
  p->h = h;
  p->group = h / h_k;
  p->scale_log2 = scale * FA_LOG2E;
  p->causal = causal;
  p->band = band;
  p->score = score_from_args(scale * FA_LOG2E, softcap, causal);
  p->slopes = slopes;
  p->slope_sb = slope_sb;
  p->sink = sink;
  return cudaSuccess;
}

// Whether the kernels take a call's tile, shapes, band and cap; `masked`:
// a band or score instantiation, which takes the causal bound as right = 0.
bool takes(int block_q, int block_k, int h, int h_k, int d, int num_tiles, int causal,
           int right, int chunk, int masked, float softcap) {
  return block_q == FWD_M && block_k == FWD_N && h_k >= 1 && h % h_k == 0 &&
         (d == 64 || d == 80 || d == 96 || d == 128 || d == 256) &&
         (int64_t)num_tiles * h <= 0x7fffffff &&
         chunk >= 0 && !(causal && right != 0 && masked) && softcap >= 0.f;
}

}  // namespace

// q (total_q, h, d) and out by element strides (token, head), k/v (total_k,
// h_k, d) likewise, the head dim contiguous, 16-byte aligned starts and
// strides (TMA); lse (h, total_q) fp32; cu_q, cu_k (b + 1,), lens_q, lens_k
// (b,) and tiles (num_tiles, 2) int32 from the wrapper, tiles of block_q
// rows; out zeroed and lse -inf-filled by the wrapper. block_q/block_k must
// name the tile the kernel is compiled for (dispatch/config.py FWD_TILE).
// The band (dispatch/band.py band_args, no sinks): window extents left and
// right (-1: no bound; right 0 under causal masking) and the chunk, per
// sequence, read when `band` is set, which launches the band
// instantiation. softcap (0: none) and the ALiBi slopes (b, h) fp32 at
// slopes[seq * slope_sb + hh] (slope_sb 0 for one slope a head; nullptr: no
// ALiBi) launch the score instantiation, which reads the band always
// (band_args' form). sink: (h,) fp32 learnable sink logits that every
// instantiation's epilogue adds to its rows' softmax, or nullptr; the
// wrapper then fills lse with each head's sink, which the rows of no tile
// keep. Returns a cudaError_t (0 on success).
extern "C" int fa_varlen_fwd(
    const void* q, const void* k, const void* v, void* out, float* lse,
    const int* cu_q, const int* cu_k, const int* lens_q, const int* lens_k,
    const int* tiles, int num_tiles, int total_q, int total_k, int h, int h_k,
    int d, int block_q, int block_k, int64_t q_st, int64_t q_sh, int64_t k_st,
    int64_t k_sh, int64_t v_st, int64_t v_sh, int64_t o_st, int64_t o_sh,
    float scale, int causal, int left, int right, int chunk, int band, float softcap,
    const float* slopes, int64_t slope_sb, const float* sink, int is_bf16, void* stream) {
  const bool score = softcap > 0.f || slopes != nullptr;
  if (!takes(block_q, block_k, h, h_k, d, num_tiles, causal, right, chunk, band || score,
             softcap))
    return (int)cudaErrorInvalidValue;
  if (num_tiles == 0 || total_q == 0 || total_k == 0) return 0;  // no row sees a key
  FwdMaps maps;
  VarlenFwdScoreParams p;
  cudaError_t err = setup(&maps, &p, q, k, v, out, lse, cu_q, cu_k, lens_q, lens_k, tiles,
                          num_tiles, total_q, total_k, h, h_k, d, q_st, q_sh, k_st, k_sh,
                          v_st, v_sh, o_st, o_sh, scale, causal,
                          band_from_args(left, right, 0, chunk), softcap, slopes, slope_sb,
                          sink, is_bf16);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  if (d == 80) return (int)run_fwd_80(is_bf16, maps, p, band, score, st);
  if (score) return (int)run_fwd_score(is_bf16, d, maps, p, st);
  if (band) return (int)run_fwd_band(is_bf16, d, maps, p, st);
  return (int)dispatch_dims<Launch>(VarlenDims{}, is_bf16, d, maps, p, st);
}

// B7 (varlen_fwd_persistent_kernel) over the same work list, arguments,
// band and score map as fa_varlen_fwd, with a grid of num_sms x the blocks that fit on
// one SM (at most one block per item), written to *grid_out (host memory).
// Returns a cudaError_t (0 on success).
extern "C" int fa_varlen_fwd_persistent(
    const void* q, const void* k, const void* v, void* out, float* lse,
    const int* cu_q, const int* cu_k, const int* lens_q, const int* lens_k,
    const int* tiles, int num_tiles, int total_q, int total_k, int h, int h_k,
    int d, int block_q, int block_k, int64_t q_st, int64_t q_sh, int64_t k_st,
    int64_t k_sh, int64_t v_st, int64_t v_sh, int64_t o_st, int64_t o_sh,
    float scale, int causal, int left, int right, int chunk, int band, float softcap,
    const float* slopes, int64_t slope_sb, const float* sink, int is_bf16, int num_sms,
    int* grid_out, void* stream) {
  if (grid_out) *grid_out = 0;
  const bool score = softcap > 0.f || slopes != nullptr;
  if (!takes(block_q, block_k, h, h_k, d, num_tiles, causal, right, chunk, band || score,
             softcap) ||
      num_sms < 1)
    return (int)cudaErrorInvalidValue;
  if (num_tiles == 0 || total_q == 0 || total_k == 0) return 0;  // no row sees a key
  FwdMaps maps;
  VarlenFwdScoreParams p;
  cudaError_t err = setup(&maps, &p, q, k, v, out, lse, cu_q, cu_k, lens_q, lens_k, tiles,
                          num_tiles, total_q, total_k, h, h_k, d, q_st, q_sh, k_st, k_sh,
                          v_st, v_sh, o_st, o_sh, scale, causal,
                          band_from_args(left, right, 0, chunk), softcap, slopes, slope_sb,
                          sink, is_bf16);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  if (d == 80)
    return (int)run_persistent_80(is_bf16, maps, p, band, score, num_sms, grid_out, st);
  if (score) return (int)run_persistent_score(is_bf16, d, maps, p, num_sms, grid_out, st);
  if (band) return (int)run_persistent_band(is_bf16, d, maps, p, num_sms, grid_out, st);
  return (int)dispatch_dims<LaunchPersistent>(VarlenDims{}, is_bf16, d, maps, p, num_sms,
                                              grid_out, st);
}
