// Packed-varlen prefill attention over a paged KV cache for Hopper (sm_90a)
// on wgmma and TMA, bf16 / fp16, head dim 64, 80, 96, 128 or 256: the
// prefix-cached chunked prefill of the serving engine (head dim 80 in
// csrc/flash_varlen_paged_80.cu).
//
// Replaces the TPU kernel
// flash_attn_tpu/kernels/flash_varlen_paged.py:_varlen_paged_kernel (B8).
// Query chunks of several sequences are packed along one token axis
// (cu_seqlens_q, optionally with a true length seqused_q per sequence
// inside a padded slot); each sequence's keys and values sit in pages of
// the cache (num_pages, h_k, page_size, d) named by its row of the block
// table, and its key count seqlens_k includes the chunk. Masking is bottom-
// right causal: local query row r of a sequence sees key positions
// <= r + seqlens_k - seqused_q; with a sliding window (flash_varlen_paged.py
// :249-254, the forward tile's BAND instantiation) also >= r + seqlens_k -
// seqused_q - left, and a block reads only the pages of its rows' band
// (the list bounds of :408-417): pages wholly below the window are not
// read. Rows past seqused_q, and rows that see no key, give out = 0 and
// lse = -inf, as the TPU kernel's do. Descales (flash_varlen_paged.py
// :225-241, :276-277) are runtime fields: q_descale * k_descale of the
// block's (sequence, KV head) multiplies its scale (and the cap's input
// factor), v_descale its 1 / l; pages of 1-byte codes are converted first
// by csrc/kv_dequant.cu (kernels/kv_dequant.py), over whose pool this
// kernel runs as it is.
//
// What bounds it on this card: a chunk of sq query rows over sk keys does
// 4 * sq * sk * d flops per head (about half that under the causal mask)
// and must move q and out (2 * sq * d * 2 bytes per head) and K and V
// (2 * sk * d * 2 bytes per KV head) once. At the engine's prefix-cached
// admission (8 chunks of 256 rows over 512 keys, 16 heads of 128) that is
// 6.4 GFLOP against 50 MB, about 129 flops a byte, under the card's 295:
// the floor is memory traffic, about 15 us. Longer chunks (more query rows
// per key) move the floor to the tensor cores' rate.
//
// What the design does about it: B6's forward (csrc/flash_varlen_fwd.cu)
// with a paged K/V source. One block per item, a 128-row query tile of one
// sequence and query head, walked head by head so that the blocks in flight
// read one head's pages from L2, and in a head sequence by sequence, each
// sequence's last tile (its longest causal band) first. The work list is a
// running count of each sequence's tiles, built by the wrapper with torch
// ops on the device; a block finds its sequence by binary search. (B6's
// list of (sequence, row) pairs sorted by band takes some 40 small torch
// ops a call, which added 0.13 ms to the call at the prefix admission,
// against the kernel's 0.028: PERF.md.) Each block runs the forward tile
// of fwd_sm90.cuh: Q once by TMA from the packed (total_q, h, d) tensor,
// 64-key K/V tiles through a two-stage TMA ring, both products on wgmma,
// two blocks an SM (one at head dim 256). The K/V
// tiles come from the pages through this file's fwd_issue_kv: the issuing
// thread resolves each box's page once a tile (PagedRows, sm90.cuh: the
// table entry clamped to the table and the page to the pool) and copies it
// as a TMA box of gcd(page_size, 64) rows over 4D maps of the caches, so any
// page size works. Keys past seqlens_k in the last page may hold anything:
// their scores are masked to -inf and their V rows zeroed in shared memory
// (ZERO_TAIL). Query rows past the sequence (a neighbour's, in the packed
// tensor) are computed and never stored; rows past seqused_q are in no tile
// and keep the wrapper's zeros and -inf. Over pages it gives B6's forward's
// bits over the same rows packed. With softcap (flash_varlen_paged.py
// :225-233; JAX's paged route takes no ALiBi) the SCORE instantiations
// (csrc/flash_varlen_paged_score.cu) cap the scores before the mask. Left
// for later: one block for a GQA
// group's query heads (each head's block reads its K/V tiles again) and a
// persistent walk.

#include "flash_varlen_paged.cuh"
#include "fwd_sm90.cuh"

namespace {

using namespace fa;
using namespace fa::sm90;
using namespace fa::varlen_paged;

template <typename T>
cudaError_t launch_band(const FwdMaps& maps, const VarlenPagedParams& p, int d, bool band,
                        cudaStream_t st) {
  return band ? launch_d<T, true, false>(maps, p, d, st)
              : launch_d<T, false, false>(maps, p, d, st);
}

}  // namespace

// q (total_q, h, d) and out by element strides (token, head), the head dim
// contiguous; pages (num_pages, h_k, page_size, d) by strides (page, head,
// row); every start and stride 16-byte aligned (TMA); lse (h, total_q)
// fp32; out zeroed and lse -inf-filled by the wrapper; tile_ends (b,) int32
// from the wrapper, the running count of tiles of block_q rows over the b
// sequences, num_tiles at least its last entry. block_q/block_k must name
// the tile the kernel is compiled for (dispatch/config.py FWD_TILE). The
// window's extents left and right (-1: no bound; right 0 under causal
// masking) are read when `band` is set; softcap > 0 selects the SCORE
// instantiation, whose scores are capped (0: none). qk_descale and
// v_descale: (b, h_k) fp32, contiguous, or nullptr (ones): the scores of
// sequence s and KV head kh are scaled by qk_descale[s, kh] (before the
// cap) and its O by v_descale[s, kh]. sink: (h,) fp32 learnable sink
// logits that the epilogue adds to every row's softmax, or nullptr; the
// wrapper then fills lse with each head's sink, which the rows of no tile
// keep. Returns a cudaError_t (0 on success).
extern "C" int fa_varlen_paged(
    const void* q, const void* kp, const void* vp, const int* cu_q,
    const int* lens_q, const int* lens_k, const int* table, const int* tile_ends,
    void* out, float* lse, int b, int num_tiles, int total_q, int h, int h_k, int d,
    int page_size, int table_width, int num_pages, int block_q, int block_k,
    int64_t q_st, int64_t q_sh, int64_t k_sp, int64_t k_sh, int64_t k_ss,
    int64_t v_sp, int64_t v_sh, int64_t v_ss, int64_t o_st, int64_t o_sh,
    int64_t t_sb, float scale_log2, int causal, int left, int right, int band,
    float softcap, const float* qk_descale, const float* v_descale, const float* sink,
    int is_bf16, void* stream) {
  if (block_q != FWD_M || block_k != FWD_N || h_k < 1 || h % h_k != 0 ||
      (causal && right != 0 && band) ||
      (d != 64 && d != 80 && d != 96 && d != 128 && d != 256) ||
      page_size < 1 || table_width < 1 || num_pages < 1 || b < 1 || softcap < 0.f ||
      (int64_t)num_tiles * h > 0x7fffffff)
    return (int)cudaErrorInvalidValue;
  if (num_tiles == 0 || total_q == 0) return 0;
  VarlenPagedParams p;
  p.out = out;
  p.lse = lse;
  p.cu_q = cu_q;
  p.lens_q = lens_q;
  p.lens_k = lens_k;
  p.table = table;
  p.tile_ends = tile_ends;
  p.o_st = o_st;
  p.o_sh = o_sh;
  p.t_sb = t_sb;
  p.b = b;
  p.num_tiles = num_tiles;
  p.total_q = total_q;
  p.h = h;
  p.group = h / h_k;
  p.page_size = page_size;
  p.box_rows = gcd64(page_size);
  p.table_width = table_width;
  p.num_pages = num_pages;
  p.scale_log2 = scale_log2;
  p.causal = causal;
  p.band.left = left < 0 ? BAND_NONE : left;
  p.band.right = right < 0 ? BAND_NONE : right;
  p.score = score_from_args(scale_log2, softcap, causal);
  p.qk_descale = qk_descale;
  p.v_descale = v_descale;
  p.sink = sink;
  FwdMaps maps;
  cudaError_t err;
  if ((err = make_tile_map<3>(&maps.q, q, is_bf16, {d, total_q, h}, {q_st, q_sh}, FWD_M)) ||
      (err = make_tile_map<4>(&maps.k, kp, is_bf16, {d, page_size, h_k, num_pages},
                              {k_ss, k_sh, k_sp}, p.box_rows)) ||
      (err = make_tile_map<4>(&maps.v, vp, is_bf16, {d, page_size, h_k, num_pages},
                              {v_ss, v_sh, v_sp}, p.box_rows)))
    return (int)err;
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  if (d == 80) return (int)run_varlen_paged_80(is_bf16, maps, p, band, softcap > 0.f, st);
  if (softcap > 0.f) return (int)run_varlen_paged_score(is_bf16, maps, p, d, band, st);
  return (int)(is_bf16 ? launch_band<__nv_bfloat16>(maps, p, d, band, st)
                       : launch_band<__half>(maps, p, d, band, st));
}
