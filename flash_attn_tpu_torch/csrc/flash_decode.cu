// Split-KV decode attention over a linear or a paged KV cache for Hopper
// (sm_90a), bf16 / fp16, head dim 64, 80, 96, 128 or 256: the d = dv route (the
// MLA route is csrc/flash_decode_mla.cu).
//
// Replaces the TPU kernel flash_attn_tpu/kernels/flash_decode.py:_decode_kernel
// (linear and paged cache, causal or not, GQA, any num_splits >= 1). The
// split partials are merged by combine_splits in kernels/flash_decode.py, as
// the JAX package merges them outside its kernel.
//
// What bounds it on this card: a decode step has one (or a few) query rows
// per head, so every cached key and value is read once and used for
// 2 * rows flops per element: the kernel is bound by device-memory bandwidth
// (b * h_k * seqlen * d * 2 * 2 bytes per call), and the tensor cores have
// nothing to do. At small batch the grid is a wave or less (b = 8, 16 KV
// heads, one split: 128 blocks on 132 SMs) and the rows differ in length,
// so the block of the longest row sets the time: its keys must stream
// through one SM with enough bytes in flight to cover memory latency.
//
// What the design does about it: one block per (batch row, KV head, split)
// handles all sq * group query rows of that KV head (the TPU kernel's GQA row
// packing), so each K/V row is read from memory once for the whole group.
// The split's keys, contiguous runs of DECODE_BLOCK_K = 64-key tiles (the
// partition of the wrapper's _split_bounds, so paged and linear decode sum
// in the same order), stream through a ring of shared-memory stages: one
// thread issues each staged tile's TMA copies (cp.async.bulk.tensor over 4D
// maps of the cache, no swizzle, rows stored one after another) and an
// mbarrier completes each stage, so the next tiles load while the block
// computes on the oldest. The dot products and the online softmax run in
// fp32 on the ordinary ALUs (at group 1 a decode row has no M dimension for
// the tensor cores): a staged row of DS = staged_dim(D) columns (a head dim
// of 96 is staged as 128: the TMA box past the cache's 96 columns fills
// zeros, which add nothing to a score, and their output columns are never
// written; 80 likewise, csrc/flash_decode_80.cu) is split across DS / 8
// lanes, each lane reads its
// 16 bytes of K and V from the stage, and a tile's scores of a lane's keys
// are reduced across their lanes together and folded into the lane's (m, l,
// acc) state in one step (one rescale a tile, one exp2 a key), with one
// block barrier a tile, which frees the stage for the next copy. The states
// are merged once at the end, by shuffles inside a warp and through shared
// memory across warps. A paged cache (num_pages, h_k, page_size, d) and a
// linear one (b_c, h_k, s_max, d), read as b_c pages of s_max rows, go
// through the same maps: a staged tile is boxes of gcd(page_size, tile)
// rows, each box's page resolved once (sm90.cuh PagedRows), so any page
// size works (16 to 256 in the engine).
//
// Small grids and full ones take two rings of the same kernel. A small grid
// (b = 8: 128 blocks on 132 SMs) runs thread-block clusters of CLUSTER
// blocks (2 or 4, the wrapper's choice: the most whose grid still fits the
// card's resident blocks) that share one (batch row, KV head, split): block
// rank c takes the c-th contiguous share of the split's tiles, and after
// the loop rank 0 merges the blocks' states, in rank order, through
// distributed shared memory into the split's one normalised fp32 partial
// (out, lse), the layout of the plain version; their ring is deep (3 stages
// of 64 keys, 96 KB at d = 128), for the long runs of the longest rows. A
// full grid (the engine's 64 slots: 1,024 blocks) runs one block a split on
// a shallow ring (2 stages of 16 keys, 16 KB), so that many blocks an SM
// cover each block's first copies: the deep ring there, or a persistent
// grid whose ring runs on across items, were slower (PERF.md PR 11).
//
// Masking is that of flash_decode.py:197-214: with sk the cache length
// after the append and shift = sk - sq, query row t sees key positions
// <= t + shift + right (right 0 for causal decode, the window's right
// extent otherwise, no bound without one), and, with a band, positions
// >= t + shift - left (a sliding window) and >= the first key of t +
// shift's chunk (attention_chunk; the decode kernel masks no upper chunk
// bound, as JAX's). The splits share out only the tiles from the band's
// first, the tile of the lowest key the item's first query token sees,
// computed from cache_seqlens on the device (so that a graphed decode step
// replays the right bound at every length): the tiles below it are masked
// for every row, and JAX's kernel, which reads them and masks them, gives
// the same result. A split whose keys are all below a row's band writes
// that row an lse of -inf and out 0, which combine_splits weighs 0. A
// length past the cache's capacity (s_max, or max_pages * page_size) is
// cut to it; the caller poisons such rows. Keys past the split's end or the
// length are staged (a page's other slots, a NaN even) but never reach a
// sum: their state update is skipped, not multiplied by 0.
//
// softcap and ALiBi (flash_decode.py:245-254) are runtime fields as the
// band is: each score s2 (q pre-scaled by scale * log2(e)) becomes
// tanh(s2 / (log2(e) cap)) cap log2(e) with a cap, then takes ALiBi's bias
// times the row's query head's slope (times log2(e)): key - (sk - 1) under
// causal masking, relative to the row's own cache length sk read from
// cache_seqlens on the device (so that a graph replays it at every length,
// and the split partials' lse all take JAX's form, which combine_splits
// merges), and -|t + sk - sq - key| otherwise. The slopes and the bias's
// base of a block's rows sit in shared memory, read a row a tile only when
// there are slopes.
//
// Quantized caches (flash_decode.py:44-50, :171-308): a cache of 1-byte
// codes (float8_e4m3fn or int8, the code a runtime field) with a bf16 q
// runs the KVB = 1 instantiations (csrc/flash_decode_kv8.cu): its TMA maps
// are of bytes, a stage holds the same keys in half the bytes, and a lane
// loads its 8 columns as 8 bytes of codes and converts them on load
// (kv8.cuh: Hopper's native e4m3 conversion, B11's role), so the lane map
// and the rings stay as they are. The decode traffic of the cache halves.
// The descales (b, h_k) are runtime fields of every instantiation, as JAX
// applies them: q_descale * k_descale is folded into the item's pre-scaled
// q (the score's scale; the wrapper refuses it with a cap), v_descale
// multiplies the split's normalised partial out before combine_splits.
// The kernels (the deep ring's K and V tiles, each lane's dot products)
// are left as they are for 2-byte caches but for those two loads of a
// scalar: the 1-byte ring could instead double its keys at the same shared
// memory (ROADMAP.md, the kernel-speed order).

#include "flash_decode.cuh"

using namespace fa;
using namespace fa::decode;

// q (b, sq, h, d) by element strides (batch, position, head); the caches
// (num_pages, h_k, page_size, d) by strides (page, head, row) with table (b,
// table_width), or, with table == nullptr, linear (b_c, h_k, s_max, d)
// passed as num_pages = b_c pages of page_size = s_max rows; the head dim
// contiguous, every start and stride 16-byte aligned (TMA). cap is the
// cache's capacity in positions; block_k must be the split granularity of
// the wrapper (dispatch/config.py DECODE_BLOCK_K), the staged tile's 64
// keys; cluster (1, 2 or 4) blocks share each split. The band
// (dispatch/band.py band_args): window extents left and right (-1: no
// bound; right 0 under causal masking) and the chunk (0: none). softcap
// (0: none) and the ALiBi slopes (b, h) fp32 at slopes[bb * slope_sb + hq]
// (slope_sb 0: one slope a head; nullptr: no ALiBi). kv_code 0: caches of
// q's type; KV_E4M3 or KV_INT8 (kv8.cuh): caches of 1-byte codes, q bf16.
// qk_descale and v_descale: (b, h_k) fp32, contiguous, or nullptr (ones).
// Returns a cudaError_t (0 on success).
extern "C" int fa_decode(const void* q, const void* kc, const void* vc,
                         const int* seqlens, const int* table, float* out_p,
                         float* lse_p, int b, int sq, int h, int h_k, int d,
                         int num_splits, int block_k, int page_size,
                         int table_width, int num_pages, int cap, int cluster,
                         int64_t q_sb, int64_t q_ss, int64_t q_sh, int64_t k_sb,
                         int64_t k_sh, int64_t k_ss, int64_t v_sb, int64_t v_sh,
                         int64_t v_ss, int64_t t_sb, float scale_log2, int causal,
                         int left, int right, int chunk, float softcap, const float* slopes,
                         int64_t slope_sb, int kv_code, const float* qk_descale,
                         const float* v_descale, int is_bf16, void* stream) {
  if (block_k != DEC_BN || h_k < 1 || h % h_k != 0 || page_size < 1 || num_pages < 1 ||
      (causal && right != 0) || chunk < 0 || softcap < 0.f ||
      num_splits < 1 || (table != nullptr && table_width < 1) ||
      (cluster != 1 && cluster != 2 && cluster != 4) ||
      (d != 64 && d != 80 && d != 96 && d != 128 && d != 256) ||
      (kv_code != 0 && kv_code != KV_E4M3 && kv_code != KV_INT8) || (kv_code != 0 && !is_bf16))
    return (int)cudaErrorInvalidValue;
  if (b == 0 || sq == 0) return 0;
  DecodeParams p;
  p.q = q;
  p.seqlens = seqlens;
  p.table = table;
  p.out_p = out_p;
  p.lse_p = lse_p;
  p.q_sb = q_sb; p.q_ss = q_ss; p.q_sh = q_sh;
  p.t_sb = t_sb;
  p.b = b;
  p.sq = sq;
  p.h_k = h_k;
  p.group = h / h_k;
  p.rows = sq * p.group;
  p.num_splits = num_splits;
  p.page_size = page_size;
  p.table_width = table_width;
  p.num_pages = num_pages;
  p.cap = cap;
  p.scale_log2 = scale_log2;
  p.band.left = left < 0 ? BAND_NONE : left;
  p.band.right = right < 0 ? BAND_NONE : right;
  p.band.chunk = chunk;
  p.cap_in = softcap > 0.f ? 1.f / (FA_LOG2E * softcap) : 0.f;
  p.cap_out = softcap * FA_LOG2E;
  p.slopes = slopes;
  p.slope_sb = slope_sb;
  p.causal = causal;
  p.kv_code = kv_code;
  p.qk_descale = qk_descale;
  p.v_descale = v_descale;
  const CacheView c = {kc, vc, k_sb, k_sh, k_ss, v_sb, v_sh, v_ss, d, is_bf16};
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  if (d == 80) return (int)run_decode_80(c, p, cluster, st);
  if (kv_code != 0) return (int)run_decode_kv8(c, p, cluster, st);
  return (int)(is_bf16 ? launch_d<__nv_bfloat16, 2>(c, p, cluster, st)
                       : launch_d<__half, 2>(c, p, cluster, st));
}
