// Dense attention forward for Hopper (sm_90a) on wgmma and TMA, bf16 / fp16,
// head dim 64, 80, 96, 128 or 256, or q/k head dim 192 beside v head dim
// 128.
//
// Replaces the TPU kernel flash_attn_tpu/kernels/flash_fwd.py:_fwd_kernel,
// together with the causal diagonal work of
// flash_attn_tpu/kernels/flash_fwd_split.py:_diag_kernel: the TPU split the
// causal band into a maskless bulk launch and a masked diagonal launch; here
// one block walks its whole band and only the diagonal (and ragged last)
// tiles run the mask.
//
// What bounds it on this card: a causal call reads q, k, v and writes out
// once (8 * b * s * h * d bytes in bf16) and does 2 * b * h * s^2 * d flops,
// s / 4 flops per byte. Below s ~ 1200 (the card's 295 flops per byte) the
// floor is memory traffic; above it, the tensor cores.
//
// What the design does about it: the forward tile of fwd_sm90.cuh, one
// block of two warpgroups per (128 query rows, head, batch row), both
// products on wgmma (the only way to the card's full tensor-core rate), Q
// and a two-stage ring of 64-key K/V tiles loaded by TMA, so that tile t +
// 1's load overlaps tile t's products and softmax. Blocks are launched
// heaviest first (the last q tiles, under causal masking). Each output
// element is written once, with no atomics: two runs give the same bits.
//
// The band masks (window, chunk, sinks; B1's part of
// flash_fwd.py:270-287) run in their own instantiation (BAND), whose blocks
// walk only the key tiles their rows' band reaches: a 4096-key window over
// 6144 causal keys reads about 89% of the causal band's pairs. A call
// without a band runs the band-free instantiation, the kernel of the
// earlier releases, with the same bits and time. softcap and ALiBi (B1's
// part of flash_fwd.py:180-247) run in the SCORE instantiations, with and
// without the band (csrc/flash_fwd_score.cu; the kernel in flash_fwd.cuh).
// Head dim 80 (BTLM) runs every form in instantiations of its own
// (csrc/flash_fwd_80.cu), the tile of 96: two 64-column panels whose
// columns past 80 TMA fills with zeros. q/k 192 beside v 128 (DeepSeek's
// MLA, not absorbed) runs the band-free, score-free form in its own
// (csrc/flash_fwd_192.cu): Q and K three panels, V and O two.
//
// Conventions: q (b, sq, h, d), k (b, sk, h_k, d), v (b, sk, h_k, dv) by
// element strides, the head dim contiguous, 16-byte aligned starts and
// strides (TMA); out (dv columns) in q's type, lse (b, h, sq) natural-log.
// The tensor maps are 4D over (d or dv, s, h, b) with rows past s
// zero-filled, encoded on the host for every call.

#include "flash_fwd.cuh"
#include "fwd_sm90.cuh"

namespace {

using namespace fa;
using namespace fa::sm90;
using namespace fa::dense_fwd;

template <typename T>
cudaError_t launch_band(const FwdMaps& maps, const FwdParams& p, int b, int d, bool band,
                        cudaStream_t st) {
  return band ? launch_d<T, true, false>(maps, p, b, d, st)
              : launch_d<T, false, false>(maps, p, b, d, st);
}

}  // namespace

// q (b, sq, h, d), k (b, sk, h_k, d), v (b, sk, h_k, dv) given by element
// strides, the head dim contiguous, 16-byte aligned starts and strides; out
// (b, sq, h, dv) has q's type and layout strides; lse (b, h, sq) fp32.
// (d, dv): one of 64, 80, 96, 128 and 256 twice, or (192, 128), which takes
// neither the band nor the score map. The band (dispatch/band.py
// band_args): window extents left and right (-1: no bound; right 0 under
// causal masking), sink tokens and the chunk, read when `band` is set.
// softcap (0: none) and the ALiBi slopes (b, h) fp32 at slopes[bb *
// slope_sb + hh] (slope_sb 0 for one slope a head; nullptr: no ALiBi)
// select the SCORE instantiation when either is given. learnable_sink: (h,)
// fp32 logits, one per query head, that every instantiation's epilogue
// adds to its rows' softmax (nullptr: none; no instantiation of its own,
// JAX flash_fwd.py:340-356). Returns a
// cudaError_t (0 on success); block_q/block_k must name the tile the
// kernel is compiled for (dispatch/config.py FWD_TILE).
extern "C" int fa_fwd(const void* q, const void* k, const void* v, void* out,
                      float* lse, int b, int sq, int sk, int h, int h_k, int d,
                      int dv, int block_q, int block_k,
                      int64_t q_sb, int64_t q_ss, int64_t q_sh, int64_t k_sb,
                      int64_t k_ss, int64_t k_sh, int64_t v_sb, int64_t v_ss,
                      int64_t v_sh, int64_t o_sb, int64_t o_ss, int64_t o_sh,
                      float scale_log2, int causal, int left, int right,
                      int sink, int chunk, int band, float softcap, const float* slopes,
                      int64_t slope_sb, const float* learnable_sink, int is_bf16,
                      void* stream) {
  const bool score = softcap > 0.f || slopes != nullptr;
  const bool mla = d == 192 && dv == 128;  // the band-free, score-free form
  if (block_q != FWD_M || block_k != FWD_N || b < 1 || sq < 1 || sk < 1 || h_k < 1 ||
      h % h_k != 0 ||
      !(mla ? !band && !score
            : dv == d && (d == 64 || d == 80 || d == 96 || d == 128 || d == 256)) ||
      sink < 0 || chunk < 0 || (causal && right != 0 && band) || softcap < 0.f)
    return (int)cudaErrorInvalidValue;
  FwdMaps maps;
  cudaError_t err;
  if ((err = make_tile_map<4>(&maps.q, q, is_bf16, {d, sq, h, b}, {q_ss, q_sh, q_sb},
                              FWD_M)) ||
      (err = make_tile_map<4>(&maps.k, k, is_bf16, {d, sk, h_k, b}, {k_ss, k_sh, k_sb},
                              FWD_N)) ||
      (err = make_tile_map<4>(&maps.v, v, is_bf16, {dv, sk, h_k, b}, {v_ss, v_sh, v_sb},
                              FWD_N)))
    return (int)err;
  FwdParams p;
  p.out = out;
  p.lse = lse;
  p.o_sb = o_sb; p.o_ss = o_ss; p.o_sh = o_sh;
  p.sq = sq;
  p.sk = sk;
  p.h = h;
  p.group = h / h_k;
  p.scale_log2 = scale_log2;
  p.causal = causal;
  p.band.left = left < 0 ? BAND_NONE : left;
  p.band.right = right < 0 ? BAND_NONE : right;
  p.band.sink = sink;
  p.band.chunk = chunk;
  p.score = score_from_args(scale_log2, softcap, causal);
  p.slopes = slopes;
  p.slope_sb = slope_sb;
  p.sink = learnable_sink;
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  if (mla) return (int)run_fwd_192(is_bf16, maps, p, b, st);
  if (d == 80) return (int)run_fwd_80(is_bf16, maps, p, b, band, score, st);
  if (score) return (int)run_fwd_score(is_bf16, maps, p, b, d, band, st);
  return (int)(is_bf16 ? launch_band<__nv_bfloat16>(maps, p, b, d, band, st)
                       : launch_band<__half>(maps, p, b, d, band, st));
}
