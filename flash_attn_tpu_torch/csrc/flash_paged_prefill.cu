// Chunked prefill against a paged KV cache with an MLA second query `qv`
// and a value width dv != d, for Hopper (sm_90a) on wgmma and TMA, bf16 /
// fp16: the prefill of absorbed-MLA serving (DeepSeek-V3's 64-wide rope key
// and 512-wide latent).
//
// Replaces the TPU kernel
// flash_attn_tpu/kernels/flash_paged_prefill.py:_paged_prefill_kernel (B8p):
// sequence s's query chunk of seqused_q[s] rows sits at the end of its
// cache_seqlens[s] keys, so with bottom-right causal masking query position
// p sees key positions <= cache_seqlens[s] - seqused_q[s] + p. Scores are
// [q | qv] . [k | v]^T (one product of depth D + DV), out = softmax(scale S)
// V. Rows at or past seqused_q, and rows that see no key, give zeros and
// lse -inf, or the head's sink under a learnable sink (the wrapper
// allocates them so, and no block writes them).
//
// What bounds it on this card: each (query row, key) pair and head costs
// 2 (D + DV) + 2 DV flops (2,176 at 64 + 512), against 1,152 bytes a key and
// 1,152 + 1,024 bytes a query row and head. At DeepSeek-V3's 128 heads a
// 512-position chunk at b = 8 over 2,048 keys is about 1,000 flops a byte:
// the tensor cores' rate bounds it (PERF.md).
//
// What the design does about it: one block per (batch row, KV head, 64-row
// tile) runs the wgmma + TMA tile of mla_sm90.cuh (which the MLA decode
// route shares) over the tile's causal band of keys, from key 0, and writes
// the normalised O in the input type: the two warpgroups add up their row
// sums, stage each normalised half in the Q panels (both are past their last
// score product) and store 16-byte chunks, rows past the chunk skipped. The
// rows of a tile, the key copies, the two warpgroups' alternating layout,
// the shared memory (218 KB at 64 + 512) and the register budget (221 a
// thread at DV = 512, no spills) are described there. Grid: one block per
// (batch row, KV head, row tile), row tiles in reverse so that the longest
// causal bands start first; the blocks of a sequence read the same keys,
// which stay in the 50 MB L2.

#include "mla_sm90.cuh"

namespace {

using namespace fa;
using namespace fa::sm90;

struct PrefillParams {
  const int* starts;   // (b,) first token of each sequence
  const int* lens_q;   // (b,) query positions of each sequence
  const int* lens_k;   // (b,) keys of each sequence, the chunk included
  const int* table;    // (b, table_width) page ids
  void* out;           // (total, h, dv) by strides
  float* lse;          // by strides (token, head)
  int64_t o_st, o_sh, l_st, l_sh, t_sb;
  int h_k, group, gb, pb, head_blocks, page_size, box_rows, table_width, num_pages;
  float scale_log2;
  int causal;
  const float* sink;  // (h,) fp32 learnable sink logits, or nullptr
};

struct PrefillMaps {
  CUtensorMap q, qv, k, v;
};

// Panel c of a tile of positions from token `token` and heads from `head0`
// of the packed (total, h, d) and (total, h, dv) tensors: q's panels, then
// qv's.
template <int D>
struct PackedQ {
  const CUtensorMap* q;
  const CUtensorMap* qv;
  int head0, token;
  __device__ __forceinline__ void load(void* dst, uint64_t* bar, int c) const {
    if (c < D / 64)
      tma_load_3d(dst, q, bar, c * 64, head0, token);
    else
      tma_load_3d(dst, qv, bar, (c - D / 64) * 64, head0, token);
  }
};

template <typename T, typename Dm>
__global__ void __launch_bounds__(MLA_THREADS, 1)
    paged_prefill_kernel(const __grid_constant__ PrefillMaps maps, const PrefillParams p) {
  constexpr int BM = MLA_BM;
  constexpr int PANEL = MLA_PANEL;
  constexpr int DVH = Dm::DVH;
  constexpr int NB = Dm::NB;
  const int bb = blockIdx.x / p.h_k;
  const int kh = blockIdx.x - bb * p.h_k;
  const int yy = gridDim.y - 1 - blockIdx.y;
  const int p0 = (yy / p.head_blocks) * p.pb;  // first position of the tile
  const int hb = (yy % p.head_blocks) * p.gb;  // first head of the tile in the group
  const int sq = p.lens_q[bb];
  if (p0 >= sq) return;
  const int sk = p.lens_k[bb];
  const int k_end = p.causal ? min(sk, min(p0 + p.pb, sq) - 1 + sk - sq + 1) : sk;
  if (k_end <= 0) return;  // no row of the tile sees a key
  const int start = p.starts[bb];
  const int head0 = kh * p.group + hb;

  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = align_1024(smem_raw);
  const MlaRows t{p0, p.gb, sq, sk, 0, (k_end + MLA_BN - 1) / MLA_BN, p.causal};
  const MlaKeys keys{&maps.k, &maps.v,
                     PagedRows{p.table + (int64_t)bb * p.t_sb, 0, p.page_size,
                               p.table_width, p.num_pages},
                     kh, p.box_rows};
  MlaAcc<Dm> a;
  mla_mainloop<T, Dm>(a, PackedQ<Dm::D>{&maps.q, &maps.qv, head0, start + p0}, keys, t,
                      p.scale_log2, smem);
  float l[2];
  mla_row_sums<Dm>(a, smem, l);

  const int tid = threadIdx.x;
  const int wg = tid >> 7;
  const int warp = (tid >> 5) & 3;
  const int g = (tid & 31) >> 2;
  const int t4 = tid & 3;
  unsigned char* ow = smem + MlaLayout<Dm>::Q_OFF + (wg * DVH / 64) * PANEL;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = warp * 16 + g + 8 * i;
    float inv = l[i] == 0.f ? 0.f : 1.f / l[i];
    float lse_sink = 0.f;
    if (p.sink != nullptr) {
      // the sink of the row's own head (rows pack gb heads of a position):
      // fwd_sm90.cuh fwd_epilogue's formula, both warpgroups alike
      const float sink = p.sink[head0 + r % p.gb];
      const float m_nat = a.m_r[i] * FA_LN2;
      const float m_tot = fmaxf(m_nat, sink);
      const float c = expf(m_nat - m_tot);
      const float l_tot = __fmaf_rn(l[i], c, expf(sink - m_tot));
      inv = c / l_tot;
      lse_sink = m_tot + logf(l_tot);
    }
#pragma unroll
    for (int b = 0; b < DVH / NB; ++b)
#pragma unroll
      for (int j = 0; j < NB / 8; ++j) {
        const int col = b * NB + 8 * j + 2 * t4;  // within the half
        *reinterpret_cast<uint32_t*>(ow + (col / 64) * PANEL + swz128(r, col % 64)) =
            Elem<T>::pack(a.o[b][4 * j + 2 * i] * inv, a.o[b][4 * j + 2 * i + 1] * inv);
      }
    const int pos = p0 + r / p.gb;
    if (wg == 0 && t4 == 0 && pos < sq)
      p.lse[(int64_t)(start + pos) * p.l_st + (int64_t)(head0 + r % p.gb) * p.l_sh] =
          p.sink != nullptr ? lse_sink
          : l[i] == 0.f     ? -INFINITY
                            : __fmaf_rn(a.m_r[i], FA_LN2, logf(l[i]));
  }
  named_barrier(2 + wg, 128);
  for (int i = tid & 127; i < BM * (DVH / 8); i += 128) {
    const int r = i / (DVH / 8);
    const int ch = i % (DVH / 8);
    const int pos = p0 + r / p.gb;
    if (pos >= sq) continue;
    T* dst = reinterpret_cast<T*>(p.out) + (int64_t)(start + pos) * p.o_st +
             (int64_t)(head0 + r % p.gb) * p.o_sh + wg * DVH + 8 * ch;
    *reinterpret_cast<uint4*>(dst) = *reinterpret_cast<const uint4*>(
        ow + (ch / 8) * PANEL + r * 128 + (((ch ^ r) & 7) << 4));
  }
}

template <typename T>
cudaError_t launch(const PrefillMaps& maps, const PrefillParams& p, int b, int row_tiles, int d,
                   int dv, cudaStream_t stream) {
  // The forms of dispatch/config.py PAGED_PREFILL_DIMS.
  return mla_dispatch<MlaDims<64, 512, true>, MlaDims<64, 128, true>,
                      MlaDims<128, 128, true>>(d, dv, true, [&](auto dims) {
    using Dm = decltype(dims);
    constexpr int smem = MlaLayout<Dm>::SMEM;
    cudaError_t err = cudaFuncSetAttribute(
        paged_prefill_kernel<T, Dm>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
    paged_prefill_kernel<T, Dm>
        <<<dim3(b * p.h_k, row_tiles), MLA_THREADS, smem, stream>>>(maps, p);
    return cudaGetLastError();
  });
}

}  // namespace

// q (total, h, d), qv (total, h, dv) and out by element strides (token,
// head), the head dim contiguous; pages (num_pages, h_k, page_size, d) and
// (..., dv) by strides (page, head, row); lse by strides (token, head); all
// starts and strides 16-byte aligned (TMA). Sequence s owns tokens
// starts[s] .. starts[s] + lens_q[s]; row_tiles bounds, over the batch,
// ceil(lens_q[s] / PB) * (group / GB) with GB = gcd(h / h_k, 64) and PB =
// 64 / GB (blocks past a sequence's rows return at once). The forms of
// dispatch/config.py PAGED_PREFILL_DIMS, qv only. sink: (h,) fp32 learnable
// sink logits, each row's own head's added to its softmax in the epilogue
// (JAX flash_paged_prefill.py:231-243), or nullptr; the wrapper then fills
// lse with each head's sink, which the rows no block writes keep. Returns a
// cudaError_t (0 on success).
extern "C" int fa_paged_prefill(
    const void* q, const void* qv, const void* kp, const void* vp,
    const int* starts, const int* lens_q, const int* lens_k, const int* table,
    void* out, float* lse, int b, int total, int row_tiles, int h, int h_k, int d,
    int dv, int has_qv, int page_size, int table_width, int num_pages, int64_t q_st,
    int64_t q_sh, int64_t qv_st, int64_t qv_sh, int64_t k_sp, int64_t k_sh,
    int64_t k_ss, int64_t v_sp, int64_t v_sh, int64_t v_ss, int64_t o_st,
    int64_t o_sh, int64_t l_st, int64_t l_sh, int64_t t_sb, float scale_log2,
    int causal, const float* sink, int is_bf16, void* stream) {
  if (!has_qv || h_k < 1 || h % h_k != 0 || page_size < 1 || table_width < 1 ||
      num_pages < 1)
    return (int)cudaErrorInvalidValue;
  if (b == 0 || row_tiles == 0 || total == 0) return 0;
  PrefillParams p;
  p.starts = starts;
  p.lens_q = lens_q;
  p.lens_k = lens_k;
  p.table = table;
  p.out = out;
  p.lse = lse;
  p.o_st = o_st; p.o_sh = o_sh; p.l_st = l_st; p.l_sh = l_sh;
  p.t_sb = t_sb;
  p.h_k = h_k;
  p.group = h / h_k;
  p.gb = gcd64(p.group);
  p.pb = MLA_BM / p.gb;
  p.head_blocks = p.group / p.gb;
  p.page_size = page_size;
  p.box_rows = gcd64(page_size);
  p.table_width = table_width;
  p.num_pages = num_pages;
  p.scale_log2 = scale_log2;
  p.causal = causal;
  p.sink = sink;
  PrefillMaps maps;
  cudaError_t err;
  if ((err = make_tile_map<3>(&maps.q, q, is_bf16, {d, h, total}, {q_sh, q_st}, p.gb, p.pb)) ||
      (err = make_tile_map<3>(&maps.qv, qv, is_bf16, {dv, h, total}, {qv_sh, qv_st}, p.gb,
                              p.pb)) ||
      (err = make_tile_map<4>(&maps.k, kp, is_bf16, {d, page_size, h_k, num_pages},
                              {k_ss, k_sh, k_sp}, p.box_rows)) ||
      (err = make_tile_map<4>(&maps.v, vp, is_bf16, {dv, page_size, h_k, num_pages},
                              {v_ss, v_sh, v_sp}, p.box_rows)))
    return (int)err;
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  if (is_bf16) return (int)launch<__nv_bfloat16>(maps, p, b, row_tiles, d, dv, st);
  return (int)launch<__half>(maps, p, b, row_tiles, d, dv, st);
}
