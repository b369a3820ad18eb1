// The MLA route of split-KV decode attention for Hopper (sm_90a) on wgmma
// and TMA, bf16 / fp16: a second query `qv` that scores against V, a value
// width dv that differs from the key width d, and DeepSeek's 576/512 latent
// cache.
//
// Replaces the qv and dv != d branches of the TPU kernel
// flash_attn_tpu/kernels/flash_decode.py:_decode_kernel (the qv term at
// :174-180 and :231-244, the value width at :367-392), over a linear or a
// paged cache. The split partials are merged by combine_splits in
// kernels/flash_decode.py, as for the d = dv route (csrc/flash_decode.cu).
//
// What bounds it on this card: DeepSeek-V3's absorbed attention caches, per
// token and layer, a 512-wide latent c_kv (the V) and a 64-wide rope key
// k_pe (the K), 1,152 bytes in bf16, and serves all 128 query heads from
// that one KV head. Each (query row, key) pair costs 64 + 512 score MACs and
// 512 output MACs: 2,176 flops a key and head, 278,528 a key at 128 heads,
// against its 1,152 bytes, about 242 flops a byte, near the card's ridge
// (295): at b = 8 and ~2,080 keys a step moves 19.2 MB (5.7 us) for 4.6
// GFLOP (4.7 us); at b = 32 and 8,192 keys, 302 MB (90 us) for 73 GFLOP
// (74 us). Beside the function's bytes, each block writes an fp32 split
// partial of 64 x dv (128 KB at dv = 512) that combine_splits reads.
//
// What the design does about it: one block per (batch row, KV head, split,
// 64-row tile) runs the wgmma + TMA tile of mla_sm90.cuh (the one B8p runs)
// over its split's keys, so the 128 heads of a token take two blocks, each
// reading the split's keys once into shared memory and feeding both
// products from them on the tensor cores. The splits, contiguous runs of
// DECODE_BLOCK_K = 64-key tiles cut as in the d = dv route (so paged and
// linear decode sum in the same order), fill the 132 SMs at small batch: b
// = 8 gives 16 row tiles, and the wrapper's split count multiplies them. A
// linear cache (b_c, h_k, s_max, d) is read as a paged one whose batch row
// bb is one page of s_max rows, through the same 4D maps and boxes of
// gcd(s_max, 64) rows. The 576/512 form without qv keeps V as K's first 512
// columns in the same stage and puts P in the rope panel. The partial is
// stored straight from the accumulators: 8-byte stores, each quad of a row
// filling a 32-byte sector. A split with no key of a row tile writes zeros
// and lse -inf (combine_splits gives it weight 0, and NaN x 0 would be NaN).
// Left for later: a length-balanced partition that would give every block
// the same number of key tiles (ROADMAP.md).

#include "mla_sm90.cuh"

namespace {

using namespace fa;
using namespace fa::sm90;

struct MlaDecodeParams {
  const int* seqlens;  // (b,) cache length after the append
  const int* table;    // (b, table_width) page ids, or nullptr for a linear cache
  float* out_p;        // (num_splits, b, h_k, rows, dv)
  float* lse_p;        // (num_splits, b, h_k, rows)
  int64_t t_sb;
  int b, sq, h_k, group, gb, pb, head_blocks, rows, num_splits;
  int page_size, box_rows, table_width, num_pages, cap;
  float scale_log2;
  int causal;
};

struct DecodeMaps {
  CUtensorMap q, qv, k, v;
};

// Panel c of a tile of positions from p0 and heads from head0 of batch row
// bb of the (b, sq, h, d) and (b, sq, h, dv) tensors: q's panels, then qv's.
template <int D>
struct BatchQ {
  const CUtensorMap* q;
  const CUtensorMap* qv;
  int head0, p0, bb;
  __device__ __forceinline__ void load(void* dst, uint64_t* bar, int c) const {
    if (c < D / 64)
      tma_load_4d(dst, q, bar, c * 64, head0, p0, bb);
    else
      tma_load_4d(dst, qv, bar, (c - D / 64) * 64, head0, p0, bb);
  }
};

template <typename T, typename Dm>
__global__ void __launch_bounds__(MLA_THREADS, 1)
    decode_mla_kernel(const __grid_constant__ DecodeMaps maps, const MlaDecodeParams p) {
  constexpr int DVH = Dm::DVH;
  constexpr int NB = Dm::NB;
  const int bb = blockIdx.x / p.h_k;
  const int kh = blockIdx.x - bb * p.h_k;
  const int split = blockIdx.y;
  const int p0 = (blockIdx.z / p.head_blocks) * p.pb;  // first position of the tile
  const int hb = (blockIdx.z % p.head_blocks) * p.gb;  // first head of the tile in the group

  // This split's keys: the cache cut into 64-key tiles, shared out in
  // contiguous runs (the d = dv route's partition), up to the causal limit
  // of the tile's last position.
  const int sk = min(p.seqlens[bb], p.cap);
  const int tiles = (sk + MLA_BN - 1) / MLA_BN;
  const int kps = (tiles + p.num_splits - 1) / p.num_splits;
  const int k_lo = min(sk, split * kps * MLA_BN);
  const int k_hi = min(sk, (split + 1) * kps * MLA_BN);
  const int k_end = p.causal ? min(k_hi, min(p0 + p.pb, p.sq) - 1 + sk - p.sq + 1) : k_hi;

  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = align_1024(smem_raw);
  const MlaRows t{p0, p.gb, p.sq, sk, k_lo,
                  k_end > k_lo ? (k_end - k_lo + MLA_BN - 1) / MLA_BN : 0, p.causal};
  const MlaKeys keys{&maps.k, &maps.v,
                     PagedRows{p.table == nullptr ? nullptr : p.table + (int64_t)bb * p.t_sb,
                               bb, p.page_size, p.table_width, p.num_pages},
                     kh, p.box_rows};
  MlaAcc<Dm> a;
  mla_mainloop<T, Dm>(a, BatchQ<Dm::D>{&maps.q, &maps.qv, kh * p.group + hb, p0, bb}, keys,
                      t, p.scale_log2, smem);
  float l[2];
  mla_row_sums<Dm>(a, smem, l);

  // The normalised fp32 partial of each live row (position < sq), row pos *
  // group + head of the (split, batch row, KV head) slab.
  const int64_t part = ((int64_t)split * p.b + bb) * p.h_k + kh;
  const int tid = threadIdx.x;
  const int wg = tid >> 7;
  const int warp = (tid >> 5) & 3;
  const int g = (tid & 31) >> 2;
  const int t4 = tid & 3;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = warp * 16 + g + 8 * i;
    const int pos = p0 + r / p.gb;
    if (pos >= p.sq) continue;
    const int64_t row = part * p.rows + (int64_t)pos * p.group + hb + r % p.gb;
    const float inv = l[i] == 0.f ? 0.f : 1.f / l[i];
    float* dst = p.out_p + row * Dm::DV + wg * DVH + 2 * t4;
#pragma unroll
    for (int b = 0; b < DVH / NB; ++b)
#pragma unroll
      for (int j = 0; j < NB / 8; ++j)
        *reinterpret_cast<float2*>(dst + b * NB + 8 * j) =
            make_float2(a.o[b][4 * j + 2 * i] * inv, a.o[b][4 * j + 2 * i + 1] * inv);
    if (wg == 0 && t4 == 0)
      p.lse_p[row] = l[i] == 0.f ? -INFINITY : __fmaf_rn(a.m_r[i], FA_LN2, logf(l[i]));
  }
}

template <typename T>
cudaError_t launch(const DecodeMaps& maps, const MlaDecodeParams& p, int d, int dv, bool has_qv,
                   int row_tiles, cudaStream_t stream) {
  // The forms of dispatch/config.py MLA_DECODE_DIMS.
  return mla_dispatch<MlaDims<64, 512, true>, MlaDims<576, 512, false>, MlaDims<64, 128, true>,
                      MlaDims<128, 128, true>>(d, dv, has_qv, [&](auto dims) {
    using Dm = decltype(dims);
    constexpr int smem = MlaLayout<Dm>::SMEM;
    cudaError_t err = cudaFuncSetAttribute(
        decode_mla_kernel<T, Dm>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
    decode_mla_kernel<T, Dm>
        <<<dim3(p.b * p.h_k, p.num_splits, row_tiles), MLA_THREADS, smem, stream>>>(maps, p);
    return cudaGetLastError();
  });
}

}  // namespace

// The MLA route of fa_decode (csrc/flash_decode.cu): q (b, sq, h, d) and qv
// (b, sq, h, dv; nullptr without it) by element strides (batch, position,
// head); the caches (num_pages, h_k, page_size, d) and (..., dv) by strides
// (page, head, row) with table (b, table_width), or, with table == nullptr,
// linear (b_c, h_k, s_max, d) passed as num_pages = b_c pages of page_size
// = s_max rows; without qv, V is K's first dv columns and vc is not read.
// The head dims contiguous, every start and stride 16-byte aligned (TMA).
// block_k must be the split granularity of the wrapper (dispatch/config.py
// DECODE_BLOCK_K), the tile's 64 keys. Returns a cudaError_t (0 on
// success).
extern "C" int fa_decode_mla(
    const void* q, const void* qv, const void* kc, const void* vc,
    const int* seqlens, const int* table, float* out_p, float* lse_p, int b,
    int sq, int h, int h_k, int d, int dv, int has_qv, int num_splits,
    int block_k, int page_size, int table_width, int num_pages, int cap,
    int64_t q_sb, int64_t q_ss, int64_t q_sh, int64_t qv_sb, int64_t qv_ss,
    int64_t qv_sh, int64_t k_sb, int64_t k_sh, int64_t k_ss, int64_t v_sb,
    int64_t v_sh, int64_t v_ss, int64_t t_sb, float scale_log2, int causal,
    int is_bf16, void* stream) {
  if (block_k != MLA_BN || h_k < 1 || h % h_k != 0 || page_size < 1 || num_pages < 1 ||
      num_splits < 1 || (table != nullptr && table_width < 1))
    return (int)cudaErrorInvalidValue;
  if (b == 0 || sq == 0) return 0;
  MlaDecodeParams p;
  p.seqlens = seqlens;
  p.table = table;
  p.out_p = out_p;
  p.lse_p = lse_p;
  p.t_sb = t_sb;
  p.b = b;
  p.sq = sq;
  p.h_k = h_k;
  p.group = h / h_k;
  p.gb = gcd64(p.group);
  p.pb = MLA_BM / p.gb;
  p.head_blocks = p.group / p.gb;
  p.rows = sq * p.group;
  p.num_splits = num_splits;
  p.page_size = page_size;
  p.box_rows = gcd64(page_size);
  p.table_width = table_width;
  p.num_pages = num_pages;
  p.cap = cap;
  p.scale_log2 = scale_log2;
  p.causal = causal;
  const int row_tiles = (sq + p.pb - 1) / p.pb * p.head_blocks;
  DecodeMaps maps;
  cudaError_t err;
  if ((err = make_tile_map<4>(&maps.q, q, is_bf16, {d, h, sq, b}, {q_sh, q_ss, q_sb}, p.gb,
                              p.pb)) ||
      (err = make_tile_map<4>(&maps.k, kc, is_bf16, {d, page_size, h_k, num_pages},
                              {k_ss, k_sh, k_sb}, p.box_rows)))
    return (int)err;
  if (has_qv &&
      ((err = make_tile_map<4>(&maps.qv, qv, is_bf16, {dv, h, sq, b}, {qv_sh, qv_ss, qv_sb},
                               p.gb, p.pb)) ||
       (err = make_tile_map<4>(&maps.v, vc, is_bf16, {dv, page_size, h_k, num_pages},
                               {v_ss, v_sh, v_sb}, p.box_rows))))
    return (int)err;
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  if (is_bf16) return (int)launch<__nv_bfloat16>(maps, p, d, dv, has_qv != 0, row_tiles, st);
  return (int)launch<__half>(maps, p, d, dv, has_qv != 0, row_tiles, st);
}
