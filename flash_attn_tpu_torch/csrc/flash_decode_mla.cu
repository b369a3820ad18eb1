// The MLA route of split-KV decode attention for Hopper (sm_90a), bf16 /
// fp16: a second query `qv` that scores against V, a value width dv that
// differs from the key width d, and DeepSeek's 576/512 latent cache.
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
// against its 1,152 bytes, about 242 flops a byte. That is near the card's
// ridge (295), not far below it as GQA decode is: at b = 8 and ~2,080 keys
// a layer moves 19.2 MB (5.7 us) for 4.6 GFLOP (4.7 us); at the reference's
// b = 32 and 8,192 keys, 302 MB (90 us) for 73 GFLOP (74 us). So the d = dv
// route's design (fp32 dot products on the ordinary ALUs, 8 query rows a
// block, each block re-reading the cache) would take 16 blocks per row to
// cover 128 rows and read the cache 16 times.
//
// What the design does about it: one block per (batch row, KV head, split,
// 64-row tile) runs the tensor-core tile loop of mla_tile.cuh over its
// split's keys, so the 128 heads of a token take two blocks, each reading
// the split's keys once into shared memory. The splits, cut on
// DECODE_BLOCK_K tiles as in the d = dv route (so paged and linear decode
// sum in the same order), are what fill the 132 SMs at small batch: b = 8
// gives 16 row tiles, and the wrapper's split count multiplies them. For
// the 576/512 form without qv, V is K's first 512 columns and is read from
// the same shared-memory tile. Left for later: wgmma with the row tile in
// one warpgroup, TMA page copies, and splitting the row tile's keys across
// SMs of a cluster instead of through the combine.

#include "mla_tile.cuh"

namespace {

struct MlaDecodeParams {
  const void* q;        // (b, sq, h, d) by strides
  const void* qv;       // (b, sq, h, dv) by strides, or nullptr
  const void* kc;       // (b_c, h_k, s_max, d) or pages (P, h_k, page_size, d)
  const void* vc;       // the same with dv (unused without qv)
  const int* seqlens;   // (b,) cache length after the append
  const int* table;     // (b, table_width) page ids, paged cache only
  float* out_p;         // (num_splits, b, h_k, rows, dv)
  float* lse_p;         // (num_splits, b, h_k, rows)
  int64_t q_sb, q_ss, q_sh, qv_sb, qv_ss, qv_sh;
  int64_t k_sb, k_sh, k_ss, v_sb, v_sh, v_ss;  // k_sb: page stride if paged
  int64_t t_sb;
  int b, sq, h_k, group, rows, num_splits, block_k;
  int page_size, table_width, num_pages, cap;
  float scale_log2;
  int causal;
};

template <typename T, typename Dims>
__global__ void __launch_bounds__(fa::MLA_THREADS, 1)
    decode_mla_kernel(const MlaDecodeParams p) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  const int bb = blockIdx.x / p.h_k;
  const int kh = blockIdx.x % p.h_k;
  const int split = blockIdx.y;
  const int m0 = blockIdx.z * fa::MLA_BM;
  if (m0 >= p.rows) return;

  // This split's keys: the cache cut into block_k tiles, shared out in
  // contiguous runs (the d = dv route's partition).
  const int sk = min(p.seqlens[bb], p.cap);
  const int tiles = (sk + p.block_k - 1) / p.block_k;
  const int kps = (tiles + p.num_splits - 1) / p.num_splits;

  fa::MlaTile<T> t;
  t.q = reinterpret_cast<const T*>(p.q) + bb * p.q_sb + kh * p.group * p.q_sh;
  t.qv = Dims::QV ? reinterpret_cast<const T*>(p.qv) + bb * p.qv_sb +
                        kh * p.group * p.qv_sh
                  : nullptr;
  const int64_t part = ((int64_t)split * p.b + bb) * p.h_k + kh;
  t.out = p.out_p + part * p.rows * Dims::DV;
  t.lse = p.lse_p + part * p.rows;
  t.q_st = p.q_ss;
  t.q_sh = p.q_sh;
  t.qv_st = p.qv_ss;
  t.qv_sh = p.qv_sh;
  t.o_st = (int64_t)p.group * Dims::DV;  // row = pos * group + j, dv apart
  t.o_sh = Dims::DV;
  t.l_st = p.group;
  t.l_sh = 1;
  t.group = p.group;
  t.rows = p.rows;
  t.m0 = m0;
  t.shift = sk - p.sq;
  t.causal = p.causal;
  t.k_lo = min(sk, split * kps * p.block_k);
  t.k_hi = min(sk, (split + 1) * kps * p.block_k);

  fa::MlaCache<T> c;
  c.k = reinterpret_cast<const T*>(p.kc) + kh * p.k_sh;
  c.v = Dims::QV ? reinterpret_cast<const T*>(p.vc) + kh * p.v_sh : c.k;
  c.k_sb = p.k_sb;
  c.k_ss = p.k_ss;
  c.v_sb = p.v_sb;
  c.v_ss = p.v_ss;
  c.table_row = p.table == nullptr ? nullptr : p.table + bb * p.t_sb;
  c.bb = bb;
  c.page_size = p.page_size;
  c.table_width = p.table_width;
  c.num_pages = p.num_pages;
  fa::mla_tile<T, Dims, true>(t, c, p.scale_log2, smem_raw);
}

template <typename T>
cudaError_t launch(const MlaDecodeParams& p, int d, int dv, bool has_qv,
                   cudaStream_t stream) {
  // The forms of dispatch/config.py MLA_DECODE_DIMS.
  return fa::mla_dispatch<fa::MlaDims<64, 512, true>,
                          fa::MlaDims<576, 512, false>,
                          fa::MlaDims<64, 128, true>,
                          fa::MlaDims<128, 128, true>>(
                              d, dv, has_qv, [&](auto dims) {
    using Dims = decltype(dims);
    const int smem = fa::mla_smem_bytes<Dims, T>();
    cudaError_t err = cudaFuncSetAttribute(
        decode_mla_kernel<T, Dims>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
    dim3 grid(p.b * p.h_k, p.num_splits,
              (p.rows + fa::MLA_BM - 1) / fa::MLA_BM);
    decode_mla_kernel<T, Dims><<<grid, fa::MLA_THREADS, smem, stream>>>(p);
    return cudaGetLastError();
  });
}

}  // namespace

// The MLA route of fa_decode (csrc/flash_decode.cu): qv (nullptr without
// it) and a value width dv; table == nullptr reads a linear cache. block_k
// must be the split granularity of the wrapper (dispatch/config.py
// DECODE_BLOCK_K, a multiple of the tile's 64 keys). Returns a cudaError_t
// (0 on success).
extern "C" int fa_decode_mla(
    const void* q, const void* qv, const void* kc, const void* vc,
    const int* seqlens, const int* table, float* out_p, float* lse_p, int b,
    int sq, int h, int h_k, int d, int dv, int has_qv, int num_splits,
    int block_k, int page_size, int table_width, int num_pages, int cap,
    int64_t q_sb, int64_t q_ss, int64_t q_sh, int64_t qv_sb, int64_t qv_ss,
    int64_t qv_sh, int64_t k_sb, int64_t k_sh, int64_t k_ss, int64_t v_sb,
    int64_t v_sh, int64_t v_ss, int64_t t_sb, float scale_log2, int causal,
    int is_bf16, void* stream) {
  if (block_k % fa::MLA_BN != 0) return (int)cudaErrorInvalidValue;
  MlaDecodeParams p;
  p.q = q;
  p.qv = qv;
  p.kc = kc;
  p.vc = vc;
  p.seqlens = seqlens;
  p.table = table;
  p.out_p = out_p;
  p.lse_p = lse_p;
  p.q_sb = q_sb; p.q_ss = q_ss; p.q_sh = q_sh;
  p.qv_sb = qv_sb; p.qv_ss = qv_ss; p.qv_sh = qv_sh;
  p.k_sb = k_sb; p.k_sh = k_sh; p.k_ss = k_ss;
  p.v_sb = v_sb; p.v_sh = v_sh; p.v_ss = v_ss;
  p.t_sb = t_sb;
  p.b = b;
  p.sq = sq;
  p.h_k = h_k;
  p.group = h / h_k;
  p.rows = sq * p.group;
  p.num_splits = num_splits;
  p.block_k = block_k;
  p.page_size = page_size;
  p.table_width = table_width;
  p.num_pages = num_pages;
  p.cap = cap;
  p.scale_log2 = scale_log2;
  p.causal = causal;
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  if (is_bf16) return (int)launch<__nv_bfloat16>(p, d, dv, has_qv != 0, st);
  return (int)launch<__half>(p, d, dv, has_qv != 0, st);
}
