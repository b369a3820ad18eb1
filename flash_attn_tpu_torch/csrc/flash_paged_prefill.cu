// Chunked prefill against a paged KV cache with an MLA second query `qv`
// and a value width dv != d, for Hopper (sm_90a), bf16 / fp16: the prefill
// of absorbed-MLA serving (DeepSeek-V3's 64-wide rope key and 512-wide
// latent).
//
// Replaces the TPU kernel
// flash_attn_tpu/kernels/flash_paged_prefill.py:_paged_prefill_kernel (B8p):
// sequence s's query chunk of seqused_q[s] rows sits at the end of its
// cache_seqlens[s] keys, so with bottom-right causal masking query row r
// sees key positions <= cache_seqlens[s] - seqused_q[s] + r; rows at or
// past seqused_q give zeros and lse -inf (the wrapper allocates them so,
// and no block writes them).
//
// What bounds it on this card: each (query row, key) pair and head costs
// 2,176 flops at 64 + 512 (score and output), against 1,152 bytes a key
// and 1,152 + 1,024 bytes a query row and head. At DeepSeek-V3's 128 heads
// the four 512-position chunks of a 2,048-token prompt at b = 8 do 1.17
// TFLOP a chunk on average against ~1.16 GB (q, qv and out dominate; the
// keys are 19 MB), about 1,000 flops a byte: the floor is the tensor cores'
// rate, 4.7 ms a layer for the four chunks.
//
// What the design does about it: the TPU kernel takes a dense-padded
// (b, sq_max) query block per grid step and walks the pages with DMAs; here
// one block per (batch row, KV head, 64-row tile) runs the tensor-core tile
// loop of mla_tile.cuh over the sequence's keys, and reads q, qv and out in
// the packed layout of flash_attn_varlen_func through a per-sequence start
// row, so the varlen entry point needs no pack, pad or unpack. Rows pack the
// heads fastest (mla_tile.cuh): at 128 heads on one KV head a tile is 64
// heads of one position, so the tile's key count is exact and only its last
// key tile is masked. The blocks of a sequence read the same keys, which
// stay in the 50 MB L2 (1,152 bytes a key: 19 MB for 8 x 2,080 keys); the
// row tiles run in reverse, so the longest causal bands start first. Left
// for later: wgmma and TMA page copies, and one block over several row
// tiles so a key tile read from L2 feeds more than 64 rows.

#include "mla_tile.cuh"

namespace {

struct PagedPrefillParams {
  const void* q;       // (total, h, d) by strides (token, head)
  const void* qv;      // (total, h, dv) by strides, or nullptr
  const void* kp;      // (num_pages, h_k, page_size, d) by strides
  const void* vp;      // (num_pages, h_k, page_size, dv) (unused without qv)
  const int* starts;   // (b,) first token of each sequence
  const int* lens_q;   // (b,) query rows of each sequence
  const int* lens_k;   // (b,) keys of each sequence, the chunk included
  const int* table;    // (b, table_width) page ids
  void* out;           // (total, h, dv) by strides
  float* lse;          // by strides (token, head)
  int64_t q_st, q_sh, qv_st, qv_sh;
  int64_t k_sp, k_sh, k_ss, v_sp, v_sh, v_ss;
  int64_t o_st, o_sh, l_st, l_sh, t_sb;
  int h_k, group, page_size, table_width, num_pages;
  float scale_log2;
  int causal;
};

template <typename T, typename Dims>
__global__ void __launch_bounds__(fa::MLA_THREADS, 1)
    paged_prefill_kernel(const PagedPrefillParams p) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  const int bb = blockIdx.x / p.h_k;
  const int kh = blockIdx.x % p.h_k;
  const int m0 = (gridDim.y - 1 - blockIdx.y) * fa::MLA_BM;
  const int sq = p.lens_q[bb];
  const int rows = sq * p.group;
  if (m0 >= rows) return;
  const int sk = p.lens_k[bb];
  const int64_t start = p.starts[bb];

  fa::MlaTile<T> t;
  t.q = reinterpret_cast<const T*>(p.q) + start * p.q_st + kh * p.group * p.q_sh;
  t.qv = Dims::QV ? reinterpret_cast<const T*>(p.qv) + start * p.qv_st +
                        kh * p.group * p.qv_sh
                  : nullptr;
  t.out = reinterpret_cast<T*>(p.out) + start * p.o_st + kh * p.group * p.o_sh;
  t.lse = p.lse + start * p.l_st + kh * p.group * p.l_sh;
  t.q_st = p.q_st;
  t.q_sh = p.q_sh;
  t.qv_st = p.qv_st;
  t.qv_sh = p.qv_sh;
  t.o_st = p.o_st;
  t.o_sh = p.o_sh;
  t.l_st = p.l_st;
  t.l_sh = p.l_sh;
  t.group = p.group;
  t.rows = rows;
  t.m0 = m0;
  t.shift = sk - sq;
  t.causal = p.causal;
  t.k_lo = 0;
  t.k_hi = sk;

  fa::MlaCache<T> c;
  c.k = reinterpret_cast<const T*>(p.kp) + kh * p.k_sh;
  c.v = Dims::QV ? reinterpret_cast<const T*>(p.vp) + kh * p.v_sh : c.k;
  c.k_sb = p.k_sp;
  c.k_ss = p.k_ss;
  c.v_sb = p.v_sp;
  c.v_ss = p.v_ss;
  c.table_row = p.table + bb * p.t_sb;
  c.bb = bb;
  c.page_size = p.page_size;
  c.table_width = p.table_width;
  c.num_pages = p.num_pages;
  fa::mla_tile<T, Dims, false>(t, c, p.scale_log2, smem_raw);
}

template <typename T>
cudaError_t launch(const PagedPrefillParams& p, int b, int row_tiles, int d,
                   int dv, bool has_qv, cudaStream_t stream) {
  // The forms of dispatch/config.py PAGED_PREFILL_DIMS: qv only, since
  // flash_attn_varlen_func sends only qv calls here.
  return fa::mla_dispatch<fa::MlaDims<64, 512, true>,
                          fa::MlaDims<64, 128, true>,
                          fa::MlaDims<128, 128, true>>(
                              d, dv, has_qv, [&](auto dims) {
    using Dims = decltype(dims);
    const int smem = fa::mla_smem_bytes<Dims, T>();
    cudaError_t err = cudaFuncSetAttribute(
        paged_prefill_kernel<T, Dims>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
    dim3 grid(b * p.h_k, row_tiles);
    paged_prefill_kernel<T, Dims><<<grid, fa::MLA_THREADS, smem, stream>>>(p);
    return cudaGetLastError();
  });
}

}  // namespace

// q/qv/out by element strides (token, head), the head dim contiguous; pages
// by strides (page, head, row); lse by strides (token, head). Sequence s
// owns tokens starts[s] .. starts[s] + lens_q[s]; row_tiles bounds
// ceil(lens_q[s] * h / h_k / 64) over the batch (blocks past a sequence's
// rows return at once). Returns a cudaError_t (0 on success).
extern "C" int fa_paged_prefill(
    const void* q, const void* qv, const void* kp, const void* vp,
    const int* starts, const int* lens_q, const int* lens_k, const int* table,
    void* out, float* lse, int b, int row_tiles, int h, int h_k, int d, int dv,
    int has_qv, int page_size, int table_width, int num_pages, int64_t q_st,
    int64_t q_sh, int64_t qv_st, int64_t qv_sh, int64_t k_sp, int64_t k_sh,
    int64_t k_ss, int64_t v_sp, int64_t v_sh, int64_t v_ss, int64_t o_st,
    int64_t o_sh, int64_t l_st, int64_t l_sh, int64_t t_sb, float scale_log2,
    int causal, int is_bf16, void* stream) {
  if (b == 0 || row_tiles == 0) return 0;
  PagedPrefillParams p;
  p.q = q;
  p.qv = qv;
  p.kp = kp;
  p.vp = vp;
  p.starts = starts;
  p.lens_q = lens_q;
  p.lens_k = lens_k;
  p.table = table;
  p.out = out;
  p.lse = lse;
  p.q_st = q_st; p.q_sh = q_sh; p.qv_st = qv_st; p.qv_sh = qv_sh;
  p.k_sp = k_sp; p.k_sh = k_sh; p.k_ss = k_ss;
  p.v_sp = v_sp; p.v_sh = v_sh; p.v_ss = v_ss;
  p.o_st = o_st; p.o_sh = o_sh; p.l_st = l_st; p.l_sh = l_sh;
  p.t_sb = t_sb;
  p.h_k = h_k;
  p.group = h / h_k;
  p.page_size = page_size;
  p.table_width = table_width;
  p.num_pages = num_pages;
  p.scale_log2 = scale_log2;
  p.causal = causal;
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  if (is_bf16)
    return (int)launch<__nv_bfloat16>(p, b, row_tiles, d, dv, has_qv != 0, st);
  return (int)launch<__half>(p, b, row_tiles, d, dv, has_qv != 0, st);
}
