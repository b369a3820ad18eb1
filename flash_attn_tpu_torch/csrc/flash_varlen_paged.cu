// Packed-varlen prefill attention over a paged KV cache for Hopper (sm_90a),
// bf16 / fp16, head dim 64 or 128: the prefix-cached chunked prefill of the
// serving engine.
//
// Replaces the TPU kernel
// flash_attn_tpu/kernels/flash_varlen_paged.py:_varlen_paged_kernel (B8).
// Query chunks of several sequences are packed along one token axis
// (cu_seqlens_q, optionally with a true length seqused_q per sequence
// inside a padded slot); each sequence's keys and values sit in pages of
// the cache (num_pages, h_k, page_size, d) named by its row of the block
// table, and its key count seqlens_k includes the chunk. Masking is bottom-
// right causal: local query row r of a sequence sees key positions
// <= r + seqlens_k - seqused_q. Rows past seqused_q, and rows that see no
// key, give out = 0 and lse = -inf, as the TPU kernel's do.
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
// What the design does about it: not the TPU's persistent grid of one step
// per KV head walking a flat work list (blocks run in parallel on Hopper,
// with no order between them), but one block per (64-row query tile of one
// sequence, query head), with the forward tile loop of fwd_tile.cuh (Q in
// registers as mma.sync fragments, 64-key K/V tiles through cp.async into
// swizzled shared memory, both products on the tensor cores, the online
// softmax in fp32 registers). Each block reads its (sequence, first local
// row) from a per-tile array the wrapper builds with torch ops (the
// counterpart of the JAX function's seq_of / qloc), so nothing is read back
// to the host. K/V tiles load row by row through the page table (PagedKV):
// key position j is row j % page_size of page table[s, j / page_size], so
// any page size works. Rows past seqused_q are in no tile; the wrapper
// fills them with zeros and lse -inf. Left for later: wgmma and TMA page
// copies, a shared-memory ring that keeps loads in flight across tiles,
// one block for the GQA group's query heads (each head's block reads its
// K/V tiles again here), and a persistent schedule.

#include "fwd_tile.cuh"

namespace {

constexpr int BM = fa::FWD_BM;  // query rows per block
constexpr int BN = fa::FWD_BN;  // keys per K/V tile
constexpr int NTHREADS = fa::FWD_THREADS;

struct VarlenPagedParams {
  const void* q;       // (total_q, h, d) by strides
  const void* kp;      // (num_pages, h_k, page_size, d) by strides
  const void* vp;
  const int* cu_q;     // (b + 1,) token offsets of the packed layout
  const int* lens_q;   // (b,) true query lengths (seqused_q, or cu deltas)
  const int* lens_k;   // (b,) key counts, the chunk included
  const int* table;    // (b, table_width) page ids
  const int* tiles;    // (num_tiles, 2): sequence (-1: no tile), first row
  void* out;           // (total_q, h, d) by strides
  float* lse;          // (h, total_q)
  int64_t q_st, q_sh;
  int64_t k_sp, k_sh, k_ss;
  int64_t v_sp, v_sh, v_ss;
  int64_t o_st, o_sh;
  int64_t t_sb;
  int total_q, h, group, page_size, table_width, num_pages;
  float scale_log2;
  int causal;
};

// K and V rows of one sequence and KV head through its row of the page
// table (fwd_tile.cuh's loader interface); positions at or past nkeys are
// zero-filled, table entries out of range read the nearest page.
template <typename T, int D>
struct PagedKV {
  const T* k;  // page 0 of this KV head
  const T* v;
  const int* table_row;
  int64_t k_sp, k_ss, v_sp, v_ss;  // page and row strides
  int page_size, table_width, num_pages;

  __device__ __forceinline__ void load(T* tile, const T* head_base,
                                       int64_t page_stride, int64_t row_stride,
                                       int n0, int nkeys, int tid) const {
    constexpr int CHUNKS = D / 8;
#pragma unroll
    for (int i = 0; i < BN * CHUNKS / NTHREADS; ++i) {
      const int c = tid + i * NTHREADS;
      const int r = c / CHUNKS;
      const int ch = c % CHUNKS;
      const int key = n0 + r;
      const bool ok = key < nkeys;
      const T* src = head_base;
      if (ok) {
        const int col = key / page_size;
        const int pg = min(max(table_row[min(col, table_width - 1)], 0),
                           num_pages - 1);
        src = head_base + pg * page_stride +
              (int64_t)(key - col * page_size) * row_stride + ch * 8;
      }
      fa::cp_async_16(fa::smem_addr(tile + fa::swz<D>(r, ch)), src, ok ? 16 : 0);
    }
  }
  __device__ __forceinline__ void load_k(T* tile, int n0, int nkeys,
                                         int tid) const {
    load(tile, k, k_sp, k_ss, n0, nkeys, tid);
  }
  __device__ __forceinline__ void load_v(T* tile, int n0, int nkeys,
                                         int tid) const {
    load(tile, v, v_sp, v_ss, n0, nkeys, tid);
  }
};

template <typename T, int D>
__global__ void __launch_bounds__(NTHREADS)
    varlen_paged_kernel(const VarlenPagedParams p) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  const int seq = p.tiles[2 * blockIdx.x];
  if (seq < 0) return;  // past the last tile of the batch
  const int hh = blockIdx.y;
  const int kh = hh / p.group;
  const int q0 = p.cu_q[seq];
  fa::FwdTile<T> t;
  t.q = reinterpret_cast<const T*>(p.q) + (int64_t)q0 * p.q_st + hh * p.q_sh;
  t.out = reinterpret_cast<T*>(p.out) + (int64_t)q0 * p.o_st + hh * p.o_sh;
  t.lse = p.lse + (int64_t)hh * p.total_q + q0;
  t.q_ss = p.q_st;
  t.o_ss = p.o_st;
  t.sq = p.lens_q[seq];
  t.sk = p.lens_k[seq];
  t.m0 = p.tiles[2 * blockIdx.x + 1];
  const PagedKV<T, D> kv{reinterpret_cast<const T*>(p.kp) + kh * p.k_sh,
                         reinterpret_cast<const T*>(p.vp) + kh * p.v_sh,
                         p.table + seq * p.t_sb,
                         p.k_sp, p.k_ss, p.v_sp, p.v_ss,
                         p.page_size, p.table_width, p.num_pages};
  fa::fwd_tile<T, D>(t, kv, p.scale_log2, p.causal, smem_raw);
}

template <typename T, int D>
cudaError_t launch(const VarlenPagedParams& p, int num_tiles,
                   cudaStream_t stream) {
  const int smem = fa::fwd_smem_bytes<T, D>();
  cudaError_t err = cudaFuncSetAttribute(
      varlen_paged_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (err != cudaSuccess) return err;
  dim3 grid(num_tiles, p.h);
  varlen_paged_kernel<T, D><<<grid, NTHREADS, smem, stream>>>(p);
  return cudaGetLastError();
}

}  // namespace

// q (total_q, h, d) and out by element strides (token, head), the head dim
// contiguous; pages (num_pages, h_k, page_size, d) by strides (page, head,
// row); lse (h, total_q) fp32; tiles (num_tiles, 2) int32 from the wrapper.
// block_q/block_k must name the tile the kernel is compiled for
// (dispatch/config.py VARLEN_PAGED_TILE). Returns a cudaError_t (0 on
// success).
extern "C" int fa_varlen_paged(
    const void* q, const void* kp, const void* vp, const int* cu_q,
    const int* lens_q, const int* lens_k, const int* table, const int* tiles,
    void* out, float* lse, int num_tiles, int total_q, int h, int h_k, int d,
    int page_size, int table_width, int num_pages, int block_q, int block_k,
    int64_t q_st, int64_t q_sh, int64_t k_sp, int64_t k_sh, int64_t k_ss,
    int64_t v_sp, int64_t v_sh, int64_t v_ss, int64_t o_st, int64_t o_sh,
    int64_t t_sb, float scale_log2, int causal, int is_bf16, void* stream) {
  if (block_q != BM || block_k != BN) return (int)cudaErrorInvalidValue;
  if (num_tiles == 0) return 0;
  VarlenPagedParams p;
  p.q = q;
  p.kp = kp;
  p.vp = vp;
  p.cu_q = cu_q;
  p.lens_q = lens_q;
  p.lens_k = lens_k;
  p.table = table;
  p.tiles = tiles;
  p.out = out;
  p.lse = lse;
  p.q_st = q_st; p.q_sh = q_sh;
  p.k_sp = k_sp; p.k_sh = k_sh; p.k_ss = k_ss;
  p.v_sp = v_sp; p.v_sh = v_sh; p.v_ss = v_ss;
  p.o_st = o_st; p.o_sh = o_sh;
  p.t_sb = t_sb;
  p.total_q = total_q;
  p.h = h;
  p.group = h / h_k;
  p.page_size = page_size;
  p.table_width = table_width;
  p.num_pages = num_pages;
  p.scale_log2 = scale_log2;
  p.causal = causal;
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  if (is_bf16) {
    if (d == 64) return launch<__nv_bfloat16, 64>(p, num_tiles, st);
    if (d == 128) return launch<__nv_bfloat16, 128>(p, num_tiles, st);
  } else {
    if (d == 64) return launch<__half, 64>(p, num_tiles, st);
    if (d == 128) return launch<__half, 128>(p, num_tiles, st);
  }
  return (int)cudaErrorInvalidValue;
}
