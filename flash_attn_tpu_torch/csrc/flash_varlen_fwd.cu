// Packed varlen attention forward (B6) for Hopper (sm_90a) on wgmma and TMA,
// bf16 / fp16, head dim 64 or 128.
//
// Replaces the TPU kernel flash_attn_tpu/kernels/flash_varlen.py:
// _varlen_fwd_stream_kernel. The TPU kernel tiles the flat token axis with
// aligned blocks, because a DMA must be aligned, and rebuilds the sequences
// from per-token segment ids. Here every tile belongs to one sequence: the
// wrapper builds a work list of 128-row tiles (sequence, first local row)
// with torch ops on the device (dispatch/varlen_meta.py, block_q = 128),
// ordered by the length of each tile's KV band, longest first, and the
// kernel runs one block per (tile, head), head by head, each head's tiles
// in that order: the blocks in flight then read one head's K and V, which
// stay in L2 (head-major ran bench.py's mixed lengths 1.33x faster than the
// heads of a tile side by side, PERF.md). A block finds its sequence's
// origin in cu_seqlens and its lengths (seqused where given) and runs the
// forward tile of fwd_sm90.cuh.
//
// What bounds it on this card: per head, a sequence of sq rows over sk keys
// does 4 * sq * sk * d flops (about half under the causal mask) and moves
// q, k, v and out once; bench.py's mixed lengths (16 sequences of 2048-4096
// at d = 128, causal) are tensor-core bound (~0.66 ms), BERT-large's packing
// (d = 64, 256-512 tokens) is memory bound. The tile's design (both products
// on wgmma, TMA loads in a two-stage ring) is what goes at the first.
//
// What TMA changes for packed rows: the tensor maps are 3D over the packed
// (total, h, d) tensors, so a box that runs past a sequence's rows loads the
// next sequence's (TMA zero-fills only past the tensor's end). The tile
// masks the scores of keys at or past the sequence's length to -inf, so that
// their P is 0 exactly, and zeroes those V rows of the ragged tile in shared
// memory; query rows past the length are computed on the neighbour's rows
// and never stored. Rows in no tile (past seqused, the packed tail past
// cu_seqlens[-1]) keep the wrapper's zeros (out) and -inf (lse). Each output
// element is written once: two runs give the same bits.

#include "fwd_sm90.cuh"

namespace {

using namespace fa::sm90;

struct VarlenFwdParams {
  void* out;           // (total_q, h, d), zeroed by the wrapper
  float* lse;          // (h, total_q), -inf-filled by the wrapper
  const int* cu_q;     // (b + 1,) token offsets of the packed layouts
  const int* cu_k;
  const int* lens_q;   // (b,) query rows of each sequence (seqused_q)
  const int* lens_k;   // (b,) keys of each sequence (seqused_k)
  const int* tiles;    // (num_tiles, 2): sequence (-1: no tile), first row
  int64_t o_st, o_sh;
  int num_tiles, total_q, h, group;
  float scale_log2;
  int causal;
};

// Rows of one sequence of the packed tensors: Q from token q0 at head hq,
// K/V from token k0 at KV head hk.
struct PackedSrc {
  const CUtensorMap* q;
  const CUtensorMap* k;
  const CUtensorMap* v;
  int q0, k0, hq, hk;
  __device__ __forceinline__ static void load(void* dst, const CUtensorMap* map, uint64_t* bar,
                                              int col, int row, int head) {
    asm volatile(
        "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::"
        "bytes [%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(fa::smem_addr(dst)),
        "l"(reinterpret_cast<uint64_t>(map)), "r"(fa::smem_addr(bar)), "r"(col), "r"(row),
        "r"(head)
        : "memory");
  }
  __device__ __forceinline__ void load_q(void* dst, uint64_t* bar, int col, int row) const {
    load(dst, q, bar, col, q0 + row, hq);
  }
  __device__ __forceinline__ void load_k(void* dst, uint64_t* bar, int col, int row) const {
    load(dst, k, bar, col, k0 + row, hk);
  }
  __device__ __forceinline__ void load_v(void* dst, uint64_t* bar, int col, int row) const {
    load(dst, v, bar, col, k0 + row, hk);
  }
};

// Item w = (head, tile) = (w / num_tiles, w % num_tiles) of the sorted
// work list: head by head, each head's longest bands first; dead tiles
// (sorted last) exit.
template <typename T, int D>
__global__ void __launch_bounds__(FWD_THREADS, 2)
    varlen_fwd_kernel(const __grid_constant__ FwdMaps maps, const VarlenFwdParams p) {
  extern __shared__ unsigned char smem_raw[];
  const int hh = blockIdx.x / p.num_tiles;
  const int tile = blockIdx.x - hh * p.num_tiles;
  const int seq = p.tiles[2 * tile];
  if (seq < 0) return;
  unsigned char* smem = align_1024(smem_raw);
  const int q0 = p.cu_q[seq];
  const PackedSrc src{&maps.q, &maps.k, &maps.v, q0, p.cu_k[seq], hh, hh / p.group};
  FwdRows<T> t;
  t.out = reinterpret_cast<T*>(p.out) + (int64_t)q0 * p.o_st + hh * p.o_sh;
  t.lse = p.lse + (int64_t)hh * p.total_q + q0;
  t.o_ss = p.o_st;
  t.sq = p.lens_q[seq];
  t.sk = p.lens_k[seq];
  t.m0 = p.tiles[2 * tile + 1];
  fwd_tile<T, D, true>(src, t, p.scale_log2, p.causal, smem);
}

template <typename T, int D>
cudaError_t launch(const FwdMaps& maps, const VarlenFwdParams& p, int num_tiles,
                   cudaStream_t stream) {
  constexpr int smem = FwdLayout<D>::SMEM;
  cudaError_t err = cudaFuncSetAttribute(
      varlen_fwd_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  varlen_fwd_kernel<T, D><<<num_tiles * p.h, FWD_THREADS, smem, stream>>>(maps, p);
  return cudaGetLastError();
}

}  // namespace

// q (total_q, h, d) and out by element strides (token, head), k/v (total_k,
// h_k, d) likewise, the head dim contiguous, 16-byte aligned starts and
// strides (TMA); lse (h, total_q) fp32; cu_q, cu_k (b + 1,), lens_q, lens_k
// (b,) and tiles (num_tiles, 2) int32 from the wrapper, tiles of block_q
// rows; out zeroed and lse -inf-filled by the wrapper. block_q/block_k must
// name the tile the kernel is compiled for (dispatch/config.py FWD_TILE).
// Returns a cudaError_t (0 on success).
extern "C" int fa_varlen_fwd(
    const void* q, const void* k, const void* v, void* out, float* lse,
    const int* cu_q, const int* cu_k, const int* lens_q, const int* lens_k,
    const int* tiles, int num_tiles, int total_q, int total_k, int h, int h_k,
    int d, int block_q, int block_k, int64_t q_st, int64_t q_sh, int64_t k_st,
    int64_t k_sh, int64_t v_st, int64_t v_sh, int64_t o_st, int64_t o_sh,
    float scale, int causal, int is_bf16, void* stream) {
  if (block_q != FWD_M || block_k != FWD_N || h_k < 1 || h % h_k != 0 ||
      (d != 64 && d != 128) || (int64_t)num_tiles * h > 0x7fffffff)
    return (int)cudaErrorInvalidValue;
  if (num_tiles == 0 || total_q == 0 || total_k == 0) return 0;  // no row sees a key
  FwdMaps maps;
  cudaError_t err;
  if ((err = make_tile_map<3>(&maps.q, q, is_bf16, {d, total_q, h}, {q_st, q_sh}, FWD_M)) ||
      (err = make_tile_map<3>(&maps.k, k, is_bf16, {d, total_k, h_k}, {k_st, k_sh}, FWD_N)) ||
      (err = make_tile_map<3>(&maps.v, v, is_bf16, {d, total_k, h_k}, {v_st, v_sh}, FWD_N)))
    return (int)err;
  VarlenFwdParams p;
  p.out = out;
  p.lse = lse;
  p.cu_q = cu_q;
  p.cu_k = cu_k;
  p.lens_q = lens_q;
  p.lens_k = lens_k;
  p.tiles = tiles;
  p.o_st = o_st;
  p.o_sh = o_sh;
  p.total_q = total_q;
  p.num_tiles = num_tiles;
  p.h = h;
  p.group = h / h_k;
  p.scale_log2 = scale * FA_LOG2E;
  p.causal = causal;
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  if (is_bf16) {
    if (d == 64) return (int)launch<__nv_bfloat16, 64>(maps, p, num_tiles, st);
    return (int)launch<__nv_bfloat16, 128>(maps, p, num_tiles, st);
  }
  if (d == 64) return (int)launch<__half, 64>(maps, p, num_tiles, st);
  return (int)launch<__half, 128>(maps, p, num_tiles, st);
}
