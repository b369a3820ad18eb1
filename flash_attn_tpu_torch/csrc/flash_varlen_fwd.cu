// Packed varlen attention forward for Hopper (sm_90a) on wgmma and TMA,
// bf16 / fp16, head dims 64, 96, 128 and 256: B6's forward (one block per
// work item) and B7 (a persistent grid that walks the same items), on the
// forward tile that B1 runs at the same head dims (fwd_sm90.cuh: 96 as two
// zero-filled panels, 256 with one block an SM).
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

#include "fwd_sm90.cuh"

namespace {

using namespace fa;
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
  __device__ __forceinline__ void load_q(void* dst, uint64_t* bar, int col, int row) const {
    tma_load_3d(dst, q, bar, col, q0 + row, hq);
  }
  __device__ __forceinline__ void load_k(void* dst, uint64_t* bar, int col, int row) const {
    tma_load_3d(dst, k, bar, col, k0 + row, hk);
  }
  __device__ __forceinline__ void load_v(void* dst, uint64_t* bar, int col, int row) const {
    tma_load_3d(dst, v, bar, col, k0 + row, hk);
  }
};

// Item w = (head, tile) = (w / num_tiles, w % num_tiles) of the sorted
// work list: head by head, each head's longest bands first; dead tiles
// (sorted last) exit.
template <typename T, int D>
__global__ void __launch_bounds__(FWD_THREADS, fwd_min_blocks<D>())
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

// B7's view of item w = (head, tile) = (w / num_tiles, w % num_tiles); w < 0:
// none. Every thread of a block computes the same items.
struct Item {
  int w, hh, m0, q0, k0, sq, sk, total;
};

// The first item at or after w, stepping by the grid, whose tile is live and
// sees at least one key.
__device__ __forceinline__ Item next_item(const VarlenFwdParams& p, int w) {
  Item it;
  const int items = p.num_tiles * p.h;
  for (; w < items; w += gridDim.x) {
    const int hh = w / p.num_tiles;
    const int tile = w - hh * p.num_tiles;
    const int seq = p.tiles[2 * tile];
    if (seq < 0) continue;  // the dead tiles that end each head's list
    it.m0 = p.tiles[2 * tile + 1];
    it.sq = p.lens_q[seq];
    it.sk = p.lens_k[seq];
    it.total = KeyRange<FWD_N>(it.m0, FWD_M, it.sq, it.sk, p.causal).count();
    if (it.total == 0) continue;
    it.w = w;
    it.hh = hh;
    it.q0 = p.cu_q[seq];
    it.k0 = p.cu_k[seq];
    return it;
  }
  it.w = -1;
  return it;
}

// Q tiles a B7 block keeps: with two, the next item's Q loads under this
// item's last K/V tile; at head dim 128 a second 32 KB Q tile would leave
// one block an SM (tools/fwd_ab.py timed it 10-12% slower there, PERF.md),
// and at 256 it would not fit beside the two 64 KB K/V stages.
__host__ __device__ constexpr int persistent_q_buffers(int d) { return d == 64 ? 2 : 1; }

// B7: a persistent block walks its items with a stride of the grid.
template <typename T, int D>
__global__ void __launch_bounds__(FWD_THREADS, fwd_min_blocks<D>())
    varlen_fwd_persistent_kernel(const __grid_constant__ FwdMaps maps,
                                 const VarlenFwdParams p) {
  constexpr int QBUF = persistent_q_buffers(D);
  using L = FwdLayout<D, QBUF>;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = align_1024(smem_raw);
  uint64_t* q_bar = reinterpret_cast<uint64_t*>(smem + L::BAR_OFF);
  uint64_t* full = q_bar + QBUF;
  const int tid = threadIdx.x;
  auto q_tile = [&](int i) { return smem + L::Q_OFF + (i % QBUF) * L::QT::BYTES; };
  auto stage = [&](int g) {
    return smem + L::STAGE_OFF + (g % FWD_STAGES) * L::STAGE_BYTES;
  };
  auto source = [&](const Item& it) {
    return PackedSrc{&maps.q, &maps.k, &maps.v, it.q0, it.k0, it.hh, it.hh / p.group};
  };

  if (tid == 0) {
    for (int i = 0; i < QBUF; ++i) mbar_init(&q_bar[i], 1);
    for (int s = 0; s < FWD_STAGES; ++s) mbar_init(&full[s], 1);
    fence_barrier_init();
  }
  __syncthreads();
  Item cur = next_item(p, blockIdx.x);
  if (tid == 0 && cur.w >= 0) {
    fwd_issue_q<D>(source(cur), q_tile(0), &q_bar[0], cur.m0);
    fwd_issue_kv<D>(source(cur), stage(0), &full[0], 0);
  }
  // g counts the K/V tiles this block has taken, i its items: the ring's
  // stages and the barriers' phases follow them across items
  int g = 0;
  for (int i = 0; cur.w >= 0; ++i) {
    const Item nxt = next_item(p, cur.w + gridDim.x);
    const PackedSrc src = source(cur);
    FwdRows<T> t;
    t.out = reinterpret_cast<T*>(p.out) + (int64_t)cur.q0 * p.o_st + cur.hh * p.o_sh;
    t.lse = p.lse + (int64_t)cur.hh * p.total_q + cur.q0;
    t.o_ss = p.o_st;
    t.sq = cur.sq;
    t.sk = cur.sk;
    t.m0 = cur.m0;
    unsigned char* Qs = q_tile(i);
    FwdAcc<D> a;
    a.init();
    mbar_wait(&q_bar[i % QBUF], (i / QBUF) & 1);
    for (int n = 0; n < cur.total; ++n, ++g) {
      // the stage of tile g + 1 was freed at g - 1, in this item or the last
      if (tid == 0) {
        const int nf = (g + 1) % FWD_STAGES;
        if (n + 1 < cur.total) {
          fwd_issue_kv<D>(src, stage(g + 1), &full[nf], n + 1);
        } else if (nxt.w >= 0) {
          fwd_issue_kv<D>(source(nxt), stage(g + 1), &full[nf], 0);
          if constexpr (QBUF == 2)  // its Q tile was freed by item i - 1
            fwd_issue_q<D>(source(nxt), q_tile(i + 1), &q_bar[(i + 1) % QBUF], nxt.m0);
        }
      }
      mbar_wait(&full[g % FWD_STAGES], (g / FWD_STAGES) & 1);
      fwd_step<T, D, true>(a, Qs, stage(g), n * FWD_N, t, p.scale_log2, p.causal);
    }
    fwd_epilogue<T, D>(a, Qs, t);
    fence_proxy_async();  // the epilogue's stores to Qs before a TMA load there
    __syncthreads();      // every thread is done with this item and its Q tile
    if constexpr (QBUF == 1) {
      if (tid == 0 && nxt.w >= 0) fwd_issue_q<D>(source(nxt), Qs, &q_bar[0], nxt.m0);
    }
    cur = nxt;
  }
}

template <typename T, int D>
struct Launch {
  static cudaError_t run(const FwdMaps& maps, const VarlenFwdParams& p, cudaStream_t stream) {
    constexpr int smem = FwdLayout<D>::SMEM;
    cudaError_t err = cudaFuncSetAttribute(
        varlen_fwd_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
    varlen_fwd_kernel<T, D><<<p.num_tiles * p.h, FWD_THREADS, smem, stream>>>(maps, p);
    return cudaGetLastError();
  }
};

template <typename T, int D>
struct LaunchPersistent {
  static cudaError_t run(const FwdMaps& maps, const VarlenFwdParams& p, int num_sms,
                         int* grid_out, cudaStream_t stream) {
    constexpr int smem = FwdLayout<D, persistent_q_buffers(D)>::SMEM;
    auto kernel = varlen_fwd_persistent_kernel<T, D>;
    cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
    int per_sm = 0;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, FWD_THREADS, smem);
    if (err != cudaSuccess) return err;
    const int64_t items = (int64_t)p.num_tiles * p.h;
    const int64_t resident = (int64_t)num_sms * (per_sm > 0 ? per_sm : 1);
    const int grid = (int)(items < resident ? items : resident);
    if (grid_out) *grid_out = grid;
    kernel<<<grid, FWD_THREADS, smem, stream>>>(maps, p);
    return cudaGetLastError();
  }
};

using VarlenDims = Dims<64, 96, 128, 256>;

// The maps and parameters of one call (see fa_varlen_fwd).
cudaError_t setup(FwdMaps* maps, VarlenFwdParams* p, const void* q, const void* k,
                  const void* v, void* out, float* lse, const int* cu_q, const int* cu_k,
                  const int* lens_q, const int* lens_k, const int* tiles, int num_tiles,
                  int total_q, int total_k, int h, int h_k, int d, int64_t q_st,
                  int64_t q_sh, int64_t k_st, int64_t k_sh, int64_t v_st, int64_t v_sh,
                  int64_t o_st, int64_t o_sh, float scale, int causal, int is_bf16) {
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
  return cudaSuccess;
}

// Whether the kernels take a call's tile and shapes.
bool takes(int block_q, int block_k, int h, int h_k, int d, int num_tiles) {
  return block_q == FWD_M && block_k == FWD_N && h_k >= 1 && h % h_k == 0 &&
         (d == 64 || d == 96 || d == 128 || d == 256) && (int64_t)num_tiles * h <= 0x7fffffff;
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
  if (!takes(block_q, block_k, h, h_k, d, num_tiles)) return (int)cudaErrorInvalidValue;
  if (num_tiles == 0 || total_q == 0 || total_k == 0) return 0;  // no row sees a key
  FwdMaps maps;
  VarlenFwdParams p;
  cudaError_t err = setup(&maps, &p, q, k, v, out, lse, cu_q, cu_k, lens_q, lens_k, tiles,
                          num_tiles, total_q, total_k, h, h_k, d, q_st, q_sh, k_st, k_sh,
                          v_st, v_sh, o_st, o_sh, scale, causal, is_bf16);
  if (err != cudaSuccess) return (int)err;
  return (int)dispatch_dims<Launch>(VarlenDims{}, is_bf16, d, maps, p,
                                    reinterpret_cast<cudaStream_t>(stream));
}

// B7 over the same work list and arguments as fa_varlen_fwd, with a grid of
// num_sms x the blocks that fit on one SM (at most one block per item),
// written to *grid_out (host memory). Returns a cudaError_t (0 on success).
extern "C" int fa_varlen_fwd_persistent(
    const void* q, const void* k, const void* v, void* out, float* lse,
    const int* cu_q, const int* cu_k, const int* lens_q, const int* lens_k,
    const int* tiles, int num_tiles, int total_q, int total_k, int h, int h_k,
    int d, int block_q, int block_k, int64_t q_st, int64_t q_sh, int64_t k_st,
    int64_t k_sh, int64_t v_st, int64_t v_sh, int64_t o_st, int64_t o_sh,
    float scale, int causal, int is_bf16, int num_sms, int* grid_out, void* stream) {
  if (grid_out) *grid_out = 0;
  if (!takes(block_q, block_k, h, h_k, d, num_tiles) || num_sms < 1)
    return (int)cudaErrorInvalidValue;
  if (num_tiles == 0 || total_q == 0 || total_k == 0) return 0;  // no row sees a key
  FwdMaps maps;
  VarlenFwdParams p;
  cudaError_t err = setup(&maps, &p, q, k, v, out, lse, cu_q, cu_k, lens_q, lens_k, tiles,
                          num_tiles, total_q, total_k, h, h_k, d, q_st, q_sh, k_st, k_sh,
                          v_st, v_sh, o_st, o_sh, scale, causal, is_bf16);
  if (err != cudaSuccess) return (int)err;
  return (int)dispatch_dims<LaunchPersistent>(VarlenDims{}, is_bf16, d, maps, p, num_sms,
                                              grid_out, reinterpret_cast<cudaStream_t>(stream));
}
