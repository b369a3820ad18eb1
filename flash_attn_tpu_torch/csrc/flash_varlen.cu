// Packed varlen attention backward for Hopper (sm_90a) on wgmma and TMA,
// bf16 / fp16, head dim 64 or 128: B6's preprocess, dK/dV and dQ kernels.
// The forward (B6's and the persistent B7) runs the wgmma/TMA tile of
// fwd_sm90.cuh in flash_varlen_fwd.cu.
//
// Replaces the TPU kernels flash_attn_tpu/kernels/flash_varlen.py:
// _varlen_dkdv_stream_kernel and _varlen_dq_stream_kernel, and the XLA op
// that computed delta before them (flash_varlen.py:854-855):
//
//  - varlen_preprocess_kernel: delta = rowsum(dO * O) in fp32 and lse in
//    base 2, a warp a row, into (h, rows_pad) buffers padded per sequence
//    to whole 128-row tiles (delta 0 and lse2 +inf past the sequence's
//    rows); its other blocks zero the gradient rows that no tile writes
//    (rows past seqused, the packed tail past cu_seqlens[-1]);
//  - varlen_dkdv_kernel: one block per (128-key tile of a sequence, KV
//    head) walks the group's query heads and the 64-row q tiles of the
//    sequence's causal band in a fixed order and writes dK and dV once;
//  - varlen_dq_kernel: one block per (128-row q tile of a sequence, head)
//    walks the 64-key tiles of its band and writes dQ once.
//
// No atomics: each gradient element is written once, so two runs give the
// same bits.
//
// What bounds it on this card: per head, a sequence of sq rows over sk keys
// runs 8 (dK/dV: S, dP, dV, dK) + 6 (dQ: S, dP, dQ) flops per (row, key)
// pair and head-dim element, about half of them under the causal mask, and
// moves q, k, v, dout, lse, delta and the three gradients once. bench.py's
// mixed lengths (16 sequences of 2048-4096 at d = 128, causal) are tensor-
// core bound (2.3 ms at 989 TFLOP/s); BERT-large's packing (d = 64, 256-512
// rows, not causal) is near the line between the two (~0.05 ms of bytes).
//
// What the design does about it: the kernels run B3's tiles
// (csrc/bwd_sm90.cuh: every product a warpgroup wgmma, the resident K/V or
// Q/dO tiles and a two-stage TMA ring of the streamed ones) with the
// packed source below. The TPU kernels tile the flat token axis with
// aligned blocks, because a DMA must be aligned, and rebuild the sequences
// from per-token segment ids. Here every tile belongs to one sequence: the
// wrapper's work lists (dispatch/varlen_meta.py: k_schedule of 128-key
// tiles ordered by the q rows that see them, the schedule of 128-row q
// tiles ordered by their key band, heaviest first, as B3 launches its
// grid) give (sequence, first local row), and a block finds its sequence's
// origin in cu_seqlens and its lengths (seqused where given).
//
// What TMA changes for packed rows: the maps are 3D over the packed (total,
// h, d) tensors, so a box that runs past a sequence's rows loads the next
// sequence's (TMA zero-fills only past the tensor's end). The tiles zero
// those rows in shared memory where they would reach a sum (ZERO_TAIL: the
// q rows past sq of a streamed dK/dV tile, the keys past sk of a streamed
// dQ tile), lse2 is +inf and delta 0 on the padded rows, and no row outside
// the sequence is stored: the sums are those of B3 over the same rows, so
// b equal-length sequences packed give B3's bits. A sequence's lse2 and
// delta rows start at padded_row(cu_q[s], s), a multiple of 4 floats (the
// bulk copies' 16-byte alignment) that leaves each sequence room for whole
// 128-row tiles before the next.

#include "bwd_sm90.cuh"

namespace {

using namespace fa::sm90;

constexpr int PRE_WARPS = 8;        // preprocess: rows (warps) a block
constexpr int PRE_ROWS = 128;       // preprocess: rows of a q tile
constexpr int ZERO_ROWS = 128;      // zero-fill: packed rows a block
constexpr int SEQ_GAP = 132;        // padded rows a sequence adds (see padded_row)

// The first row of sequence `seq` in the padded (h, rows_pad) lse2 / delta
// buffers: cu rounded up to 4 rows, plus SEQ_GAP a sequence before it. The
// next sequence starts at least its length + 129 rows later, so whole
// 128-row tiles of each fit; the buffers hold total_q + SEQ_GAP * b rows.
__device__ __forceinline__ int64_t padded_row(int cu, int seq) {
  return (int64_t)((cu + 3) & ~3) + (int64_t)SEQ_GAP * seq;
}

struct VarlenParams {
  const float* lse2;   // (h, rows_pad)
  const float* delta;  // (h, rows_pad)
  void* dq;            // (total_q, h, d) by strides
  void* dk;            // (total_k, h_k, d)
  void* dv;
  const int* cu_q;     // (b + 1,) token offsets of the packed layouts
  const int* cu_k;
  const int* lens_q;   // (b,) query rows of each sequence (seqused_q)
  const int* lens_k;   // (b,) keys of each sequence (seqused_k)
  const int* tiles;    // (num_tiles, 2): sequence (-1: no tile), first row
  int64_t dq_st, dq_sh, dk_st, dk_sh, dv_st, dv_sh, rows_pad;
  int num_tiles, h, h_k;
  BwdArgs a;
};

// Sequence `seq` of the packed operands: 3D maps, the padded lse2 / delta
// rows, the gradients by element strides.
template <typename T>
struct PackedSrc {
  static constexpr bool ZERO_TAIL = true;  // a box past the sequence holds its neighbour's rows
  const BwdMaps* maps;
  const VarlenParams* p;
  int q0, k0, sq, sk;
  int64_t pad;  // the sequence's first padded lse2 / delta row
  __device__ __forceinline__ PackedSrc(const BwdMaps& m, const VarlenParams& prm, int seq)
      : maps(&m),
        p(&prm),
        q0(prm.cu_q[seq]),
        k0(prm.cu_k[seq]),
        sq(prm.lens_q[seq]),
        sk(prm.lens_k[seq]),
        pad(padded_row(prm.cu_q[seq], seq)) {}
  __device__ __forceinline__ void load_q(void* dst, uint64_t* bar, int col, int row,
                                         int hq) const {
    tma_load_3d(dst, &maps->q, bar, col, q0 + row, hq);
  }
  __device__ __forceinline__ void load_do(void* dst, uint64_t* bar, int col, int row,
                                          int hq) const {
    tma_load_3d(dst, &maps->dout, bar, col, q0 + row, hq);
  }
  __device__ __forceinline__ void load_k(void* dst, uint64_t* bar, int col, int row,
                                         int hk) const {
    tma_load_3d(dst, &maps->k, bar, col, k0 + row, hk);
  }
  __device__ __forceinline__ void load_v(void* dst, uint64_t* bar, int col, int row,
                                         int hk) const {
    tma_load_3d(dst, &maps->v, bar, col, k0 + row, hk);
  }
  __device__ __forceinline__ const float* lse2(int hq, int row) const {
    return p->lse2 + hq * p->rows_pad + pad + row;
  }
  __device__ __forceinline__ const float* delta(int hq, int row) const {
    return p->delta + hq * p->rows_pad + pad + row;
  }
  __device__ __forceinline__ T* dk(int row, int hk) const {
    return reinterpret_cast<T*>(p->dk) + (int64_t)(k0 + row) * p->dk_st + hk * p->dk_sh;
  }
  __device__ __forceinline__ T* dv(int row, int hk) const {
    return reinterpret_cast<T*>(p->dv) + (int64_t)(k0 + row) * p->dv_st + hk * p->dv_sh;
  }
  __device__ __forceinline__ T* dq(int row, int hq) const {
    return reinterpret_cast<T*>(p->dq) + (int64_t)(q0 + row) * p->dq_st + hq * p->dq_sh;
  }
};

// ---- preprocess -------------------------------------------------------------

struct PreParams {
  const void* dout;    // (total_q, h, d) by strides
  const void* out;
  const float* lse;    // (h, total_q) natural-log
  float* lse2;         // (h, rows_pad)
  float* delta;
  void* dq;            // (total_q, h, d), (total_k, h_k, d): contiguous rows
  void* dk;
  void* dv;
  const int* cu_q;
  const int* cu_k;
  const int* lens_q;
  const int* lens_k;
  const int* tiles;    // the 128-row q tiles
  int64_t do_st, do_sh, o_st, o_sh, rows_pad;
  int num_tiles, b, total_q, total_k, h, h_k;
};

// Whether packed row t of one side (offsets cu (b + 1), lengths lens (b))
// lies in no sequence: before cu[0], past cu[b], or past its sequence's
// length (seqused) inside its slot.
__device__ __forceinline__ bool dead_row(const int* cu, const int* lens, int b, int t) {
  if (t < cu[0] || t >= cu[b]) return true;
  int lo = 0, hi = b;  // the last sequence s < b with cu[s] <= t
  while (hi - lo > 1) {
    const int mid = (lo + hi) >> 1;
    if (cu[mid] <= t) lo = mid;
    else hi = mid;
  }
  return t - cu[lo] >= lens[lo];
}

// Zeroes `elems` 2-byte elements (a multiple of 8) from `row` with the lanes
// of a warp.
__device__ __forceinline__ void zero_row(void* row, int elems, int lane) {
  uint4* r = reinterpret_cast<uint4*>(row);
  for (int c = lane; c < elems / 8; c += 32) r[c] = make_uint4(0, 0, 0, 0);
}

// Blocks [0, num_tiles * h): q tile blockIdx.x / h of head blockIdx.x % h,
// a warp a row (PRE_ROWS / PRE_WARPS rows each); the rest: ZERO_ROWS packed
// rows each of dq, dk and dv. (A block of PRE_WARPS rows, a warp a row,
// took 1.3-1.5x as long at BERT-large's packing and bench.py's mixed
// lengths: PERF.md PR 11.)
template <typename T, int D>
__global__ void __launch_bounds__(PRE_WARPS * 32)
    varlen_preprocess_kernel(const PreParams p) {
  constexpr int PER = D / 32;  // elements a lane
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int work = p.num_tiles * p.h;
  if ((int)blockIdx.x >= work) {
    const int r0 = (blockIdx.x - work) * ZERO_ROWS;
    for (int t = r0 + warp; t < r0 + ZERO_ROWS; t += PRE_WARPS) {
      if (t < p.total_q && dead_row(p.cu_q, p.lens_q, p.b, t))
        zero_row(reinterpret_cast<T*>(p.dq) + (int64_t)t * p.h * D, p.h * D, lane);
      if (t < p.total_k && dead_row(p.cu_k, p.lens_k, p.b, t)) {
        zero_row(reinterpret_cast<T*>(p.dk) + (int64_t)t * p.h_k * D, p.h_k * D, lane);
        zero_row(reinterpret_cast<T*>(p.dv) + (int64_t)t * p.h_k * D, p.h_k * D, lane);
      }
    }
    return;
  }
  const int tile = blockIdx.x / p.h;
  const int hh = blockIdx.x - tile * p.h;
  const int seq = p.tiles[2 * tile];
  if (seq < 0) return;
  const int m0 = p.tiles[2 * tile + 1];
  const int q0 = p.cu_q[seq];
  const int sq = p.lens_q[seq];
  const int64_t base = hh * p.rows_pad + padded_row(q0, seq) + m0;
  for (int r = warp; r < PRE_ROWS; r += PRE_WARPS) {
    const int row = m0 + r;
    if (row >= sq) {
      if (lane == 0) {
        p.delta[base + r] = 0.f;
        p.lse2[base + r] = INFINITY;
      }
      continue;
    }
    const int64_t tok = q0 + row;
    const float acc = bwd_preprocess_row<T, D>(
        reinterpret_cast<const T*>(p.dout) + tok * p.do_st + hh * p.do_sh + lane * PER,
        reinterpret_cast<const T*>(p.out) + tok * p.o_st + hh * p.o_sh + lane * PER);
    if (lane == 0) {
      p.delta[base + r] = acc;
      p.lse2[base + r] = bwd_lse2(p.lse[hh * (int64_t)p.total_q + tok]);
    }
  }
}

// ---- dK / dV and dQ ---------------------------------------------------------

// Item x = (tile, KV head) = (x / h_k, x % h_k) of the key-side schedule,
// the heaviest tiles first; dead tiles (sorted last) exit.
template <typename T, int D>
__global__ void __launch_bounds__(BWD_THREADS, 1)
    varlen_dkdv_kernel(const __grid_constant__ BwdMaps maps, const VarlenParams p) {
  extern __shared__ unsigned char smem_raw[];
  const int tile = blockIdx.x / p.h_k;
  const int seq = p.tiles[2 * tile];
  if (seq < 0) return;
  bwd_dkdv<T, D, false>(PackedSrc<T>(maps, p, seq), p.a, blockIdx.x - tile * p.h_k,
                        p.tiles[2 * tile + 1], align_1024(smem_raw));
}

// Item x = (tile, head) = (x / h, x % h) of the query-side schedule.
template <typename T, int D>
__global__ void __launch_bounds__(BWD_THREADS, 1)
    varlen_dq_kernel(const __grid_constant__ BwdMaps maps, const VarlenParams p) {
  extern __shared__ unsigned char smem_raw[];
  const int tile = blockIdx.x / p.h;
  const int seq = p.tiles[2 * tile];
  if (seq < 0) return;
  bwd_dq<T, D>(PackedSrc<T>(maps, p, seq), p.a, blockIdx.x - tile * p.h,
               p.tiles[2 * tile + 1], align_1024(smem_raw));
}

// ---- host side --------------------------------------------------------------

template <typename Kernel>
cudaError_t launch(Kernel kernel, int64_t blocks, int threads, int smem, cudaStream_t stream,
                   const BwdMaps& maps, const VarlenParams& p) {
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         smem);
  if (err != cudaSuccess) return err;
  kernel<<<(unsigned)blocks, threads, smem, stream>>>(maps, p);
  return cudaGetLastError();
}

template <typename T, int D>
struct Dkdv {
  static cudaError_t run(const BwdMaps& maps, const VarlenParams& p, cudaStream_t st) {
    return launch(varlen_dkdv_kernel<T, D>, (int64_t)p.num_tiles * p.h_k, BWD_THREADS,
                  DkdvLayout<D, false>::SMEM, st, maps, p);
  }
};

template <typename T, int D>
struct Dq {
  static cudaError_t run(const BwdMaps& maps, const VarlenParams& p, cudaStream_t st) {
    return launch(varlen_dq_kernel<T, D>, (int64_t)p.num_tiles * p.h, BWD_THREADS,
                  DqLayout<D>::SMEM, st, maps, p);
  }
};

template <typename T, int D>
struct Pre {
  static cudaError_t run(const PreParams& p, cudaStream_t st) {
    const int64_t zero_blocks =
        ((p.total_q > p.total_k ? p.total_q : p.total_k) + ZERO_ROWS - 1) / ZERO_ROWS;
    varlen_preprocess_kernel<T, D>
        <<<(unsigned)((int64_t)p.num_tiles * p.h + zero_blocks), PRE_WARPS * 32, 0, st>>>(p);
    return cudaGetLastError();
  }
};

// Run F<T, D>::run(args...) for the element type and head dim of a call.
template <template <typename, int> class F, typename... Args>
int dispatch(int is_bf16, int d, Args&&... args) {
  if (is_bf16) {
    if (d == 64) return (int)F<__nv_bfloat16, 64>::run(args...);
    if (d == 128) return (int)F<__nv_bfloat16, 128>::run(args...);
  } else {
    if (d == 64) return (int)F<__half, 64>::run(args...);
    if (d == 128) return (int)F<__half, 128>::run(args...);
  }
  return (int)cudaErrorInvalidValue;
}

// Whether the kernels take a call's shapes: rows_pad whole 4-row groups
// that hold the padded rows of b sequences.
bool takes(int b, int total_q, int total_k, int h, int h_k, int d, int num_tiles,
           int64_t rows_pad) {
  return b > 0 && total_q > 0 && total_k > 0 && h_k > 0 && h % h_k == 0 &&
         (d == 64 || d == 128) && rows_pad % 4 == 0 &&
         rows_pad >= (int64_t)total_q + (int64_t)SEQ_GAP * b &&
         (int64_t)num_tiles * h <= 0x7fffffff;
}

// The maps (q/dout boxes of q_rows rows, k/v boxes of kv_rows) and the
// parameters of one kernel's launch; see fa_varlen_bwd_dkdv.
cudaError_t setup(BwdMaps* maps, VarlenParams* p, const void* q, const void* k,
                  const void* v, const void* dout, const float* lse2, const float* delta,
                  const int* cu_q, const int* cu_k, const int* lens_q, const int* lens_k,
                  const int* tiles, int num_tiles, int b, int total_q, int total_k, int h,
                  int h_k, int d, int64_t rows_pad, int64_t q_st, int64_t q_sh,
                  int64_t k_st, int64_t k_sh, int64_t v_st, int64_t v_sh, int64_t do_st,
                  int64_t do_sh, float scale, int causal, int is_bf16, int q_rows,
                  int kv_rows) {
  if (!takes(b, total_q, total_k, h, h_k, d, num_tiles, rows_pad) ||
      (int64_t)num_tiles * h_k > 0x7fffffff)
    return cudaErrorInvalidValue;
  cudaError_t err;
  if ((err = make_tile_map<3>(&maps->q, q, is_bf16, {d, total_q, h}, {q_st, q_sh}, q_rows)) ||
      (err = make_tile_map<3>(&maps->dout, dout, is_bf16, {d, total_q, h}, {do_st, do_sh},
                              q_rows)) ||
      (err = make_tile_map<3>(&maps->k, k, is_bf16, {d, total_k, h_k}, {k_st, k_sh},
                              kv_rows)) ||
      (err = make_tile_map<3>(&maps->v, v, is_bf16, {d, total_k, h_k}, {v_st, v_sh},
                              kv_rows)))
    return err;
  *p = {};
  p->lse2 = lse2;
  p->delta = delta;
  p->cu_q = cu_q;
  p->cu_k = cu_k;
  p->lens_q = lens_q;
  p->lens_k = lens_k;
  p->tiles = tiles;
  p->rows_pad = rows_pad;
  p->num_tiles = num_tiles;
  p->h = h;
  p->h_k = h_k;
  p->a = {scale, scale * FA_LOG2E, causal, h / h_k};
  return cudaSuccess;
}

}  // namespace

// delta = rowsum(dout * out) and lse2 = lse * log2(e) (+inf where lse is
// -inf) into (h, rows_pad) fp32 buffers, each sequence's rows from
// padded_row in whole 128-row tiles of the q-side work list `tiles` (delta
// 0, lse2 +inf past the sequence); zeroes the rows of dq (total_q, h, d)
// and dk, dv (total_k, h_k, d), all contiguous, that lie in no sequence.
// dout/out (total_q, h, d) by element strides, the head dim contiguous; lse
// (h, total_q) contiguous fp32; cu_q, cu_k (b + 1,), lens_q, lens_k (b,)
// and tiles (num_tiles, 2) int32; rows_pad >= total_q + 132 b, a multiple
// of 4. Returns a cudaError_t (0 on success).
extern "C" int fa_varlen_bwd_preprocess(
    const void* dout, const void* out, const float* lse, float* lse2, float* delta,
    void* dq, void* dk, void* dv, const int* cu_q, const int* cu_k, const int* lens_q,
    const int* lens_k, const int* tiles, int num_tiles, int b, int total_q, int total_k,
    int h, int h_k, int d, int64_t rows_pad, int64_t do_st, int64_t do_sh, int64_t o_st,
    int64_t o_sh, int is_bf16, void* stream) {
  if (!takes(b, total_q, total_k, h, h_k, d, num_tiles, rows_pad))
    return (int)cudaErrorInvalidValue;
  const PreParams p = {dout,   out,    lse,     lse2,    delta,   dq,      dk,
                       dv,     cu_q,   cu_k,    lens_q,  lens_k,  tiles,   do_st,
                       do_sh,  o_st,   o_sh,    rows_pad, num_tiles, b,    total_q,
                       total_k, h,     h_k};
  return dispatch<Pre>(is_bf16, d, p, reinterpret_cast<cudaStream_t>(stream));
}

// dK, dV (total_k, h_k, d) in k's type over the key-side work list `tiles`
// (num_tiles, 2) of block_k-key tiles; rows in no tile are zeroed by
// fa_varlen_bwd_preprocess. q/dout (total_q, h, d) and k/v (total_k, h_k,
// d) by element strides (token, head), the head dim contiguous, 16-byte
// aligned starts and strides (TMA); lse2 and delta (h, rows_pad) from
// fa_varlen_bwd_preprocess; cu_q, cu_k (b + 1,) and lens_q, lens_k (b,)
// int32. block_q/block_k must name the tiles the kernels are compiled for
// (dispatch/config.py VARLEN_BWD_TILE). Returns a cudaError_t (0 on
// success).
extern "C" int fa_varlen_bwd_dkdv(
    const void* q, const void* k, const void* v, const void* dout, const float* lse2,
    const float* delta, void* dk, void* dv, const int* cu_q, const int* cu_k,
    const int* lens_q, const int* lens_k, const int* tiles, int num_tiles, int b,
    int total_q, int total_k, int h, int h_k, int d, int block_q, int block_k,
    int64_t rows_pad, int64_t q_st, int64_t q_sh, int64_t k_st, int64_t k_sh, int64_t v_st,
    int64_t v_sh, int64_t do_st, int64_t do_sh, int64_t dk_st, int64_t dk_sh, int64_t dv_st,
    int64_t dv_sh, float scale, int causal, int is_bf16, void* stream) {
  if (block_q != BWD_Q_ROWS || block_k != BWD_KV_ROWS) return (int)cudaErrorInvalidValue;
  BwdMaps maps;
  VarlenParams p;
  cudaError_t err = setup(&maps, &p, q, k, v, dout, lse2, delta, cu_q, cu_k, lens_q, lens_k,
                          tiles, num_tiles, b, total_q, total_k, h, h_k, d, rows_pad, q_st,
                          q_sh, k_st, k_sh, v_st, v_sh, do_st, do_sh, scale, causal, is_bf16,
                          BWD_KV_BM, BWD_KV_ROWS);
  if (err != cudaSuccess) return (int)err;
  p.dk = dk;
  p.dv = dv;
  p.dk_st = dk_st; p.dk_sh = dk_sh;
  p.dv_st = dv_st; p.dv_sh = dv_sh;
  return dispatch<Dkdv>(is_bf16, d, maps, p, reinterpret_cast<cudaStream_t>(stream));
}

// dQ (total_q, h, d) in q's type over the query-side work list `tiles` of
// block_q-row tiles, written once. Layouts as fa_varlen_bwd_dkdv.
extern "C" int fa_varlen_bwd_dq(
    const void* q, const void* k, const void* v, const void* dout, const float* lse2,
    const float* delta, void* dq, const int* cu_q, const int* cu_k, const int* lens_q,
    const int* lens_k, const int* tiles, int num_tiles, int b, int total_q, int total_k,
    int h, int h_k, int d, int block_q, int block_k, int64_t rows_pad, int64_t q_st,
    int64_t q_sh, int64_t k_st, int64_t k_sh, int64_t v_st, int64_t v_sh, int64_t do_st,
    int64_t do_sh, int64_t dq_st, int64_t dq_sh, float scale, int causal, int is_bf16,
    void* stream) {
  if (block_q != BWD_Q_ROWS || block_k != BWD_KV_ROWS) return (int)cudaErrorInvalidValue;
  BwdMaps maps;
  VarlenParams p;
  cudaError_t err = setup(&maps, &p, q, k, v, dout, lse2, delta, cu_q, cu_k, lens_q, lens_k,
                          tiles, num_tiles, b, total_q, total_k, h, h_k, d, rows_pad, q_st,
                          q_sh, k_st, k_sh, v_st, v_sh, do_st, do_sh, scale, causal, is_bf16,
                          BWD_Q_ROWS, BWD_Q_BN);
  if (err != cudaSuccess) return (int)err;
  p.dq = dq;
  p.dq_st = dq_st; p.dq_sh = dq_sh;
  return dispatch<Dq>(is_bf16, d, maps, p, reinterpret_cast<cudaStream_t>(stream));
}
