// Block-sparse attention for Hopper (sm_90a) on wgmma and TMA, bf16 / fp16,
// head dim 64 or 128.
//
// Replaces the TPU kernels flash_attn_tpu/kernels/flash_blocksparse.py:
// _bs_kernel (the forward) and :_bs_bwd_kernel (the deterministic
// backward), and the XLA op that computed delta before it (:403). Query tile
// i of bq rows attends the caller's key tiles kv_idx[i, :kv_num[i]] of bk
// keys each, in full, intersected with the bottom-right causal mask when
// causal; bq and bk are multiples of 64 (the wrapper,
// kernels/flash_blocksparse.py, resolves JAX's tile rule first). Four
// kernels, all on the tiles of the dense kernels:
//
//  - bs_fwd_kernel: one block of two warpgroups per (128 q rows, head,
//    batch) runs the pieces of fwd_sm90.cuh's forward tile (B1's) over the
//    64-key tiles of its list, each listed tile as bk / 64 of them;
//  - bs_preprocess_kernel: delta = rowsum(dO * O) in fp32 and lse in base
//    2 into (b, h, sq_pad) buffers padded to whole 128-row tiles, as the
//    backward tiles take them; its other blocks build the inverse lists, a
//    warp a key tile: the q tiles that list it, ascending;
//  - bs_dkdv_kernel: one block per (128 keys, head, batch) runs
//    bwd_sm90.cuh's dK/dV tile (B3's) over the q tiles of the inverse list,
//    the heaviest blocks first (an order the wrapper builds on the device);
//  - bs_dq_kernel: one block per (128 q rows, head, batch) runs its dQ tile
//    over the kv list. It reads nothing that dK/dV writes, so it is
//    launched as a programmatic dependent of the dK/dV kernel: its blocks
//    take the SMs that dK/dV's last blocks leave idle (a key tile listed by
//    every q tile, a local window's global tile, walks far longer than the
//    rest), and its last block waits for dK/dV before it exits, so that
//    the dQ grid ends after both.
// No atomics and a fixed order: two runs give the same bits. The gradients
// are written in fp32, as the TPU kernel returns them.
//
// The walk. A block's list is read once into shared memory (up to LIST_CAP
// entries a list; the rest from global memory), and the walk's length is
// counted there (by all threads; a merge of two lists, below, by the
// issuing thread, which runs it once). The thread that issues the TMA loads then
// steps a cursor through the list as it issues each tile and records the
// tile's first row or key in its stage's slot, which the other threads read
// once the stage has landed. The walk skips an index outside [0, sk / bk)
// (which the TPU kernel would have read out of bounds), a tile wholly above
// the causal diagonal (or, for dK/dV, a q tile wholly below it), and the
// entries past kv_num, capped at the list's width; a tile listed twice is
// walked twice.
//
// A block's 128 rows may hold rows of two caller tiles (bq = 64 or an odd
// multiple of 64 on the query side, bk = 64 on the key side), whose lists
// may differ. Each warpgroup's 64 rows lie in one caller tile. The block
// then walks a merge of the two halves' lists that keeps each list's own
// order: a tile that both lists have next is walked once for both, any
// other for its own warpgroup alone. In the forward the other warpgroup
// masks the whole tile, which leaves its O, max and sum bitwise unchanged
// (no wgmma sits behind a branch that splits the warpgroups); in the
// backward the other one skips its products, as the dense tiles do for a
// tile past the causal diagonal. So each warpgroup sums exactly its own
// list's tiles, in its list's order.
//
// Bits. Over the full causal block mask at tiles of 128 the walks visit the
// same 64-key and 64-row tiles in the same order as B1's, B3's and B6's
// causal bands, on the same tiles: out and lse equal B1's, the gradients
// rounded to the inputs' type B3's.
//
// What bounds it on this card: the listed pairs' flops (4 d a pair forward,
// 10 d backward) while the bytes scale with the sequence: at a few tiles a
// row (a local window) the work per byte falls to the memory floor, and a
// walk of few tiles pays its first loads more often.
//
// Conventions: softmax_scale natural (its log2 form for the forward), lse
// natural-log (b, h, sq), -inf and out 0 for a row that sees no key (its
// gradients 0). q/k/v/dout (b, h, s, d) by element strides with the head
// dim contiguous, 16-byte aligned starts and strides (TMA; the 4D tensor
// maps zero-fill past each view's s extent); out (b, h, sq, d) and the
// gradients (b, h, s, d) contiguous; kv_num (b, nq), kv_idx (b, nq, nl),
// q_num (b, nk), q_idx (b, nk, ql), order (b * sk / 128) contiguous int32.

#include <climits>

#include "bwd_sm90.cuh"
#include "fwd_sm90.cuh"

namespace {

using namespace fa::sm90;

constexpr int UNIT = 64;        // rows or keys of a walked tile
constexpr int LIST_CAP = 1024;  // entries of each list a block keeps in shared memory
constexpr int PRE_ROWS = 128;   // preprocess: rows of a block
constexpr int PRE_WARPS = 8;
static_assert(FWD_N == UNIT && BWD_KV_BM == UNIT && BWD_Q_BN == UNIT,
              "the walks step in tiles of 64");
static_assert(FWD_M == 128 && BWD_KV_ROWS == 128 && BWD_Q_ROWS == 128,
              "a block holds two warpgroups of 64 rows");

// ---- the list walk ----------------------------------------------------------

// One part of a walk: the list idx[0, num) of caller tiles (rows or keys
// a tile: the walk's unit), whose unit / 64 tiles are kept when their first
// row or key x lies in [lo, hi].
struct ListPart {
  const int* idx;  // in global memory (the walk reads entries past LIST_CAP here)
  int num, lo, hi;
};

// A block's walk in shared memory: one or two parts (the lists of the
// caller tiles of its two halves), their first LIST_CAP entries, and a
// cursor into each (entry e, row or key s into the entry) of the issuing
// thread. An entry outside [0, n_units) is skipped.
struct ListWalkSmem {
  ListPart part[2];
  int2 slot[2];  // each stage's step: first row or key, owner
  int count;     // steps in all
  int parts, unit, n_units;
  int e[2], s[2];
  int list[2][LIST_CAP];
};

__host__ __device__ constexpr int walk_offset(int layout_bytes) {
  return (layout_bytes + 15) & ~15;
}
constexpr int walk_smem(int layout_smem) {
  return walk_offset(layout_smem) + (int)sizeof(ListWalkSmem);
}

// How many of the unit / 64 tiles of entry j the part keeps.
__device__ __forceinline__ int kept_tiles(int j, int unit, int n_units, const ListPart& q) {
  if (j < 0 || j >= n_units) return 0;
  int c = 0;
  for (int x = j * unit; x < (j + 1) * unit; x += UNIT) c += x >= q.lo && x <= q.hi;
  return c;
}

// Moves part p's cursor (e, s) to its next kept tile, if it is not on one,
// and returns that tile's first row or key, or INT_MAX past the list's end.
__device__ __forceinline__ int walk_seek(const ListWalkSmem* w, int p, int& e, int& s) {
  const ListPart& q = w->part[p];
  for (; e < q.num;) {
    const int j = e < LIST_CAP ? w->list[p][e] : q.idx[e];
    const int x = j * w->unit + s;
    if (j >= 0 && j < w->n_units && x >= q.lo && x <= q.hi) return x;
    if ((s += UNIT) == w->unit) {
      s = 0;
      ++e;
    }
  }
  return INT_MAX;
}

// The next step of a walk from the cursors (e, s): one part walks its kept
// tiles in order; two parts are merged, each part's tiles in its own order,
// a tile that both parts have next taken once for both warpgroups (owner
// -1) and otherwise the smaller one for its own warpgroup alone. Returns
// the step's first row or key and sets its owner; INT_MAX at the end.
__device__ __forceinline__ int walk_step(const ListWalkSmem* w, int (&e)[2], int (&s)[2],
                                         int& owner) {
  auto advance = [&](int p) {
    if ((s[p] += UNIT) == w->unit) {
      s[p] = 0;
      ++e[p];
    }
  };
  const int x0 = walk_seek(w, 0, e[0], s[0]);
  if (w->parts == 1) {
    owner = -1;
    if (x0 != INT_MAX) advance(0);
    return x0;
  }
  const int x1 = walk_seek(w, 1, e[1], s[1]);
  owner = x0 == x1 ? -1 : x0 < x1 ? 0 : 1;
  if (owner != 1 && x0 != INT_MAX) advance(0);
  if (owner != 0 && x1 != INT_MAX) advance(1);
  return min(x0, x1);
}

// Sets up the walk of a block over one or two parts, with every thread of
// the block: the lists' first LIST_CAP entries are copied in and the
// walk's steps counted (one part by all threads; a merge of two by the
// issuing thread, which runs it once). Ends with a block barrier.
__device__ __forceinline__ void walk_setup(ListWalkSmem* w, int parts, ListPart p0,
                                           ListPart p1, int unit, int n_units) {
  const int tid = threadIdx.x;
  const int nthreads = blockDim.x;
  if (tid == 0) {
    w->part[0] = p0;
    w->part[1] = p1;
    w->parts = parts;
    w->unit = unit;
    w->n_units = n_units;
    w->e[0] = w->e[1] = w->s[0] = w->s[1] = 0;
    w->count = 0;
  }
  int c = 0;
  for (int p = 0; p < parts; ++p) {
    const ListPart q = p == 0 ? p0 : p1;  // a copy: its address would put p0, p1 on the stack
    for (int e = tid; e < q.num; e += nthreads) {
      const int j = q.idx[e];
      if (e < LIST_CAP) w->list[p][e] = j;
      c += kept_tiles(j, unit, n_units, q);
    }
  }
  __syncthreads();
  if (parts == 1) {
    if (c) atomicAdd(&w->count, c);
  } else if (tid == 0) {
    int e[2] = {0, 0}, s[2] = {0, 0}, owner, n = 0;
    while (walk_step(w, e, s, owner) != INT_MAX) ++n;
    w->count = n;
  }
  __syncthreads();
}

// The issuing thread: take the walk's next step, record it in stage st's
// slot and return its first row or key. Called count times, in order.
__device__ __forceinline__ int walk_next(ListWalkSmem* w, int st) {
  int e[2] = {w->e[0], w->e[1]}, s[2] = {w->s[0], w->s[1]}, owner;
  const int x = walk_step(w, e, s, owner);
  w->e[0] = e[0];
  w->e[1] = e[1];
  w->s[0] = s[0];
  w->s[1] = s[1];
  w->slot[st] = make_int2(x, owner);
  return x;
}

// A list walk as the backward tiles take it (bwd_sm90.cuh's Walk).
struct ListWalk {
  ListWalkSmem* w;
  int head;
  __device__ __forceinline__ int count() const { return w->count; }
  __device__ __forceinline__ WalkStep next(int, int st) const {
    return {walk_next(w, st), head, -1};
  }
  __device__ __forceinline__ WalkStep at(int, int st) const {
    const int2 v = w->slot[st];
    return {v.x, head, v.y};
  }
};

struct BsParams {
  void* out;           // forward: (b, h, sq, d) in q's type
  float* lse;          // forward: (b, h, sq)
  const float* lse2;   // backward: (b, h, sq_pad)
  const float* delta;  // backward: (b, h, sq_pad)
  float* dq;           // (b, h, sq, d) fp32
  float* dk;           // (b, h, sk, d) fp32
  float* dv;
  const int* kv_num;   // (b, nq)
  const int* kv_idx;   // (b, nq, nl)
  const int* q_num;    // (b, nk)
  const int* q_idx;    // (b, nk, ql)
  const int* order;    // (b * sk / 128): the dK/dV blocks, heaviest first
  int h, sq, sk, sq_pad, bq, bk, nq, nk, nl, ql;
  BwdArgs a;  // the scalars (group 1)
};

// The walk of the 128 rows [m0, m0 + 128) over their kv lists (the forward
// and dQ): keys x of a listed tile kept up to the diagonal of the part's
// last row.
__device__ __forceinline__ void kv_walk_setup(ListWalkSmem* w, const BsParams& p, int bb,
                                              int m0) {
  const int shift = p.sk - p.sq;
  const int i0 = m0 / p.bq;
  const int i1 = (m0 + 64) / p.bq;
  const int two = m0 + 64 < p.sq && i1 != i0;
  auto hi = [&](int end) {
    return p.a.causal ? min(end, p.sq) - 1 + shift : INT_MAX;
  };
  const int64_t r0 = (int64_t)bb * p.nq + i0;
  const int64_t r1 = (int64_t)bb * p.nq + i1;
  walk_setup(w, two ? 2 : 1,
             {p.kv_idx + r0 * p.nl, max(0, min(p.kv_num[r0], p.nl)), INT_MIN,
              hi(two ? m0 + 64 : m0 + 128)},
             {p.kv_idx + r1 * p.nl, two ? max(0, min(p.kv_num[r1], p.nl)) : 0, INT_MIN,
              hi(m0 + 128)},
             p.bk, p.nk);
}

// The walk of the 128 keys [n0, n0 + 128) over their inverse lists (dK/dV):
// a q tile of 64 rows m0 is kept when it lies in [0, sq) and, causal, its
// last row sees the part's first key (m0 + 63 >= that key - shift).
__device__ __forceinline__ void q_walk_setup(ListWalkSmem* w, const BsParams& p, int bb,
                                             int n0) {
  const int shift = p.sk - p.sq;
  const int j0 = n0 / p.bk;
  const int j1 = (n0 + 64) / p.bk;
  const int two = j1 != j0;
  auto lo = [&](int key) { return p.a.causal ? key - shift - (UNIT - 1) : INT_MIN; };
  auto hi = [&](int key) {
    return p.a.causal && key - shift > p.sq - 1 ? -1 : p.sq - 1;
  };
  const int64_t c0 = (int64_t)bb * p.nk + j0;
  const int64_t c1 = (int64_t)bb * p.nk + j1;
  walk_setup(w, two ? 2 : 1, {p.q_idx + c0 * p.ql, min(p.q_num[c0], p.ql), lo(n0), hi(n0)},
             {p.q_idx + c1 * p.ql, two ? min(p.q_num[c1], p.ql) : 0, lo(n0 + 64), hi(n0 + 64)},
             p.bq, p.nq);
}

// ---- sources ----------------------------------------------------------------

// Batch row bb of the (b, h, s, d) operands for the forward tile.
struct FwdSrc {
  const CUtensorMap* q;
  const CUtensorMap* k;
  const CUtensorMap* v;
  int hh, bb;
  __device__ __forceinline__ void load_q(void* dst, uint64_t* bar, int col, int row) const {
    tma_load_4d(dst, q, bar, col, row, hh, bb);
  }
  __device__ __forceinline__ void load_k(void* dst, uint64_t* bar, int col, int row) const {
    tma_load_4d(dst, k, bar, col, row, hh, bb);
  }
  __device__ __forceinline__ void load_v(void* dst, uint64_t* bar, int col, int row) const {
    tma_load_4d(dst, v, bar, col, row, hh, bb);
  }
};

// Batch row bb of the (b, h, s, d) operands for the backward tiles: the
// padded lse2 / delta rows and the fp32 gradients.
template <int D>
struct BwdSrc {
  static constexpr bool ZERO_TAIL = false;  // TMA zero-fills past sq and sk
  const BwdMaps* maps;
  const BsParams* p;
  int bb, sq, sk;
  __device__ __forceinline__ BwdSrc(const BwdMaps& m, const BsParams& prm, int b)
      : maps(&m), p(&prm), bb(b), sq(prm.sq), sk(prm.sk) {}
  __device__ __forceinline__ void load_q(void* dst, uint64_t* bar, int col, int row,
                                         int hh) const {
    tma_load_4d(dst, &maps->q, bar, col, row, hh, bb);
  }
  __device__ __forceinline__ void load_do(void* dst, uint64_t* bar, int col, int row,
                                          int hh) const {
    tma_load_4d(dst, &maps->dout, bar, col, row, hh, bb);
  }
  __device__ __forceinline__ void load_k(void* dst, uint64_t* bar, int col, int row,
                                         int hh) const {
    tma_load_4d(dst, &maps->k, bar, col, row, hh, bb);
  }
  __device__ __forceinline__ void load_v(void* dst, uint64_t* bar, int col, int row,
                                         int hh) const {
    tma_load_4d(dst, &maps->v, bar, col, row, hh, bb);
  }
  __device__ __forceinline__ int64_t bh(int hh) const { return (int64_t)bb * p->h + hh; }
  __device__ __forceinline__ const float* lse2(int hh, int row) const {
    return p->lse2 + bh(hh) * p->sq_pad + row;
  }
  __device__ __forceinline__ const float* delta(int hh, int row) const {
    return p->delta + bh(hh) * p->sq_pad + row;
  }
  __device__ __forceinline__ float* dk(int row, int hh) const {
    return p->dk + (bh(hh) * sk + row) * D;
  }
  __device__ __forceinline__ float* dv(int row, int hh) const {
    return p->dv + (bh(hh) * sk + row) * D;
  }
  __device__ __forceinline__ float* dq(int row, int hh) const {
    return p->dq + (bh(hh) * sq + row) * D;
  }
};

// ---- the kernels ------------------------------------------------------------

// Forward: one block per (head, batch row, 128 q rows), the last q rows
// first and a q tile's heads side by side, as B1's grid.
template <typename T, int D>
__global__ void __launch_bounds__(FWD_THREADS, 2)
    bs_fwd_kernel(const __grid_constant__ FwdMaps maps, const BsParams p) {
  using L = FwdLayout<D>;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = align_1024(smem_raw);
  ListWalkSmem* w = reinterpret_cast<ListWalkSmem*>(smem + walk_offset(L::BYTES));
  unsigned char* Qs = smem + L::Q_OFF;
  uint64_t* q_bar = reinterpret_cast<uint64_t*>(smem + L::BAR_OFF);
  uint64_t* full = q_bar + 1;
  auto stage = [&](int n) { return smem + L::STAGE_OFF + (n % FWD_STAGES) * L::STAGE_BYTES; };
  const int tid = threadIdx.x;
  const int hh = blockIdx.x;
  const int bb = blockIdx.y;
  const int64_t bh = (int64_t)bb * p.h + hh;
  const FwdSrc src{&maps.q, &maps.k, &maps.v, hh, bb};
  FwdRows<T> t;
  t.out = reinterpret_cast<T*>(p.out) + bh * p.sq * D;
  t.lse = p.lse + bh * p.sq;
  t.o_ss = D;
  t.sq = p.sq;
  t.sk = p.sk;
  t.m0 = (gridDim.z - 1 - blockIdx.z) * FWD_M;

  // Q's load does not wait for the walk (the epilogue stages O in its tile,
  // so every block waits for it, even one whose walk is empty)
  if (tid == 0) {
    mbar_init(q_bar, 1);
    for (int s = 0; s < FWD_STAGES; ++s) mbar_init(&full[s], 1);
    fence_barrier_init();
    fwd_issue_q<D>(src, Qs, q_bar, t.m0);
  }
  kv_walk_setup(w, p, bb, t.m0);  // its closing barrier also publishes the mbarriers
  const int total = w->count;
  if (tid == 0 && total > 0)
    fwd_issue_kv<D>(src, stage(0), &full[0], walk_next(w, 0) / FWD_N);

  FwdAcc<D> a;
  a.init();
  mbar_wait(q_bar, 0);
  for (int n = 0; n < total; ++n) {
    if (tid == 0 && n + 1 < total)
      fwd_issue_kv<D>(src, stage(n + 1), &full[(n + 1) % FWD_STAGES],
                      walk_next(w, (n + 1) % FWD_STAGES) / FWD_N);
    mbar_wait(&full[n % FWD_STAGES], (n / FWD_STAGES) & 1);
    const int2 step = w->slot[n % FWD_STAGES];
    fwd_step<T, D, false>(a, Qs, stage(n), step.x, t, p.a.scale_log2, p.a.causal, step.y);
  }
  fwd_epilogue<T, D>(a, Qs, t);
}

struct PreParams {
  const void* dout;   // (b, h, sq, d) by strides
  const void* out;
  const float* lse;   // (b, h, sq)
  float* lse2;        // (b, h, sq_pad)
  float* delta;
  const int* kv_num;  // (b, nq)
  const int* kv_idx;  // (b, nq, nl)
  int* q_num;         // (b, nk)
  int* q_idx;         // (b, nk, ql)
  int64_t do_sb, do_sh, do_ss, o_sb, o_sh, o_ss;
  int b, h, sq, sq_pad, nq, nk, nl, ql;
};

// Blocks [0, b h sq_pad / 128): 128 rows of one (batch row, head), a warp a
// row: delta and lse2 (delta 0 and lse2 +inf past sq). The rest: a warp a
// (batch row, key tile j) builds the inverse list of j, the q tiles i that
// list it, ascending (i twice where i lists j twice), 32 q tiles a round.
template <typename T, int D>
__global__ void __launch_bounds__(PRE_WARPS * 32) bs_preprocess_kernel(const PreParams p) {
  constexpr int PER = D / 32;  // elements a lane
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int tiles = p.sq_pad / PRE_ROWS;
  const int64_t row_blocks = (int64_t)p.b * p.h * tiles;
  if (blockIdx.x < row_blocks) {
    const int64_t bh = blockIdx.x / tiles;
    const int m0 = (blockIdx.x - bh * tiles) * PRE_ROWS;
    const int bb = bh / p.h;
    const int hh = bh - (int64_t)bb * p.h;
    const T* dout = reinterpret_cast<const T*>(p.dout) + bb * p.do_sb + hh * p.do_sh + lane * PER;
    const T* out = reinterpret_cast<const T*>(p.out) + bb * p.o_sb + hh * p.o_sh + lane * PER;
    for (int r = warp; r < PRE_ROWS; r += PRE_WARPS) {
      const int row = m0 + r;
      const int64_t at = bh * p.sq_pad + row;
      if (row >= p.sq) {
        if (lane == 0) {
          p.delta[at] = 0.f;
          p.lse2[at] = INFINITY;
        }
        continue;
      }
      const float acc = bwd_preprocess_row<T, D>(dout + row * p.do_ss, out + row * p.o_ss);
      if (lane == 0) {
        p.delta[at] = acc;
        p.lse2[at] = bwd_lse2(p.lse[bh * p.sq + row]);
      }
    }
    return;
  }
  const int64_t col = (blockIdx.x - row_blocks) * PRE_WARPS + warp;  // bb * nk + j
  if (col >= (int64_t)p.b * p.nk) return;
  const int bb = col / p.nk;
  const int j = col - (int64_t)bb * p.nk;
  int* dst = p.q_idx + col * p.ql;
  int base = 0;
  for (int i0 = 0; i0 < p.nq; i0 += 32) {
    const int i = i0 + lane;
    int c = 0;
    if (i < p.nq) {
      const int64_t row = (int64_t)bb * p.nq + i;
      const int num = max(0, min(p.kv_num[row], p.nl));
      const int* idx = p.kv_idx + row * p.nl;
      for (int e = 0; e < num; ++e) c += idx[e] == j;
    }
    int incl = c;
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const int v = __shfl_up_sync(0xffffffff, incl, off);
      if (lane >= off) incl += v;
    }
    for (int k = incl - c; k < incl; ++k) dst[base + k] = i;
    base += __shfl_sync(0xffffffff, incl, 31);
  }
  if (lane == 0) p.q_num[col] = base;
}

// dK/dV: block x is (the x / h-th heaviest 128-key block, head x % h).
template <typename T, int D>
__global__ void __launch_bounds__(BWD_THREADS, 1)
    bs_dkdv_kernel(const __grid_constant__ BwdMaps maps, const BsParams p) {
  using L = DkdvLayout<D, false>;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = align_1024(smem_raw);
  ListWalkSmem* w = reinterpret_cast<ListWalkSmem*>(smem + walk_offset(L::BYTES));
  const int r = blockIdx.x / p.h;
  const int hh = blockIdx.x - r * p.h;
  // the dQ grid may start as soon as every dK/dV block has (see above)
  asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");
  const int kb = p.order[r];
  const int blocks = p.sk / BWD_KV_ROWS;
  const int bb = kb / blocks;
  const int n0 = (kb - bb * blocks) * BWD_KV_ROWS;
  q_walk_setup(w, p, bb, n0);
  bwd_dkdv<T, D, false>(BwdSrc<D>(maps, p, bb), p.a, hh, n0, smem, ListWalk{w, hh});
}

// dQ: one block per (head, batch row, 128 q rows), the last q rows first.
// The grid's last block waits for the dK/dV grid before it exits.
template <typename T, int D>
__global__ void __launch_bounds__(BWD_THREADS, 1)
    bs_dq_kernel(const __grid_constant__ BwdMaps maps, const BsParams p) {
  using L = DqLayout<D>;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = align_1024(smem_raw);
  ListWalkSmem* w = reinterpret_cast<ListWalkSmem*>(smem + walk_offset(L::BYTES));
  const int hh = blockIdx.x;
  const int bb = blockIdx.y;
  const int m0 = (gridDim.z - 1 - blockIdx.z) * BWD_Q_ROWS;
  kv_walk_setup(w, p, bb, m0);
  bwd_dq<T, D>(BwdSrc<D>(maps, p, bb), p.a, hh, m0, smem, ListWalk{w, hh});
  if (blockIdx.x == gridDim.x - 1 && blockIdx.y == gridDim.y - 1 && blockIdx.z == gridDim.z - 1)
    asm volatile("griddepcontrol.wait;\n" ::: "memory");
}

// ---- host side --------------------------------------------------------------

template <typename Kernel, typename Maps>
cudaError_t launch(Kernel kernel, dim3 grid, int threads, int smem, const Maps& maps,
                   const BsParams& p, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         smem);
  if (err != cudaSuccess) return err;
  kernel<<<grid, threads, smem, stream>>>(maps, p);
  return cudaGetLastError();
}

template <typename T, int D>
struct Fwd {
  static cudaError_t run(const FwdMaps& maps, const BsParams& p, int b, cudaStream_t st) {
    const dim3 grid(p.h, b, (p.sq + FWD_M - 1) / FWD_M);
    return launch(bs_fwd_kernel<T, D>, grid, FWD_THREADS, walk_smem(FwdLayout<D>::SMEM), maps,
                  p, st);
  }
};

template <typename T, int D>
struct Dkdv {
  static cudaError_t run(const BwdMaps& maps, const BsParams& p, int b, cudaStream_t st) {
    const dim3 grid(b * (p.sk / BWD_KV_ROWS) * p.h);
    return launch(bs_dkdv_kernel<T, D>, grid, BWD_THREADS,
                  walk_smem(DkdvLayout<D, false>::SMEM), maps, p, st);
  }
};

// Launched as a programmatic dependent of the dK/dV kernel before it in
// the stream.
template <typename T, int D>
struct Dq {
  static cudaError_t run(const BwdMaps& maps, const BsParams& p, int b, cudaStream_t st) {
    auto kernel = bs_dq_kernel<T, D>;
    const int smem = walk_smem(DqLayout<D>::SMEM);
    cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3(p.h, b, (p.sq + BWD_Q_ROWS - 1) / BWD_Q_ROWS);
    cfg.blockDim = dim3(BWD_THREADS);
    cfg.dynamicSmemBytes = smem;
    cfg.stream = st;
    cudaLaunchAttribute attr[1];
    attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
    attr[0].val.programmaticStreamSerializationAllowed = 1;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
    err = cudaLaunchKernelEx(&cfg, kernel, maps, p);
    if (err != cudaSuccess) return err;
    return cudaGetLastError();
  }
};

template <typename T, int D>
struct Pre {
  static cudaError_t run(const PreParams& p, cudaStream_t st) {
    const int64_t blocks = (int64_t)p.b * p.h * (p.sq_pad / PRE_ROWS) +
                           ((int64_t)p.b * p.nk + PRE_WARPS - 1) / PRE_WARPS;
    bs_preprocess_kernel<T, D><<<(unsigned)blocks, PRE_WARPS * 32, 0, st>>>(p);
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

// What every entry point checks of the shapes: the tiles the kernels are
// built for and whole caller key tiles.
bool shapes_ok(int b, int h, int sq, int sk, int d, int bq, int bk) {
  return b > 0 && h > 0 && b <= 65535 && sq > 0 && (sq + 127) / 128 <= 65535 && sk > 0 &&
         (d == 64 || d == 128) && bq > 0 && bk > 0 && bq % UNIT == 0 && bk % UNIT == 0 &&
         sk % bk == 0;
}

// The backward's shapes: also whole 128-key blocks and rows padded to 128.
bool bwd_shapes_ok(int b, int h, int sq, int sk, int sq_pad, int d, int bq, int bk) {
  return shapes_ok(b, h, sq, sk, d, bq, bk) && sk % BWD_KV_ROWS == 0 &&
         sq_pad % BWD_ROW_PAD == 0 && sq_pad >= sq;
}

BsParams make_params(int h, int sq, int sk, int bq, int bk, float scale, int causal) {
  BsParams p = {};
  p.h = h;
  p.sq = sq;
  p.sk = sk;
  p.bq = bq;
  p.bk = bk;
  p.nq = (sq + bq - 1) / bq;
  p.nk = sk / bk;
  p.a = {scale, scale * FA_LOG2E, causal, 1};
  return p;
}

// The map of a (b, h, s, d) operand given by element strides (sb, sh, ss),
// boxes of 64 columns by `rows` rows of one head.
cudaError_t make_map(CUtensorMap* map, const void* ptr, bool bf16, int d, int s, int h,
                     int b, int64_t sb, int64_t sh, int64_t ss, int rows) {
  return make_tile_map<4>(map, ptr, bf16, {d, s, h, b}, {ss, sh, sb}, rows);
}

struct Operands {
  const void* q;
  const void* k;
  const void* v;
  const void* dout;
  int64_t q_sb, q_sh, q_ss, k_sb, k_sh, k_ss, v_sb, v_sh, v_ss, do_sb, do_sh, do_ss;
};

// The backward's maps: q and dout in boxes of q_rows rows, k and v of
// kv_rows.
cudaError_t make_bwd_maps(BwdMaps* m, const Operands& o, bool bf16, int b, int h, int sq,
                          int sk, int d, int q_rows, int kv_rows) {
  cudaError_t err;
  if ((err = make_map(&m->q, o.q, bf16, d, sq, h, b, o.q_sb, o.q_sh, o.q_ss, q_rows)) ||
      (err = make_map(&m->dout, o.dout, bf16, d, sq, h, b, o.do_sb, o.do_sh, o.do_ss,
                      q_rows)) ||
      (err = make_map(&m->k, o.k, bf16, d, sk, h, b, o.k_sb, o.k_sh, o.k_ss, kv_rows)) ||
      (err = make_map(&m->v, o.v, bf16, d, sk, h, b, o.v_sb, o.v_sh, o.v_ss, kv_rows)))
    return err;
  return cudaSuccess;
}

}  // namespace

// out (b, h, sq, d) in q's type and lse (b, h, sq) fp32 over the kv lists
// kv_num (b, nq) / kv_idx (b, nq, nl). Returns a cudaError_t (0 on
// success).
extern "C" int fa_blocksparse_fwd(
    const void* q, const void* k, const void* v, void* out, float* lse,
    const int* kv_num, const int* kv_idx, int b, int h, int sq, int sk, int d,
    int bq, int bk, int nl, int64_t q_sb, int64_t q_sh, int64_t q_ss,
    int64_t k_sb, int64_t k_sh, int64_t k_ss, int64_t v_sb, int64_t v_sh,
    int64_t v_ss, float scale, int causal, int is_bf16, void* stream) {
  if (!shapes_ok(b, h, sq, sk, d, bq, bk) || nl < 0) return (int)cudaErrorInvalidValue;
  FwdMaps maps;
  cudaError_t err;
  if ((err = make_map(&maps.q, q, is_bf16, d, sq, h, b, q_sb, q_sh, q_ss, FWD_M)) ||
      (err = make_map(&maps.k, k, is_bf16, d, sk, h, b, k_sb, k_sh, k_ss, FWD_N)) ||
      (err = make_map(&maps.v, v, is_bf16, d, sk, h, b, v_sb, v_sh, v_ss, FWD_N)))
    return (int)err;
  BsParams p = make_params(h, sq, sk, bq, bk, scale, causal);
  p.out = out;
  p.lse = lse;
  p.kv_num = kv_num;
  p.kv_idx = kv_idx;
  p.nl = nl;
  return dispatch<Fwd>(is_bf16, d, maps, p, b, reinterpret_cast<cudaStream_t>(stream));
}

// delta = rowsum(dout * out) and lse2 = lse * log2(e) (+inf where lse is
// -inf) into (b, h, sq_pad) fp32 buffers (delta 0 and lse2 +inf on the rows
// [sq, sq_pad)), and the inverse lists of kv_num (b, nq) / kv_idx (b, nq,
// nl): q_num (b, nk) and q_idx (b, nk, ql), ql >= nq * nl, for each key
// tile the q tiles that list it, ascending (entries past q_num not
// written). dout/out (b, h, sq, d) by element strides (sb, sh, ss) with the
// head dim contiguous; lse (b, h, sq) contiguous. Returns a cudaError_t.
extern "C" int fa_blocksparse_bwd_preprocess(
    const void* dout, const void* out, const float* lse, float* lse2, float* delta,
    const int* kv_num, const int* kv_idx, int* q_num, int* q_idx, int b, int h, int sq,
    int sk, int sq_pad, int d, int bq, int bk, int nl, int ql, int64_t do_sb, int64_t do_sh,
    int64_t do_ss, int64_t o_sb, int64_t o_sh, int64_t o_ss, int is_bf16, void* stream) {
  if (!bwd_shapes_ok(b, h, sq, sk, sq_pad, d, bq, bk) || nl < 0 ||
      (int64_t)ql < (int64_t)((sq + bq - 1) / bq) * nl)
    return (int)cudaErrorInvalidValue;
  PreParams p = {dout, out, lse, lse2, delta, kv_num, kv_idx, q_num, q_idx,
                 do_sb, do_sh, do_ss, o_sb, o_sh, o_ss,
                 b, h, sq, sq_pad, (sq + bq - 1) / bq, sk / bk, nl, ql};
  return dispatch<Pre>(is_bf16, d, p, reinterpret_cast<cudaStream_t>(stream));
}

// dK and dV (b, h, sk, d) fp32 over the inverse lists q_num (b, nk) / q_idx
// (b, nk, ql) from fa_blocksparse_bwd_preprocess, the 128-key blocks in the
// order `order` (b * sk / 128 block indices bb * sk / 128 + n0 / 128,
// heaviest first). lse2 and delta (b, h, sq_pad) from the preprocess.
// Returns a cudaError_t (0 on success).
extern "C" int fa_blocksparse_bwd_dkdv(
    const void* q, const void* k, const void* v, const void* dout, const float* lse2,
    const float* delta, float* dk, float* dv, const int* q_num, const int* q_idx,
    const int* order, int b, int h, int sq, int sk, int sq_pad, int d, int bq, int bk,
    int ql, int64_t q_sb, int64_t q_sh, int64_t q_ss, int64_t k_sb, int64_t k_sh,
    int64_t k_ss, int64_t v_sb, int64_t v_sh, int64_t v_ss, int64_t do_sb, int64_t do_sh,
    int64_t do_ss, float scale, int causal, int is_bf16, void* stream) {
  if (!bwd_shapes_ok(b, h, sq, sk, sq_pad, d, bq, bk) ||
      (int64_t)b * (sk / BWD_KV_ROWS) * h > 0x7fffffff)
    return (int)cudaErrorInvalidValue;
  const Operands o = {q, k, v, dout, q_sb, q_sh, q_ss, k_sb, k_sh, k_ss,
                      v_sb, v_sh, v_ss, do_sb, do_sh, do_ss};
  BwdMaps maps;
  cudaError_t err = make_bwd_maps(&maps, o, is_bf16, b, h, sq, sk, d, BWD_KV_BM, BWD_KV_ROWS);
  if (err != cudaSuccess) return (int)err;
  BsParams p = make_params(h, sq, sk, bq, bk, scale, causal);
  p.lse2 = lse2;
  p.delta = delta;
  p.sq_pad = sq_pad;
  p.dk = dk;
  p.dv = dv;
  p.q_num = q_num;
  p.q_idx = q_idx;
  p.order = order;
  p.ql = ql;
  return dispatch<Dkdv>(is_bf16, d, maps, p, b, reinterpret_cast<cudaStream_t>(stream));
}

// dQ (b, h, sq, d) fp32 over the kv lists, as fa_blocksparse_fwd reads
// them. Layouts as fa_blocksparse_bwd_dkdv.
extern "C" int fa_blocksparse_bwd_dq(
    const void* q, const void* k, const void* v, const void* dout, const float* lse2,
    const float* delta, float* dq, const int* kv_num, const int* kv_idx, int b, int h,
    int sq, int sk, int sq_pad, int d, int bq, int bk, int nl, int64_t q_sb, int64_t q_sh,
    int64_t q_ss, int64_t k_sb, int64_t k_sh, int64_t k_ss, int64_t v_sb, int64_t v_sh,
    int64_t v_ss, int64_t do_sb, int64_t do_sh, int64_t do_ss, float scale, int causal,
    int is_bf16, void* stream) {
  if (!bwd_shapes_ok(b, h, sq, sk, sq_pad, d, bq, bk) || nl < 0)
    return (int)cudaErrorInvalidValue;
  const Operands o = {q, k, v, dout, q_sb, q_sh, q_ss, k_sb, k_sh, k_ss,
                      v_sb, v_sh, v_ss, do_sb, do_sh, do_ss};
  BwdMaps maps;
  cudaError_t err = make_bwd_maps(&maps, o, is_bf16, b, h, sq, sk, d, BWD_Q_ROWS, BWD_Q_BN);
  if (err != cudaSuccess) return (int)err;
  BsParams p = make_params(h, sq, sk, bq, bk, scale, causal);
  p.lse2 = lse2;
  p.delta = delta;
  p.sq_pad = sq_pad;
  p.dq = dq;
  p.kv_num = kv_num;
  p.kv_idx = kv_idx;
  p.nl = nl;
  return dispatch<Dq>(is_bf16, d, maps, p, b, reinterpret_cast<cudaStream_t>(stream));
}
