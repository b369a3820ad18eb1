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
// sequence, query head), as the dense forward kernel csrc/flash_fwd.cu
// launches them, with its tile loop: Q in registers as mma.sync fragments,
// 64-key K/V tiles through cp.async into swizzled shared memory, both
// products on the tensor cores, the online softmax in fp32 registers. Each
// block reads its (sequence, first local row) from a per-tile array the
// wrapper builds with torch ops (the counterpart of the JAX function's
// seq_of / qloc), so nothing is read back to the host. K/V tiles load row by
// row through the page table: key position j is row j % page_size of page
// table[s, j / page_size], so any page size works. Left for later: wgmma
// and TMA page copies, a shared-memory ring that keeps loads in flight
// across tiles, one block for the GQA group's query heads (each head's
// block reads its K/V tiles again here), and a persistent schedule.

#include "common.cuh"

namespace {

constexpr int BM = 64;  // query rows per block
constexpr int BN = 64;  // keys per K/V tile
constexpr int NWARPS = 4;
constexpr int NTHREADS = NWARPS * 32;

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

// Rows [0, 64) of the query tile starting at `base`; rows at or past
// `nrows` are zero-filled.
template <typename T, int D>
__device__ __forceinline__ void load_q_tile(T* tile, const T* base,
                                            int64_t row_stride, int nrows,
                                            int tid) {
  constexpr int CHUNKS = D / 8;
#pragma unroll
  for (int i = 0; i < BM * CHUNKS / NTHREADS; ++i) {
    const int c = tid + i * NTHREADS;
    const int r = c / CHUNKS;
    const int ch = c % CHUNKS;
    const bool ok = r < nrows;
    const T* src = ok ? base + (int64_t)r * row_stride + ch * 8 : base;
    fa::cp_async_16(fa::smem_addr(tile + fa::swz<D>(r, ch)), src, ok ? 16 : 0);
  }
}

// Key positions [n0, n0 + 64) of one sequence and KV head, each through the
// page table; positions at or past `nkeys` are zero-filled.
template <typename T, int D>
__device__ __forceinline__ void load_kv_tile(T* tile, const T* head_base,
                                             int64_t page_stride,
                                             int64_t row_stride,
                                             const int* table_row,
                                             const VarlenPagedParams& p,
                                             int n0, int nkeys, int tid) {
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
      const int col = key / p.page_size;
      const int pg = min(max(table_row[min(col, p.table_width - 1)], 0),
                         p.num_pages - 1);
      src = head_base + pg * page_stride +
            (int64_t)(key - col * p.page_size) * row_stride + ch * 8;
    }
    fa::cp_async_16(fa::smem_addr(tile + fa::swz<D>(r, ch)), src, ok ? 16 : 0);
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(NTHREADS)
    varlen_paged_kernel(const VarlenPagedParams p) {
  using E = fa::Elem<T>;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  T* Qs = reinterpret_cast<T*>(smem_raw);
  T* Ks = Qs + BM * D;
  T* Vs = Ks + BN * D;

  const int seq = p.tiles[2 * blockIdx.x];
  if (seq < 0) return;  // past the last tile of the batch
  const int qloc = p.tiles[2 * blockIdx.x + 1];
  const int hh = blockIdx.y;
  const int kh = hh / p.group;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int g = lane >> 2;
  const int t4 = lane & 3;

  const int q0 = p.cu_q[seq] + qloc;                  // first packed row
  const int rows_addr = min(BM, p.cu_q[seq + 1] - q0);  // rows of the layout
  const int lq = p.lens_q[seq];
  const int lk = p.lens_k[seq];
  const int shift = lk - lq;

  const T* qg = reinterpret_cast<const T*>(p.q) + q0 * p.q_st + hh * p.q_sh;
  const T* kg = reinterpret_cast<const T*>(p.kp) + kh * p.k_sh;
  const T* vg = reinterpret_cast<const T*>(p.vp) + kh * p.v_sh;
  const int* table_row = p.table + seq * p.t_sb;

  // KV tiles of this block's band: none when every row is past seqused_q.
  int n_tiles = (lk + BN - 1) / BN;
  const int row_hi = min(qloc + BM, lq) - 1;  // last real row of the tile
  if (row_hi < qloc) {
    n_tiles = 0;
  } else if (p.causal) {
    const int col_hi = row_hi + shift;
    n_tiles = col_hi < 0 ? 0 : min(n_tiles, col_hi / BN + 1);
  }

  load_q_tile<T, D>(Qs, qg, p.q_st, rows_addr, tid);
  fa::cp_async_commit();
  fa::cp_async_wait<0>();
  __syncthreads();

  uint32_t qa[D / 16][4];
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    const int r = warp * 16 + (lane & 7) + ((lane >> 3) & 1) * 8;
    fa::ldmatrix_x4(qa[kk], fa::smem_addr(Qs + fa::swz<D>(r, kk * 2 + (lane >> 4))));
  }

  float o[D / 8][4];
#pragma unroll
  for (int i = 0; i < D / 8; ++i) o[i][0] = o[i][1] = o[i][2] = o[i][3] = 0.f;
  float m_r[2] = {-INFINITY, -INFINITY};  // running max, base 2
  float l_r[2] = {0.f, 0.f};              // this lane's share of the row sum
  const int row0 = qloc + warp * 16 + g;  // local rows row0 and row0 + 8

  for (int n = 0; n < n_tiles; ++n) {
    const int n0 = n * BN;
    __syncthreads();  // every warp is done with the previous K/V tile
    load_kv_tile<T, D>(Ks, kg, p.k_sp, p.k_ss, table_row, p, n0, lk, tid);
    fa::cp_async_commit();
    load_kv_tile<T, D>(Vs, vg, p.v_sp, p.v_ss, table_row, p, n0, lk, tid);
    fa::cp_async_commit();
    fa::cp_async_wait<1>();  // K has landed; V may still be in flight
    __syncthreads();

    float s[BN / 8][4];
#pragma unroll
    for (int i = 0; i < BN / 8; ++i) s[i][0] = s[i][1] = s[i][2] = s[i][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
#pragma unroll
      for (int np = 0; np < BN / 16; ++np) {
        uint32_t kb[4];
        const int r = np * 16 + (lane & 7) + (lane >> 4) * 8;
        fa::ldmatrix_x4(kb, fa::smem_addr(Ks + fa::swz<D>(r, kk * 2 + ((lane >> 3) & 1))));
        E::mma(s[2 * np], qa[kk], kb[0], kb[1]);
        E::mma(s[2 * np + 1], qa[kk], kb[2], kb[3]);
      }
    }

    // Tiles that cross the causal diagonal, the end of the keys or the end
    // of the sequence's real rows run the mask.
    const bool need_mask = (p.causal && n0 + BN - 1 > qloc + shift) ||
                           (n0 + BN > lk) || (qloc + BM > lq);
#pragma unroll
    for (int nb = 0; nb < BN / 8; ++nb) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float x = s[nb][e] * p.scale_log2;
        if (need_mask) {
          const int col = n0 + nb * 8 + 2 * t4 + (e & 1);
          const int row = row0 + (e >> 1) * 8;
          const bool ok = col < lk && row < lq && (!p.causal || col <= row + shift);
          x = ok ? x : -INFINITY;
        }
        s[nb][e] = x;
      }
    }

    // Online softmax over the tile.
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      float mx = -INFINITY;
#pragma unroll
      for (int nb = 0; nb < BN / 8; ++nb)
        mx = fmaxf(mx, fmaxf(s[nb][2 * i], s[nb][2 * i + 1]));
      mx = fa::quad_max(mx);
      const float m_new = fmaxf(m_r[i], mx);
      const float m_safe = m_new == -INFINITY ? 0.f : m_new;
      const float corr = exp2f(m_r[i] - m_safe);
      m_r[i] = m_new;
      float rs = 0.f;
#pragma unroll
      for (int nb = 0; nb < BN / 8; ++nb) {
        s[nb][2 * i] = exp2f(s[nb][2 * i] - m_safe);
        s[nb][2 * i + 1] = exp2f(s[nb][2 * i + 1] - m_safe);
        rs += s[nb][2 * i] + s[nb][2 * i + 1];
      }
      l_r[i] = l_r[i] * corr + rs;
#pragma unroll
      for (int db = 0; db < D / 8; ++db) {
        o[db][2 * i] *= corr;
        o[db][2 * i + 1] *= corr;
      }
    }

    fa::cp_async_wait<0>();
    __syncthreads();

    // O += P V, with P taken straight from the S accumulators.
#pragma unroll
    for (int kk = 0; kk < BN / 16; ++kk) {
      uint32_t pa[4];
      pa[0] = E::pack(s[2 * kk][0], s[2 * kk][1]);
      pa[1] = E::pack(s[2 * kk][2], s[2 * kk][3]);
      pa[2] = E::pack(s[2 * kk + 1][0], s[2 * kk + 1][1]);
      pa[3] = E::pack(s[2 * kk + 1][2], s[2 * kk + 1][3]);
#pragma unroll
      for (int dp = 0; dp < D / 16; ++dp) {
        uint32_t vb[4];
        const int r = kk * 16 + (lane & 7) + ((lane >> 3) & 1) * 8;
        fa::ldmatrix_x4_trans(vb, fa::smem_addr(Vs + fa::swz<D>(r, dp * 2 + (lane >> 4))));
        E::mma(o[2 * dp], pa, vb[0], vb[1]);
        E::mma(o[2 * dp + 1], pa, vb[2], vb[3]);
      }
    }
  }

  // Epilogue: every row of the packed layout that the tile covers is
  // written, zeros (and lse -inf) for the rows that saw no key.
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = warp * 16 + g + i * 8;  // row within the tile
    const float l = fa::quad_sum(l_r[i]);
    if (r >= rows_addr) continue;
    const float inv = l == 0.f ? 0.f : 1.f / l;
    T* og = reinterpret_cast<T*>(p.out) + (q0 + r) * p.o_st + hh * p.o_sh;
#pragma unroll
    for (int db = 0; db < D / 8; ++db) {
      *reinterpret_cast<uint32_t*>(og + db * 8 + 2 * t4) =
          E::pack(o[db][2 * i] * inv, o[db][2 * i + 1] * inv);
    }
    if (t4 == 0) {
      p.lse[(int64_t)hh * p.total_q + q0 + r] =
          l == 0.f ? -INFINITY : m_r[i] * FA_LN2 + logf(l);
    }
  }
}

template <typename T, int D>
cudaError_t launch(const VarlenPagedParams& p, int num_tiles,
                   cudaStream_t stream) {
  const int smem = (BM + 2 * BN) * D * (int)sizeof(T);
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
