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
// lse -inf (the wrapper allocates them so, and no block writes them).
//
// What bounds it on this card: each (query row, key) pair and head costs
// 2 (D + DV) + 2 DV flops (2,176 at 64 + 512), against 1,152 bytes a key and
// 1,152 + 1,024 bytes a query row and head. At DeepSeek-V3's 128 heads a
// 512-position chunk at b = 8 over 2,048 keys is about 1,000 flops a byte:
// the tensor cores' rate bounds it (PERF.md).
//
// Rows. A block computes a tile of 64 query rows of one sequence and KV
// head: PB positions by GB heads of the KV head's group, GB = gcd(group,
// 64), PB = 64 / GB, row p GB + j being position p0 + p of head hb + j. At
// DeepSeek's 128 heads on one KV head a tile is 64 heads of one position,
// so it has one causal limit and only its last key tile is masked; at GQA
// 8/2 it is 16 positions of 4 heads, masked per row on the tiles that cross
// a limit. Q and QV come once by TMA as boxes of (64 columns, GB heads, PB
// positions) over the packed (total, h, d) and (total, h, dv) tensors into
// 128B-swizzled 64-column panels: (D + DV) / 64 panels (9 at 64 + 512).
// TMA zero-fills only past a tensor's end, so rows past the chunk are
// computed on the next sequence's rows and never stored.
//
// Keys. A key tile is 64 keys as [K | V] rows in the same panels. One
// warp walks the block table (each page id clamped to the table
// and the pool) and copies each page's part of a tile as TMA boxes of
// gcd(page_size, 64) rows over 4D maps of the caches (num_pages, h_k,
// page_size, d or dv): one box a panel at pages of 64 or more, 64 /
// page_size at smaller pages. Two stages, each with a full and an empty
// mbarrier. Keys at or past cache_seqlens are masked to -inf and their V
// rows zeroed in shared memory, so that a NaN in a page the table points
// past cannot reach the output.
//
// Products. Two consumer warpgroups take the key tiles in turn (FlashMLA's
// alternating layout, deepseek-ai/FlashMLA): warpgroup w computes S of the
// tiles n = w mod 2 once, at N = 64 with both operands K-major (SS wgmma),
// runs the online softmax on it and publishes its row maxima, its rescale
// factors and P (bf16, into the tile's K panel, whose keys it no longer
// needs) behind a `ready` mbarrier. The softmax is a chain (tile n starts
// from the maxima after tile n - 1, read from the other warpgroup), but
// each warpgroup's score product runs while the other's softmax does. Each
// warpgroup owns half of the DV output columns (a 64 x 256 fp32 half, 128
// registers a thread at DV = 512) and applies every tile's P to it in
// order, rescaling first: O += P V by SS wgmma with P K-major and V
// MN-major through the transpose bit. Every wgmma sits on control flow that
// is uniform across the block's consumers: a warpgroup with no tile left
// in the last pair still runs its score product on the other's stage and
// drops it. The epilogue exchanges the two warpgroups' row sums, stages
// each normalised half in the Q panels (both are past their last score
// product) and stores 16-byte chunks, rows past the chunk skipped.
//
// Shared memory at 64 + 512: Q 72 KB and two key stages of 72 KB, 218 KB
// with the exchange arrays and barriers (and 1 KB to align the base).
// 256 threads, the two warpgroups, at 221 registers a thread at DV = 512
// without spills. A producer warpgroup (384 threads) would cap ptxas at 168
// registers a thread, setmaxnreg notwithstanding, and spill O; so the
// second warpgroup's first warp issues the copies between its products.
// Grid: one block per (batch row, KV head, row tile), row tiles in reverse
// so that the longest causal bands start first; the blocks of a sequence
// read the same keys, which stay in the 50 MB L2.

#include <limits.h>

#include "sm90.cuh"

namespace {

using namespace fa;
using namespace fa::sm90;

constexpr int BM = 64;  // query rows a tile
constexpr int BN = 64;  // keys a key tile
constexpr int THREADS = 256;  // two warpgroups
constexpr int PANEL = BM * 128;  // one 64-column panel of 64 rows

// The (D, DV) forms the kernel is compiled for, all with qv (dispatch/
// config.py PAGED_PREFILL_DIMS).
template <int D_, int DV_>
struct Dims {
  static constexpr int D = D_;
  static constexpr int DV = DV_;
  static constexpr int DQK = D + DV;        // score depth = key-tile row width
  static constexpr int PANELS = DQK / 64;   // of Q and of a key tile
  static constexpr int DVH = DV / 2;        // output columns a warpgroup
  static constexpr int NB = DVH < 128 ? DVH : 128;  // width of one P V product
  static_assert(D % 64 == 0 && DV % 128 == 0, "64-column panels, halves of 64");
};

template <typename Dm>
struct Layout {
  static constexpr int Q_OFF = 0;
  static constexpr int STAGE_OFF = Dm::PANELS * PANEL;
  static constexpr int STAGE_BYTES = Dm::PANELS * PANEL;  // K panels, then V
  static constexpr int X_OFF = STAGE_OFF + 2 * STAGE_BYTES;
  // m_buf[2][64], c_buf[2][64] (row maxima and rescale factors of the last
  // tile of each stage), l_buf[2][64] (each warpgroup's row sums)
  static constexpr int BAR_OFF = X_OFF + 6 * BM * 4;
  // q_full, full[2], empty[2], ready[2]
  static constexpr int BYTES = BAR_OFF + 7 * 8;
  static constexpr int SMEM = BYTES + 1024;  // the base is rounded up to 1024
};

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
};

struct PrefillMaps {
  CUtensorMap q, qv, k, v;
};

template <typename T, typename Dm>
__global__ void __launch_bounds__(THREADS, 1)
    paged_prefill_kernel(const __grid_constant__ PrefillMaps maps, const PrefillParams p) {
  using L = Layout<Dm>;
  constexpr int D = Dm::D;
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
  const int shift = sk - sq;
  const int k_end = p.causal ? min(sk, min(p0 + p.pb, sq) - 1 + shift + 1) : sk;
  if (k_end <= 0) return;  // no row of the tile sees a key
  const int n_tiles = (k_end + BN - 1) / BN;
  const int start = p.starts[bb];
  const int head0 = kh * p.group + hb;

  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = align_1024(smem_raw);
  unsigned char* Qs = smem + L::Q_OFF;
  float* m_buf = reinterpret_cast<float*>(smem + L::X_OFF);
  float* c_buf = m_buf + 2 * BM;
  float* l_buf = c_buf + 2 * BM;
  uint64_t* q_full = reinterpret_cast<uint64_t*>(smem + L::BAR_OFF);
  uint64_t* full = q_full + 1;
  uint64_t* empty = full + 2;
  uint64_t* ready = empty + 2;
  auto stage = [&](int s) { return smem + L::STAGE_OFF + s * L::STAGE_BYTES; };

  const int tid = threadIdx.x;
  if (tid == 0) {
    mbar_init(q_full, 1);
    for (int s = 0; s < 2; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], THREADS);
      mbar_init(&ready[s], 128);
    }
    fence_barrier_init();
  }
  __syncthreads();

  const int wg = tid >> 7;
  const int warp = (tid >> 5) & 3;
  const int lane = tid & 31;
  const int g = lane >> 2;
  const int t4 = lane & 3;
  // The key copies are issued by warpgroup 1's first warp, which releases
  // each stage last in the steady state: tile n + 2 goes into tile n's
  // stage once both warpgroups have released it, one lane a box (each page
  // id clamped to the table and to the pool).
  const bool issuer = wg == 1 && warp == 0;
  const int* table_row = p.table + (int64_t)bb * p.t_sb;
  auto issue_keys = [&](int n) {
    const int s = n & 1;
    unsigned char* st = stage(s);
    if (lane == 0) mbar_expect_tx(&full[s], L::STAGE_BYTES);
    __syncwarp();
    for (int j = lane; j < BN / p.box_rows; j += 32) {
      const int key = n * BN + j * p.box_rows;
      const int col = key / p.page_size;
      const int pg = min(max(table_row[min(col, p.table_width - 1)], 0), p.num_pages - 1);
      const int row = key - col * p.page_size;
      unsigned char* dst = st + j * p.box_rows * 128;
#pragma unroll
      for (int c = 0; c < Dm::PANELS; ++c) {
        if (c < D / 64)
          tma_load_4d(dst + c * PANEL, &maps.k, &full[s], c * 64, row, kh, pg);
        else
          tma_load_4d(dst + c * PANEL, &maps.v, &full[s], (c - D / 64) * 64, row, kh, pg);
      }
    }
  };
  if (tid == 0) {
    mbar_expect_tx(q_full, Dm::PANELS * PANEL);
#pragma unroll
    for (int c = 0; c < Dm::PANELS; ++c) {
      if (c < D / 64)
        tma_load_3d(Qs + c * PANEL, &maps.q, q_full, c * 64, head0, start + p0);
      else
        tma_load_3d(Qs + c * PANEL, &maps.qv, q_full, (c - D / 64) * 64, head0, start + p0);
    }
  }
  if (issuer) {
    issue_keys(0);
    if (n_tiles > 1) issue_keys(1);
  }

  int lim[2];  // the last key each of this thread's two rows may see
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = warp * 16 + g + 8 * i;
    lim[i] = p.causal ? p0 + r / p.gb + shift : INT_MAX - 1;
  }
  const int lim_first = p.causal ? p0 + shift : INT_MAX - 1;  // the tile's smallest

  float o[DVH / NB][NB / 2];
#pragma unroll
  for (int b = 0; b < DVH / NB; ++b)
#pragma unroll
    for (int i = 0; i < NB / 2; ++i) o[b][i] = 0.f;
  float m_r[2] = {-INFINITY, -INFINITY};  // row maxima after the last tile applied
  float l_r[2] = {0.f, 0.f};              // this thread's share of its own tiles' sums

  mbar_wait(q_full, 0);
  for (int n0 = 0; n0 < n_tiles; n0 += 2) {
    const int own = n0 + wg;
    const bool has_own = own < n_tiles;
    // with no tile of its own, the score product runs on the even tile's
    // stage, which is held until both warpgroups release it, and is dropped
    const int st_s = has_own ? wg : 0;
    unsigned char* Ks = stage(st_s);
    mbar_wait(&full[st_s], (n0 >> 1) & 1);

    // S = [Q | QV] [K | V]^T over the tile's 64 keys at the full depth
    float s[BN / 2];
#pragma unroll
    for (int i = 0; i < BN / 2; ++i) s[i] = 0.f;
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < Dm::DQK / 16; ++kk)
      wgmma_ss<T, BN, 0, 0>(s, Tile<BM, Dm::DQK>::k_slice(Qs, 0, kk),
                            Tile<BN, Dm::DQK>::k_slice(Ks, 0, kk), kk > 0);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(s);

    float own_c[2] = {1.f, 1.f}, own_rs[2] = {0.f, 0.f};
    if (has_own) {
      const int kn = own * BN;
      // the maxima after tile own - 1 (published by the other warpgroup, or
      // by this one two tiles ago and already applied)
      float m_prev[2] = {-INFINITY, -INFINITY};
      if (own > 0) {
        mbar_wait(&ready[(own - 1) & 1], ((own - 1) >> 1) & 1);
#pragma unroll
        for (int i = 0; i < 2; ++i) m_prev[i] = m_buf[((own - 1) & 1) * BM + warp * 16 + g + 8 * i];
      }
      const bool need_mask = kn + BN - 1 > lim_first || kn + BN > sk;
#pragma unroll
      for (int j = 0; j < BN / 8; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          float x = __fmul_rn(s[4 * j + e], p.scale_log2);
          if (need_mask) {
            const int col = kn + 8 * j + 2 * t4 + (e & 1);
            if (col >= sk || col > lim[e >> 1]) x = -INFINITY;
          }
          s[4 * j + e] = x;
        }
      }
      float m_new[2];
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        float mx = -INFINITY;
#pragma unroll
        for (int j = 0; j < BN / 8; ++j)
          mx = fmaxf(mx, fmaxf(s[4 * j + 2 * i], s[4 * j + 2 * i + 1]));
        m_new[i] = fmaxf(m_prev[i], quad_max(mx));
        // a row that has seen no key yet keeps m = -inf; exponentiate
        // against 0 so that it gives 0 and not NaN
        const float m_safe = m_new[i] == -INFINITY ? 0.f : m_new[i];
        own_c[i] = exp2_ftz(m_prev[i] - m_safe);
        float rs = 0.f;
#pragma unroll
        for (int j = 0; j < BN / 8; ++j) {
          s[4 * j + 2 * i] = exp2_ftz(s[4 * j + 2 * i] - m_safe);
          s[4 * j + 2 * i + 1] = exp2_ftz(s[4 * j + 2 * i + 1] - m_safe);
          rs += s[4 * j + 2 * i] + s[4 * j + 2 * i + 1];
        }
        own_rs[i] = rs;
      }
      // V rows past the keys of the ragged tile: zeros (whole 128-byte rows
      // of each V panel, so the swizzle does not matter)
      if (kn + BN > sk) {
        const int first = sk - kn;
        const int per_panel = (BN - first) * 8;  // 16-byte chunks
        for (int i = tid & 127; i < per_panel * (Dm::DV / 64); i += 128) {
          const int c = i / per_panel;
          const int r = first + (i - c * per_panel) / 8;
          *reinterpret_cast<uint4*>(Ks + (D / 64 + c) * PANEL + r * 128 + (i & 7) * 16) =
              make_uint4(0, 0, 0, 0);
        }
      }
      // P into the tile's first K panel, the maxima and factors beside it
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int r = warp * 16 + g + 8 * i;
#pragma unroll
        for (int j = 0; j < BN / 8; ++j)
          *reinterpret_cast<uint32_t*>(Ks + swz128(r, 8 * j + 2 * t4)) =
              Elem<T>::pack(s[4 * j + 2 * i], s[4 * j + 2 * i + 1]);
        if (t4 == 0) {
          m_buf[wg * BM + r] = m_new[i];
          c_buf[wg * BM + r] = own_c[i];
        }
      }
      fence_proxy_async();  // P and the zeroed rows before wgmma reads them
      mbar_arrive(&ready[wg]);
    }

    // O += P V for the pair's tiles in order, each rescaled first
#pragma unroll
    for (int k = 0; k < 2; ++k) {
      const int n = n0 + k;
      if (n >= n_tiles) break;
      unsigned char* Ps = stage(k);
      mbar_wait(&ready[k], (n >> 1) & 1);
      const bool mine = n == own;
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int r = warp * 16 + g + 8 * i;
        const float c = mine ? own_c[i] : c_buf[k * BM + r];
        m_r[i] = m_buf[k * BM + r];
        l_r[i] = __fmaf_rn(l_r[i], c, mine ? own_rs[i] : 0.f);
#pragma unroll
        for (int b = 0; b < DVH / NB; ++b)
#pragma unroll
          for (int j = 0; j < NB / 8; ++j) {
            o[b][4 * j + 2 * i] = __fmul_rn(o[b][4 * j + 2 * i], c);
            o[b][4 * j + 2 * i + 1] = __fmul_rn(o[b][4 * j + 2 * i + 1], c);
          }
      }
#pragma unroll
      for (int b = 0; b < DVH / NB; ++b) fence_regs(o[b]);
      wgmma_fence();
#pragma unroll
      for (int b = 0; b < DVH / NB; ++b) {
        const unsigned char* Vs = Ps + (D / 64 + (wg * DVH + b * NB) / 64) * PANEL;
#pragma unroll
        for (int kk = 0; kk < BN / 16; ++kk)
          wgmma_ss<T, NB, 0, 1>(o[b], Tile<BM, 64>::k_slice(Ps, 0, kk),
                                desc_mn(Vs + 16 * kk * 128, PANEL), 1);
      }
      wgmma_commit();
      wgmma_wait<0>();
#pragma unroll
      for (int b = 0; b < DVH / NB; ++b) fence_regs(o[b]);
      mbar_arrive(&empty[k]);
      if (issuer && n + 2 < n_tiles) {
        mbar_wait(&empty[k], (n >> 1) & 1);  // both warpgroups are done with tile n
        issue_keys(n + 2);
      }
    }
  }

  // the row sums over both warpgroups; both are then past their last score
  // product, so O may be staged in the Q panels
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    l_r[i] = quad_sum(l_r[i]);
    if (t4 == 0) l_buf[wg * BM + warp * 16 + g + 8 * i] = l_r[i];
  }
  __syncthreads();
  unsigned char* ow = Qs + (wg * DVH / 64) * PANEL;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = warp * 16 + g + 8 * i;
    const float l = l_r[i] + l_buf[(wg ^ 1) * BM + r];
    const float inv = l == 0.f ? 0.f : 1.f / l;
#pragma unroll
    for (int b = 0; b < DVH / NB; ++b)
#pragma unroll
      for (int j = 0; j < NB / 8; ++j) {
        const int col = b * NB + 8 * j + 2 * t4;  // within the half
        *reinterpret_cast<uint32_t*>(ow + (col / 64) * PANEL + swz128(r, col % 64)) =
            Elem<T>::pack(o[b][4 * j + 2 * i] * inv, o[b][4 * j + 2 * i + 1] * inv);
      }
    const int pos = p0 + r / p.gb;
    if (wg == 0 && t4 == 0 && pos < sq)
      p.lse[(int64_t)(start + pos) * p.l_st + (int64_t)(head0 + r % p.gb) * p.l_sh] =
          l == 0.f ? -INFINITY : __fmaf_rn(m_r[i], FA_LN2, logf(l));
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

template <typename T, typename Dm>
cudaError_t launch(const PrefillMaps& maps, const PrefillParams& p, int b, int row_tiles,
                   cudaStream_t stream) {
  constexpr int smem = Layout<Dm>::SMEM;
  cudaError_t err = cudaFuncSetAttribute(
      paged_prefill_kernel<T, Dm>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  paged_prefill_kernel<T, Dm><<<dim3(b * p.h_k, row_tiles), THREADS, smem, stream>>>(maps, p);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_form(const PrefillMaps& maps, const PrefillParams& p, int b,
                        int row_tiles, int d, int dv, cudaStream_t stream) {
  if (d == 64 && dv == 512) return launch<T, Dims<64, 512>>(maps, p, b, row_tiles, stream);
  if (d == 64 && dv == 128) return launch<T, Dims<64, 128>>(maps, p, b, row_tiles, stream);
  if (d == 128 && dv == 128) return launch<T, Dims<128, 128>>(maps, p, b, row_tiles, stream);
  return cudaErrorInvalidValue;
}

int gcd(int a, int b) {
  while (b) {
    const int t = a % b;
    a = b;
    b = t;
  }
  return a;
}

}  // namespace

// q (total, h, d), qv (total, h, dv) and out by element strides (token,
// head), the head dim contiguous; pages (num_pages, h_k, page_size, d) and
// (..., dv) by strides (page, head, row); lse by strides (token, head); all
// starts and strides 16-byte aligned (TMA). Sequence s owns tokens
// starts[s] .. starts[s] + lens_q[s]; row_tiles bounds, over the batch,
// ceil(lens_q[s] / PB) * (group / GB) with GB = gcd(h / h_k, 64) and PB =
// 64 / GB (blocks past a sequence's rows return at once). The forms of
// dispatch/config.py PAGED_PREFILL_DIMS, qv only. Returns a cudaError_t (0
// on success).
extern "C" int fa_paged_prefill(
    const void* q, const void* qv, const void* kp, const void* vp,
    const int* starts, const int* lens_q, const int* lens_k, const int* table,
    void* out, float* lse, int b, int total, int row_tiles, int h, int h_k, int d,
    int dv, int has_qv, int page_size, int table_width, int num_pages, int64_t q_st,
    int64_t q_sh, int64_t qv_st, int64_t qv_sh, int64_t k_sp, int64_t k_sh,
    int64_t k_ss, int64_t v_sp, int64_t v_sh, int64_t v_ss, int64_t o_st,
    int64_t o_sh, int64_t l_st, int64_t l_sh, int64_t t_sb, float scale_log2,
    int causal, int is_bf16, void* stream) {
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
  p.gb = gcd(p.group, BM);
  p.pb = BM / p.gb;
  p.head_blocks = p.group / p.gb;
  p.page_size = page_size;
  p.box_rows = gcd(page_size, BN);
  p.table_width = table_width;
  p.num_pages = num_pages;
  p.scale_log2 = scale_log2;
  p.causal = causal;
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
  if (is_bf16) return (int)launch_form<__nv_bfloat16>(maps, p, b, row_tiles, d, dv, st);
  return (int)launch_form<__half>(maps, p, b, row_tiles, d, dv, st);
}
