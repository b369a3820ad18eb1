// Split-KV decode attention over a linear or a paged KV cache for Hopper
// (sm_90a), bf16 / fp16, head dim 64 or 128.
//
// Replaces the TPU kernel flash_attn_tpu/kernels/flash_decode.py:_decode_kernel
// (linear and paged cache, causal or not, GQA, any num_splits >= 1). The
// split partials are merged by combine_splits in kernels/flash_decode.py, as
// the JAX package merges them outside its kernel.
//
// What bounds it on this card: a decode step has one (or a few) query rows
// per head, so every cached key and value is read once and used for
// 2 * rows flops per element: the kernel is bound by device-memory bandwidth
// (b * h_k * seqlen * d * 2 * 2 bytes per call), and the tensor cores have
// nothing to do.
//
// What the design does about it: one block per (batch row, KV head, split)
// handles all sq * group query rows of that KV head (the TPU kernel's GQA row
// packing), so each K/V row is read from memory once for the whole group.
// The block streams its split's share of the cache with 16-byte loads: a
// key is split across D / 8 lanes, a warp covers 32 / (D / 8) keys at once,
// and each lane keeps DEC_UNROLL keys' K and V loads in flight before it
// computes, so enough bytes are in flight to cover memory latency. The dot
// products and the online softmax run in fp32 on the ordinary ALUs, each
// key group with its own (m, l, acc) state and no barrier in the loop; the
// states are merged once at the end, by shuffles inside a warp and through
// shared memory across warps. Each block writes a normalised fp32 partial
// out and lse for its split.
//
// The paged cache (num_pages, h_k, page_size, d) replaces the paged branch
// of the same TPU kernel, which DMAs whole pages of a (b, max_pages) block
// table into VMEM. Here each key position j resolves on its own, inside the
// load, to row j % page_size of page table[b, j / page_size], so any page
// size works (16 to 256 in the engine) and a block needs no staging buffer.
// What bounds it is the same as for the linear cache: the K and V bytes of
// each key, read once (2 * h_k * d * 2 bytes a key), plus one 4-byte table
// read per key and lane that the L1 cache serves. Split boundaries stay on
// DECODE_BLOCK_K tiles of positions, so paged and linear decode sum in the
// same order. Left for later: TMA page copies into a
// shared-memory ring (one per page instead of a 16-byte load per lane),
// tensor-core products for the GQA group, and a persistent schedule.
//
// Masking is that of flash_decode.py for causal decode: with sk the cache
// length after the append, query row t sees key positions <= t + sk - sq.
// A length past the cache's capacity (s_max, or max_pages * page_size) is
// cut to it; the caller poisons such rows.

#include "common.cuh"

namespace {

constexpr int DEC_WARPS = 4;
constexpr int DEC_THREADS = DEC_WARPS * 32;
constexpr int DEC_UNROLL = 4;

struct DecodeParams {
  const void* q;        // (b, sq, h, d) by strides
  const void* kc;       // (b_c, h_k, s_max, d) or pages (P, h_k, page_size, d)
  const void* vc;
  const int* seqlens;   // (b,) cache length after the append
  const int* table;     // (b, table_width) page ids, paged cache only
  float* out_p;         // (num_splits, b, h_k, rows, d)
  float* lse_p;         // (num_splits, b, h_k, rows)
  int64_t q_sb, q_ss, q_sh;
  int64_t k_sb, k_sh, k_ss;  // k_sb: the page stride for the paged cache
  int64_t v_sb, v_sh, v_ss;
  int64_t t_sb;
  int b, sq, h_k, group, rows, num_splits, block_k;
  int page_size, table_width, num_pages, cap;
  float scale_log2;
  int causal;
};

template <typename T>
__device__ __forceinline__ void unpack8(const uint4& u, float* f) {
  using E = fa::Elem<T>;
  float2 a = E::unpack(u.x), b = E::unpack(u.y), c = E::unpack(u.z),
         d = E::unpack(u.w);
  f[0] = a.x; f[1] = a.y; f[2] = b.x; f[3] = b.y;
  f[4] = c.x; f[5] = c.y; f[6] = d.x; f[7] = d.y;
}

// Merge online-softmax state (m2, l2, acc2) into (m, l, acc), base-2 maxima.
__device__ __forceinline__ void merge_coeffs(float m, float m2, float& a,
                                             float& b2, float& m_new) {
  m_new = fmaxf(m, m2);
  const float ms = m_new == -INFINITY ? 0.f : m_new;
  a = exp2f(m - ms);
  b2 = exp2f(m2 - ms);
}

// Element offset of key position `key`, at the lane's slice of the head
// dim, from the start of the cache: row `key` of the batch row's linear
// cache, or row key % page_size of the page the table names.
template <bool PAGED>
__device__ __forceinline__ int64_t key_offset(const DecodeParams& p, int bb,
                                              int key, int64_t sb, int64_t ss) {
  if (!PAGED) return bb * sb + key * ss;
  const int col = key / p.page_size;
  const int pg = min(max(p.table[bb * p.t_sb + min(col, p.table_width - 1)], 0),
                     p.num_pages - 1);
  return pg * sb + (key - col * p.page_size) * ss;
}

// RM: query rows held per block (grid.z covers rows beyond RM).
template <typename T, int D, int RM, bool PAGED>
__global__ void __launch_bounds__(DEC_THREADS) decode_kernel(const DecodeParams p) {
  constexpr int LPK = D / 8;           // lanes per key, 8 elements each
  constexpr int KPW = 32 / LPK;        // keys per warp per load
  constexpr int KEYS_PER_STEP = DEC_WARPS * KPW;
  constexpr int KEYS_PER_ITER = KEYS_PER_STEP * DEC_UNROLL;

  __shared__ float sm_m[DEC_WARPS][RM];
  __shared__ float sm_l[DEC_WARPS][RM];
  __shared__ float sm_acc[DEC_WARPS][RM][D];

  const int bb = blockIdx.x / p.h_k;
  const int kh = blockIdx.x % p.h_k;
  const int split = blockIdx.y;
  const int r_base = blockIdx.z * RM;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int kg = lane / LPK;  // key slot within the warp
  const int dl = lane % LPK;  // which 8 elements of the head dim

  // This split's key range: the cache is cut into block_k tiles and the
  // tiles are shared out in contiguous runs, as the TPU kernel does.
  const int sk = min(p.seqlens[bb], p.cap);
  const int tiles = (sk + p.block_k - 1) / p.block_k;
  const int kps = (tiles + p.num_splits - 1) / p.num_splits;
  const int k_lo = min(sk, split * kps * p.block_k);
  const int k_hi = min(sk, (split + 1) * kps * p.block_k);

  // The block's query rows (row = t * group + j is query token t of head
  // kh * group + j), pre-scaled by softmax_scale * log2(e).
  float q[RM][8];
  int limit[RM];  // last key position the row may see
#pragma unroll
  for (int r = 0; r < RM; ++r) {
    const int row = r_base + r;
    if (row < p.rows) {
      const int t = row / p.group;
      const int hq = kh * p.group + row % p.group;
      const T* qp = reinterpret_cast<const T*>(p.q) + bb * p.q_sb + t * p.q_ss +
                    hq * p.q_sh + dl * 8;
      unpack8<T>(*reinterpret_cast<const uint4*>(qp), q[r]);
#pragma unroll
      for (int i = 0; i < 8; ++i) q[r][i] *= p.scale_log2;
      limit[r] = p.causal ? t + sk - p.sq : sk - 1;
    } else {
#pragma unroll
      for (int i = 0; i < 8; ++i) q[r][i] = 0.f;
      limit[r] = -1;
    }
  }

  float m[RM], l[RM], acc[RM][8];
#pragma unroll
  for (int r = 0; r < RM; ++r) {
    m[r] = -INFINITY;
    l[r] = 0.f;
#pragma unroll
    for (int i = 0; i < 8; ++i) acc[r][i] = 0.f;
  }

  const T* kbase = reinterpret_cast<const T*>(p.kc) + kh * p.k_sh + dl * 8;
  const T* vbase = reinterpret_cast<const T*>(p.vc) + kh * p.v_sh + dl * 8;

  for (int base = k_lo; base < k_hi; base += KEYS_PER_ITER) {
    uint4 kr[DEC_UNROLL], vr[DEC_UNROLL];
    int key[DEC_UNROLL];
#pragma unroll
    for (int u = 0; u < DEC_UNROLL; ++u) {
      key[u] = base + u * KEYS_PER_STEP + warp * KPW + kg;
      if (key[u] < k_hi) {
        kr[u] = __ldg(reinterpret_cast<const uint4*>(
            kbase + key_offset<PAGED>(p, bb, key[u], p.k_sb, p.k_ss)));
        vr[u] = __ldg(reinterpret_cast<const uint4*>(
            vbase + key_offset<PAGED>(p, bb, key[u], p.v_sb, p.v_ss)));
      } else {
        kr[u] = make_uint4(0, 0, 0, 0);
        vr[u] = make_uint4(0, 0, 0, 0);
      }
    }
#pragma unroll
    for (int u = 0; u < DEC_UNROLL; ++u) {
      float kf[8], vf[8];
      unpack8<T>(kr[u], kf);
      unpack8<T>(vr[u], vf);
#pragma unroll
      for (int r = 0; r < RM; ++r) {
        float s = 0.f;
#pragma unroll
        for (int i = 0; i < 8; ++i) s += q[r][i] * kf[i];
#pragma unroll
        for (int off = LPK / 2; off >= 1; off >>= 1)
          s += __shfl_xor_sync(0xffffffff, s, off);
        const bool ok = key[u] < k_hi && key[u] <= limit[r];
        s = ok ? s : -INFINITY;
        float a, pb, m_new;
        merge_coeffs(m[r], s, a, pb, m_new);
        m[r] = m_new;
        l[r] = l[r] * a + pb;
#pragma unroll
        for (int i = 0; i < 8; ++i) acc[r][i] = acc[r][i] * a + pb * vf[i];
      }
    }
  }

  // Merge the key groups of the warp (lanes that hold the same head slice).
#pragma unroll
  for (int off = LPK; off < 32; off <<= 1) {
#pragma unroll
    for (int r = 0; r < RM; ++r) {
      const float m2 = __shfl_xor_sync(0xffffffff, m[r], off);
      const float l2 = __shfl_xor_sync(0xffffffff, l[r], off);
      float a, b2, m_new;
      merge_coeffs(m[r], m2, a, b2, m_new);
      m[r] = m_new;
      l[r] = l[r] * a + l2 * b2;
#pragma unroll
      for (int i = 0; i < 8; ++i)
        acc[r][i] = acc[r][i] * a + __shfl_xor_sync(0xffffffff, acc[r][i], off) * b2;
    }
  }

  // Merge the warps through shared memory and write the split's partial.
  if (kg == 0) {
#pragma unroll
    for (int r = 0; r < RM; ++r) {
#pragma unroll
      for (int i = 0; i < 8; ++i) sm_acc[warp][r][dl * 8 + i] = acc[r][i];
      if (dl == 0) {
        sm_m[warp][r] = m[r];
        sm_l[warp][r] = l[r];
      }
    }
  }
  __syncthreads();

  const int64_t part = ((int64_t)split * p.b + bb) * p.h_k + kh;
  for (int idx = tid; idx < RM * D; idx += DEC_THREADS) {
    const int r = idx / D;
    const int dd = idx % D;
    const int row = r_base + r;
    if (row >= p.rows) continue;
    float mm = -INFINITY;
#pragma unroll
    for (int w = 0; w < DEC_WARPS; ++w) mm = fmaxf(mm, sm_m[w][r]);
    const float ms = mm == -INFINITY ? 0.f : mm;
    float ll = 0.f, aa = 0.f;
#pragma unroll
    for (int w = 0; w < DEC_WARPS; ++w) {
      const float f = exp2f(sm_m[w][r] - ms);
      ll += sm_l[w][r] * f;
      aa += sm_acc[w][r][dd] * f;
    }
    p.out_p[(part * p.rows + row) * D + dd] = ll == 0.f ? 0.f : aa / ll;
    if (dd == 0)
      p.lse_p[part * p.rows + row] = ll == 0.f ? -INFINITY : mm * FA_LN2 + logf(ll);
  }
}

template <typename T, int D, int RM>
cudaError_t launch_rm(const DecodeParams& p, cudaStream_t stream) {
  dim3 grid(p.b * p.h_k, p.num_splits, (p.rows + RM - 1) / RM);
  if (p.table != nullptr)
    decode_kernel<T, D, RM, true><<<grid, DEC_THREADS, 0, stream>>>(p);
  else
    decode_kernel<T, D, RM, false><<<grid, DEC_THREADS, 0, stream>>>(p);
  return cudaGetLastError();
}

template <typename T, int D>
cudaError_t launch(const DecodeParams& p, cudaStream_t stream) {
  if (p.rows <= 1) return launch_rm<T, D, 1>(p, stream);
  if (p.rows <= 2) return launch_rm<T, D, 2>(p, stream);
  if (p.rows <= 4) return launch_rm<T, D, 4>(p, stream);
  return launch_rm<T, D, 8>(p, stream);
}

}  // namespace

// table == nullptr reads a linear cache (page_size, table_width, num_pages
// and t_sb unused); otherwise kc/vc are pages and k_sb/v_sb their page
// strides. cap is the cache's capacity in positions. Returns a cudaError_t
// (0 on success).
extern "C" int fa_decode(const void* q, const void* kc, const void* vc,
                         const int* seqlens, const int* table, float* out_p,
                         float* lse_p, int b, int sq, int h, int h_k, int d,
                         int num_splits, int block_k, int page_size,
                         int table_width, int num_pages, int cap, int64_t q_sb,
                         int64_t q_ss, int64_t q_sh, int64_t k_sb, int64_t k_sh,
                         int64_t k_ss, int64_t v_sb, int64_t v_sh, int64_t v_ss,
                         int64_t t_sb, float scale_log2, int causal,
                         int is_bf16, void* stream) {
  DecodeParams p;
  p.q = q;
  p.kc = kc;
  p.vc = vc;
  p.seqlens = seqlens;
  p.table = table;
  p.out_p = out_p;
  p.lse_p = lse_p;
  p.q_sb = q_sb; p.q_ss = q_ss; p.q_sh = q_sh;
  p.k_sb = k_sb; p.k_sh = k_sh; p.k_ss = k_ss;
  p.v_sb = v_sb; p.v_sh = v_sh; p.v_ss = v_ss;
  p.t_sb = t_sb;
  p.page_size = page_size;
  p.table_width = table_width;
  p.num_pages = num_pages;
  p.cap = cap;
  p.b = b;
  p.sq = sq;
  p.h_k = h_k;
  p.group = h / h_k;
  p.rows = sq * p.group;
  p.num_splits = num_splits;
  p.block_k = block_k;
  p.scale_log2 = scale_log2;
  p.causal = causal;
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  if (is_bf16) {
    if (d == 64) return launch<__nv_bfloat16, 64>(p, st);
    if (d == 128) return launch<__nv_bfloat16, 128>(p, st);
  } else {
    if (d == 64) return launch<__half, 64>(p, st);
    if (d == 128) return launch<__half, 128>(p, st);
  }
  return (int)cudaErrorInvalidValue;
}
