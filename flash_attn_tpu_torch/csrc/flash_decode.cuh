// B4's d = dv route (csrc/flash_decode.cu) as templates over the query
// type, the head dim, the rows a block holds, the ring and the bytes of a
// cache element, shared by flash_decode.cu, which holds the C entry point
// and the instantiations over caches of q's type, flash_decode_kv8.cu,
// which holds those over 1-byte caches (bf16 q), and flash_decode_80.cu,
// which holds both kinds at head dim 80, so that the three sources build
// side by side. See flash_decode.cu for the
// design.
#pragma once

#include <cooperative_groups.h>

#include "kv8.cuh"
#include "sm90.cuh"

namespace fa {
namespace decode {

namespace cg = cooperative_groups;
using namespace fa::sm90;

constexpr int DEC_WARPS = 4;
constexpr int DEC_THREADS = DEC_WARPS * 32;
constexpr int DEC_BN = 64;  // the split granularity (DECODE_BLOCK_K)
constexpr int MAX_CLUSTER = 4;

struct DecodeParams {
  const void* q;        // (b, sq, h, d) by strides
  const int* seqlens;   // (b,) cache length after the append
  const int* table;     // (b, table_width) page ids, or nullptr (linear cache)
  float* out_p;         // (num_splits, b, h_k, rows, d)
  float* lse_p;         // (num_splits, b, h_k, rows)
  int64_t q_sb, q_ss, q_sh, t_sb;
  int b, sq, h_k, group, rows, num_splits;
  int page_size, box_rows, table_width, num_pages, cap;  // box_rows: set by the ring
  float scale_log2;
  Band band;  // right 0 for causal decode; sink unused
  float cap_in, cap_out;  // 1 / (log2(e) softcap) and softcap log2(e); 0: no cap
  const float* slopes;    // (b, h) fp32 at slopes[bb * slope_sb + hq], or nullptr
  int64_t slope_sb;
  int causal;             // the form of ALiBi's bias
  int kv_code;            // the cache's codes: KV_E4M3 or KV_INT8 (1-byte caches)
  const float* qk_descale;  // (b, h_k) q_descale * k_descale, or nullptr (ones)
  const float* v_descale;   // (b, h_k), or nullptr (ones)
};

struct DecodeMaps {
  CUtensorMap k, v;
};

// The K and V caches as the host sees them: (num_pages, h_k, page_size, d)
// by element strides (page, head, row).
struct CacheView {
  const void* k;
  const void* v;
  int64_t k_sb, k_sh, k_ss, v_sb, v_sh, v_ss;
  int d, is_bf16;
};

// The ring: S stages of a K tile then a V tile (TK rows of D elements of
// KVB bytes, row after row), then the warps' (m, l, acc) states for the
// merge, then a barrier a stage, then the rows' ALiBi slopes and bias bases.
template <int D, int RM, int TK, int S, int KVB>
struct DecLayout {
  static constexpr int TILE_BYTES = TK * D * KVB;
  static constexpr int STAGE_BYTES = 2 * TILE_BYTES;
  static constexpr int MERGE_OFF = S * STAGE_BYTES;  // the warps' states
  static constexpr int BAR_OFF = MERGE_OFF + DEC_WARPS * RM * (D + 2) * 4;
  static constexpr int ROW_OFF = BAR_OFF + 8 * S;
  static constexpr int BYTES = ROW_OFF + 8 * RM;
  static constexpr int SMEM = BYTES + 1024;
};

// The two rings (TK keys a staged tile, S stages): a deep one of 64-key
// tiles, 96 KB at head dim 128, for grids of clusters, which leave SMs
// idle and give each block a long run of tiles; a shallow one of 16-key
// tiles, 16 KB, for a full grid (the engine's 64 slots), where more blocks
// an SM cover each block's first copies (PERF.md PR 11 timed 16- and
// 32-key tiles of 2 to 4 stages there).
// The deep ring by staged width: 4 stages of 64 keys at 64 (64 KB), 3 at
// 128 (96 KB), 2 stages of 32 keys at 256 (64 KB and a merge area of up to
// 33 KB), so that two blocks share an SM at every width
// (dispatch/config.py DECODE_BLOCKS_PER_SM) and a thread's keys of a tile
// (16 a warp of 64 keys at 256, one a warp step) do not spill at 8 rows.
constexpr int NARROW_TK = 16, NARROW_S = 2;
template <int DS>
constexpr int wide_tk() { return DS == 256 ? 32 : 64; }
template <int DS>
constexpr int wide_stages() { return DS == 64 ? 4 : DS == 128 ? 3 : 2; }

// Columns a staged K or V row takes: the head dim, 80 and 96 padded to 128
// so that a key's lanes divide a warp.
template <int D>
__host__ __device__ constexpr int staged_dim() { return D == 80 || D == 96 ? 128 : D; }

template <typename T>
__device__ __forceinline__ void unpack8(const uint4& u, float* f) {
  using E = fa::Elem<T>;
  float2 a = E::unpack(u.x), b = E::unpack(u.y), c = E::unpack(u.z),
         d = E::unpack(u.w);
  f[0] = a.x; f[1] = a.y; f[2] = b.x; f[3] = b.y;
  f[4] = c.x; f[5] = c.y; f[6] = d.x; f[7] = d.y;
}

// A lane's 8 elements of a staged K or V row as floats: 16 bytes of T, or
// (KVB 1) 8 bytes of codes converted on load (kv8.cuh, B11's role).
template <typename T, int KVB>
__device__ __forceinline__ void load8(const unsigned char* src, int code, float* f) {
  if constexpr (KVB == 2)
    unpack8<T>(*reinterpret_cast<const uint4*>(src), f);
  else
    kv8_to_float8(*reinterpret_cast<const uint2*>(src), code, f);
}

// Merge online-softmax state (m2, l2, acc2) into (m, l, acc), base-2 maxima.
__device__ __forceinline__ void merge_coeffs(float m, float m2, float& a,
                                             float& b2, float& m_new) {
  m_new = fmaxf(m, m2);
  const float ms = m_new == -INFINITY ? 0.f : m_new;
  a = exp2f(m - ms);
  b2 = exp2f(m2 - ms);
}

// The lowest key query position rs = t + sk - sq may see under the band's
// lower bounds (negative: none).
__device__ __forceinline__ int band_first_key(const Band& b, int rs) {
  const int lo = rs - b.left;
  return b.chunk > 0 ? max(lo, b.chunk_lo(rs)) : lo;
}

// A block's item: a (batch row, KV head, split, block of RM rows) and the
// block's share of the split's 64-key tiles, keys from k_lo in n staged
// tiles of TK keys (the last may end past k_hi).
struct DecItem {
  int bb, kh, split, r_base, sk, k_hi, k_lo, n;
  __device__ __forceinline__ DecItem(const DecodeParams& p, int item, int rm, int tk,
                                     int csize, int rank) {
    const int heads = p.b * p.h_k;
    const int x = item % heads;
    const int yz = item / heads;
    bb = x / p.h_k;
    kh = x - bb * p.h_k;
    split = yz % p.num_splits;
    r_base = (yz / p.num_splits) * rm;
    // the cache cut into 64-key tiles, shared out to the splits in
    // contiguous runs (as the TPU kernel does), a split's run to the
    // cluster's blocks in contiguous shares
    // (from the band's first tile: the lowest key query token 0 sees)
    sk = min(p.seqlens[bb], p.cap);
    const int tiles = (sk + DEC_BN - 1) / DEC_BN;
    const int t0 = min(tiles, max(0, band_first_key(p.band, sk - p.sq)) / DEC_BN);
    const int kps = (tiles - t0 + p.num_splits - 1) / p.num_splits;
    const int t_lo = min(tiles, t0 + split * kps);
    const int t_hi = min(tiles, t_lo + kps);
    k_hi = min(sk, t_hi * DEC_BN);
    const int per = (t_hi - t_lo + csize - 1) / csize;
    const int c_lo = min(t_hi, t_lo + rank * per);
    const int c_hi = min(t_hi, c_lo + per);
    k_lo = c_lo * DEC_BN;
    n = c_hi > c_lo ? (min(k_hi, c_hi * DEC_BN) - k_lo + tk - 1) / tk : 0;
  }
};

// RM: query rows an item holds (the items cover the rest in row blocks).
// Item blockIdx.x / CLUSTER, block rank blockIdx.x % CLUSTER of its
// cluster. TK, S: the ring. KVB: bytes a cache element (2: T; 1: the codes
// of p.kv_code, converted on load, with q in T = bf16).
template <typename T, int D, int RM, int TK, int S, int KVB>
__global__ void __launch_bounds__(DEC_THREADS)
    decode_kernel(const __grid_constant__ DecodeMaps maps, const DecodeParams p) {
  constexpr int DS = staged_dim<D>();
  using L = DecLayout<DS, RM, TK, S, KVB>;
  constexpr int LPK = DS / 8;           // lanes per key, 8 elements each
  constexpr int KPW = 32 / LPK;         // keys per warp per step
  constexpr int KEYS_PER_WARP = TK / DEC_WARPS;
  constexpr int U = KEYS_PER_WARP / KPW;  // keys of a lane's group a tile
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = align_1024(smem_raw);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + L::BAR_OFF);
  float* sm_m = reinterpret_cast<float*>(smem + L::MERGE_OFF);  // [DEC_WARPS][RM]
  float* sm_l = sm_m + DEC_WARPS * RM;                           // [DEC_WARPS][RM]
  float* sm_acc = sm_l + DEC_WARPS * RM;                         // [DEC_WARPS][RM][DS]
  float* sm_slope = reinterpret_cast<float*>(smem + L::ROW_OFF);  // [RM], times log2(e)
  int* sm_base = reinterpret_cast<int*>(sm_slope + RM);           // [RM], the bias's base

  const cg::cluster_group cluster = cg::this_cluster();
  const int csize = (int)cluster.num_blocks();
  const int rank = (int)cluster.block_rank();
  const DecItem it(p, blockIdx.x / csize, RM, TK, csize, rank);
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int kg = lane / LPK;  // key slot within the warp
  const int dl = lane % LPK;  // which 8 elements of the staged row

  const PagedRows pages{p.table == nullptr ? nullptr : p.table + (int64_t)it.bb * p.t_sb,
                        it.bb, p.page_size, p.table_width, p.num_pages};
  auto issue = [&](int i) {  // tile i into stage i % S (one thread)
    unsigned char* dst = smem + (i % S) * L::STAGE_BYTES;
    const int key0 = it.k_lo + i * TK;
    mbar_expect_tx(&full[i % S], L::STAGE_BYTES);
    for (int r = 0; r < TK; r += p.box_rows) {
      int pg, row;
      pages.locate(key0 + r, pg, row);
      tma_load_4d(dst + r * DS * KVB, &maps.k, &full[i % S], 0, row, it.kh, pg);
      tma_load_4d(dst + L::TILE_BYTES + r * DS * KVB, &maps.v, &full[i % S], 0, row, it.kh, pg);
    }
  };

  if (tid == 0) {
    for (int s = 0; s < S; ++s) mbar_init(&full[s], 1);
    fence_barrier_init();
  }
  if (p.slopes != nullptr && tid < RM) {
    // row t * group + j: query head kh * group + j; the bias is
    // key + base under causal masking (base 1 - sk), else -|base - key|
    // (base t + sk - sq)
    const int row = min(it.r_base + tid, p.rows - 1);
    const int hq = it.kh * p.group + row % p.group;
    sm_slope[tid] = p.slopes[it.bb * p.slope_sb + hq] * FA_LOG2E;
    sm_base[tid] = p.causal ? 1 - it.sk : row / p.group + it.sk - p.sq;
  }
  __syncthreads();
  if (tid == 0)
    for (int i = 0; i < S && i < it.n; ++i) issue(i);

  // The item's query rows (row = t * group + j is query token t of head
  // kh * group + j), pre-scaled by softmax_scale * log2(e) and the item's
  // q_descale * k_descale (flash_decode.py:248-249; with a cap there is
  // none: the wrapper refuses the two together); the lanes of a staged
  // row's padding hold zeros.
  const int64_t dix = (int64_t)it.bb * p.h_k + it.kh;
  const float q_scale =
      p.qk_descale == nullptr ? p.scale_log2 : p.scale_log2 * p.qk_descale[dix];
  float q[RM][8];
  int limit[RM];  // last key position the row may see
  int first[RM];  // first key position the row may see
#pragma unroll
  for (int r = 0; r < RM; ++r) {
    const int row = it.r_base + r;
    if (row < p.rows) {
      const int t = row / p.group;
      const int hq = it.kh * p.group + row % p.group;
      const T* qp = reinterpret_cast<const T*>(p.q) + it.bb * p.q_sb + t * p.q_ss +
                    hq * p.q_sh + dl * 8;
      if (DS == D || dl * 8 < D) {
        unpack8<T>(*reinterpret_cast<const uint4*>(qp), q[r]);
#pragma unroll
        for (int e = 0; e < 8; ++e) q[r][e] *= q_scale;
      } else {
#pragma unroll
        for (int e = 0; e < 8; ++e) q[r][e] = 0.f;
      }
      limit[r] = min(it.k_hi - 1, min(it.sk - 1, t + it.sk - p.sq + p.band.right));
      first[r] = band_first_key(p.band, t + it.sk - p.sq);
    } else {
#pragma unroll
      for (int e = 0; e < 8; ++e) q[r][e] = 0.f;
      limit[r] = -1;
      first[r] = 0;
    }
  }

  float m[RM], l[RM], acc[RM][8];
#pragma unroll
  for (int r = 0; r < RM; ++r) {
    m[r] = -INFINITY;
    l[r] = 0.f;
#pragma unroll
    for (int e = 0; e < 8; ++e) acc[r][e] = 0.f;
  }

  // Each tile: for each row, the scores of this lane's U keys (U
  // independent dot products, reduced across their LPK lanes together),
  // then one online-softmax step over them: one rescale of the row's state
  // a tile, one exp2 a key.
  for (int i = 0; i < it.n; ++i) {
    const unsigned char* Kt = smem + (i % S) * L::STAGE_BYTES + dl * 8 * KVB;
    const unsigned char* Vt = Kt + L::TILE_BYTES;
    const int kl0 = warp * KEYS_PER_WARP + kg;  // the lane's first key in the tile
    const int key0 = it.k_lo + i * TK + kl0;
    mbar_wait(&full[i % S], (i / S) & 1);
#pragma unroll
    for (int r = 0; r < RM; ++r) {
      float s[U];
#pragma unroll
      for (int u = 0; u < U; ++u) {
        float kf[8];
        load8<T, KVB>(Kt + (kl0 + u * KPW) * DS * KVB, p.kv_code, kf);
        s[u] = 0.f;
#pragma unroll
        for (int e = 0; e < 8; ++e) s[u] += q[r][e] * kf[e];
      }
#pragma unroll
      for (int off = LPK / 2; off >= 1; off >>= 1)
#pragma unroll
        for (int u = 0; u < U; ++u) s[u] += __shfl_xor_sync(0xffffffff, s[u], off);
      if (p.cap_in != 0.f) {
#pragma unroll
        for (int u = 0; u < U; ++u)
          s[u] = __fmul_rn(tanh_approx(__fmul_rn(s[u], p.cap_in)), p.cap_out);
      }
      if (p.slopes != nullptr) {
        const float sl = sm_slope[r];
        const int base = sm_base[r];
#pragma unroll
        for (int u = 0; u < U; ++u) {
          const int key = key0 + u * KPW;
          const int bias = p.causal ? key + base : -abs(base - key);
          s[u] = __fmaf_rn(sl, (float)bias, s[u]);
        }
      }
      float mx = -INFINITY;
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const int key = key0 + u * KPW;
        if (key > limit[r] || key < first[r]) s[u] = -INFINITY;  // the same for the key's lanes
        mx = fmaxf(mx, s[u]);
      }
      const float m_new = fmaxf(m[r], mx);
      const float ms = m_new == -INFINITY ? 0.f : m_new;
      const float corr = exp2f(m[r] - ms);
      m[r] = m_new;
      l[r] *= corr;
#pragma unroll
      for (int e = 0; e < 8; ++e) acc[r][e] *= corr;
#pragma unroll
      for (int u = 0; u < U; ++u) {
        if (s[u] == -INFINITY) continue;  // a masked key's V may be NaN
        const float pb = exp2f(s[u] - ms);
        float vf[8];
        load8<T, KVB>(Vt + (kl0 + u * KPW) * DS * KVB, p.kv_code, vf);
        l[r] += pb;
#pragma unroll
        for (int e = 0; e < 8; ++e) acc[r][e] += pb * vf[e];
      }
    }
    __syncthreads();  // every warp is done with stage i % S
    if (tid == 0 && i + S < it.n) issue(i + S);
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
      for (int e = 0; e < 8; ++e)
        acc[r][e] = acc[r][e] * a + __shfl_xor_sync(0xffffffff, acc[r][e], off) * b2;
    }
  }

  // Each warp's state into the merge area; the block merges its warps (an
  // element a thread) into the area's first slot, then rank 0 merges the
  // cluster's blocks, rank by rank, and writes the split's partial.
  if (kg == 0) {
#pragma unroll
    for (int r = 0; r < RM; ++r) {
#pragma unroll
      for (int e = 0; e < 8; ++e) sm_acc[(warp * RM + r) * DS + dl * 8 + e] = acc[r][e];
      if (dl == 0) {
        sm_m[warp * RM + r] = m[r];
        sm_l[warp * RM + r] = l[r];
      }
    }
  }
  __syncthreads();
  constexpr int EPT = (RM * DS + DEC_THREADS - 1) / DEC_THREADS;  // elements a thread
  float bm[EPT], bl[EPT], ba[EPT];
#pragma unroll
  for (int j = 0; j < EPT; ++j) {
    const int idx = min(tid + j * DEC_THREADS, RM * DS - 1);
    const int r = idx / DS;
    float mm = -INFINITY;
#pragma unroll
    for (int w = 0; w < DEC_WARPS; ++w) mm = fmaxf(mm, sm_m[w * RM + r]);
    const float ms = mm == -INFINITY ? 0.f : mm;
    float ll = 0.f, aa = 0.f;
#pragma unroll
    for (int w = 0; w < DEC_WARPS; ++w) {
      const float f = exp2f(sm_m[w * RM + r] - ms);
      ll += sm_l[w * RM + r] * f;
      aa += sm_acc[(w * RM + r) * DS + idx % DS] * f;
    }
    bm[j] = mm;
    bl[j] = ll;
    ba[j] = aa;
  }
  __syncthreads();  // every warp state has been read
#pragma unroll
  for (int j = 0; j < EPT; ++j) {
    const int idx = tid + j * DEC_THREADS;
    if (idx >= RM * DS) break;
    sm_acc[idx] = ba[j];
    if (idx % DS == 0) {
      sm_m[idx / DS] = bm[j];
      sm_l[idx / DS] = bl[j];
    }
  }
  cluster.sync();
  if (rank == 0) {
    const int64_t part = ((int64_t)it.split * p.b + it.bb) * p.h_k + it.kh;
    // v_descale scales the split's normalised out (flash_decode.py:307-308)
    const float vd = p.v_descale == nullptr ? 1.f : p.v_descale[dix];
#pragma unroll
    for (int j = 0; j < EPT; ++j) {
      const int idx = tid + j * DEC_THREADS;
      if (idx >= RM * DS) break;
      const int r = idx / DS;
      const int col = idx % DS;
      const int row = it.r_base + r;
      // the cluster's blocks' states, read together (at most MAX_CLUSTER)
      float cm[MAX_CLUSTER], cl[MAX_CLUSTER], ca[MAX_CLUSTER];
#pragma unroll
      for (int c = 0; c < MAX_CLUSTER; ++c) {
        if (c < csize) {
          cm[c] = *cluster.map_shared_rank(sm_m + r, c);
          cl[c] = *cluster.map_shared_rank(sm_l + r, c);
          ca[c] = *cluster.map_shared_rank(sm_acc + idx, c);
        }
      }
      float mm = -INFINITY;
#pragma unroll
      for (int c = 0; c < MAX_CLUSTER; ++c)
        if (c < csize) mm = fmaxf(mm, cm[c]);
      const float ms = mm == -INFINITY ? 0.f : mm;
      float ll = 0.f, aa = 0.f;
#pragma unroll
      for (int c = 0; c < MAX_CLUSTER; ++c) {
        if (c < csize) {
          const float f = exp2f(cm[c] - ms);
          ll += cl[c] * f;
          aa += ca[c] * f;
        }
      }
      if (row >= p.rows) continue;
      if (col < D) p.out_p[(part * p.rows + row) * D + col] = ll == 0.f ? 0.f : aa / ll * vd;
      if (col == 0)
        p.lse_p[part * p.rows + row] = ll == 0.f ? -INFINITY : mm * FA_LN2 + logf(ll);
    }
  }
  cluster.sync();  // the merge areas stay until rank 0 has read them
}

// The maps with boxes of gcd(page_size, TK) rows (a box stays within a page
// and a staged tile) by the staged row's columns (of 1-byte codes with KVB
// 1), and the launch.
template <typename T, int D, int RM, int TK, int S, int KVB>
cudaError_t launch_ring(const CacheView& c, DecodeParams p, int cluster, cudaStream_t stream) {
  constexpr int DS = staged_dim<D>();
  constexpr int smem = DecLayout<DS, RM, TK, S, KVB>::SMEM;
  p.box_rows = min(gcd64(p.page_size), TK);  // powers of two, so gcd(page_size, TK)
  const CUtensorMapDataType type =
      KVB == 1 ? CU_TENSOR_MAP_DATA_TYPE_UINT8
               : c.is_bf16 ? CU_TENSOR_MAP_DATA_TYPE_BFLOAT16 : CU_TENSOR_MAP_DATA_TYPE_FLOAT16;
  DecodeMaps maps;
  cudaError_t err;
  if ((err = make_typed_map<4>(&maps.k, c.k, type, KVB, {D, p.page_size, p.h_k, p.num_pages},
                               {c.k_ss, c.k_sh, c.k_sb}, p.box_rows, 1, DS, false)) ||
      (err = make_typed_map<4>(&maps.v, c.v, type, KVB, {D, p.page_size, p.h_k, p.num_pages},
                               {c.v_ss, c.v_sh, c.v_sb}, p.box_rows, 1, DS, false)))
    return err;
  auto kernel = decode_kernel<T, D, RM, TK, S, KVB>;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim =
      dim3((unsigned)((int64_t)p.b * p.h_k * p.num_splits * ((p.rows + RM - 1) / RM) * cluster));
  cfg.blockDim = dim3(DEC_THREADS);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, kernel, maps, p);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

// Clusters take the deep ring, one block a split the shallow one (the same
// rings for 1-byte caches: their stages take half the bytes).
template <typename T, int D, int RM, int KVB>
cudaError_t launch_rm(const CacheView& c, const DecodeParams& p, int cluster,
                      cudaStream_t stream) {
  if (cluster > 1)
    return launch_ring<T, D, RM, wide_tk<staged_dim<D>()>(), wide_stages<staged_dim<D>()>(),
                       KVB>(c, p, cluster, stream);
  return launch_ring<T, D, RM, NARROW_TK, NARROW_S, KVB>(c, p, cluster, stream);
}

template <typename T, int D, int KVB>
cudaError_t launch(const CacheView& c, const DecodeParams& p, int cluster,
                   cudaStream_t stream) {
  if (p.rows <= 1) return launch_rm<T, D, 1, KVB>(c, p, cluster, stream);
  if (p.rows <= 2) return launch_rm<T, D, 2, KVB>(c, p, cluster, stream);
  if (p.rows <= 4) return launch_rm<T, D, 4, KVB>(c, p, cluster, stream);
  return launch_rm<T, D, 8, KVB>(c, p, cluster, stream);
}

template <typename T, int KVB>
cudaError_t launch_d(const CacheView& c, const DecodeParams& p, int cluster, cudaStream_t st) {
  switch (c.d) {
    case 64: return launch<T, 64, KVB>(c, p, cluster, st);
    case 96: return launch<T, 96, KVB>(c, p, cluster, st);
    case 128: return launch<T, 128, KVB>(c, p, cluster, st);
    default: return launch<T, 256, KVB>(c, p, cluster, st);
  }
}

// The instantiations over 1-byte caches (bf16 q), in csrc/flash_decode_kv8.cu.
cudaError_t run_decode_kv8(const CacheView& c, const DecodeParams& p, int cluster,
                           cudaStream_t st);

// The instantiations at head dim 80, over caches of q's type and of 1-byte
// codes, in csrc/flash_decode_80.cu.
cudaError_t run_decode_80(const CacheView& c, const DecodeParams& p, int cluster,
                          cudaStream_t st);


}  // namespace decode
}  // namespace fa
