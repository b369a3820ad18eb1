// Dense attention backward for Hopper (sm_90a) on wgmma and TMA, bf16 /
// fp16, head dim 64 or 128.
//
// Replaces the TPU kernels flash_attn_tpu/kernels/flash_bwd.py:_dkdv_kernel
// and :_dq_kernel (the deterministic two-kernel backward),
// flash_attn_tpu/kernels/flash_bwd_fused.py:_bwd_fused_kernel (the fused
// single pass) and flash_attn_tpu/kernels/flash_bwd_split.py:
// _bwd_diag_merge_kernel (the causal diagonal as a second launch), and the
// XLA op that computed delta before them (flash_bwd.py:406-413). Three
// kernels:
//
//  - preprocess_kernel: delta = rowsum(dO * O) in fp32 and lse in base 2,
//    one warp per (row, head), into (b, h, sq_pad) buffers padded to the
//    tiles (delta 0 and lse +inf past sq, so a padded row's P is 0); for the
//    fused path it also zeroes the fp32 dQ buffer;
//  - dkdv_kernel<ACCUM_DQ = false>: one block per (128 KV rows, KV head,
//    batch row) walks the group's query heads and the 64-row q tiles of its
//    causal band, keeps dK and dV in registers and writes them once
//    (deterministic); dq_kernel: one block per (128 q rows, head, batch row)
//    walks the 64-key tiles of its band and writes dQ once (deterministic);
//  - dkdv_kernel<ACCUM_DQ = true>: the fused single pass, which also adds
//    each q tile's dQ = dS K over the block's 128 keys into a zeroed fp32
//    buffer with vector reductions (red.global.add.v2.f32), each element
//    once a block; the order of the adds varies, so its last bits may vary
//    from run to run.
//
// What bounds it on this card: tensor cores. Per (q tile, KV tile) pair the
// two-kernel form runs 7 tile products (S and dP twice) and the fused form
// 5, against 2 in the forward: at the training shape (b = 4, s = 2048,
// h = 16, d = 128, causal) 172 GFLOP of useful products, 0.17 ms at 989
// TFLOP/s, while its bytes take 0.04 ms at 3.35 TB/s.
//
// What the design does about it (csrc/bwd_sm90.cuh): every product is a
// warpgroup wgmma, the only way to the card's full tensor-core rate. Two
// warpgroups of 64 rows share a block; K and V (dK/dV kernel) or Q and dO
// (dQ kernel) are loaded once by TMA and stay in shared memory, and the
// streamed tiles run through a two-stage ring: one thread issues the TMA
// loads (and the bulk copies of lse and delta) of tile t + 1 as tile t
// starts, so no tile waits for its own load. The transposed scores
// S^T = K Q^T put the KV rows in wgmma's M, so P^T and dS^T pack from the
// accumulators straight into the register A operand of dV += P^T dO and
// dK += dS^T Q (dQ += dS K likewise in the dQ kernel), and Q, dO and K are
// read transposed through the descriptors' transpose bit. Each thread keeps
// 64 + 64 fp32 accumulators of dK and dV at d = 128 within the 255 registers
// that a 256-thread block allows, so no register rebalancing
// (setmaxnreg) or separate producer warp is needed. One block barrier a
// tile keeps the two warpgroups in step: freeing each stage by mbarrier
// arrivals instead, a third stage, or issuing the next tile's products
// before the last one's end let them drift and made both kernels slower on
// the card (PERF.md §6). The fused form stages both warpgroups' dS^T
// (8 KB each; zeros from a warpgroup whose keys see no row of the tile, so
// that no product is skipped by a branch) in shared memory, and each
// warpgroup computes one 64-column half of dQ = dS K over all 128 keys:
// half the reductions of one partial a warpgroup. Only the
// tiles that cross the causal diagonal or the ragged end of the keys run
// the mask; rows past sq take P = 0 from their padded lse. Blocks are
// launched heaviest first (the first KV tiles, the last q tiles, under
// causal masking).
//
// Conventions: softmax_scale is natural; lse is natural-log (b, h, sq) and
// -inf for a row that sees no key (its P is 0). Causal masking is
// bottom-right aligned (shift = sk - sq). The tensor maps are encoded on the
// host for every call by cuTensorMapEncodeTiled, a CUDA driver API function
// reached with cudaGetDriverEntryPoint so that only the runtime is linked.

#include <cudaTypedefs.h>

#include "bwd_sm90.cuh"

namespace {

using namespace fa::sm90;

constexpr int THREADS = 256;  // two consumer warpgroups
constexpr int STAGES = 2;
constexpr int KV_ROWS = 128;  // dK/dV block: KV rows (64 a warpgroup)
constexpr int KV_BM = 64;     // dK/dV block: q rows of a streamed tile
constexpr int Q_ROWS = 128;   // dQ block: q rows (64 a warpgroup)
constexpr int Q_BN = 64;      // dQ block: keys of a streamed tile
constexpr int ROW_PAD = 128;  // lse2 / delta rows are padded to this
constexpr int PRE_ROWS = 8;   // preprocess: rows (warps) a block

struct BwdMaps {
  CUtensorMap q, k, v, dout;
};

struct BwdParams {
  const float* lse2;   // (b, h, sq_pad): lse * log2(e), +inf for P = 0
  const float* delta;  // (b, h, sq_pad)
  void* dq;            // dq kernel: (b, sq, h, d) in q's type
  void* dk;
  void* dv;
  float* dq_accum;  // fused dkdv: (b, sq, h, d) fp32, zeroed
  int64_t dq_sb, dq_ss, dq_sh;
  int64_t dk_sb, dk_ss, dk_sh;
  int64_t dv_sb, dv_ss, dv_sh;
  int sq, sk, sq_pad, h, group;
  float scale, scale_log2;
  int causal;
};

template <typename T>
__device__ __forceinline__ void store_pair(T* dst, float lo, float hi) {
  *reinterpret_cast<uint32_t*>(dst) = fa::Elem<T>::pack(lo, hi);
}

// ---- preprocess -------------------------------------------------------------

template <typename T, int D>
__global__ void __launch_bounds__(PRE_ROWS * 32)
    preprocess_kernel(const T* __restrict__ dout, const T* __restrict__ out,
                      const float* __restrict__ lse, float* __restrict__ lse2,
                      float* __restrict__ delta, float* __restrict__ dq_accum,
                      int sq, int sq_pad, int h, int64_t do_sb, int64_t do_ss,
                      int64_t do_sh, int64_t o_sb, int64_t o_ss, int64_t o_sh) {
  constexpr int PER = D / 32;  // elements a lane
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * PRE_ROWS + (threadIdx.x >> 5);
  const int hh = blockIdx.y;
  const int bb = blockIdx.z;
  if (row >= sq_pad) return;
  const int64_t idx = ((int64_t)bb * h + hh) * sq_pad + row;
  if (row >= sq) {
    if (lane == 0) {
      delta[idx] = 0.f;
      lse2[idx] = INFINITY;
    }
    return;
  }
  const T* dr = dout + bb * do_sb + row * do_ss + hh * do_sh + lane * PER;
  const T* orow = out + bb * o_sb + row * o_ss + hh * o_sh + lane * PER;
  float acc = 0.f;
#pragma unroll
  for (int i = 0; i < PER; i += 2) {
    const float2 a = fa::Elem<T>::unpack(*reinterpret_cast<const uint32_t*>(dr + i));
    const float2 o = fa::Elem<T>::unpack(*reinterpret_cast<const uint32_t*>(orow + i));
    acc = fmaf(a.x, o.x, acc);
    acc = fmaf(a.y, o.y, acc);
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) acc += __shfl_xor_sync(0xffffffff, acc, off);
  if (lane == 0) {
    delta[idx] = acc;
    const float l = lse[((int64_t)bb * h + hh) * sq + row];
    lse2[idx] = l == -INFINITY ? INFINITY : l * FA_LOG2E;
  }
  if (dq_accum != nullptr) {
    float* dst = dq_accum + (((int64_t)bb * sq + row) * h + hh) * D + lane * PER;
#pragma unroll
    for (int i = 0; i < PER; i += 2) *reinterpret_cast<float2*>(dst + i) = make_float2(0.f, 0.f);
  }
}

// ---- dK / dV (and the fused dQ) --------------------------------------------

template <int D, bool ACCUM_DQ>
struct DkdvLayout {
  using KV = Tile<KV_ROWS, D>;
  using QT = Tile<KV_BM, D>;
  using DS = Tile<64, KV_BM>;  // one warpgroup's dS^T: 64 KV rows x KV_BM q
  static constexpr int K_OFF = 0;
  static constexpr int V_OFF = KV::BYTES;
  static constexpr int STAGE_OFF = 2 * KV::BYTES;
  static constexpr int STAGE_BYTES = 2 * QT::BYTES;  // Q then dO
  static constexpr int DS_OFF = STAGE_OFF + STAGES * STAGE_BYTES;
  static constexpr int DS_BYTES = ACCUM_DQ ? 2 * DS::BYTES : 0;
  static constexpr int VEC_OFF = DS_OFF + DS_BYTES;  // lse2 then delta a stage
  static constexpr int BAR_OFF = VEC_OFF + STAGES * 2 * KV_BM * 4;
  static constexpr int BYTES = BAR_OFF + 8 * (1 + STAGES);
  static constexpr uint32_t KV_TX = 2 * KV::BYTES;
  static constexpr uint32_t STAGE_TX = STAGE_BYTES + 2 * KV_BM * 4;
};

template <typename T, int D, bool ACCUM_DQ>
__global__ void __launch_bounds__(THREADS, 1)
    dkdv_kernel(const __grid_constant__ BwdMaps maps, const BwdParams p) {
  using L = DkdvLayout<D, ACCUM_DQ>;
  constexpr int BM = KV_BM;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = align_1024(smem_raw);
  unsigned char* Ks = smem + L::K_OFF;
  unsigned char* Vs = smem + L::V_OFF;
  uint64_t* kv_bar = reinterpret_cast<uint64_t*>(smem + L::BAR_OFF);
  uint64_t* full = kv_bar + 1;

  const int hk = blockIdx.x;
  const int bb = blockIdx.y;
  const int n0 = blockIdx.z * KV_ROWS;  // KV tile 0 (the heaviest) first
  const int tid = threadIdx.x;
  const int wg = tid >> 7;
  const int warp = (tid >> 5) & 3;
  const int lane = tid & 31;
  const int g = lane >> 2;
  const int t4 = lane & 3;
  const int shift = p.sk - p.sq;

  // the causal band: the first q row that sees key n0 is n0 - shift
  const int m_begin = p.causal && n0 - shift > 0 ? (n0 - shift) / BM : 0;
  const int n_m = max(0, (p.sq + BM - 1) / BM - m_begin);
  const int total = n_m * p.group;  // (query head, q tile) pairs in order

  auto issue = [&](int t) {
    const int st = t % STAGES;
    unsigned char* stage = smem + L::STAGE_OFF + st * L::STAGE_BYTES;
    float* vec = reinterpret_cast<float*>(smem + L::VEC_OFF) + st * 2 * BM;
    const int hq = hk * p.group + t / n_m;
    const int m0 = (m_begin + t % n_m) * BM;
    mbar_expect_tx(&full[st], L::STAGE_TX);
#pragma unroll
    for (int c = 0; c < D / 64; ++c) {
      tma_load_4d(stage + c * L::QT::PANEL_BYTES, &maps.q, &full[st], c * 64, m0, hq, bb);
      tma_load_4d(stage + L::QT::BYTES + c * L::QT::PANEL_BYTES, &maps.dout, &full[st],
                  c * 64, m0, hq, bb);
    }
    const int64_t row = ((int64_t)bb * p.h + hq) * p.sq_pad + m0;
    bulk_load(vec, p.lse2 + row, BM * 4, &full[st]);
    bulk_load(vec + BM, p.delta + row, BM * 4, &full[st]);
  };

  if (tid == 0) {
    mbar_init(kv_bar, 1);
    for (int s = 0; s < STAGES; ++s) mbar_init(&full[s], 1);
    fence_barrier_init();
  }
  __syncthreads();
  if (tid == 0) {
    mbar_expect_tx(kv_bar, L::KV_TX);
#pragma unroll
    for (int c = 0; c < D / 64; ++c) {
      tma_load_4d(Ks + c * L::KV::PANEL_BYTES, &maps.k, kv_bar, c * 64, n0, hk, bb);
      tma_load_4d(Vs + c * L::KV::PANEL_BYTES, &maps.v, kv_bar, c * 64, n0, hk, bb);
    }
    if (total > 0) issue(0);
  }

  float dk[D / 2], dv[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) dk[i] = dv[i] = 0.f;

  const int kv0 = n0 + wg * 64;  // this warpgroup's KV rows
  mbar_wait(kv_bar, 0);
  for (int t = 0; t < total; ++t) {
    const int st = t % STAGES;
    if (tid == 0 && t + 1 < total) issue(t + 1);  // its stage was freed at t - 1
    const unsigned char* Qs = smem + L::STAGE_OFF + st * L::STAGE_BYTES;
    const unsigned char* dOs = Qs + L::QT::BYTES;
    const float* lse_s = reinterpret_cast<const float*>(smem + L::VEC_OFF) + st * 2 * BM;
    const float* delta_s = lse_s + BM;
    const int m0 = (m_begin + t % n_m) * BM;
    const int hq = hk * p.group + t / n_m;
    mbar_wait(&full[st], (t / STAGES) & 1);

    // does any key of this warpgroup see any row of the tile?
    const bool active = kv0 < p.sk && (!p.causal || kv0 <= m0 + BM - 1 + shift);
    if (active) {
      float s[BM / 2], dp[BM / 2];
#pragma unroll
      for (int i = 0; i < BM / 2; ++i) s[i] = dp[i] = 0.f;
      // S^T = K Q^T and dP^T = V dO^T (KV rows as M)
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
        wgmma_ss<T, BM, 0, 0>(s, L::KV::k_slice(Ks, wg * 64, kk),
                              L::QT::k_slice(Qs, 0, kk), kk > 0);
      wgmma_commit();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
        wgmma_ss<T, BM, 0, 0>(dp, L::KV::k_slice(Vs, wg * 64, kk),
                              L::QT::k_slice(dOs, 0, kk), kk > 0);
      wgmma_commit();
      wgmma_wait<1>();
      fence_regs(s);

      // P^T = exp2(S^T * scale_log2 - lse2), masked on the diagonal and the
      // ragged end of the keys; rows past sq have lse2 = +inf
      const bool need_mask = (p.causal && kv0 + 63 > m0 + shift) || kv0 + 64 > p.sk;
#pragma unroll
      for (int j = 0; j < BM / 8; ++j) {
        const float2 l = *reinterpret_cast<const float2*>(lse_s + 8 * j + 2 * t4);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          float x = fmaf(s[4 * j + e], p.scale_log2, -((e & 1) ? l.y : l.x));
          if (need_mask) {
            const int kv = kv0 + warp * 16 + g + 8 * (e >> 1);
            const int qrow = m0 + 8 * j + 2 * t4 + (e & 1);
            if (kv >= p.sk || (p.causal && kv > qrow + shift)) x = -INFINITY;
          }
          s[4 * j + e] = exp2f(x);
        }
      }
      uint32_t pa[BM / 16][4];
#pragma unroll
      for (int kk = 0; kk < BM / 16; ++kk) pack_a<T>(pa[kk], s, kk);

      // dV += P^T dO
      fence_regs(dv);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < BM / 16; ++kk)
        wgmma_rs<T, D, 1>(dv, pa[kk], L::QT::mn_slice(dOs, 16 * kk), 1);
      wgmma_commit();
      wgmma_wait<1>();  // dP^T is in; dV may still run
      fence_regs(dp);

      // dS^T = P^T (dP^T - delta)
#pragma unroll
      for (int j = 0; j < BM / 8; ++j) {
        const float2 dl = *reinterpret_cast<const float2*>(delta_s + 8 * j + 2 * t4);
#pragma unroll
        for (int e = 0; e < 4; ++e)
          s[4 * j + e] *= dp[4 * j + e] - ((e & 1) ? dl.y : dl.x);
      }
      uint32_t da[BM / 16][4];
#pragma unroll
      for (int kk = 0; kk < BM / 16; ++kk) pack_a<T>(da[kk], s, kk);

      // dK += dS^T Q (scaled once at the end)
      fence_regs(dk);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < BM / 16; ++kk)
        wgmma_rs<T, D, 1>(dk, da[kk], L::QT::mn_slice(Qs, 16 * kk), 1);
      wgmma_commit();

      if constexpr (ACCUM_DQ) {
        // this warpgroup's dS^T goes to shared memory, the transposed A
        // operand of dQ = dS K below
        unsigned char* dsw = smem + L::DS_OFF + wg * L::DS::BYTES;
#pragma unroll
        for (int kk = 0; kk < BM / 16; ++kk) {
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            // da[kk][i]: row g + 8 (i & 1), columns 16 kk + 8 (i >> 1) + 2 t4
            const int row = warp * 16 + g + 8 * (i & 1);
            const int col = 16 * kk + 8 * (i >> 1) + 2 * t4;
            *reinterpret_cast<uint32_t*>(dsw + swz128(row, col)) = da[kk][i];
          }
        }
      }
      wgmma_wait<0>();
      fence_regs(dk);
      fence_regs(dv);
    } else if (ACCUM_DQ) {
      // a warpgroup whose keys see no row of the tile adds dS^T = 0
      uint4* dsw = reinterpret_cast<uint4*>(smem + L::DS_OFF + wg * L::DS::BYTES);
      for (int i = tid & 127; i < L::DS::BYTES / 16; i += 128) dsw[i] = make_uint4(0, 0, 0, 0);
    }
    if constexpr (ACCUM_DQ) {
      // dQ[m0 : m0 + BM] += dS K over the block's 128 keys, each warpgroup
      // one 64-column group of dQ (at d = 64 the first alone), so that the
      // block adds each dQ element of the tile once
      fence_proxy_async();
      named_barrier(1, THREADS);  // both dS^T halves are in shared memory
      if (wg < D / 64) {
        const unsigned char* kcol = Ks + wg * L::KV::PANEL_BYTES;
        float dq[32];
#pragma unroll
        for (int i = 0; i < 32; ++i) dq[i] = 0.f;
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < 8; ++kk)
          wgmma_ss<T, 64, 1, 1>(dq, L::DS::mn_slice(smem + L::DS_OFF + (kk / 4) * L::DS::BYTES,
                                                    16 * (kk % 4)),
                                L::KV::mn_slice(kcol, 16 * kk), kk > 0);
        wgmma_commit();
        wgmma_wait<0>();
        fence_regs(dq);
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          const int row = m0 + warp * 16 + g + 8 * i;
          if (row >= p.sq) continue;
          float* dst = p.dq_accum + (((int64_t)bb * p.sq + row) * p.h + hq) * D +
                       wg * 64 + 2 * t4;
#pragma unroll
          for (int j = 0; j < 8; ++j)
            atomicAdd(reinterpret_cast<float2*>(dst + 8 * j),
                      make_float2(dq[4 * j + 2 * i] * p.scale,
                                  dq[4 * j + 2 * i + 1] * p.scale));
        }
      }
    }
    __syncthreads();  // both warpgroups are done with stage st
  }

  // dK (scaled) and dV in the inputs' type, rows past sk skipped
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = kv0 + warp * 16 + g + 8 * i;
    if (row >= p.sk) continue;
    T* dkg = reinterpret_cast<T*>(p.dk) + bb * p.dk_sb + row * p.dk_ss + hk * p.dk_sh;
    T* dvg = reinterpret_cast<T*>(p.dv) + bb * p.dv_sb + row * p.dv_ss + hk * p.dv_sh;
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      store_pair(dkg + 8 * j + 2 * t4, dk[4 * j + 2 * i] * p.scale,
                 dk[4 * j + 2 * i + 1] * p.scale);
      store_pair(dvg + 8 * j + 2 * t4, dv[4 * j + 2 * i], dv[4 * j + 2 * i + 1]);
    }
  }
}

// ---- dQ ---------------------------------------------------------------------

template <int D>
struct DqLayout {
  using QT = Tile<Q_ROWS, D>;
  using KT = Tile<Q_BN, D>;
  static constexpr int Q_OFF = 0;
  static constexpr int DO_OFF = QT::BYTES;
  static constexpr int STAGE_OFF = 2 * QT::BYTES;
  static constexpr int STAGE_BYTES = 2 * KT::BYTES;  // K then V
  static constexpr int VEC_OFF = STAGE_OFF + STAGES * STAGE_BYTES;  // lse2, delta
  static constexpr int BAR_OFF = VEC_OFF + 2 * Q_ROWS * 4;
  static constexpr int BYTES = BAR_OFF + 8 * (1 + STAGES);
  static constexpr uint32_t Q_TX = 2 * QT::BYTES + 2 * Q_ROWS * 4;
  static constexpr uint32_t STAGE_TX = STAGE_BYTES;
};

template <typename T, int D>
__global__ void __launch_bounds__(THREADS, 1)
    dq_kernel(const __grid_constant__ BwdMaps maps, const BwdParams p) {
  using L = DqLayout<D>;
  constexpr int BN = Q_BN;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = align_1024(smem_raw);
  unsigned char* Qs = smem + L::Q_OFF;
  unsigned char* dOs = smem + L::DO_OFF;
  float* lse_s = reinterpret_cast<float*>(smem + L::VEC_OFF);
  float* delta_s = lse_s + Q_ROWS;
  uint64_t* q_bar = reinterpret_cast<uint64_t*>(smem + L::BAR_OFF);
  uint64_t* full = q_bar + 1;

  const int hh = blockIdx.x;
  const int bb = blockIdx.y;
  const int m0 = (gridDim.z - 1 - blockIdx.z) * Q_ROWS;  // the last (heaviest) first
  const int hk = hh / p.group;
  const int tid = threadIdx.x;
  const int wg = tid >> 7;
  const int warp = (tid >> 5) & 3;
  const int lane = tid & 31;
  const int g = lane >> 2;
  const int t4 = lane & 3;
  const int shift = p.sk - p.sq;

  // the key tiles of the causal band of rows [m0, m0 + Q_ROWS)
  int total = (p.sk + BN - 1) / BN;
  if (p.causal) {
    const int col_hi = min(m0 + Q_ROWS, p.sq) - 1 + shift;
    total = col_hi < 0 ? 0 : min(total, col_hi / BN + 1);
  }

  auto issue = [&](int t) {
    const int st = t % STAGES;
    unsigned char* stage = smem + L::STAGE_OFF + st * L::STAGE_BYTES;
    mbar_expect_tx(&full[st], L::STAGE_TX);
#pragma unroll
    for (int c = 0; c < D / 64; ++c) {
      tma_load_4d(stage + c * L::KT::PANEL_BYTES, &maps.k, &full[st], c * 64, t * BN, hk, bb);
      tma_load_4d(stage + L::KT::BYTES + c * L::KT::PANEL_BYTES, &maps.v, &full[st],
                  c * 64, t * BN, hk, bb);
    }
  };

  if (tid == 0) {
    mbar_init(q_bar, 1);
    for (int s = 0; s < STAGES; ++s) mbar_init(&full[s], 1);
    fence_barrier_init();
  }
  __syncthreads();
  if (tid == 0) {
    mbar_expect_tx(q_bar, L::Q_TX);
#pragma unroll
    for (int c = 0; c < D / 64; ++c) {
      tma_load_4d(Qs + c * L::QT::PANEL_BYTES, &maps.q, q_bar, c * 64, m0, hh, bb);
      tma_load_4d(dOs + c * L::QT::PANEL_BYTES, &maps.dout, q_bar, c * 64, m0, hh, bb);
    }
    const int64_t row = ((int64_t)bb * p.h + hh) * p.sq_pad + m0;
    bulk_load(lse_s, p.lse2 + row, Q_ROWS * 4, q_bar);
    bulk_load(delta_s, p.delta + row, Q_ROWS * 4, q_bar);
    if (total > 0) issue(0);
  }

  float dq[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) dq[i] = 0.f;

  const int r0 = m0 + wg * 64;  // this warpgroup's q rows
  mbar_wait(q_bar, 0);
  float lse2[2], delta[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    lse2[i] = lse_s[wg * 64 + warp * 16 + g + 8 * i];
    delta[i] = delta_s[wg * 64 + warp * 16 + g + 8 * i];
  }
  for (int t = 0; t < total; ++t) {
    const int st = t % STAGES;
    if (tid == 0 && t + 1 < total) issue(t + 1);  // its stage was freed at t - 1
    const unsigned char* Ks = smem + L::STAGE_OFF + st * L::STAGE_BYTES;
    const unsigned char* Vs = Ks + L::KT::BYTES;
    const int n0 = t * BN;
    mbar_wait(&full[st], (t / STAGES) & 1);

    // does any row of this warpgroup see any key of the tile?
    const bool active = r0 < p.sq && (!p.causal || n0 <= r0 + 63 + shift);
    if (active) {
      float s[BN / 2], dp[BN / 2];
#pragma unroll
      for (int i = 0; i < BN / 2; ++i) s[i] = dp[i] = 0.f;
      // S = Q K^T and dP = dO V^T
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
        wgmma_ss<T, BN, 0, 0>(s, L::QT::k_slice(Qs, wg * 64, kk),
                              L::KT::k_slice(Ks, 0, kk), kk > 0);
      wgmma_commit();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
        wgmma_ss<T, BN, 0, 0>(dp, L::QT::k_slice(dOs, wg * 64, kk),
                              L::KT::k_slice(Vs, 0, kk), kk > 0);
      wgmma_commit();
      wgmma_wait<1>();
      fence_regs(s);

      // P = exp2(S * scale_log2 - lse2), masked on the diagonal and the
      // ragged end of the keys
      const bool need_mask = (p.causal && n0 + BN - 1 > r0 + shift) || n0 + BN > p.sk;
#pragma unroll
      for (int j = 0; j < BN / 8; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          float x = fmaf(s[4 * j + e], p.scale_log2, -lse2[e >> 1]);
          if (need_mask) {
            const int col = n0 + 8 * j + 2 * t4 + (e & 1);
            const int row = r0 + warp * 16 + g + 8 * (e >> 1);
            if (col >= p.sk || (p.causal && col > row + shift)) x = -INFINITY;
          }
          s[4 * j + e] = exp2f(x);
        }
      }
      wgmma_wait<0>();
      fence_regs(dp);

      // dS = P (dP - delta); dQ += dS K (scaled once at the end)
#pragma unroll
      for (int i = 0; i < BN / 2; ++i) s[i] *= dp[i] - delta[(i >> 1) & 1];
      uint32_t da[BN / 16][4];
#pragma unroll
      for (int kk = 0; kk < BN / 16; ++kk) pack_a<T>(da[kk], s, kk);
      fence_regs(dq);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < BN / 16; ++kk)
        wgmma_rs<T, D, 1>(dq, da[kk], L::KT::mn_slice(Ks, 16 * kk), 1);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(dq);
    }
    __syncthreads();  // both warpgroups are done with stage st
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = r0 + warp * 16 + g + 8 * i;
    if (row >= p.sq) continue;
    T* dqg = reinterpret_cast<T*>(p.dq) + bb * p.dq_sb + row * p.dq_ss + hh * p.dq_sh;
#pragma unroll
    for (int j = 0; j < D / 8; ++j)
      store_pair(dqg + 8 * j + 2 * t4, dq[4 * j + 2 * i] * p.scale,
                 dq[4 * j + 2 * i + 1] * p.scale);
  }
}

// ---- host side --------------------------------------------------------------

PFN_cuTensorMapEncodeTiled_v12000 encode_tiled() {
  static PFN_cuTensorMapEncodeTiled_v12000 fn = nullptr;
  if (fn == nullptr) {
    void* ptr = nullptr;
    cudaDriverEntryPointQueryResult found;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &ptr, cudaEnableDefault,
                                &found) == cudaSuccess &&
        found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<PFN_cuTensorMapEncodeTiled_v12000>(ptr);
  }
  return fn;
}

// The tensor map of a (b, s, h, d) operand given by element strides (the
// head dim contiguous): boxes of 64 columns by `rows` rows of one head,
// 128-byte swizzle, rows past s zero-filled.
cudaError_t make_map(CUtensorMap* map, const void* ptr, bool bf16, int d, int s,
                     int h, int b, int64_t ss, int64_t sh, int64_t sb, int rows) {
  auto encode = encode_tiled();
  if (encode == nullptr) return cudaErrorNotSupported;
  const cuuint64_t dims[4] = {(cuuint64_t)d, (cuuint64_t)s, (cuuint64_t)h, (cuuint64_t)b};
  const cuuint64_t strides[3] = {(cuuint64_t)ss * 2, (cuuint64_t)sh * 2, (cuuint64_t)sb * 2};
  const cuuint32_t box[4] = {64, (cuuint32_t)rows, 1, 1};
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  const CUresult r = encode(
      map, bf16 ? CU_TENSOR_MAP_DATA_TYPE_BFLOAT16 : CU_TENSOR_MAP_DATA_TYPE_FLOAT16,
      4, const_cast<void*>(ptr), dims, strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
      CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
      CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

struct Operands {
  const void* q;
  const void* k;
  const void* v;
  const void* dout;
  int64_t q_sb, q_ss, q_sh, k_sb, k_ss, k_sh, v_sb, v_ss, v_sh, do_sb, do_ss, do_sh;
};

// Maps of q and dout with boxes of q_rows rows, k and v of kv_rows rows.
cudaError_t make_maps(BwdMaps* m, const Operands& o, bool bf16, int b, int sq, int sk,
                      int h, int h_k, int d, int q_rows, int kv_rows) {
  cudaError_t err;
  if ((err = make_map(&m->q, o.q, bf16, d, sq, h, b, o.q_ss, o.q_sh, o.q_sb, q_rows)) ||
      (err = make_map(&m->dout, o.dout, bf16, d, sq, h, b, o.do_ss, o.do_sh, o.do_sb,
                      q_rows)) ||
      (err = make_map(&m->k, o.k, bf16, d, sk, h_k, b, o.k_ss, o.k_sh, o.k_sb, kv_rows)) ||
      (err = make_map(&m->v, o.v, bf16, d, sk, h_k, b, o.v_ss, o.v_sh, o.v_sb, kv_rows)))
    return err;
  return cudaSuccess;
}

template <typename Kernel>
cudaError_t launch(Kernel kernel, dim3 grid, int smem, const BwdMaps& maps,
                   const BwdParams& p, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  kernel<<<grid, THREADS, smem, stream>>>(maps, p);
  return cudaGetLastError();
}

template <typename T, int D>
cudaError_t launch_dkdv(const BwdMaps& maps, const BwdParams& p, int b, int h_k,
                        cudaStream_t stream) {
  const dim3 grid(h_k, b, (p.sk + KV_ROWS - 1) / KV_ROWS);
  if (p.dq_accum != nullptr)
    return launch(dkdv_kernel<T, D, true>, grid, DkdvLayout<D, true>::BYTES + 1024, maps,
                  p, stream);
  return launch(dkdv_kernel<T, D, false>, grid, DkdvLayout<D, false>::BYTES + 1024, maps,
                p, stream);
}

template <typename T, int D>
cudaError_t launch_dq(const BwdMaps& maps, const BwdParams& p, int b,
                      cudaStream_t stream) {
  const dim3 grid(p.h, b, (p.sq + Q_ROWS - 1) / Q_ROWS);
  return launch(dq_kernel<T, D>, grid, DqLayout<D>::BYTES + 1024, maps, p, stream);
}

BwdParams make_params(const float* lse2, const float* delta, int sq, int sk, int sq_pad,
                      int h, int h_k, float scale, int causal) {
  BwdParams p = {};
  p.lse2 = lse2;
  p.delta = delta;
  p.sq = sq;
  p.sk = sk;
  p.sq_pad = sq_pad;
  p.h = h;
  p.group = h / h_k;
  p.scale = scale;
  p.scale_log2 = scale * FA_LOG2E;
  p.causal = causal;
  return p;
}

bool valid(int b, int sq, int sk, int sq_pad, int h, int h_k, int d) {
  return b > 0 && sq > 0 && sk > 0 && h_k > 0 && h % h_k == 0 && (d == 64 || d == 128) &&
         sq_pad % ROW_PAD == 0 && sq_pad >= sq;
}

}  // namespace

// delta = rowsum(dout * out) (b, h, sq_pad) fp32 and lse2 = lse * log2(e)
// (+inf where lse is -inf), delta 0 and lse2 +inf on the rows [sq, sq_pad);
// with dq_accum (b, sq, h, d) fp32 given, also zeroes it. dout/out (b, sq,
// h, d) by element strides with the head dim contiguous; lse (b, h, sq)
// contiguous fp32. Returns a cudaError_t (0 on success).
extern "C" int fa_bwd_preprocess(const void* dout, const void* out, const float* lse,
                                 float* lse2, float* delta, float* dq_accum, int b,
                                 int sq, int sq_pad, int h, int d, int64_t do_sb,
                                 int64_t do_ss, int64_t do_sh, int64_t o_sb,
                                 int64_t o_ss, int64_t o_sh, int is_bf16, void* stream) {
  if (!valid(b, sq, 1, sq_pad, h, 1, d)) return (int)cudaErrorInvalidValue;
  const dim3 grid((sq_pad + PRE_ROWS - 1) / PRE_ROWS, h, b);
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
#define FA_PRE(T, D)                                                              \
  preprocess_kernel<T, D><<<grid, PRE_ROWS * 32, 0, st>>>(                         \
      reinterpret_cast<const T*>(dout), reinterpret_cast<const T*>(out), lse, lse2, \
      delta, dq_accum, sq, sq_pad, h, do_sb, do_ss, do_sh, o_sb, o_ss, o_sh)
  if (is_bf16) {
    if (d == 64) FA_PRE(__nv_bfloat16, 64);
    else FA_PRE(__nv_bfloat16, 128);
  } else {
    if (d == 64) FA_PRE(__half, 64);
    else FA_PRE(__half, 128);
  }
#undef FA_PRE
  return (int)cudaGetLastError();
}

// dK and dV (and, with dq_accum given, dQ * scale added into it). q/dout
// (b, sq, h, d), k/v and dk/dv (b, sk, h_k, d), all by element strides with
// the head dim contiguous, 16-byte aligned starts and strides (TMA); lse2 and
// delta (b, h, sq_pad) from fa_bwd_preprocess; dq_accum (b, sq, h, d)
// contiguous fp32, zeroed. block_q/block_k must name the tile the kernel is
// compiled for (dispatch/config.py DENSE_BWD_TILES). Returns a cudaError_t.
extern "C" int fa_bwd_dkdv(const void* q, const void* k, const void* v,
                           const void* dout, const float* lse2,
                           const float* delta, void* dk, void* dv,
                           float* dq_accum, int b, int sq, int sk, int sq_pad,
                           int h, int h_k, int d, int block_q, int block_k,
                           int64_t q_sb, int64_t q_ss, int64_t q_sh,
                           int64_t k_sb, int64_t k_ss, int64_t k_sh,
                           int64_t v_sb, int64_t v_ss, int64_t v_sh,
                           int64_t do_sb, int64_t do_ss, int64_t do_sh,
                           int64_t dk_sb, int64_t dk_ss, int64_t dk_sh,
                           int64_t dv_sb, int64_t dv_ss, int64_t dv_sh,
                           float scale, int causal, int is_bf16, void* stream) {
  if (block_q != KV_BM || block_k != KV_ROWS || !valid(b, sq, sk, sq_pad, h, h_k, d))
    return (int)cudaErrorInvalidValue;
  const Operands o = {q, k, v, dout, q_sb, q_ss, q_sh, k_sb, k_ss, k_sh,
                      v_sb, v_ss, v_sh, do_sb, do_ss, do_sh};
  BwdMaps maps;
  cudaError_t err = make_maps(&maps, o, is_bf16, b, sq, sk, h, h_k, d, KV_BM, KV_ROWS);
  if (err != cudaSuccess) return (int)err;
  BwdParams p = make_params(lse2, delta, sq, sk, sq_pad, h, h_k, scale, causal);
  p.dk = dk;
  p.dv = dv;
  p.dq_accum = dq_accum;
  p.dk_sb = dk_sb; p.dk_ss = dk_ss; p.dk_sh = dk_sh;
  p.dv_sb = dv_sb; p.dv_ss = dv_ss; p.dv_sh = dv_sh;
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  if (is_bf16) {
    if (d == 64) return launch_dkdv<__nv_bfloat16, 64>(maps, p, b, h_k, st);
    return launch_dkdv<__nv_bfloat16, 128>(maps, p, b, h_k, st);
  }
  if (d == 64) return launch_dkdv<__half, 64>(maps, p, b, h_k, st);
  return launch_dkdv<__half, 128>(maps, p, b, h_k, st);
}

// dQ (b, sq, h, d) in q's type, written once. Layouts as fa_bwd_dkdv.
extern "C" int fa_bwd_dq(const void* q, const void* k, const void* v,
                         const void* dout, const float* lse2,
                         const float* delta, void* dq, int b, int sq, int sk,
                         int sq_pad, int h, int h_k, int d, int block_q, int block_k,
                         int64_t q_sb, int64_t q_ss, int64_t q_sh,
                         int64_t k_sb, int64_t k_ss, int64_t k_sh,
                         int64_t v_sb, int64_t v_ss, int64_t v_sh,
                         int64_t do_sb, int64_t do_ss, int64_t do_sh,
                         int64_t dq_sb, int64_t dq_ss, int64_t dq_sh,
                         float scale, int causal, int is_bf16, void* stream) {
  if (block_q != Q_ROWS || block_k != Q_BN || !valid(b, sq, sk, sq_pad, h, h_k, d))
    return (int)cudaErrorInvalidValue;
  const Operands o = {q, k, v, dout, q_sb, q_ss, q_sh, k_sb, k_ss, k_sh,
                      v_sb, v_ss, v_sh, do_sb, do_ss, do_sh};
  BwdMaps maps;
  cudaError_t err = make_maps(&maps, o, is_bf16, b, sq, sk, h, h_k, d, Q_ROWS, Q_BN);
  if (err != cudaSuccess) return (int)err;
  BwdParams p = make_params(lse2, delta, sq, sk, sq_pad, h, h_k, scale, causal);
  p.dq = dq;
  p.dq_sb = dq_sb; p.dq_ss = dq_ss; p.dq_sh = dq_sh;
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  if (is_bf16) {
    if (d == 64) return launch_dq<__nv_bfloat16, 64>(maps, p, b, st);
    return launch_dq<__nv_bfloat16, 128>(maps, p, b, st);
  }
  if (d == 64) return launch_dq<__half, 64>(maps, p, b, st);
  return launch_dq<__half, 128>(maps, p, b, st);
}
