// The attention forward tile for Hopper (sm_90a) on wgmma and TMA, shared by
// the dense forward (csrc/flash_fwd.cu, B1) and the packed-varlen forward
// (csrc/flash_varlen_fwd.cu, B6): one block of two warpgroups computes 128
// query rows of one sequence and head against the 64-key tiles of its
// causal band. It is the sm_90a counterpart of the mma.sync tile loop of
// fwd_tile.cuh, which B7, B8 and the block-sparse forward keep.
//
// What it computes is what flash_attn_tpu/kernels/flash_fwd.py:_fwd_kernel
// computes, with the causal diagonal of flash_fwd_split.py:_diag_kernel:
// out = softmax(scale Q K^T) V per row under bottom-right causal masking
// (shift = sk - sq: row r sees key c <= r + shift), and the natural-log lse;
// a row that sees no key gets out 0 and lse -inf. The softmax runs in base 2
// with scale * log2(e) folded into one multiply.
//
// Layout (csrc/sm90.cuh): Q comes once by TMA into a 128-row tile of
// 128B-swizzled panels; K and V tiles of 64 keys come through a two-stage
// ring, one thread issuing tile t + 1's loads as tile t starts. Each
// warpgroup runs S = Q K^T over its 64 rows by SS wgmma (both operands
// K-major) and the online softmax in registers (only the tiles that cross
// the diagonal or the ragged end of the keys run the mask), then packs P
// from the S accumulators (pack_a) into the register A operand of
// O += P V, with V read MN-major through the descriptor's transpose bit.
// One block barrier a tile keeps the warpgroups in step and frees the
// stage. A warpgroup whose rows see no key of a tile (the lower one, on the
// last tile of a causal band) still runs its products on P = 0, so that no
// wgmma sits behind a warpgroup-divergent branch. O takes 64 fp32 registers
// a thread at d = 128, S 32, within the 128 a thread that let two blocks
// share an SM (the kernels' __launch_bounds__(256, 2), no spills); shared
// memory holds 32 KB of Q and two stages of K + V at 32 KB each, 97 KB a
// block. With two blocks an SM one block's softmax runs while the other's
// products hold the tensor cores: measured faster than one block an SM with
// 64- or 128-key tiles, and than issuing tile t + 1's scores before tile t's
// softmax within a block, which spills at 128 registers (PERF.md §6).
// The epilogue stages the normalised O of each warpgroup in its own rows of
// the Q tile (swizzled, so the stores are free of bank conflicts) and
// writes it out in 16-byte row chunks, rows past sq skipped: 7% faster at
// the prefill's shape than 4-byte stores straight from the accumulators.
//
// Rows: TMA zero-fills rows past a tensor's end. In a packed tensor the
// rows past a sequence's end belong to the next one: their scores are
// masked to -inf (P = 0 exactly) and, with ZERO_TAIL, the V rows past the
// keys of the ragged tile are zeroed in shared memory, so that what a
// neighbour holds (a NaN even) cannot reach the output through 0 * V. Rows
// past sq are computed on whatever arrived and never stored. Every multiply
// that feeds an add is rounded explicitly (__fmul_rn, __fmaf_rn), so the
// kernels that inline this tile give the same bits for the same rows.
#pragma once

#include <cudaTypedefs.h>

#include "sm90.cuh"

namespace fa {
namespace sm90 {

constexpr int FWD_M = 128;  // query rows a block (64 a warpgroup)
constexpr int FWD_N = 64;   // keys a K/V tile
constexpr int FWD_THREADS = 256;
constexpr int FWD_STAGES = 2;

template <int D>
struct FwdLayout {
  using QT = Tile<FWD_M, D>;
  using KT = Tile<FWD_N, D>;
  static constexpr int Q_OFF = 0;
  static constexpr int STAGE_OFF = QT::BYTES;
  static constexpr int STAGE_BYTES = 2 * KT::BYTES;  // K then V
  static constexpr int BAR_OFF = STAGE_OFF + FWD_STAGES * STAGE_BYTES;
  static constexpr int BYTES = BAR_OFF + 8 * (1 + FWD_STAGES);
  // what a launch asks for: the base is rounded up to 1024 bytes
  static constexpr int SMEM = BYTES + 1024;
};

// The rows a block writes: out and lse at row 0 of the sequence and this
// query head (lse rows are consecutive floats); rows [m0, m0 + 128) of sq
// query rows over sk keys.
template <typename T>
struct FwdRows {
  T* out;
  float* lse;
  int64_t o_ss;  // out's row stride in elements
  int sq, sk, m0;
};

// 2^x on the special-function unit (subnormal results flush to 0).
__device__ __forceinline__ float exp2_ftz(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// Src: load_q / load_k / load_v(dst, bar, col, row) issue the TMA load of
// the box of 64 columns from `col` and 128 (Q) or 64 (K, V) rows from the
// sequence's row `row`, counted on `bar`. ZERO_TAIL: zero the V rows past
// sk of the ragged tile (a packed tensor's neighbour rows).
template <typename T, int D, bool ZERO_TAIL, typename Src>
__device__ __forceinline__ void fwd_tile(const Src& src, const FwdRows<T>& t,
                                         float scale_log2, bool causal,
                                         unsigned char* smem) {
  using L = FwdLayout<D>;
  constexpr int BN = FWD_N;
  unsigned char* Qs = smem + L::Q_OFF;
  uint64_t* q_bar = reinterpret_cast<uint64_t*>(smem + L::BAR_OFF);
  uint64_t* full = q_bar + 1;

  const int tid = threadIdx.x;
  const int wg = tid >> 7;
  const int warp = (tid >> 5) & 3;
  const int lane = tid & 31;
  const int g = lane >> 2;
  const int t4 = lane & 3;
  const int shift = t.sk - t.sq;
  const int total = KeyRange<BN>(t.m0, FWD_M, t.sq, t.sk, causal).count();

  auto issue = [&](int n) {
    const int st = n % FWD_STAGES;
    unsigned char* stage = smem + L::STAGE_OFF + st * L::STAGE_BYTES;
    mbar_expect_tx(&full[st], L::STAGE_BYTES);
#pragma unroll
    for (int c = 0; c < D / 64; ++c) {
      src.load_k(stage + c * L::KT::PANEL_BYTES, &full[st], c * 64, n * BN);
      src.load_v(stage + L::KT::BYTES + c * L::KT::PANEL_BYTES, &full[st], c * 64,
                 n * BN);
    }
  };

  if (tid == 0) {
    mbar_init(q_bar, 1);
    for (int s = 0; s < FWD_STAGES; ++s) mbar_init(&full[s], 1);
    fence_barrier_init();
  }
  __syncthreads();
  if (tid == 0 && total > 0) {
    mbar_expect_tx(q_bar, L::QT::BYTES);
#pragma unroll
    for (int c = 0; c < D / 64; ++c)
      src.load_q(Qs + c * L::QT::PANEL_BYTES, q_bar, c * 64, t.m0);
    issue(0);
  }

  float o[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) o[i] = 0.f;
  float m_r[2] = {-INFINITY, -INFINITY};  // running max of the scaled scores
  float l_r[2] = {0.f, 0.f};              // this thread's share of the row sum
  const int r0 = t.m0 + wg * 64;          // this warpgroup's rows
  const int row_a = r0 + warp * 16 + g;   // this thread's rows: row_a, row_a + 8

  if (total > 0) mbar_wait(q_bar, 0);
  for (int n = 0; n < total; ++n) {
    const int st = n % FWD_STAGES;
    if (tid == 0 && n + 1 < total) issue(n + 1);  // its stage was freed at n - 1
    const unsigned char* Ks = smem + L::STAGE_OFF + st * L::STAGE_BYTES;
    unsigned char* Vs = smem + L::STAGE_OFF + st * L::STAGE_BYTES + L::KT::BYTES;
    const int n0 = n * BN;
    mbar_wait(&full[st], (n / FWD_STAGES) & 1);

    if constexpr (ZERO_TAIL) {
      if (n0 + BN > t.sk) {  // the same for the whole block
        // whole 128-byte rows of each panel, so the swizzle does not matter
        const int first = t.sk - n0;
        const int per_panel = (BN - first) * 8;  // 16-byte chunks
        for (int i = tid; i < per_panel * (D / 64); i += FWD_THREADS) {
          const int c = i / per_panel;
          const int r = first + (i - c * per_panel) / 8;
          *reinterpret_cast<uint4*>(Vs + c * L::KT::PANEL_BYTES + r * 128 + (i & 7) * 16) =
              make_uint4(0, 0, 0, 0);
        }
        fence_proxy_async();  // before wgmma reads them
        __syncthreads();
      }
    }

    // S = Q K^T over this warpgroup's 64 rows
    float s[BN / 2];
#pragma unroll
    for (int i = 0; i < BN / 2; ++i) s[i] = 0.f;
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      wgmma_ss<T, BN, 0, 0>(s, L::QT::k_slice(Qs, wg * 64, kk), L::KT::k_slice(Ks, 0, kk),
                            kk > 0);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(s);

    // scale into base 2; mask the diagonal and the ragged end of the keys
    const bool need_mask = (causal && n0 + BN - 1 > r0 + shift) || n0 + BN > t.sk;
#pragma unroll
    for (int j = 0; j < BN / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float x = __fmul_rn(s[4 * j + e], scale_log2);
        if (need_mask) {
          const int col = n0 + 8 * j + 2 * t4 + (e & 1);
          const int row = row_a + 8 * (e >> 1);
          if (col >= t.sk || (causal && col > row + shift)) x = -INFINITY;
        }
        s[4 * j + e] = x;
      }
    }

    // online softmax, one row pair at a time
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      float mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < BN / 8; ++j)
        mx = fmaxf(mx, fmaxf(s[4 * j + 2 * i], s[4 * j + 2 * i + 1]));
      mx = quad_max(mx);
      const float m_new = fmaxf(m_r[i], mx);
      // a row that has seen no key yet keeps m = -inf; exponentiate against
      // 0 so that it gives 0 and not NaN
      const float m_safe = m_new == -INFINITY ? 0.f : m_new;
      const float corr = exp2_ftz(m_r[i] - m_safe);
      m_r[i] = m_new;
      float rs = 0.f;
#pragma unroll
      for (int j = 0; j < BN / 8; ++j) {
        s[4 * j + 2 * i] = exp2_ftz(s[4 * j + 2 * i] - m_safe);
        s[4 * j + 2 * i + 1] = exp2_ftz(s[4 * j + 2 * i + 1] - m_safe);
        rs += s[4 * j + 2 * i] + s[4 * j + 2 * i + 1];
      }
      l_r[i] = __fmaf_rn(l_r[i], corr, rs);
#pragma unroll
      for (int j = 0; j < D / 8; ++j) {
        o[4 * j + 2 * i] = __fmul_rn(o[4 * j + 2 * i], corr);
        o[4 * j + 2 * i + 1] = __fmul_rn(o[4 * j + 2 * i + 1], corr);
      }
    }

    // O += P V, P packed from the S accumulators
    uint32_t pa[BN / 16][4];
#pragma unroll
    for (int kk = 0; kk < BN / 16; ++kk) pack_a<T>(pa[kk], s, kk);
    fence_regs(o);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BN / 16; ++kk)
      wgmma_rs<T, D, 1>(o, pa[kk], L::KT::mn_slice(Vs, 16 * kk), 1);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(o);
    __syncthreads();  // both warpgroups are done with stage st
  }

  // normalise; O in the input type goes through this warpgroup's rows of
  // the Q tile (its last product has read them) and out in 16-byte chunks,
  // rows past sq skipped; the natural-log lse
  unsigned char* ow = Qs + wg * 64 * 128;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = warp * 16 + g + 8 * i;
    const float l = quad_sum(l_r[i]);
    const float inv = l == 0.f ? 0.f : 1.f / l;
#pragma unroll
    for (int j = 0; j < D / 8; ++j)
      *reinterpret_cast<uint32_t*>(ow + (j / 8) * L::QT::PANEL_BYTES +
                                   swz128(r, 8 * (j % 8) + 2 * t4)) =
          Elem<T>::pack(o[4 * j + 2 * i] * inv, o[4 * j + 2 * i + 1] * inv);
    if (t4 == 0 && r0 + r < t.sq)
      t.lse[r0 + r] = l == 0.f ? -INFINITY : __fmaf_rn(m_r[i], FA_LN2, logf(l));
  }
  named_barrier(1 + wg, 128);
  for (int i = tid & 127; i < 64 * (D / 8); i += 128) {
    const int r = i / (D / 8);
    const int ch = i % (D / 8);
    if (r0 + r >= t.sq) continue;
    *reinterpret_cast<uint4*>(t.out + (int64_t)(r0 + r) * t.o_ss + 8 * ch) =
        *reinterpret_cast<const uint4*>(ow + (ch / 8) * L::QT::PANEL_BYTES + r * 128 +
                                        (((ch ^ r) & 7) << 4));
  }
}

// ---- host side --------------------------------------------------------------

inline PFN_cuTensorMapEncodeTiled_v12000 encode_tiled() {
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

// The tensor map of a RANK-dimensional operand of 2-byte elements whose
// innermost dim (the head dim, `dims[0]` elements) is contiguous: `dims`
// innermost first, `strides` the element strides of dims 1 .. RANK - 1.
// Boxes of 64 columns by `rows` rows (dim 1) of one index of every outer
// dim, 128-byte swizzle, zero fill past each dim's end.
template <int RANK>
cudaError_t make_tile_map(CUtensorMap* map, const void* ptr, bool bf16,
                          const int64_t (&dims)[RANK], const int64_t (&strides)[RANK - 1],
                          int rows) {
  auto encode = encode_tiled();
  if (encode == nullptr) return cudaErrorNotSupported;
  cuuint64_t d[RANK], st[RANK - 1];
  cuuint32_t box[RANK], elem[RANK];
  for (int i = 0; i < RANK; ++i) {
    d[i] = (cuuint64_t)dims[i];
    box[i] = i == 0 ? 64 : i == 1 ? (cuuint32_t)rows : 1;
    elem[i] = 1;
  }
  for (int i = 0; i < RANK - 1; ++i) st[i] = (cuuint64_t)strides[i] * 2;
  const CUresult r = encode(
      map, bf16 ? CU_TENSOR_MAP_DATA_TYPE_BFLOAT16 : CU_TENSOR_MAP_DATA_TYPE_FLOAT16, RANK,
      const_cast<void*>(ptr), d, st, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
      CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
      CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

// The maps of one forward call.
struct FwdMaps {
  CUtensorMap q, k, v;
};

}  // namespace sm90
}  // namespace fa
