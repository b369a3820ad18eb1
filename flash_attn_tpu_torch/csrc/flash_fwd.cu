// Dense attention forward for Hopper (sm_90a), bf16 / fp16, head dim 64 or 128.
//
// Replaces the TPU kernel flash_attn_tpu/kernels/flash_fwd.py:_fwd_kernel,
// together with the causal diagonal work of
// flash_attn_tpu/kernels/flash_fwd_split.py:_diag_kernel: the TPU split the
// causal band into a maskless bulk launch and a masked diagonal launch; here
// one block walks its whole band and only the diagonal (and ragged last)
// tiles run the mask.
//
// What bounds it on this card: a causal call reads q, k, v and writes out
// once (8 * b * s * h * d bytes in bf16) and does 2 * b * h * s^2 * d flops,
// s / 4 flops per byte. Below s ~ 1200 (the card's 295 flops per byte) the
// floor is memory traffic; above it, the tensor cores. A kernel as simple as
// this one reaches neither floor: what limits it is how well it keeps the
// tensor cores fed (operand loads into shared memory, and the softmax
// between the two products, which runs on the ordinary ALUs).
//
// What the design does about it: each block of 4 warps owns 64 query rows
// (16 per warp) of one (batch, head) and loops over 64-key K/V tiles of its
// causal band. Q stays in registers as mma fragments for the whole loop;
// K/V tiles arrive with cp.async into XOR-swizzled shared memory so the
// ldmatrix reads are free of bank conflicts, and the V copy overlaps the
// Q K^T product. Both products run on the tensor cores with
// mma.sync.m16n8k16 (fp32 accumulation); P never leaves registers (the
// accumulator layout of S is the A-operand layout of P V). The online
// softmax keeps (m, l, acc) in fp32 registers and uses exp2 with
// softmax_scale * log2(e) folded into one multiply, as the TPU kernel does.
// wgmma, TMA and warp specialisation are left for later work.
//
// Masking is bottom-right aligned (shift = sk - sq): query row r sees key
// columns c <= r + shift. A row that sees no key gets out = 0, lse = -inf.

#include "common.cuh"

namespace {

constexpr int BM = 64;  // query rows per block
constexpr int BN = 64;  // keys per K/V tile
constexpr int NWARPS = 4;
constexpr int NTHREADS = NWARPS * 32;

struct FwdParams {
  const void* q;
  const void* k;
  const void* v;
  void* out;
  float* lse;  // (b, h, sq)
  int64_t q_sb, q_ss, q_sh;
  int64_t k_sb, k_ss, k_sh;
  int64_t v_sb, v_ss, v_sh;
  int64_t o_sb, o_ss, o_sh;
  int sq, sk, h, group;
  float scale_log2;
  int causal;
};

// Copy rows [row0, row0 + 64) of one (batch, head) slice into a swizzled
// shared tile; rows at or past `nrows` are zero-filled.
template <typename T, int D>
__device__ __forceinline__ void load_tile(T* tile, const T* base,
                                          int64_t row_stride, int row0,
                                          int nrows, int tid) {
  constexpr int CHUNKS = D / 8;
  constexpr int PER_THREAD = 64 * CHUNKS / NTHREADS;
#pragma unroll
  for (int i = 0; i < PER_THREAD; ++i) {
    const int c = tid + i * NTHREADS;
    const int r = c / CHUNKS;
    const int ch = c % CHUNKS;
    const int gr = row0 + r;
    const bool ok = gr < nrows;
    const T* src = ok ? base + (int64_t)gr * row_stride + ch * 8 : base;
    fa::cp_async_16(fa::smem_addr(tile + fa::swz<D>(r, ch)), src, ok ? 16 : 0);
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(NTHREADS) fwd_kernel(const FwdParams p) {
  using E = fa::Elem<T>;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  T* Qs = reinterpret_cast<T*>(smem_raw);
  T* Ks = Qs + BM * D;
  T* Vs = Ks + BN * D;

  const int mb = blockIdx.x;
  const int hh = blockIdx.y;
  const int bb = blockIdx.z;
  const int kh = hh / p.group;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int g = lane >> 2;  // accumulator row within the warp's 16 (and +8)
  const int t4 = lane & 3;  // accumulator column pair
  const int m0 = mb * BM;
  const int shift = p.sk - p.sq;

  const T* qg = reinterpret_cast<const T*>(p.q) + bb * p.q_sb + hh * p.q_sh;
  const T* kg = reinterpret_cast<const T*>(p.k) + bb * p.k_sb + kh * p.k_sh;
  const T* vg = reinterpret_cast<const T*>(p.v) + bb * p.v_sb + kh * p.v_sh;

  // KV tiles of this block's band.
  int n_tiles = (p.sk + BN - 1) / BN;
  if (p.causal) {
    const int col_hi = min(m0 + BM, p.sq) - 1 + shift;
    n_tiles = col_hi < 0 ? 0 : min(n_tiles, col_hi / BN + 1);
  }

  load_tile<T, D>(Qs, qg, p.q_ss, m0, p.sq, tid);
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
  const int row0 = m0 + warp * 16 + g;    // rows row0 and row0 + 8

  for (int n = 0; n < n_tiles; ++n) {
    const int n0 = n * BN;
    __syncthreads();  // every warp is done with the previous K/V tile
    load_tile<T, D>(Ks, kg, p.k_ss, n0, p.sk, tid);
    fa::cp_async_commit();
    load_tile<T, D>(Vs, vg, p.v_ss, n0, p.sk, tid);
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

    // Only the tiles that cross the causal diagonal or the end of the keys
    // run the mask.
    const bool need_mask =
        (p.causal && n0 + BN - 1 > m0 + shift) || (n0 + BN > p.sk);
#pragma unroll
    for (int nb = 0; nb < BN / 8; ++nb) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float x = s[nb][e] * p.scale_log2;
        if (need_mask) {
          const int col = n0 + nb * 8 + 2 * t4 + (e & 1);
          const int row = row0 + (e >> 1) * 8;
          const bool ok = col < p.sk && (!p.causal || col <= row + shift);
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
      // A row that has seen no key yet keeps m = -inf; exponentiate
      // against 0 so that it gives 0 and not NaN.
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

  // Epilogue: normalise, write out in the input type and the natural-log lse.
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = row0 + i * 8;
    const float l = fa::quad_sum(l_r[i]);
    if (row >= p.sq) continue;
    const float inv = l == 0.f ? 0.f : 1.f / l;
    T* og = reinterpret_cast<T*>(p.out) + bb * p.o_sb + row * p.o_ss + hh * p.o_sh;
#pragma unroll
    for (int db = 0; db < D / 8; ++db) {
      *reinterpret_cast<uint32_t*>(og + db * 8 + 2 * t4) =
          E::pack(o[db][2 * i] * inv, o[db][2 * i + 1] * inv);
    }
    if (t4 == 0) {
      p.lse[((int64_t)bb * p.h + hh) * p.sq + row] =
          l == 0.f ? -INFINITY : m_r[i] * FA_LN2 + logf(l);
    }
  }
}

template <typename T, int D>
cudaError_t launch(const FwdParams& p, int b, cudaStream_t stream) {
  const int smem = (BM + 2 * BN) * D * (int)sizeof(T);
  cudaError_t err = cudaFuncSetAttribute(
      fwd_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  dim3 grid((p.sq + BM - 1) / BM, p.h, b);
  fwd_kernel<T, D><<<grid, NTHREADS, smem, stream>>>(p);
  return cudaGetLastError();
}

}  // namespace

// q (b, sq, h, d), k/v (b, sk, h_k, d) given by element strides, the head
// dim contiguous; out has q's type and layout strides; lse (b, h, sq) fp32.
// Returns a cudaError_t (0 on success); block_q/block_k must name the tile
// the kernel is compiled for (dispatch/config.py get_fwd_config).
extern "C" int fa_fwd(const void* q, const void* k, const void* v, void* out,
                      float* lse, int b, int sq, int sk, int h, int h_k, int d,
                      int block_q, int block_k,
                      int64_t q_sb, int64_t q_ss, int64_t q_sh, int64_t k_sb,
                      int64_t k_ss, int64_t k_sh, int64_t v_sb, int64_t v_ss,
                      int64_t v_sh, int64_t o_sb, int64_t o_ss, int64_t o_sh,
                      float scale_log2, int causal, int is_bf16,
                      void* stream) {
  if (block_q != BM || block_k != BN) return (int)cudaErrorInvalidValue;
  FwdParams p;
  p.q = q;
  p.k = k;
  p.v = v;
  p.out = out;
  p.lse = lse;
  p.q_sb = q_sb; p.q_ss = q_ss; p.q_sh = q_sh;
  p.k_sb = k_sb; p.k_ss = k_ss; p.k_sh = k_sh;
  p.v_sb = v_sb; p.v_ss = v_ss; p.v_sh = v_sh;
  p.o_sb = o_sb; p.o_ss = o_ss; p.o_sh = o_sh;
  p.sq = sq;
  p.sk = sk;
  p.h = h;
  p.group = h / h_k;
  p.scale_log2 = scale_log2;
  p.causal = causal;
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  if (is_bf16) {
    if (d == 64) return launch<__nv_bfloat16, 64>(p, b, st);
    if (d == 128) return launch<__nv_bfloat16, 128>(p, b, st);
  } else {
    if (d == 64) return launch<__half, 64>(p, b, st);
    if (d == 128) return launch<__half, 128>(p, b, st);
  }
  return (int)cudaErrorInvalidValue;
}
