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
// causal band, the tile loop of fwd_tile.cuh (shared with the packed-varlen
// forwards of flash_varlen.cu). Q stays in registers as mma fragments for the whole loop;
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

#include "fwd_tile.cuh"

namespace {

constexpr int BM = fa::FWD_BM;  // query rows per block
constexpr int BN = fa::FWD_BN;  // keys per K/V tile
constexpr int NTHREADS = fa::FWD_THREADS;

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

// One block per (64-row query tile, head, batch row): the tile loop of
// fwd_tile.cuh over this batch row's keys.
template <typename T, int D>
__global__ void __launch_bounds__(NTHREADS) fwd_kernel(const FwdParams p) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  const int hh = blockIdx.y;
  const int bb = blockIdx.z;
  const int kh = hh / p.group;
  fa::FwdTile<T> t;
  t.q = reinterpret_cast<const T*>(p.q) + bb * p.q_sb + hh * p.q_sh;
  t.out = reinterpret_cast<T*>(p.out) + bb * p.o_sb + hh * p.o_sh;
  t.lse = p.lse + ((int64_t)bb * p.h + hh) * p.sq;
  t.q_ss = p.q_ss;
  t.o_ss = p.o_ss;
  t.sq = p.sq;
  t.sk = p.sk;
  t.m0 = blockIdx.x * BM;
  const fa::LinearKV<T, D> kv{
      reinterpret_cast<const T*>(p.k) + bb * p.k_sb + kh * p.k_sh,
      reinterpret_cast<const T*>(p.v) + bb * p.v_sb + kh * p.v_sh, p.k_ss,
      p.v_ss};
  fa::fwd_tile<T, D>(t, kv, p.scale_log2, p.causal, smem_raw);
}

template <typename T, int D>
cudaError_t launch(const FwdParams& p, int b, cudaStream_t stream) {
  const int smem = fa::fwd_smem_bytes<T, D>();
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
