// Two probes of the card, the counterparts of the TPU probes of benchmarks/.
//
//  - smem_probe_kernel replaces benchmarks/vmem_probe.py:kernel, which
//    compiled a kernel with a growing VMEM scratch to find the largest that
//    Mosaic accepts. Here a block opts into `bytes` of dynamic shared memory
//    (cudaFuncSetAttribute(..., cudaFuncAttributeMaxDynamicSharedMemorySize,
//    bytes)), the entry point reports whether the card accepts that size and
//    how many such blocks fit on an SM (the occupancy API), and the kernel
//    computes o = x + x[0, 0] over an (8, 128) fp32 tile through the END of
//    the buffer, so that every accepted byte is addressable.
//  - overlap_probe_kernel replaces benchmarks/mxu_vpu_overlap_probe.py:
//    _kernel (MXU-only, VPU-only and both with no data dependence, timed by
//    trip-count slope): one block of 4 warps runs, per step, REPS rounds of
//    an mma.sync.m16n8k16 bf16 chain over CH independent accumulators
//    (tensor cores), of an exp2 chain v = exp2(v * 0.03125) - 1 over NV
//    independent values a thread (the MUFU special-function units plus two
//    FMA-pipe operations), or of both interleaved. Per-step time near the
//    larger of the two says the warp schedulers overlap them; near the sum,
//    that they serialise.
//
// Neither is bound by the card's rates in any useful sense: the first moves
// 8 KB, the second runs on one SM at the chains' latency. They measure
// limits (shared memory per block, instruction overlap), not throughput.

#include "common.cuh"

namespace {

constexpr int PROBE_THREADS = 128;
constexpr int CH = 4;     // independent mma accumulators a warp
constexpr int NV = 16;    // independent exp2 values a thread
constexpr int REPS = 4;   // rounds of each chain a step

__global__ void __launch_bounds__(PROBE_THREADS)
    smem_probe_kernel(const float* x, float* o, int n, int buf_floats) {
  extern __shared__ __align__(16) float buf[];
  float* tail = buf + buf_floats - n;
  for (int i = threadIdx.x; i < n; i += PROBE_THREADS) tail[i] = x[i];
  __syncthreads();
  const float x00 = tail[0];
  for (int i = threadIdx.x; i < n; i += PROBE_THREADS) o[i] = tail[i] + x00;
}

// MODE bit 0: the mma chain; bit 1: the exp2 chain.
template <int MODE>
__global__ void __launch_bounds__(PROBE_THREADS)
    overlap_probe_kernel(float* out_mma, float* out_exp, int steps) {
  const uint32_t ones = 0x3F803F80u;  // two bf16 1.0
  const uint32_t a[4] = {ones, ones, ones, ones};
  float acc[CH][4];
  float v[NV];
#pragma unroll
  for (int c = 0; c < CH; ++c) acc[c][0] = acc[c][1] = acc[c][2] = acc[c][3] = 0.f;
#pragma unroll
  for (int i = 0; i < NV; ++i) v[i] = 1.f;
  for (int t = 0; t < steps; ++t) {
#pragma unroll
    for (int r = 0; r < REPS; ++r) {
      if (MODE & 1) {
#pragma unroll
        for (int c = 0; c < CH; ++c)
          fa::Elem<__nv_bfloat16>::mma(acc[c], a, ones, ones);
      }
      if (MODE & 2) {
#pragma unroll
        for (int i = 0; i < NV; ++i) v[i] = exp2f(v[i] * 0.03125f) - 1.f;
      }
    }
  }
  const int tid = threadIdx.x;
#pragma unroll
  for (int c = 0; c < CH; ++c)
#pragma unroll
    for (int e = 0; e < 4; ++e) out_mma[(tid * CH + c) * 4 + e] = acc[c][e];
#pragma unroll
  for (int i = 0; i < NV; ++i) out_exp[tid * NV + i] = v[i];
}

}  // namespace

// Opt one block into `bytes` of dynamic shared memory and, if the card
// accepts it, run the (8, 128) tile through the end of it: o = x + x[0, 0]
// (n = 1024 floats). *blocks_per_sm gets the resident blocks of that size an
// SM takes. Returns the cudaError_t of the first step that refuses (0: the
// size is accepted and the kernel launched).
extern "C" int fa_smem_probe(const float* x, float* o, int n, int bytes,
                             int* blocks_per_sm, void* stream) {
  *blocks_per_sm = 0;
  if (n <= 0 || bytes < n * (int)sizeof(float) || bytes % 16)
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      smem_probe_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        blocks_per_sm, smem_probe_kernel, PROBE_THREADS, bytes);
  if (err != cudaSuccess) {
    cudaGetLastError();  // a refused size is an answer, not a sticky fault
    return (int)err;
  }
  smem_probe_kernel<<<1, PROBE_THREADS, bytes,
                      reinterpret_cast<cudaStream_t>(stream)>>>(
      x, o, n, bytes / (int)sizeof(float));
  return (int)cudaGetLastError();
}

// One block, `steps` steps of mode 1 (mma), 2 (exp2) or 3 (both). out_mma
// (128 * CH * 4) and out_exp (128 * NV) fp32 get the chains' final values.
extern "C" int fa_overlap_probe(float* out_mma, float* out_exp, int mode,
                                int steps, void* stream) {
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  if (mode == 1)
    overlap_probe_kernel<1><<<1, PROBE_THREADS, 0, st>>>(out_mma, out_exp, steps);
  else if (mode == 2)
    overlap_probe_kernel<2><<<1, PROBE_THREADS, 0, st>>>(out_mma, out_exp, steps);
  else if (mode == 3)
    overlap_probe_kernel<3><<<1, PROBE_THREADS, 0, st>>>(out_mma, out_exp, steps);
  else
    return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}
