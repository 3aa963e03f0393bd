// Throughput probe of the two mma.sync products that the count kernels can
// use: s8 m16n8k32 (mma_common.cuh mma_s8) and b1 m16n8k256 .and.popc
// (mma_b1).  NVIDIA's data sheet gives the H100's int8 tensor-core rate but
// no 1-bit one, so chip_smoke.py's phase 2 times this kernel for each kind
// and reports its operations a second (2 * 16 * 8 * K a product) and the
// SASS opcode it compiled to; feature_count.cu's design, and its 1-bit
// bound, rest on that ratio.  Not on any path of the program.
//
// Each warp runs kChains independent accumulator chains, one product each
// per iteration, on register operands that depend on the thread (so nothing
// folds), and writes one sum of its accumulators a thread, so the compiler
// keeps every product.  Nothing is read from memory.
#include <stdint.h>

#include "mma_common.cuh"

namespace {

constexpr int kChains = 8;

template <int KIND>
__global__ void __launch_bounds__(gm::kThreads)
    mma_rate_kernel(int iters, int* __restrict__ out) {
  const uint32_t x = threadIdx.x * 0x9e3779b9u + blockIdx.x;
  const uint32_t a[4] = {x, x ^ 0x55555555u, x + 0x01010101u, x * 3u};
  const uint32_t b0 = x ^ 0x0f0f0f0fu, b1 = x + 7u;
  int acc[kChains][4] = {};
#pragma unroll 4
  for (int i = 0; i < iters; ++i)
#pragma unroll
    for (int c = 0; c < kChains; ++c)
      gm::mma_step<KIND == 1>(acc[c], a, b0, b1);
  int sum = 0;
#pragma unroll
  for (int c = 0; c < kChains; ++c)
#pragma unroll
    for (int i = 0; i < 4; ++i) sum += acc[c][i];
  out[blockIdx.x * gm::kThreads + threadIdx.x] = sum;
}

}  // namespace

// kind 0: s8 m16n8k32, kind 1: b1 m16n8k256; blocks of 8 warps, each warp
// issuing iters * 8 products; out (blocks * 256,) int32.  Returns
// cudaGetLastError() after the launch.
extern "C" int gm_mma_rate(int kind, int blocks, int iters, void* out,
                           void* stream) {
  if (kind < 0 || kind > 1 || blocks <= 0 || iters <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  int* o = static_cast<int*>(out);
  if (kind == 0)
    mma_rate_kernel<0><<<blocks, gm::kThreads, 0, s>>>(iters, o);
  else
    mma_rate_kernel<1><<<blocks, gm::kThreads, 0, s>>>(iters, o);
  return static_cast<int>(cudaGetLastError());
}
