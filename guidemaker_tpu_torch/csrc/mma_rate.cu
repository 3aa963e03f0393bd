// Throughput probe of the tensor-core products that the count kernels can
// use: the mma.sync s8 m16n8k32 (mma_common.cuh mma_s8) and b1 m16n8k256
// .and.popc (mma_b1), and the warpgroup s8 m64n128k32 and b1 m64n128k256
// .and.popc with A in registers that the 2-bit and the 3-gram counts issue
// (wgmma_common.cuh).  NVIDIA's data sheet gives the H100's int8
// tensor-core rate but no 1-bit one, and no rate for any instruction, so
// chip_smoke.py's phase 2 times this kernel for each kind and reports its
// operations a second (2 * M * N * K a product) and the SASS opcode it
// compiled to; the 3-gram count's 1-bit bound rests on the mma.sync
// ratio, and the counts' times are read against the wgmma rates.  Not on
// any path of the program.
//
// Each mma.sync warp runs kChains independent accumulator chains, one
// product each per iteration, on register operands that depend on the
// thread (so nothing folds), and writes one sum of its accumulators a
// thread, so the compiler keeps every product.  Nothing is read from
// memory.  Each wgmma warpgroup issues kChains products an iteration into
// one accumulator set, as the count kernels' steps do, with at most two
// commit groups in flight, on a B tile of 128 rows in shared memory.
#include <stdint.h>

#include "mma_common.cuh"
#include "wgmma_common.cuh"

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

// Each warpgroup of the block issues iters * kChains wgmma products into
// one accumulator set, b1 m64n128k256 if kB1, else s8 m64n128k32, on one B
// tile of 128 rows of 32 bytes in shared memory.
template <bool kB1>
__device__ __forceinline__ void wgmma_chain(int iters, int* __restrict__ out) {
  // one B tile of 128 rows in the layout of wgmma_common.cuh
  __shared__ __align__(128) uint32_t b[128 * 32 / 4];
  for (int i = threadIdx.x; i < 128 * 32 / 4; i += gm::kThreads)
    b[i] = i * 0x9e3779b9u + blockIdx.x;
  gm::fence_proxy_async();
  __syncthreads();
  const uint32_t x = threadIdx.x * 0x9e3779b9u + blockIdx.x;
  const uint32_t a[4] = {x, x ^ 0x55555555u, x + 0x01010101u, x * 3u};
  const uint64_t desc = gm::smem_desc(
      static_cast<uint32_t>(__cvta_generic_to_shared(b)), 128, 256);
  int acc[64] = {};
  gm::wgmma_fence();
  for (int i = 0; i < iters; ++i) {
#pragma unroll
    for (int c = 0; c < kChains; ++c) {
      if constexpr (kB1)
        gm::wgmma_m64n128k256_b1(acc, a, desc, 1);
      else
        gm::wgmma_m64n128k32_s8(acc, a, desc, 1);
    }
    gm::wgmma_commit();
    gm::wgmma_wait<1>();
  }
  gm::wgmma_wait<0>();
  gm::fence_regs(acc);
  int sum = 0;
#pragma unroll
  for (int i = 0; i < 64; ++i) sum += acc[i];
  out[blockIdx.x * gm::kThreads + threadIdx.x] = sum;
}

__global__ void __launch_bounds__(gm::kThreads)
    wgmma_rate_kernel(int iters, int* __restrict__ out) {
  wgmma_chain<false>(iters, out);
}

__global__ void __launch_bounds__(gm::kThreads)
    wgmma_b1_rate_kernel(int iters, int* __restrict__ out) {
  wgmma_chain<true>(iters, out);
}

}  // namespace

// kind 0: s8 m16n8k32, kind 1: b1 m16n8k256, each warp of a block of 8
// issuing iters * 8 products; kind 2: s8 wgmma m64n128k32, kind 3: b1
// wgmma m64n128k256 .and.popc, each of the block's 2 warpgroups issuing
// iters * 8 products; out (blocks * 256,) int32.  Returns
// cudaGetLastError() after the launch.
extern "C" int gm_mma_rate(int kind, int blocks, int iters, void* out,
                           void* stream) {
  if (kind < 0 || kind > 3 || blocks <= 0 || iters <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  int* o = static_cast<int*>(out);
  if (kind == 0)
    mma_rate_kernel<0><<<blocks, gm::kThreads, 0, s>>>(iters, o);
  else if (kind == 1)
    mma_rate_kernel<1><<<blocks, gm::kThreads, 0, s>>>(iters, o);
  else if (kind == 2)
    wgmma_rate_kernel<<<blocks, gm::kThreads, 0, s>>>(iters, o);
  else
    wgmma_b1_rate_kernel<<<blocks, gm::kThreads, 0, s>>>(iters, o);
  return static_cast<int>(cudaGetLastError());
}
