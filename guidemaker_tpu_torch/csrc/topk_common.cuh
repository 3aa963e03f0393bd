// Shared pieces of the top-k kernels (hamming_topk.cu, packed_topk.cu):
// the register-list insertion and the kernel that merges the per-split
// lists into the final top-k.
//
// Each top-k kernel writes one ascending list of K packed keys
// (dist << 24) | idx per (query, database split) to partial, shaped
// (nq, n_splits, K); merge_kernel folds the splits into out (nq, k).  Keys
// are unique per query, so the result does not depend on split order.
#pragma once

#include <cuda_runtime.h>

#include "hamming_common.cuh"

namespace gm {

constexpr int kMergeThreads = 256;

// Insert key into the ascending list best[0..K), dropping the largest.
template <int K>
__device__ __forceinline__ void insert(int (&best)[K], int key) {
#pragma unroll
  for (int i = 0; i < K; ++i) {
    const int lo = min(best[i], key);
    key = max(best[i], key);
    best[i] = lo;
  }
}

template <int K>
__global__ void __launch_bounds__(kMergeThreads)
    merge_kernel(const int* __restrict__ partial, int nq, int n_splits, int k,
                 int* __restrict__ out) {
  const int qi = blockIdx.x * kMergeThreads + threadIdx.x;
  if (qi >= nq) return;
  int best[K];
#pragma unroll
  for (int i = 0; i < K; ++i) best[i] = kInfKey;
  const int* p = partial + static_cast<size_t>(qi) * n_splits * K;
  for (int s = 0; s < n_splits; ++s) {
    for (int i = 0; i < K; ++i) {
      const int key = p[s * K + i];
      if (key >= best[K - 1]) break;  // each split's list is ascending
      insert<K>(best, key);
    }
  }
#pragma unroll
  for (int i = 0; i < K; ++i)
    if (i < k) out[static_cast<size_t>(qi) * k + i] = best[i];
}

// Launch merge_kernel after a top-k kernel; returns the first CUDA error.
template <int K>
int launch_merge(const void* partial, int nq, int n_splits, int k, void* out,
                 cudaStream_t stream) {
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  merge_kernel<K><<<(nq + kMergeThreads - 1) / kMergeThreads, kMergeThreads,
                    0, stream>>>(static_cast<const int*>(partial), nq,
                                 n_splits, k, static_cast<int*>(out));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace gm

// The extern "C" entry of a top-k kernel file: dispatch kcap (k rounded up
// to a power of two <= 128) to the template LAUNCH<K>(ARGS...).
#define GM_DISPATCH_KCAP(kcap, LAUNCH, ...)                  \
  switch (kcap) {                                            \
    case 1: return LAUNCH<1>(__VA_ARGS__);                   \
    case 2: return LAUNCH<2>(__VA_ARGS__);                   \
    case 4: return LAUNCH<4>(__VA_ARGS__);                   \
    case 8: return LAUNCH<8>(__VA_ARGS__);                   \
    case 16: return LAUNCH<16>(__VA_ARGS__);                 \
    case 32: return LAUNCH<32>(__VA_ARGS__);                 \
    case 64: return LAUNCH<64>(__VA_ARGS__);                 \
    case 128: return LAUNCH<128>(__VA_ARGS__);               \
    default: return static_cast<int>(cudaErrorInvalidValue); \
  }
