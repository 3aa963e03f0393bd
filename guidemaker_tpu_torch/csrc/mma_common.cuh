// Shared pieces of the tensor-core kernels from before Hopper's warpgroup
// product: the block and tile heights that the wgmma kernels
// (onehot_wgmma.cuh, packed_common.cuh, feature_count.cu) take, the
// mma.sync wrappers (s8 m16n8k32, b1 m16n8k256) that the tensor-core rate
// probe (mma_rate.cu) times beside the wgmma products, and cp.async.
// No kernel of the program issues mma.sync.
#pragma once

#include <stdint.h>

#include "hamming_common.cuh"

namespace gm {

// threads of a rate-probe block: 8 warps, or 2 warpgroups
constexpr int kThreads = 256;
// queries a block: four consumer warpgroups of one m64 tile each
constexpr int kQPerBlock = 256;
// database rows a shared-memory tile: the N of one m64n128 product
constexpr int kTile = 128;
// k32 steps of a 32-base one-hot row
constexpr int kMaxSteps = 4;

// d += a x b over one k32 step of int8 lanes (32 bytes a row).
__device__ __forceinline__ void mma_s8(int (&d)[4], const uint32_t (&a)[4],
                                       uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// d += popcount(a & b) over one k256 step of 1-bit lanes (32 bytes a row).
// Its fragments are mma_s8's with each byte read as 8 consecutive k lanes.
__device__ __forceinline__ void mma_b1(int (&d)[4], const uint32_t (&a)[4],
                                       uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k256.row.col.s32.b1.b1.s32.and.popc "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// mma_b1 if kB1, else mma_s8.
template <bool kB1>
__device__ __forceinline__ void mma_step(int (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  if constexpr (kB1)
    mma_b1(d, a, b0, b1);
  else
    mma_s8(d, a, b0, b1);
}

// Copy N (8 or 16) bytes from global src to shared dst without passing
// through registers; src_bytes 0 writes N zero bytes instead.
template <int N>
__device__ __forceinline__ void cp_async(uint32_t dst, const void* src,
                                         int src_bytes) {
  static_assert(N == 8 || N == 16, "8- or 16-byte copies");
  if constexpr (N == 16)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
                 :
                 : "r"(dst), "l"(src), "r"(src_bytes)
                 : "memory");
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n"
                 :
                 : "r"(dst), "l"(src), "r"(src_bytes)
                 : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Wait until at most N of this thread's cp.async groups are in flight.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" : : "n"(N) : "memory");
}

}  // namespace gm
