// Shared pieces of the Hamming kernels: the packed-row layout and the
// match count of one (query, database) pair.
//
// A guide of L <= 32 bases is one 16-byte row: .x holds base i at bits
// 2i..2i+1 (A=0, C=1, G=2, T=3), .y has bit 2i set iff base i is A/C/G/T
// (guidemaker_tpu_torch/knn/hamming.py:pack_codes).
#pragma once

#include <cuda_runtime.h>

namespace gm {

constexpr int kIdxBits = 24;
constexpr int kInfKey = 1 << 30;

// Positions where both bases are valid and equal.  x | x >> 1 has bit 2i
// clear iff the two 2-bit codes at i agree; the valid words drop every
// position holding an N on either side, so an N matches nothing.
__device__ __forceinline__ int matches(const ulonglong2 q,
                                       const ulonglong2 d) {
  const unsigned long long x = q.x ^ d.x;
  return __popcll(~(x | (x >> 1)) & q.y & d.y);
}

}  // namespace gm
