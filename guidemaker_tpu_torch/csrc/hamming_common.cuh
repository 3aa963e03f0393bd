// Shared pieces of the Hamming kernels: the packed-row layout and the
// packed-key constants.
//
// A guide of L <= 32 bases is one 16-byte row: .x holds base i at bits
// 2i..2i+1 (A=0, C=1, G=2, T=3), .y has bit 2i set iff base i is A/C/G/T
// (guidemaker_tpu_torch/knn/hamming.py:pack_codes).
#pragma once

#include <cuda_runtime.h>

namespace gm {

constexpr int kIdxBits = 24;
constexpr int kInfKey = 1 << 30;

}  // namespace gm
