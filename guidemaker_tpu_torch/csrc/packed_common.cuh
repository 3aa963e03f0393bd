// Shared pieces of the packed-pair kernels (packed_count.cu,
// packed_topk.cu): the row layout, the dot product and its exact decode.
//
// Layout (guidemaker_tpu_torch/knn/packed.py).  Each base maps to a vertex
// of the regular tetrahedron in {-1,+1}^3 (A, C, G, T; N -> 0), so two
// bases dot to 3 if equal and -1 if not, and L bases to 4m - L for m
// matches.  A query row is the int8 row [tetra(q) | tetra(q) | 0] and a
// database row holds two guides, [s * tetra(even) | tetra(odd) | 0], with
// s = 4L + 1 and 6L <= 128 lanes (L <= 21).  One 128-lane dot is then
// v = s*A + B with A = 4*m_even - L and B = 4*m_odd - L.
//
// Decode.  v + L = s*A + (B + L) with 0 <= B + L <= 4L < s, so
// A = floor((v + L) / s) and B = v - s*A.  The floor is taken in float32 as
// floor((v + L + 0.5) * (1/s)): |v| < 2^13, and the +0.5 keeps the quotient
// at least 0.5/s from an integer, far beyond the few ulp of error of the
// multiply by a rounded reciprocal (exhaustively checked over every (A, B)
// and every L <= 21 by tests/test_torch_packed.py).  The intrinsics keep
// the compiler from fusing the add and the multiply into one FMA.
//
// The kernels are never fed an N: an N is the zero vector here and would
// count as a quarter match, so the index routes guides with N to the 2-bit
// kernels (KnnIndex's N gate).
#pragma once

#include <cuda_runtime.h>

namespace gm {

// int4 words of one 128-lane int8 row
constexpr int kPackedVecs = 8;

// Load a packed row into 32 registers.
__device__ __forceinline__ void load_row(const int4* __restrict__ row,
                                         int (&r)[4 * kPackedVecs]) {
#pragma unroll
  for (int w = 0; w < kPackedVecs; ++w) {
    const int4 x = row[w];
    r[4 * w] = x.x;
    r[4 * w + 1] = x.y;
    r[4 * w + 2] = x.z;
    r[4 * w + 3] = x.w;
  }
}

// v = sum over 128 int8 lanes of q * d, as 32 signed dp4a.
__device__ __forceinline__ int packed_dot(const int (&q)[4 * kPackedVecs],
                                          const int4* d) {
  int v = 0;
#pragma unroll
  for (int w = 0; w < kPackedVecs; ++w) {
    const int4 x = d[w];
    v = __dp4a(q[4 * w], x.x, v);
    v = __dp4a(q[4 * w + 1], x.y, v);
    v = __dp4a(q[4 * w + 2], x.z, v);
    v = __dp4a(q[4 * w + 3], x.w, v);
  }
  return v;
}

// A of v = s*A + B (see Decode above).
__device__ __forceinline__ int decode_even(int v, int length, float inv_s) {
  const float vl = __fadd_rn(__int2float_rn(v + length), 0.5f);
  return __float2int_rd(__fmul_rn(vl, inv_s));
}

}  // namespace gm
