// Shared pieces of the packed-pair kernels (packed_count.cu,
// packed_topk.cu) on the int8 tensor cores: the row layout, the split of
// the product into its even and odd sums, the A fragments, the tile loader
// of mma_common.cuh's cp.async ring and one warp's product with 16 pair
// rows.
//
// Layout (guidemaker_tpu_torch/knn/packed.py).  Each base maps to a vertex
// of the regular tetrahedron in {-1,+1}^3 (A, C, G, T; N -> 0), so two
// bases dot to 3 if equal and -1 if not, and L bases to 4m - L for m
// matches.  A query row is the int8 row [tetra(q) | tetra(q) | 0] and a
// database row holds two guides, [s * tetra(even) | tetra(odd) | 0], with
// s = 4L + 1 and 6L <= 128 lanes (L <= 21).  The dot of lanes [0, 3L) is
// s*A and that of lanes [3L, 6L) is B, with A = 4*m_even - L and
// B = 4*m_odd - L.
//
// Split sums.  A database row is, as it stands, one n-column of the
// B operand of mma.sync.m16n8k32 s8 (K = 32 lanes a step), so its tiles go
// to shared memory untouched.  The query side is cut in two: the even
// fragments take the k32 steps over lanes [0, 3L) with the query's lanes
// >= 3L zeroed, and the odd fragments the steps over [3L, 6L) with its
// lanes < 3L zeroed; the step that straddles lane 3L (3L is never a
// multiple of 32 for L <= 21) is taken by both.  Two accumulators then
// hold s*A and B apart, and no pair needs the float decode of the single
// sum v = s*A + B.  That is NS + 1 MMAs per m16 x n8 tile for NS = 6L/32
// rounded up (5 at L 17..21), each tile 16 queries x 16 guides.
//
// Block: 8 warps; each holds 2 m16 tiles (32 queries) as A fragments in
// registers for the whole database loop.  Tiles of 128 pair rows (the first
// 32 * NS bytes of each) are copied by cp.async into a ring of two
// shared-memory buffers, row stride 32 * NS + 16 bytes (an odd number of
// 16-byte units, so the 8 row addresses of an ldmatrix phase fall in 8
// different bank groups), zero-filled past the split's end, and read with
// ldmatrix.x4, one per k32 step for two n8 tiles.  A warp multiplies 2 n8
// tiles (16 pair rows, 32 guides) before its epilogue: 32 sums a lane, 8
// independent accumulator chains.
//
// In the accumulator layout, lane 4g + t holds, for m16 tile mt and n8 tile
// nt, acc_e[mt][nt][i] (acc_o alike) = the sum of query row
// 16 mt + 8 (i >> 1) + g of the warp with pair row 8 nt + 2t + (i & 1) of
// the batch, that is guide 2 * pair row (acc_e) or 2 * pair row + 1
// (acc_o).
//
// A zero slot (a pair row past the split's end, the odd slot of the last
// row when nd is odd) sums to 0, which means m = L/4, not "no match", so
// both epilogues mask every passing sum by its global guide index.
//
// The kernels are never fed an N: an N is the zero vector here and would
// count as a quarter match, so the index routes guides with N to the 2-bit
// kernels (KnnIndex's N gate).
#pragma once

#include <stdint.h>

#include "mma_common.cuh"

namespace gm {

// int4 words of one 128-lane int8 row
constexpr int kPackedVecs = 8;
// n8 tiles of pair rows a warp multiplies before one epilogue
constexpr int kPairNTiles = 2;
constexpr int kPairBatch = 8 * kPairNTiles;
// k32 steps of a full row, and the widest tile row in shared memory
constexpr int kPairMaxSteps = 4;
constexpr int kPairMaxStride = 32 * kPairMaxSteps + 16;
// shared memory of the two-buffer tile ring
constexpr int kPairRing = 2 * kTile * kPairMaxStride;

static_assert(kPairNTiles == 2, "one ldmatrix.x4 a k32 step covers the batch");
static_assert(kTile % kPairBatch == 0, "whole batches a tile");

// k32 steps of the B operand: lanes [0, 6L)
__host__ __device__ constexpr int pair_steps(int length) {
  return (6 * length + 31) / 32;
}

// k32 steps of the even sum, lanes [0, 3L), and of the odd sum, steps
// even_steps(NS) - 1 .. NS - 1.
__host__ __device__ constexpr int even_steps(int ns) { return (ns + 1) / 2; }
__host__ __device__ constexpr int odd_steps(int ns) {
  return ns - even_steps(ns) + 1;
}

constexpr bool even_steps_cover_3l() {
  for (int length = 1; 6 * length <= 128; ++length)
    if (even_steps(pair_steps(length)) != (3 * length + 31) / 32)
      return false;
  return true;
}
static_assert(even_steps_cover_3l(),
              "the even steps are ceil(3L / 32) for every L a row holds");

// The k32 steps NS of a row, as a type.
template <int NS>
struct PairSteps {
  static constexpr int value = NS;
};

// f(PairSteps<pair_steps(length)>{}): the kernels' step counts are
// template parameters, set here from the length their entry points take.
template <typename F>
__device__ __forceinline__ void with_pair_steps(int length, F&& f) {
  static_assert(kPairMaxSteps == 4, "one case a step count");
  switch (pair_steps(length)) {
    case 1: f(PairSteps<1>{}); break;
    case 2: f(PairSteps<2>{}); break;
    case 3: f(PairSteps<3>{}); break;
    case 4: f(PairSteps<4>{}); break;
  }
}

// The bytes of the 4-byte word at lane offset o whose lanes are < n.
__device__ __forceinline__ uint32_t lanes_below(int o, int n) {
  const int keep = min(max(n - o, 0), 4);
  return keep == 4 ? 0xffffffffu : (1u << (8 * keep)) - 1u;
}

// The A fragments of the warp's queries qw..qw+31 from their int8 rows:
// rows g and g+8 of each m16 tile; lanes 32s+4t.. in registers 0 and 1,
// lanes 32s+16+4t.. in registers 2 and 3 (the s8 m16n8k32 layout).  ae
// holds steps 0..ES-1 with lanes >= 3L zeroed, ao steps ES-1..NS-1 with
// lanes < 3L zeroed (ES = even_steps(NS)).  A query past nq is zeros.
template <int NS>
__device__ __forceinline__ void load_pair_a(
    uint32_t (&ae)[kMTiles][even_steps(NS)][4],
    uint32_t (&ao)[kMTiles][odd_steps(NS)][4],
    const uint32_t* __restrict__ q, int nq, int qw, int three_l) {
  constexpr int ES = even_steps(NS);
  const int g = (threadIdx.x & 31) >> 2, t = threadIdx.x & 3;
#pragma unroll
  for (int mt = 0; mt < kMTiles; ++mt) {
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int qi = qw + mt * 16 + half * 8 + g;
      const uint32_t* row = q + static_cast<size_t>(qi) * (4 * kPackedVecs);
#pragma unroll
      for (int s = 0; s < NS; ++s) {
#pragma unroll
        for (int hi = 0; hi < 2; ++hi) {
          const int o = 32 * s + 16 * hi + 4 * t;
          const uint32_t w = qi < nq ? row[o / 4] : 0u;
          const uint32_t below = lanes_below(o, three_l);
          if (s < ES) ae[mt][s][2 * hi + half] = w & below;
          if (s >= ES - 1) ao[mt][s - ES + 1][2 * hi + half] = w & ~below;
        }
      }
    }
  }
}

// Start copying pair rows [t0, t0 + kTile) of the database into the ring
// buffer at shared address dst: the first 32 * NS bytes of each row, 16
// bytes a cp.async; rows at or past hi are zero-filled.
template <int NS>
__device__ __forceinline__ void load_pair_tile(uint32_t dst,
                                               const int4* __restrict__ db,
                                               int t0, int hi) {
  constexpr int kUnits = 2 * NS;  // 16-byte units a tile row
  static_assert(kTile * 2 == kThreads, "NS copies a thread");
#pragma unroll
  for (int j = 0; j < NS; ++j) {
    const int c = threadIdx.x + j * kThreads;
    const int r = c / kUnits, u = c % kUnits;
    const bool in = t0 + r < hi;
    const int4* src =
        db + (in ? static_cast<size_t>(t0 + r) * kPackedVecs + u : 0);
    cp_async<16>(dst + r * (32 * NS + 16) + 16 * u, src, in ? 16 : 0);
  }
}

// acc_e += the even fragments times tile rows n0..n0+15, acc_o += the odd
// ones; src is the lane's ldmatrix address of the buffer's row 0
// (ldsm_src<NS>).
template <int NS>
__device__ __forceinline__ void pair_mma_batch(
    int (&acc_e)[kMTiles][kPairNTiles][4],
    int (&acc_o)[kMTiles][kPairNTiles][4],
    const uint32_t (&ae)[kMTiles][even_steps(NS)][4],
    const uint32_t (&ao)[kMTiles][odd_steps(NS)][4], uint32_t src, int n0) {
  constexpr int ES = even_steps(NS);
  constexpr int kStride = 32 * NS + 16;
  uint32_t b[NS][4];
#pragma unroll
  for (int s = 0; s < NS; ++s) ldsm_x4(b[s], src + n0 * kStride + 32 * s);
#pragma unroll
  for (int mt = 0; mt < kMTiles; ++mt)
#pragma unroll
    for (int nt = 0; nt < kPairNTiles; ++nt) {
#pragma unroll
      for (int s = 0; s < ES; ++s)
        mma_s8(acc_e[mt][nt], ae[mt][s], b[s][2 * nt], b[s][2 * nt + 1]);
#pragma unroll
      for (int s = ES - 1; s < NS; ++s)
        mma_s8(acc_o[mt][nt], ao[mt][s - ES + 1], b[s][2 * nt],
               b[s][2 * nt + 1]);
    }
}

// Every thread of the block walks the split's pair rows [lo, hi) through
// the two-buffer tile ring (tile_ring) at shared address ring, calling
// batch(src, t0, n0) for each 16-row batch of each tile.
template <int NS, typename Batch>
__device__ __forceinline__ void pair_tiles(const int4* __restrict__ db,
                                           int lo, int hi, uint8_t* ring,
                                           Batch&& batch) {
  tile_ring<NS, kPairBatch>(
      lo, hi, ring,
      [&](uint32_t dst, int t0) { load_pair_tile<NS>(dst, db, t0, hi); },
      batch);
}

}  // namespace gm
