// Packed-pair count kernel: for each query, the number of database guides
// at Hamming distance < editdist, with two database guides per 128-lane
// int8 row (packed_common.cuh), on the int8 tensor cores.
//
// Replaces the JAX package's Pallas kernel
// guidemaker_tpu/knn/pallas_packed.py:_count_kernel (launched by
// _packed_count), which ran the same int8 product on the TPU's matrix unit
// and decoded both guides' sums from the one dot v = s*A + B of a row.
// What it computes: dist < e <=> m > L - e <=> A > T (and B > T) with
// T = 3L - 4e, every real guide counted once.
//
// What bounds it on an H100: operations.  The product is the packed rows'
// int8 dot, 2 * nq * (nd / 2) * 6L = 2 * nq * nd * 3L useful operations
// (the bound that chip_smoke.py states), at 1,979 TOP/s dense; the threshold epilogue is a few integer operations a
// sum on the INT32 pipes.  The database streams from L2 and is reused by
// the 256 queries of a block.  The design:
//   * the product is packed_common.cuh's: mma.sync.m16n8k32 s8 -> s32 on
//     the rows as they stand, with the sum split into acc_e = s*A (even
//     steps) and acc_o = B (odd steps) instead of decoding v in float32 on
//     every pair (the dp4a kernel it replaces spent 32 dp4a and a float
//     decode a pair row on the CUDA cores); NS + 1 MMAs a 16 x 16 tile of
//     (query, guide) pairs, 5 at L 17..21, where the 2-bit count needs 6
//     for the same pairs at L 20;
//   * 8 warps of 32 queries held as A fragments, 128-row tiles copied by
//     cp.async into a two-buffer ring (the rows need no decode, so they
//     need not pass through registers), read by ldmatrix.x4;
//   * the gate is the 2-bit count's, with no decode: acc_e starts at
//     -s*(T+1) and acc_o at -(T+1), so a pair counts iff its sum is >= 0.
//     A lane ANDs its 32 sums; if the sign bit survives, none counts (the
//     common case), else each sum >= 0 is counted when its guide index is
//     below the split's end and nd (a zero slot sums to 0, which passes
//     whenever T + 1 <= 0, e.g. at editdist L);
//   * the NS k32 steps (1..4) are a template parameter, set from L by
//     gm::with_pair_steps, as the length is an argument of the C entry
//     point;
//   * the database is cut into gridDim.y splits of whole tiles so that
//     small query sets still fill the card; each split adds its per-query
//     counts, summed over the quad, with one integer atomicAdd, so the
//     result is exact and does not depend on the order in which blocks
//     finish.
// Targets sm_90a (mma.sync, ldmatrix and cp.async exist from sm_80; wgmma
// and TMA, Hopper's faster path to the tensor cores, are not used).
#include <stdint.h>

#include "packed_common.cuh"

namespace {

using gm::kMTiles;
using gm::kPairNTiles;
using gm::kQPerBlock;
using gm::kThreads;
using gm::kTile;

template <int NS>
__device__ __forceinline__ void count_block(
    const uint32_t* __restrict__ q, int nq, const int4* __restrict__ db,
    int lo, int hi, int ghi, int three_l, int bias_e, int bias_o,
    int* __restrict__ out, uint8_t* ring) {
  const int t = threadIdx.x & 3;
  const int qw = blockIdx.x * kQPerBlock + (threadIdx.x >> 5) * 32;
  uint32_t ae[kMTiles][gm::even_steps(NS)][4];
  uint32_t ao[kMTiles][gm::odd_steps(NS)][4];
  gm::load_pair_a<NS>(ae, ao, q, nq, qw, three_l);
  int cnt[kMTiles][2] = {};

  gm::pair_tiles<NS>(db, lo, hi, ring, [&](uint32_t src, int t0, int n0) {
    int acc_e[kMTiles][kPairNTiles][4], acc_o[kMTiles][kPairNTiles][4];
#pragma unroll
    for (int mt = 0; mt < kMTiles; ++mt)
#pragma unroll
      for (int nt = 0; nt < kPairNTiles; ++nt)
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          acc_e[mt][nt][i] = bias_e;
          acc_o[mt][nt][i] = bias_o;
        }
    gm::pair_mma_batch<NS>(acc_e, acc_o, ae, ao, src, n0);
    int all = -1;
#pragma unroll
    for (int mt = 0; mt < kMTiles; ++mt)
#pragma unroll
      for (int nt = 0; nt < kPairNTiles; ++nt)
#pragma unroll
        for (int i = 0; i < 4; ++i) all &= acc_e[mt][nt][i] & acc_o[mt][nt][i];
    if (all < 0) return;  // every sum is < 0: nothing counts
    // the even guide of the lane's pair row 8 nt + 2t + e is
    // ge + 16 nt + 2e, its odd guide one more
    const int ge = 2 * (t0 + n0 + 2 * t);
#pragma unroll
    for (int mt = 0; mt < kMTiles; ++mt)
#pragma unroll
      for (int nt = 0; nt < kPairNTiles; ++nt)
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int gi = ge + 16 * nt + 2 * (i & 1);
          cnt[mt][i >> 1] += (acc_e[mt][nt][i] >= 0 && gi < ghi) +
                             (acc_o[mt][nt][i] >= 0 && gi + 1 < ghi);
        }
  });
  gm::add_counts(cnt, out, nq, qw);
}

__global__ void __launch_bounds__(kThreads, 2)
    packed_count_kernel(const uint32_t* __restrict__ q, int nq,
                        const int4* __restrict__ db, int nd, int length,
                        int thresh, int rows_per_split,
                        int* __restrict__ out) {
  __shared__ __align__(16) uint8_t ring[gm::kPairRing];
  const int lo = blockIdx.y * rows_per_split;
  const int hi = min((nd + 1) / 2, lo + rows_per_split);
  // guides below ghi are real and in this split
  const int ghi = min(2 * hi, nd);
  const int bias_o = -(thresh + 1), bias_e = (4 * length + 1) * bias_o;
  const int three_l = 3 * length;
  gm::with_pair_steps(length, [&](auto ns) {
    count_block<decltype(ns)::value>(q, nq, db, lo, hi, ghi, three_l, bias_e,
                                     bias_o, out, ring);
  });
}

}  // namespace

// q (nq, 128) and db (n2 = ceil(nd / 2), 128) int8 packed rows, 16-byte
// aligned; out (nq,) int32, zeroed by the caller.  Returns
// cudaGetLastError() after the launch.
extern "C" int gm_packed_count(const void* q, int nq, const void* db, int nd,
                               int length, int editdist, int n_splits,
                               void* out, void* stream) {
  const int n2 = (nd + 1) / 2;
  if (nq <= 0 || nd <= 0 || length < 1 || 6 * length > 128 ||
      editdist < 0 || editdist > length || n_splits <= 0 ||
      n_splits > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  // whole tiles a split, so that only the last split has a ragged tile
  const int tiles = (n2 + kTile - 1) / kTile;
  const int rows_per_split = (tiles + n_splits - 1) / n_splits * kTile;
  const dim3 grid((nq + kQPerBlock - 1) / kQPerBlock, n_splits);
  packed_count_kernel<<<grid, kThreads, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(q), nq, static_cast<const int4*>(db), nd,
      length, 3 * length - 4 * editdist, rows_per_split,
      static_cast<int*>(out));
  return static_cast<int>(cudaGetLastError());
}
