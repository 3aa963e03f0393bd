// Count kernel: for each query, the number of database rows at Hamming
// distance < editdist (matches > L - editdist), on the int8 tensor cores.
//
// Replaces the JAX package's Pallas count kernel
// (guidemaker_tpu/knn/pallas_stream.py:_count_kernel, launched by
// _stream_count), which one-hot encoded the guides and counted matches as
// an int8 matrix product on the TPU's matrix unit.  This kernel computes
// the same product, (nq, K) x (K, nd) int8 one-hot rows into int32 match
// counts, with mma.sync on Hopper's tensor cores, and thresholds it in
// registers: the nq x nd match matrix never leaves the SM.
//
// What bounds it on an H100: operations, not bytes.  The product is
// 2 * nq * nd * 4L int8 operations (1,979 TOP/s dense), where the function
// needs 2 * nq * nd * 3L (the tetrahedral code of packed_common.cuh, the
// bound that chip_smoke.py states); the threshold
// epilogue is a few integer operations a pair on the INT32 pipes.  The
// database streams from L2 and is reused by the 256 queries of a block, so
// memory is far below either.  The design follows:
//   * layout and block shape: those of mma_common.cuh, shared with the
//     top-k kernel: one-hot rows of K = 32 * steps bytes, in which an N, a
//     base past L, a query past nq and a database row past the split all
//     decode to zeros, whose match count 0 is never > thresh >= 0, so the
//     loop needs no mask; only the final write checks nq; 8 warps of 32
//     queries held as A fragments in registers; 128-row database tiles
//     decoded once into shared memory and read with ldmatrix.x4, the next
//     tile's packed rows prefetched in registers (in place of cp.async:
//     they are decoded before they are stored, so they pass through
//     registers anyway);
//   * the k32 steps (1..4) are a template parameter; a block takes as many
//     as the last valid base of any of its queries needs (20-mers: 3), as
//     the length is not an argument of the C entry point;
//   * product: mma.sync.m16n8k32 s8 x s8 -> s32 on 32 database rows a warp,
//     the accumulators starting at -(thresh + 1), so a pair counts iff its
//     sum is >= 0.  A thread then ANDs its 32 sums: if the sign bit
//     survives, none counts (the common case: close pairs are rare), else
//     each adds its sign test to its query row's counter;
//   * the database is cut into gridDim.y splits so that small query sets
//     still fill the card; each split adds its per-query counts, summed
//     over the quad, with one integer atomicAdd, so the result is exact and
//     does not depend on the order in which blocks finish.
// Targets sm_90a (mma.sync and ldmatrix exist from sm_80; wgmma and TMA,
// Hopper's faster path to the tensor cores, are not used).
#include <stdint.h>

#include "mma_common.cuh"

namespace {

using gm::kMTiles;
using gm::kNTiles;
using gm::kQPerBlock;
using gm::kThreads;
using gm::kTile;

template <int KS>
__device__ __forceinline__ void count_block(
    const ulonglong2* __restrict__ q, int nq,
    const ulonglong2* __restrict__ db, int lo, int hi, int thresh,
    int* __restrict__ out, uint8_t* tile) {
  const ulonglong2 zero = make_ulonglong2(0ull, 0ull);
  const int qw = blockIdx.x * kQPerBlock + (threadIdx.x >> 5) * 32;
  uint32_t a[kMTiles][KS][4];
  gm::load_a<KS>(a, q, nq, qw);
  int cnt[kMTiles][2] = {};

  const int r = threadIdx.x >> 1;
  uint4* dst = gm::decode_dst<KS>(tile);
  const uint32_t src = gm::ldsm_src<KS>(tile);
  const int bias = -(thresh + 1);

  ulonglong2 next = lo + r < hi ? db[lo + r] : zero;
  for (int t0 = lo; t0 < hi; t0 += kTile) {
    __syncthreads();  // every warp is done with the previous tile
    gm::decode_row<KS>(dst, next);
    __syncthreads();
    const int rows = min(kTile, hi - t0);
    next = t0 + kTile + r < hi ? db[t0 + kTile + r] : zero;
#pragma unroll 1
    for (int n0 = 0; n0 < rows; n0 += gm::kBatch) {
      int acc[kMTiles][kNTiles][4];
#pragma unroll
      for (int mt = 0; mt < kMTiles; ++mt)
#pragma unroll
        for (int nt = 0; nt < kNTiles; ++nt)
#pragma unroll
          for (int i = 0; i < 4; ++i) acc[mt][nt][i] = bias;
      gm::mma_batch<KS>(acc, a, src, n0);
      gm::count_batch(cnt, acc);
    }
  }
  gm::add_counts(cnt, out, nq, qw);
}

__global__ void __launch_bounds__(kThreads, 2)
    count_kernel(const ulonglong2* __restrict__ q, int nq,
                 const ulonglong2* __restrict__ db, int nd, int thresh,
                 int rows_per_split, int* __restrict__ out) {
  __shared__ __align__(16) uint8_t tile[kTile * gm::kMaxStride];
  __shared__ int steps;
  const int lo = blockIdx.y * rows_per_split;
  const int hi = min(nd, lo + rows_per_split);
  switch (gm::block_steps(q, nq, &steps)) {
    case 1:
      count_block<1>(q, nq, db, lo, hi, thresh, out, tile);
      break;
    case 2:
      count_block<2>(q, nq, db, lo, hi, thresh, out, tile);
      break;
    case 3:
      count_block<3>(q, nq, db, lo, hi, thresh, out, tile);
      break;
    case 4:
      count_block<4>(q, nq, db, lo, hi, thresh, out, tile);
      break;
    default:  // no query of the block has a valid base: it counts nothing
      break;
  }
}

}  // namespace

// q (nq, 2) and db (nd, 2) packed rows; thresh = L - editdist >= 0; out
// (nq,) int32, zeroed by the caller.  Returns cudaGetLastError() after the
// launch.
extern "C" int gm_hamming_count(const void* q, int nq, const void* db, int nd,
                                int thresh, int n_splits, void* out,
                                void* stream) {
  if (nq <= 0 || nd <= 0 || thresh < 0 || n_splits <= 0 || n_splits > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  // whole tiles a split, so that only the last split has a ragged tile
  const int tiles = (nd + kTile - 1) / kTile;
  const int rows_per_split = (tiles + n_splits - 1) / n_splits * kTile;
  const dim3 grid((nq + kQPerBlock - 1) / kQPerBlock, n_splits);
  count_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const ulonglong2*>(q), nq,
      static_cast<const ulonglong2*>(db), nd, thresh, rows_per_split,
      static_cast<int*>(out));
  return static_cast<int>(cudaGetLastError());
}
