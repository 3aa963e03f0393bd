// Count kernel over bit-packed binary feature rows: for each query row, the
// number of database rows whose feature dot product exceeds thresh, on the
// tensor cores' 1-bit product.
//
// Replaces the JAX package's Pallas count kernel
// (guidemaker_tpu/knn/pallas_stream.py:164, _stream_count launching
// _count_kernel) where the Levenshtein retention filter calls it on
// positional 3-gram features (guidemaker_tpu/knn/leven.py:684 and 786):
// int8 rows of (L-2)*64 lanes, one lane per (gram position, gram value),
// multiplied on the TPU's matrix unit.  Every feature is 0 or 1, so here a
// row is G = n_words = L-2 64-bit words, bit g of word p being lane 64p + g
// (guidemaker_tpu_torch/knn/features.py), and the dot of two rows is
// sum_p popcount(q[p] & d[p]): exactly the tensor cores' 1-bit product,
// mma.sync.m16n8k256 .b1 .and.popc.
//
// What bounds it on an H100: operations, 2 * nq * nd * 64G bit
// operations.  NVIDIA's data sheet gives no 1-bit rate; chip_smoke.py's
// phase 2 measures one with csrc/mma_rate.cu, and this design was chosen on
// it: on an NVIDIA H100 80GB HBM3 at 700 W, b1 m16n8k256 issued 0.1554 T
// products/s (SASS BMMA) against s8 m16n8k32's 0.1549 T (IMMA), so one
// k256 step costs what one k32 step does: 10,187 T bit operations/s
// against 1,269 T int8 operations/s, 8.03 times the rate.  At L 20 a 16 x 8
// tile of pairs takes 5 BMMA, where the int8 form of the 64 lanes a gram
// position would take 36 IMMA.  The database streams from L2 and is reused
// by the 256 queries of a block.  The design:
//   * a row goes to the tensor cores as it stands, with no decode: the b1
//     m16n8k256 fragments are the s8 m16n8k32 fragments of mma_common.cuh
//     with each byte read as 8 consecutive k lanes, so one k256 step is 32
//     bytes of a row, words 4s..4s+3, and a row takes S = ceil(G / 4)
//     steps (5 at L 20), a template parameter 1..8 set from n_words;
//   * the block is mma_common.cuh's: 8 warps of 32 queries held as A
//     fragments in registers (2 * 4S of them: lanes g and g+8 of each m16
//     tile, 32-bit units 8s + 4h + t of their rows), 128-row database tiles
//     copied by cp.async into the two-buffer ring (tile_ring) at a stride of
//     32 S + 16 bytes and read with ldmatrix.x4, 4 n8 tiles a warp batch.
//     A global row is 8G bytes from the next, so a 16-byte copy would be
//     misaligned whenever G is odd: the tiles are copied 8 bytes (one word)
//     a cp.async, and the rows need no padding;
//   * words G..4S-1 of a row must read as zero, or they add counts that do
//     not exist: the A fragments load them as 0, and each block zeroes them
//     once in both ring buffers, where cp.async never writes;
//   * a query past nq, and a database row past the split's end (zero-filled
//     by cp.async), are zero rows: their dot 0 is never > thresh >= 0, so
//     the loop needs no mask; only the final write checks nq;
//   * the epilogue is the 2-bit count's (mma_common.cuh count_batch and
//     add_counts): accumulators start at -(thresh + 1) (thresh <= 64G =
//     1,920 at L 32, far inside int32), a thread ANDs its 32 sums and
//     counts the sums >= 0 only when the sign bit does not survive, and
//     each split adds its quad-summed per-query counts with one integer
//     atomicAdd, so the result is exact and order-free;
//   * the database is cut into gridDim.y splits of whole tiles so that
//     small query sets still fill the card.
// At S <= 5 (G <= 20, guides of <= 22 bases) the kernel is built for two
// blocks an SM (128 registers); above, its A and B fragments need more, so
// it is built for one.
// Targets sm_90a (mma.sync, ldmatrix and cp.async exist from sm_80; wgmma
// and TMA, Hopper's faster path to the tensor cores, are not used).
#include <stdint.h>

#include "mma_common.cuh"

namespace {

using gm::kMTiles;
using gm::kNTiles;
using gm::kQPerBlock;
using gm::kThreads;
using gm::kTile;

// the widest row: 30 words, for 32-base guides
constexpr int kMaxWords = 30;

// k256 steps of a row of n_words words
__host__ __device__ constexpr int feature_steps(int n_words) {
  return (n_words + 3) / 4;
}

// bytes of the two-buffer tile ring
__host__ __device__ constexpr int ring_bytes(int steps) {
  return 2 * kTile * (32 * steps + 16);
}

// The A fragments of the warp's queries qw..qw+31: rows g and g+8 of each
// m16 tile; 32-bit units 8s + t (bits 32t.. of step s) in registers 0 and
// 1, units 8s + 4 + t (bits 128 + 32t..) in registers 2 and 3.  A unit past
// the row's 2 n_words, and a query past nq, are zero.
template <int S>
__device__ __forceinline__ void load_feature_a(
    uint32_t (&a)[kMTiles][S][4], const uint32_t* __restrict__ q, int nq,
    int n_words, int qw) {
  const int g = (threadIdx.x & 31) >> 2, t = threadIdx.x & 3;
#pragma unroll
  for (int mt = 0; mt < kMTiles; ++mt) {
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int qi = qw + mt * 16 + half * 8 + g;
      const uint32_t* row = q + static_cast<size_t>(qi < nq ? qi : 0) *
                                    (2 * n_words);
#pragma unroll
      for (int s = 0; s < S; ++s) {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int u = 8 * s + 4 * h + t;
          a[mt][s][2 * h + half] = qi < nq && u < 2 * n_words ? row[u] : 0u;
        }
      }
    }
  }
}

// Start copying database rows [t0, t0 + kTile) into the ring buffer at
// shared address dst: thread (r, h) = (threadIdx.x / 2, threadIdx.x % 2)
// copies words h, h + 2, ... < n_words of tile row r, 8 bytes a cp.async;
// a row at or past hi is zero-filled.
template <int S>
__device__ __forceinline__ void load_feature_tile(
    uint32_t dst, const unsigned long long* __restrict__ db, int n_words,
    int t0, int hi) {
  static_assert(kTile * 2 == kThreads, "two threads copy each tile row");
  const int r = threadIdx.x >> 1, h = threadIdx.x & 1;
  const bool in = t0 + r < hi;
  const unsigned long long* src =
      db + (in ? static_cast<size_t>(t0 + r) * n_words : 0);
  dst += r * (32 * S + 16);
#pragma unroll
  for (int j = 0; j < 2 * S; ++j) {
    const int w = h + 2 * j;
    if (w < n_words) gm::cp_async<8>(dst + 8 * w, src + w, in ? 8 : 0);
  }
}

template <int S>
__global__ void __launch_bounds__(kThreads, S <= 5 ? 2 : 1)
    feature_count_kernel(const uint32_t* __restrict__ q, int nq,
                         const unsigned long long* __restrict__ db, int nd,
                         int n_words, int thresh, int rows_per_split,
                         int* __restrict__ out) {
  extern __shared__ __align__(16) uint8_t ring[];
  const int lo = blockIdx.y * rows_per_split;
  const int hi = min(nd, lo + rows_per_split);
  const int qw = blockIdx.x * kQPerBlock + (threadIdx.x >> 5) * 32;
  {
    // words n_words..4S-1 of row threadIdx.x / 2 of buffer threadIdx.x % 2;
    // the ring's first barrier orders these stores before any read
    unsigned long long* pad = reinterpret_cast<unsigned long long*>(
        ring + (threadIdx.x & 1) * (ring_bytes(S) / 2) +
        (threadIdx.x >> 1) * (32 * S + 16));
    for (int w = n_words; w < 4 * S; ++w) pad[w] = 0ull;
  }
  uint32_t a[kMTiles][S][4];
  load_feature_a<S>(a, q, nq, n_words, qw);
  int cnt[kMTiles][2] = {};
  const int bias = -(thresh + 1);

  gm::tile_ring<S, gm::kBatch>(
      lo, hi, ring,
      [&](uint32_t dst, int t0) {
        load_feature_tile<S>(dst, db, n_words, t0, hi);
      },
      [&](uint32_t src, int, int n0) {
        int acc[kMTiles][kNTiles][4];
#pragma unroll
        for (int mt = 0; mt < kMTiles; ++mt)
#pragma unroll
          for (int nt = 0; nt < kNTiles; ++nt)
#pragma unroll
            for (int i = 0; i < 4; ++i) acc[mt][nt][i] = bias;
        gm::mma_batch<S, true>(acc, a, src, n0);
        gm::count_batch(cnt, acc);
      });
  gm::add_counts(cnt, out, nq, qw);
}

template <int S>
int launch(const void* q, int nq, const void* db, int nd, int n_words,
           int thresh, int n_splits, void* out, cudaStream_t stream) {
  const int bytes = ring_bytes(S);
  cudaError_t err = cudaFuncSetAttribute(
      feature_count_kernel<S>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  // whole tiles a split, so that only the last split has a ragged tile
  const int tiles = (nd + kTile - 1) / kTile;
  const int rows_per_split = (tiles + n_splits - 1) / n_splits * kTile;
  const dim3 grid((nq + kQPerBlock - 1) / kQPerBlock, n_splits);
  feature_count_kernel<S><<<grid, kThreads, bytes, stream>>>(
      static_cast<const uint32_t*>(q), nq,
      static_cast<const unsigned long long*>(db), nd, n_words, thresh,
      rows_per_split, static_cast<int*>(out));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// q (nq, n_words) and db (nd, n_words) int64 feature rows, n_words 1..30;
// thresh >= 0; out (nq,) int32, zeroed by the caller.  Returns
// cudaGetLastError() after the launch.
extern "C" int gm_feature_count(const void* q, int nq, const void* db, int nd,
                                int n_words, int thresh, int n_splits,
                                void* out, void* stream) {
  if (nq <= 0 || nd <= 0 || n_words < 1 || n_words > kMaxWords ||
      thresh < 0 || n_splits <= 0 || n_splits > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  static_assert(feature_steps(kMaxWords) == 8, "one case a step count");
  switch (feature_steps(n_words)) {
#define GM_CASE(S) \
  case S:          \
    return launch<S>(q, nq, db, nd, n_words, thresh, n_splits, out, s);
    GM_CASE(1) GM_CASE(2) GM_CASE(3) GM_CASE(4)
    GM_CASE(5) GM_CASE(6) GM_CASE(7) GM_CASE(8)
#undef GM_CASE
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
