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
// 2 * nq * nd * 4L int8 operations (1,979 TOP/s dense); the threshold
// epilogue is a few integer operations a pair on the INT32 pipes.  The
// database streams from L2 and is reused by the 256 queries of a block, so
// memory is far below either.  The design follows:
//   * layout: base i of a packed row (hamming_common.cuh) becomes the
//     32-bit word `valid_i ? 1 << (8 * code_i) : 0`, four one-hot bytes, and
//     a row becomes K = 32 * ceil(nb / 8) bytes for its first nb bases.  An
//     N, a base past L, a query past nq and a database row past the split
//     all decode to zeros, whose match count 0 is never > thresh >= 0, so
//     the loop needs no mask; only the final write checks nq;
//   * the k32 steps (1..4) are a template parameter; a block takes as many
//     as the last valid base of any of its queries needs (20-mers: 3), as
//     the length is not an argument of the C entry point;
//   * A, the queries: each of 8 warps holds 2 m16 tiles (32 queries) as
//     fragments in registers for the whole database loop, decoded straight
//     from the packed rows (2 tiles x steps x 4 registers);
//   * B, the database: tiles of 128 rows, decoded once by the block into
//     shared memory (row stride 32 * steps + 16 bytes, an odd number of
//     16-byte units, so the 8 row addresses of an ldmatrix phase fall in 8
//     different bank groups) and read with ldmatrix.x4, one per k32 step
//     for two n8 tiles.  The next tile's packed rows are loaded into
//     registers while the current tile is in use (in place of cp.async:
//     they are decoded before they are stored, so they pass through
//     registers anyway);
//   * product: mma.sync.m16n8k32 s8 x s8 -> s32, the accumulators starting
//     at -(thresh + 1), so a pair counts iff its sum is >= 0.  A warp
//     multiplies 4 n8 tiles (32 database rows) before it tests them, which
//     gives the tensor pipe 8 independent accumulator chains; a thread
//     then ANDs its 32 sums: if the sign bit survives, none counts (the
//     common case: close pairs are rare), else each adds its sign test to
//     its query row's counter;
//   * the database is cut into gridDim.y splits so that small query sets
//     still fill the card; each split adds its per-query counts, summed
//     over the quad, with one integer atomicAdd, so the result is exact and
//     does not depend on the order in which blocks finish.
// Targets sm_90a (mma.sync and ldmatrix exist from sm_80; wgmma and TMA,
// Hopper's faster path to the tensor cores, are not used).
#include <stdint.h>

#include "hamming_common.cuh"

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;
// m16 tiles of queries a warp holds
constexpr int kMTiles = 2;
constexpr int kQPerBlock = kWarps * 16 * kMTiles;
// n8 tiles of database rows a warp multiplies before one epilogue test
constexpr int kNTiles = 4;
// database rows a shared-memory tile
constexpr int kTile = 128;
// k32 steps of a 32-base row
constexpr int kMaxSteps = 4;
constexpr int kMaxStride = 32 * kMaxSteps + 16;

static_assert(kQPerBlock == kThreads, "one query a thread in the step scan");
static_assert(kTile * 2 == kThreads, "two threads decode each tile row");
static_assert(kNTiles % 2 == 0 && kTile % (8 * kNTiles) == 0,
              "one ldmatrix.x4 a k32 step covers two n8 tiles");

// One-hot word of base j of a packed row: byte code_j is 1 when valid.
__device__ __forceinline__ uint32_t onehot(const ulonglong2 row, int j) {
  const uint32_t c = static_cast<uint32_t>(row.x >> (2 * j)) & 3u;
  const uint32_t v = static_cast<uint32_t>(row.y >> (2 * j)) & 1u;
  return v << (8 * c);
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

__device__ __forceinline__ void mma_s8(int (&d)[4], const uint32_t (&a)[4],
                                       uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

template <int KS>
__device__ __forceinline__ void count_block(
    const ulonglong2* __restrict__ q, int nq,
    const ulonglong2* __restrict__ db, int lo, int hi, int thresh,
    int* __restrict__ out, uint8_t* tile) {
  constexpr int kStride = 32 * KS + 16;
  const ulonglong2 zero = make_ulonglong2(0ull, 0ull);
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int qw = blockIdx.x * kQPerBlock + (threadIdx.x >> 5) * 32;

  // A fragments: rows g and g+8 of each m16 tile; base 8s+t in registers
  // 0 and 1, base 8s+4+t in registers 2 and 3 (the s8 m16n8k32 layout)
  uint32_t a[kMTiles][KS][4];
#pragma unroll
  for (int mt = 0; mt < kMTiles; ++mt) {
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int qi = qw + mt * 16 + half * 8 + g;
      const ulonglong2 row = qi < nq ? q[qi] : zero;
#pragma unroll
      for (int s = 0; s < KS; ++s) {
        a[mt][s][half] = onehot(row, 8 * s + t);
        a[mt][s][2 + half] = onehot(row, 8 * s + 4 + t);
      }
    }
  }
  int cnt[kMTiles][2] = {};

  // the decode: thread (r, h) writes bases [4*KS*h, 4*KS*(h+1)) of row r
  const int r = threadIdx.x >> 1, h = threadIdx.x & 1;
  uint4* dst = reinterpret_cast<uint4*>(tile + r * kStride) + h * KS;
  // ldmatrix.x4 of two n8 tiles: lanes 8m..8m+7 address the rows of
  // matrix m = (n8 tile m >> 1, 16-byte half m & 1 of the k32 step)
  const uint32_t src = static_cast<uint32_t>(__cvta_generic_to_shared(tile)) +
                       (((lane >> 4) << 3) + (lane & 7)) * kStride +
                       ((lane >> 3) & 1) * 16;
  const int bias = -(thresh + 1);

  ulonglong2 next = lo + r < hi ? db[lo + r] : zero;
  for (int t0 = lo; t0 < hi; t0 += kTile) {
    __syncthreads();  // every warp is done with the previous tile
#pragma unroll
    for (int i = 0; i < KS; ++i) {
      const int j = 4 * KS * h + 4 * i;
      dst[i] = make_uint4(onehot(next, j), onehot(next, j + 1),
                          onehot(next, j + 2), onehot(next, j + 3));
    }
    __syncthreads();
    const int rows = min(kTile, hi - t0);
    next = t0 + kTile + r < hi ? db[t0 + kTile + r] : zero;
#pragma unroll 1
    for (int n0 = 0; n0 < rows; n0 += 8 * kNTiles) {
      uint32_t b[KS][kNTiles / 2][4];
#pragma unroll
      for (int s = 0; s < KS; ++s)
#pragma unroll
        for (int p = 0; p < kNTiles / 2; ++p)
          ldsm_x4(b[s][p], src + (n0 + 16 * p) * kStride + 32 * s);
      int acc[kMTiles][kNTiles][4];
#pragma unroll
      for (int mt = 0; mt < kMTiles; ++mt) {
#pragma unroll
        for (int nt = 0; nt < kNTiles; ++nt) {
#pragma unroll
          for (int i = 0; i < 4; ++i) acc[mt][nt][i] = bias;
#pragma unroll
          for (int s = 0; s < KS; ++s)
            mma_s8(acc[mt][nt], a[mt][s], b[s][nt >> 1][2 * (nt & 1)],
                   b[s][nt >> 1][2 * (nt & 1) + 1]);
        }
      }
      int all = -1;
#pragma unroll
      for (int mt = 0; mt < kMTiles; ++mt)
#pragma unroll
        for (int nt = 0; nt < kNTiles; ++nt)
#pragma unroll
          for (int i = 0; i < 4; ++i) all &= acc[mt][nt][i];
      if (all >= 0) {  // some sum is >= 0: count them
#pragma unroll
        for (int mt = 0; mt < kMTiles; ++mt)
#pragma unroll
          for (int nt = 0; nt < kNTiles; ++nt)
#pragma unroll
            for (int i = 0; i < 4; ++i)
              cnt[mt][i >> 1] += acc[mt][nt][i] >= 0;
      }
    }
  }
  // the quad's four threads hold the same rows' counts over other columns
#pragma unroll
  for (int mt = 0; mt < kMTiles; ++mt) {
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      int c = cnt[mt][half];
      c += __shfl_xor_sync(0xffffffffu, c, 1);
      c += __shfl_xor_sync(0xffffffffu, c, 2);
      const int qi = qw + mt * 16 + half * 8 + g;
      if (t == 0 && qi < nq && c != 0) atomicAdd(out + qi, c);
    }
  }
}

__global__ void __launch_bounds__(kThreads, 2)
    count_kernel(const ulonglong2* __restrict__ q, int nq,
                 const ulonglong2* __restrict__ db, int nd, int thresh,
                 int rows_per_split, int* __restrict__ out) {
  __shared__ __align__(16) uint8_t tile[kTile * kMaxStride];
  __shared__ int steps;
  // k32 steps: enough for the last valid base of any query of the block
  const int qi = blockIdx.x * kQPerBlock + threadIdx.x;
  const unsigned long long valid = qi < nq ? q[qi].y : 0ull;
  int need = valid ? ((63 - __clzll(valid)) / 2 + 8) / 8 : 0;
  need = __reduce_max_sync(0xffffffffu, need);
  if (threadIdx.x == 0) steps = 0;
  __syncthreads();
  if ((threadIdx.x & 31) == 0) atomicMax(&steps, need);
  __syncthreads();
  const int lo = blockIdx.y * rows_per_split;
  const int hi = min(nd, lo + rows_per_split);
  switch (steps) {
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
