// Top-k kernel: for each query, the k smallest packed keys
// (dist << 24) | idx over the whole database, ascending, with the match
// counts taken on the int8 tensor cores.
//
// Replaces two Pallas kernels of the JAX package:
// guidemaker_tpu/knn/pallas_stream.py:_stream_kernel (launched by
// _stream_topk) and guidemaker_tpu/knn/pallas_hamming.py:_kernel (launched
// by _pallas_topk).  Both take dist = L - matches from a one-hot int8
// product on the TPU's matrix unit; their split existed only because of the
// TPU's cost per grid step, so one kernel serves both here.
//
// What bounds it on an H100: operations.  The match counts are the count
// kernel's one-hot product, 2 * nq * nd * 4L int8 operations (1,979 TOP/s
// dense), where the function needs 3L lanes a pair (the bound that
// chip_smoke.py states, as in hamming_count.cu).  Building a key and testing it against a running top-K list is
// CUDA-core work that would cost several times the product if every pair
// paid it; the gated epilogue below makes most pairs pay nothing.  The
// design:
//   * the product is the count kernel's (mma_common.cuh): 8 warps of 32
//     queries held as A fragments, 128-row one-hot database tiles in shared
//     memory read by ldmatrix.x4, the next tile prefetched in registers,
//     mma.sync.m16n8k32 s8 on 32 database rows a warp, the k32 steps (1..4,
//     a template parameter) taken from the last valid base of the block's
//     queries;
//   * lane r of a warp owns query row r: its ascending list of K keys in
//     registers (K is k rounded up to a power of two, a template parameter,
//     so every index into the list is static);
//   * the gate: each row's accumulators start at a bias dK - L - 1, where dK
//     is the distance of the owner's K-th key (L + 1 while the list is not
//     full), so a sum is >= 0 iff the pair is closer than that key.  Within
//     a split the columns come in ascending index, so a pair at dK itself
//     could never enter the list.  A lane ANDs its 32 sums; if no lane of
//     the warp holds one >= 0 (__any_sync), the batch costs nothing more.
//     Once the lists fill, that is the common case;
//   * otherwise each lane stages its 32 sums as bytes (they lie in
//     [-33, 32]) in its warp's 1 KB of shared memory; each owner reads its
//     row's 32, and for each sum >= 0 on a column below the split's end
//     (a padding column decodes to 0 matches, distance L) builds the key
//     and inserts it where it beats the K-th key.  The exact compare
//     decides, so the result does not depend on the gate or on the order of
//     insertion.  The owners then hand their new biases to the quads by 4
//     shuffles;
//   * a block whose queries are all N runs the 1-step product on zeros:
//     every pair is at distance L, and the lists take the lowest indices;
//   * the database is cut into gridDim.y splits of whole tiles to fill the
//     card; each split writes its own sorted list to (nq, n_splits, K), and
//     gm::merge_kernel (topk_common.cuh) folds the splits into the final
//     (nq, k) by key, so ties go to the lower index.
// At K >= 16 the list no longer fits beside the fragments in the 128
// registers that two blocks an SM allow, so those kernels are built for one
// block an SM.
// Targets sm_90a (mma.sync and ldmatrix exist from sm_80; wgmma and TMA,
// Hopper's faster path to the tensor cores, are not used).
#include <stdint.h>

#include "mma_common.cuh"
#include "topk_common.cuh"

namespace {

using gm::kMTiles;
using gm::kNTiles;
using gm::kQPerBlock;
using gm::kThreads;
using gm::kTile;

// a warp's staging buffer: one byte for each of its 32 query rows x 32
// batch rows; lane (g, t) puts batch row 8 nt + 2t + e of each of its rows
// at byte 8t + 2nt + e, so its 8 bytes of a row are one store
constexpr int kStage = 32 * gm::kBatch;

// The low bytes of four sums, in order.
__device__ __forceinline__ uint32_t pack4(int b0, int b1, int b2, int b3) {
  return __byte_perm(__byte_perm(b0, b1, 0x0040), __byte_perm(b2, b3, 0x0040),
                     0x5410);
}

template <int K, int KS>
__device__ __forceinline__ void topk_block(
    const ulonglong2* __restrict__ q, int nq,
    const ulonglong2* __restrict__ db, int lo, int hi, int length,
    int* __restrict__ partial, uint8_t* tile, uint8_t* stage) {
  const ulonglong2 zero = make_ulonglong2(0ull, 0ull);
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int qw = blockIdx.x * kQPerBlock + (threadIdx.x >> 5) * 32;
  uint32_t a[kMTiles][KS][4];
  gm::load_a<KS>(a, q, nq, qw);

  // the list of query qw + lane, and its row's bias; 0 while not full
  int best[K];
#pragma unroll
  for (int i = 0; i < K; ++i) best[i] = gm::kInfKey;
  int own_bias = 0;
  // the biases of the rows 16 mt + 8 half + g that this lane's sums hold
  int bias[kMTiles][2] = {};
  uint2* put = reinterpret_cast<uint2*>(stage) + g * 4 + t;
  const uint4* row = reinterpret_cast<const uint4*>(stage + 32 * lane);

  const int r = threadIdx.x >> 1;
  uint4* dst = gm::decode_dst<KS>(tile);
  const uint32_t src = gm::ldsm_src<KS>(tile);

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
          for (int i = 0; i < 4; ++i) acc[mt][nt][i] = bias[mt][i >> 1];
      gm::mma_batch<KS>(acc, a, src, n0);
      int all = -1;
#pragma unroll
      for (int mt = 0; mt < kMTiles; ++mt)
#pragma unroll
        for (int nt = 0; nt < kNTiles; ++nt)
#pragma unroll
          for (int i = 0; i < 4; ++i) all &= acc[mt][nt][i];
      // the sign bit survives the AND iff every sum is < 0
      if (!__any_sync(0xffffffffu, all >= 0)) continue;

#pragma unroll
      for (int mt = 0; mt < kMTiles; ++mt)
#pragma unroll
        for (int h = 0; h < 2; ++h)
          put[(mt * 16 + h * 8) * 4] = make_uint2(
              pack4(acc[mt][0][2 * h], acc[mt][0][2 * h + 1],
                    acc[mt][1][2 * h], acc[mt][1][2 * h + 1]),
              pack4(acc[mt][2][2 * h], acc[mt][2][2 * h + 1],
                    acc[mt][3][2 * h], acc[mt][3][2 * h + 1]));
      __syncwarp();
      const uint4 w0 = row[0], w1 = row[1];
      __syncwarp();  // the buffer is free for the next batch
      const uint32_t w[8] = {w0.x, w0.y, w0.z, w0.w, w1.x, w1.y, w1.z, w1.w};
      const int col0 = t0 + n0;
      const int dbase = length + own_bias;  // dist = dbase - sum
#pragma unroll
      for (int wi = 0; wi < 8; ++wi) {
        uint32_t pass = ~w[wi] & 0x80808080u;  // the sums >= 0
        while (pass) {
          const int bit = __ffs(pass) - 1;  // 8 byte + 7
          pass &= pass - 1;
          const int byte = bit >> 3;
          // byte 4 wi + byte = 8t + 2nt + e holds batch row 8 nt + 2t + e
          const int col = col0 + 8 * (2 * (wi & 1) + (byte >> 1)) +
                          2 * (wi >> 1) + (byte & 1);
          const int sum = static_cast<int8_t>(w[wi] >> (bit - 7));
          const int key = ((dbase - sum) << gm::kIdxBits) | col;
          if (col < hi && key < best[K - 1]) gm::insert<K>(best, key);
        }
      }
      own_bias = min(best[K - 1] >> gm::kIdxBits, length + 1) - length - 1;
#pragma unroll
      for (int mt = 0; mt < kMTiles; ++mt)
#pragma unroll
        for (int h = 0; h < 2; ++h)
          bias[mt][h] = __shfl_sync(0xffffffffu, own_bias, mt * 16 + h * 8 + g);
    }
  }
  const int qi = qw + lane;
  if (qi < nq) {
    int* o = partial + (static_cast<size_t>(qi) * gridDim.y + blockIdx.y) * K;
#pragma unroll
    for (int i = 0; i < K; ++i) o[i] = best[i];
  }
}

template <int K>
__global__ void __launch_bounds__(kThreads, K <= 8 ? 2 : 1)
    topk_kernel(const ulonglong2* __restrict__ q, int nq,
                const ulonglong2* __restrict__ db, int nd, int length,
                int rows_per_split, int* __restrict__ partial) {
  __shared__ __align__(16) uint8_t tile[kTile * gm::kMaxStride];
  __shared__ __align__(16) uint8_t stage[gm::kWarps * kStage];
  __shared__ int steps;
  uint8_t* warp_stage = stage + (threadIdx.x >> 5) * kStage;
  const int lo = blockIdx.y * rows_per_split;
  const int hi = min(nd, lo + rows_per_split);
  switch (gm::block_steps(q, nq, &steps)) {
    case 0:  // every query of the block is all N: the product is all zeros
    case 1:
      topk_block<K, 1>(q, nq, db, lo, hi, length, partial, tile, warp_stage);
      break;
    case 2:
      topk_block<K, 2>(q, nq, db, lo, hi, length, partial, tile, warp_stage);
      break;
    case 3:
      topk_block<K, 3>(q, nq, db, lo, hi, length, partial, tile, warp_stage);
      break;
    case 4:
      topk_block<K, 4>(q, nq, db, lo, hi, length, partial, tile, warp_stage);
      break;
  }
}

template <int K>
int launch(const void* q, int nq, const void* db, int nd, int length, int k,
           int n_splits, void* partial, void* out, cudaStream_t stream) {
  // whole tiles a split, so that only the last split has a ragged tile
  const int tiles = (nd + kTile - 1) / kTile;
  const int rows_per_split = (tiles + n_splits - 1) / n_splits * kTile;
  const dim3 grid((nq + kQPerBlock - 1) / kQPerBlock, n_splits);
  topk_kernel<K><<<grid, kThreads, 0, stream>>>(
      static_cast<const ulonglong2*>(q), nq,
      static_cast<const ulonglong2*>(db), nd, length, rows_per_split,
      static_cast<int*>(partial));
  return gm::launch_merge<K>(partial, nq, n_splits, k, out, stream);
}

}  // namespace

// q (nq, 2) and db (nd, 2) packed rows; partial (nq, n_splits, kcap) and
// out (nq, k) int32, allocated by the caller; kcap is k rounded up to a
// power of two <= 128.  Returns the first CUDA error of the two launches.
extern "C" int gm_hamming_topk(const void* q, int nq, const void* db, int nd,
                               int length, int k, int kcap, int n_splits,
                               void* partial, void* out, void* stream) {
  if (nq <= 0 || nd <= 0 || length < 1 || length > 32 || k < 1 || k > kcap ||
      n_splits <= 0 || n_splits > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  GM_DISPATCH_KCAP(kcap, launch, q, nq, db, nd, length, k, n_splits, partial,
                   out, s)
}
