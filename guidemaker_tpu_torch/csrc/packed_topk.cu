// Packed-pair top-k kernel: for each query, the k smallest packed keys
// (dist << 24) | idx over the whole database, ascending, with two database
// guides per 128-lane int8 row (packed_common.cuh), on the int8 tensor
// cores.
//
// Replaces the JAX package's Pallas kernel
// guidemaker_tpu/knn/pallas_packed.py:_topk_kernel (launched by
// _packed_topk), which ran the same int8 product on the TPU's matrix unit,
// decoded both guides' sums from the one dot v = s*A + B of a row and
// merged two candidate keys a row into its running list.  What it
// computes: the distances (3L - A) >> 2 of guide 2j and (3L - B) >> 2 of
// guide 2j + 1; the odd slot of the last row is no guide when nd is odd.
// Keys are unique per query, so the order of insertion does not matter.
//
// What bounds it on an H100: operations, the packed product as in
// packed_count.cu.  Building a key and testing it against a running top-K
// list is CUDA-core work that would cost several times the product if
// every pair paid it (the dp4a kernel it replaces paid it on every pair
// row, with a float decode); the gated epilogue of hamming_topk.cu makes
// most pairs pay nothing.  The design:
//   * the product is packed_common.cuh's: 8 warps of 32 queries held as
//     split A fragments, 128-row tiles in a cp.async ring read by
//     ldmatrix.x4, mma.sync.m16n8k32 s8 on 16 pair rows (32 guides) a
//     warp into acc_e = s*A and acc_o = B;
//   * lane r of a warp owns query row r: its ascending list of K keys in
//     registers (K is k rounded up to a power of two, a template
//     parameter, so every index into the list is static);
//   * the gate: with dK the distance of the owner's K-th key (L + 1 while
//     the list is not full), a pair is closer than that key iff
//     A > 3L - 4 dK, so each row's sums start at acc_e = s * bias and
//     acc_o = bias with bias = 4 dK - 3L - 1, and a sum is >= 0 iff its
//     pair could enter.  Within a split the guides come in ascending
//     index, so a pair at dK itself never could.  A lane ANDs its 32 sums;
//     if no lane of the warp holds one >= 0 (__any_sync), the batch costs
//     nothing more.  Once the lists fill, that is the common case;
//   * otherwise each lane stages, for each of its 32 sums, the guide's
//     distance (3L + bias - acc) >> 2 in [0, L] as a byte, or 0xff for a
//     sum < 0 (the sums, up to s * 3L, do not fit a byte; acc_e / s is
//     exact in float32, as acc_e is a multiple of s below 2^13), in its
//     warp's 1 KB of shared memory; each owner reads its row's 32 bytes
//     and, for each distance below 0xff whose guide index is below the
//     split's end and nd (a zero slot sums to 0 and may pass), builds the
//     key and inserts it where it beats the K-th key.  The exact compare
//     decides, so the result does not depend on the gate.  The owners then
//     hand their new biases to the quads by 4 shuffles;
//   * the database is cut into gridDim.y splits of whole tiles to fill the
//     card; each split writes its own sorted list to (nq, n_splits, K), and
//     gm::merge_kernel (topk_common.cuh) folds the splits into the final
//     (nq, k) by key, so ties go to the lower index.
// At K >= 16 the list no longer fits beside the fragments in the 128
// registers that two blocks an SM allow, so those kernels are built for one
// block an SM.
// Targets sm_90a (mma.sync, ldmatrix and cp.async exist from sm_80; wgmma
// and TMA, Hopper's faster path to the tensor cores, are not used).
#include <stdint.h>

#include "packed_common.cuh"
#include "topk_common.cuh"

namespace {

using gm::kMTiles;
using gm::kPairNTiles;
using gm::kQPerBlock;
using gm::kThreads;
using gm::kTile;

// a warp's staging buffer: one byte for each of its 32 query rows x 32
// batch guides; lane (g, t) puts guide 16 nt + 4t + 2e + slot of each of
// its rows (pair row 8 nt + 2t + e, slot 0 even, 1 odd) at byte
// 8t + 4nt + 2e + slot, so its 8 bytes of a row are one store
constexpr int kStage = 32 * 2 * gm::kPairBatch;

// The low bytes of four ints, in order.
__device__ __forceinline__ uint32_t pack4(int b0, int b1, int b2, int b3) {
  return __byte_perm(__byte_perm(b0, b1, 0x0040), __byte_perm(b2, b3, 0x0040),
                     0x5410);
}

template <int K, int NS>
__device__ __forceinline__ void topk_block(
    const uint32_t* __restrict__ q, int nq, const int4* __restrict__ db,
    int lo, int hi, int ghi, int length, int* __restrict__ partial,
    uint8_t* ring, uint8_t* stage) {
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int qw = blockIdx.x * kQPerBlock + (threadIdx.x >> 5) * 32;
  const int three_l = 3 * length, s = 4 * length + 1;
  const float inv_s = 1.0f / static_cast<float>(s);
  uint32_t ae[kMTiles][gm::even_steps(NS)][4];
  uint32_t ao[kMTiles][gm::odd_steps(NS)][4];
  gm::load_pair_a<NS>(ae, ao, q, nq, qw, three_l);

  // the list of query qw + lane; bias 4 dK - 3L - 1 with dK = L + 1 while
  // it is not full
  int best[K];
#pragma unroll
  for (int i = 0; i < K; ++i) best[i] = gm::kInfKey;
  const int fill_bias = length + 3;
  // the biases of the rows 16 mt + 8 half + g that this lane's sums hold
  int bias[kMTiles][2];
#pragma unroll
  for (int mt = 0; mt < kMTiles; ++mt)
    bias[mt][0] = bias[mt][1] = fill_bias;
  uint2* put = reinterpret_cast<uint2*>(stage) + g * 4 + t;
  const uint4* row = reinterpret_cast<const uint4*>(stage + 32 * lane);

  gm::pair_tiles<NS>(db, lo, hi, ring, [&](uint32_t src, int t0, int n0) {
    int acc_e[kMTiles][kPairNTiles][4], acc_o[kMTiles][kPairNTiles][4];
#pragma unroll
    for (int mt = 0; mt < kMTiles; ++mt)
#pragma unroll
      for (int nt = 0; nt < kPairNTiles; ++nt)
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          acc_e[mt][nt][i] = s * bias[mt][i >> 1];
          acc_o[mt][nt][i] = bias[mt][i >> 1];
        }
    gm::pair_mma_batch<NS>(acc_e, acc_o, ae, ao, src, n0);
    int all = -1;
#pragma unroll
    for (int mt = 0; mt < kMTiles; ++mt)
#pragma unroll
      for (int nt = 0; nt < kPairNTiles; ++nt)
#pragma unroll
        for (int i = 0; i < 4; ++i) all &= acc_e[mt][nt][i] & acc_o[mt][nt][i];
    // the sign bit survives the AND iff every sum is < 0
    if (!__any_sync(0xffffffffu, all >= 0)) return;

#pragma unroll
    for (int mt = 0; mt < kMTiles; ++mt)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int top = three_l + bias[mt][h];  // dist = (top - sum) >> 2
        int d[kPairNTiles][4];
#pragma unroll
        for (int nt = 0; nt < kPairNTiles; ++nt)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int se = acc_e[mt][nt][2 * h + e];
            const int so = acc_o[mt][nt][2 * h + e];
            const int a = __float2int_rn(__int2float_rn(se) * inv_s);
            d[nt][2 * e] = se >= 0 ? (top - a) >> 2 : 0xff;
            d[nt][2 * e + 1] = so >= 0 ? (top - so) >> 2 : 0xff;
          }
        put[(mt * 16 + h * 8) * 4] =
            make_uint2(pack4(d[0][0], d[0][1], d[0][2], d[0][3]),
                       pack4(d[1][0], d[1][1], d[1][2], d[1][3]));
      }
    __syncwarp();
    const uint4 w0 = row[0], w1 = row[1];
    __syncwarp();  // the buffer is free for the next batch
    const uint32_t w[8] = {w0.x, w0.y, w0.z, w0.w, w1.x, w1.y, w1.z, w1.w};
    const int gbase = 2 * (t0 + n0);
#pragma unroll
    for (int wi = 0; wi < 8; ++wi) {
      uint32_t pass = ~w[wi] & 0x80808080u;  // the distances below 0x80
      while (pass) {
        const int bit = __ffs(pass) - 1;  // 8 byte + 7
        pass &= pass - 1;
        // byte 4 wi + b = 8t + 4nt + 2e + slot holds guide
        // 16 nt + 4t + 2e + slot of the batch
        const int gi = gbase + 16 * (wi & 1) + 4 * (wi >> 1) + (bit >> 3);
        const int dist = (w[wi] >> (bit - 7)) & 0xff;
        const int key = (dist << gm::kIdxBits) | gi;
        if (gi < ghi && key < best[K - 1]) gm::insert<K>(best, key);
      }
    }
    const int own_bias =
        4 * min(best[K - 1] >> gm::kIdxBits, length + 1) - three_l - 1;
#pragma unroll
    for (int mt = 0; mt < kMTiles; ++mt)
#pragma unroll
      for (int h = 0; h < 2; ++h)
        bias[mt][h] = __shfl_sync(0xffffffffu, own_bias, mt * 16 + h * 8 + g);
  });
  const int qi = qw + lane;
  if (qi < nq) {
    int* o = partial + (static_cast<size_t>(qi) * gridDim.y + blockIdx.y) * K;
#pragma unroll
    for (int i = 0; i < K; ++i) o[i] = best[i];
  }
}

template <int K>
__global__ void __launch_bounds__(kThreads, K <= 8 ? 2 : 1)
    packed_topk_kernel(const uint32_t* __restrict__ q, int nq,
                       const int4* __restrict__ db, int nd, int length,
                       int rows_per_split, int* __restrict__ partial) {
  __shared__ __align__(16) uint8_t ring[gm::kPairRing];
  __shared__ __align__(16) uint8_t stage[gm::kWarps * kStage];
  uint8_t* warp_stage = stage + (threadIdx.x >> 5) * kStage;
  const int lo = blockIdx.y * rows_per_split;
  const int hi = min((nd + 1) / 2, lo + rows_per_split);
  // guides below ghi are real and in this split
  const int ghi = min(2 * hi, nd);
  gm::with_pair_steps(length, [&](auto ns) {
    topk_block<K, decltype(ns)::value>(q, nq, db, lo, hi, ghi, length,
                                       partial, ring, warp_stage);
  });
}

template <int K>
int launch(const void* q, int nq, const void* db, int nd, int length, int k,
           int n_splits, void* partial, void* out, cudaStream_t stream) {
  // whole tiles a split, so that only the last split has a ragged tile
  const int tiles = ((nd + 1) / 2 + kTile - 1) / kTile;
  const int rows_per_split = (tiles + n_splits - 1) / n_splits * kTile;
  const dim3 grid((nq + kQPerBlock - 1) / kQPerBlock, n_splits);
  packed_topk_kernel<K><<<grid, kThreads, 0, stream>>>(
      static_cast<const uint32_t*>(q), nq, static_cast<const int4*>(db), nd,
      length, rows_per_split, static_cast<int*>(partial));
  return gm::launch_merge<K>(partial, nq, n_splits, k, out, stream);
}

}  // namespace

// q (nq, 128) and db (ceil(nd / 2), 128) int8 packed rows, 16-byte
// aligned; partial (nq, n_splits, kcap) and out (nq, k) int32, allocated by
// the caller; kcap is k rounded up to a power of two <= 128.  Returns the
// first CUDA error of the two launches.
extern "C" int gm_packed_topk(const void* q, int nq, const void* db, int nd,
                              int length, int k, int kcap, int n_splits,
                              void* partial, void* out, void* stream) {
  if (nq <= 0 || nd <= 0 || length < 1 || 6 * length > 128 || k < 1 ||
      k > kcap || k > nd || n_splits <= 0 || n_splits > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  GM_DISPATCH_KCAP(kcap, launch, q, nq, db, nd, length, k, n_splits, partial,
                   out, s)
}
