// Count kernel: for each query, the number of database rows at Hamming
// distance < editdist (matches > L - editdist), on the int8 tensor cores
// through Hopper's warpgroup product (wgmma).
//
// Replaces the JAX package's Pallas count kernel
// (guidemaker_tpu/knn/pallas_stream.py:_count_kernel, launched by
// _stream_count), which one-hot encoded the guides and counted matches as
// an int8 matrix product on the TPU's matrix unit.  This kernel computes
// the same product, (nq, K) x (K, nd) int8 one-hot rows into int32 match
// counts, and thresholds it in registers: the nq x nd match matrix never
// leaves the SM.
//
// What bounds it on an H100: operations, not bytes.  The product is
// 2 * nq * nd * 4L int8 operations (1,979 TOP/s dense), where the function
// needs 2 * nq * nd * 3L (the tetrahedral code of packed_common.cuh, the
// bound that chip_smoke.py states).  The database streams from L2 and is
// reused by the 256 queries of a block, so memory is far below either.
// Beside the tensor pipe, the ALU pipe decodes the database rows and
// thresholds every sum, about one operation a pair; the design keeps the
// two pipes busy at once:
//   * layout: one-hot rows of K = 32 KS bytes for KS k32 steps, KS a
//     template parameter (1..4) taken per block from the last valid base of
//     any of its queries (20-mers: 3).  A 16-byte chunk holds bases 4c ..
//     4c + 3 code-major: byte 4k + b is 1 iff base 4c + b is valid with code
//     k (any order of K gives the same product, as long as queries and
//     database share it; this one decodes with a multiply a word);
//   * block: wgmma_common.cuh's ring block (its one-hot side, shared with
//     the 2-bit top-k, in onehot_wgmma.cuh), one producer warpgroup and
//     four consumer warpgroups (640 threads, one block an SM; setmaxnreg
//     gives the consumers the registers the producer does not need).  Each
//     consumer holds 64 queries, one m64 tile, as wgmma A fragments in
//     registers for the whole database walk, so each database tile feeds
//     256 queries;
//   * a ring of kStages database tiles of 128 rows in shared memory: each
//     producer thread loads one packed 16-byte row (prefetched a tile
//     ahead; the 2-bit database stays in L2) and decodes it into the
//     K-major core-matrix layout that wgmma reads B from
//     (wgmma_common.cuh);
//   * product: per tile, KS wgmma m64n128k32 s8 x s8 -> s32 in one commit
//     group, the consumers taking turns to issue;
//   * the threshold as part of the product: when the block's bases leave a
//     base slot of its K unused (nb % 8 != 0, every 20-mer block), slot
//     8 KS - 1 is a bias lane: -(thresh + 1) at its code-0 byte in every
//     query row, 1 there in every database row (padding rows past the split
//     included), so the first k32 step overwrites the accumulators
//     (scale-d 0) and a pair counts iff its sum is >= 0.  Blocks whose last
//     valid base fills their K (L 8, 16, 24, 32 with a valid last base) set
//     the accumulators to -(thresh + 1) before each product instead, one
//     more operation a pair;
//   * epilogue (gm::count_tile): a thread ANDs the 32 sums of each of its
//     two query rows: if the sign bit survives, none counts (the common
//     case: close pairs are rare), else the row counts its sums >= 0, one
//     shift-add a sum and only for that row, so a larger editdist, where
//     more rows count, costs little;
//   * the database is cut into gridDim.y splits of whole tiles so that
//     small query sets still fill the card; each split adds its per-query
//     counts, summed over the quad, with one integer atomicAdd, so the
//     result is exact and does not depend on the order in which blocks
//     finish.
// Targets sm_90a: wgmma and setmaxnreg exist for no other target.
#include <stdint.h>

#include "onehot_wgmma.cuh"

namespace {

using gm::kQPerBlock;
using gm::kTile;
using gm::kWarpgroup;

constexpr int kStageBytes = gm::kOnehotStageBytes;
constexpr int kSmemBytes = gm::ring_smem_bytes(kStageBytes);
// registers a thread of the producer and of a consumer warpgroup
constexpr int kProducerRegs = 32;
constexpr int kConsumerRegs = 112;

// A consumer warpgroup: its 64 queries against every tile of the split.
template <int KS, bool kBias>
__device__ __forceinline__ void consume(const ulonglong2* __restrict__ q,
                                        int nq, int lo, int hi, int thresh,
                                        int* __restrict__ out, uint32_t ring,
                                        uint32_t full, uint32_t empty) {
  // consumer c holds queries 64 c .. 64 c + 63 of the block, its warp w
  // rows 16 w .. 16 w + 15 of those
  const int c = (threadIdx.x - kWarpgroup) / kWarpgroup;
  const int qw = blockIdx.x * kQPerBlock + 64 * c +
                 ((threadIdx.x >> 5) & 3) * 16;
  const int bias = -(thresh + 1);
  uint32_t a[KS][4];
  gm::onehot_a<KS, kBias>(a, q, nq, qw, bias);
  int cnt[2] = {};
  const int n_tiles = (hi - lo + kTile - 1) / kTile;
  const uint64_t desc0 = gm::smem_desc(ring, 128, 256 * KS);
  constexpr uint64_t kStageDesc = kStageBytes >> 4;
  int acc[64] = {};
  gm::consume_tiles(
      n_tiles, full, empty, acc,
      [&](int st) {
        gm::onehot_product<KS, kBias>(acc, a, desc0 + st * kStageDesc, bias,
                                      bias);
      },
      [&](int) { gm::count_tile(cnt, acc); });
  gm::add_row_counts(cnt, out, nq, qw);
}

__global__ void __launch_bounds__(gm::kRingThreads, 1)
    count_kernel(const ulonglong2* __restrict__ q, int nq,
                 const ulonglong2* __restrict__ db, int nd, int thresh,
                 int rows_per_split, int* __restrict__ out) {
  extern __shared__ __align__(1024) uint8_t smem[];
  __shared__ int nb_shared;
  const int lo = blockIdx.y * rows_per_split;
  const int hi = min(nd, lo + rows_per_split);
  const int nb = gm::block_bases(q, nq, &nb_shared);
  // no query of the block has a valid base, or the split is empty: the
  // block counts nothing
  if (nb == 0 || lo >= hi) return;
  const int cfg = gm::onehot_config(nb);
  gm::ring_roles<kStageBytes, kProducerRegs, kConsumerRegs>(
      smem,
      [&](uint8_t* ring, uint32_t full, uint32_t empty) {
#define GM_PRODUCE(KS, B) \
  gm::produce_onehot<KS, B>(db, lo, hi, ring, full, empty)
        switch (cfg) { GM_ONEHOT_CASES(GM_PRODUCE) }
#undef GM_PRODUCE
      },
      [&](uint32_t ring, uint32_t full, uint32_t empty) {
#define GM_CONSUME(KS, B) \
  consume<KS, B>(q, nq, lo, hi, thresh, out, ring, full, empty)
        switch (cfg) { GM_ONEHOT_CASES(GM_CONSUME) }
#undef GM_CONSUME
      });
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
  const cudaError_t err =
      gm::ring_kernel_ready<kProducerRegs, kConsumerRegs>(count_kernel,
                                                          kSmemBytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  // whole tiles a split, so that only the last split has a ragged tile
  const int tiles = (nd + kTile - 1) / kTile;
  const int rows_per_split = (tiles + n_splits - 1) / n_splits * kTile;
  const dim3 grid((nq + kQPerBlock - 1) / kQPerBlock, n_splits);
  count_kernel<<<grid, gm::kRingThreads, kSmemBytes,
                 static_cast<cudaStream_t>(stream)>>>(
      static_cast<const ulonglong2*>(q), nq,
      static_cast<const ulonglong2*>(db), nd, thresh, rows_per_split,
      static_cast<int*>(out));
  return static_cast<int>(cudaGetLastError());
}
