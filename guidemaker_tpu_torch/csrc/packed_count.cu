// Packed-pair count kernel: for each query, the number of database guides
// at Hamming distance < editdist, with two database guides per 128-lane
// int8 row (packed_common.cuh), on the int8 tensor cores through Hopper's
// warpgroup product (wgmma).
//
// Replaces the JAX package's Pallas kernel
// guidemaker_tpu/knn/pallas_packed.py:_count_kernel (launched by
// _packed_count), which ran the packed rows' int8 product on the TPU's
// matrix unit and decoded both guides' sums from the one dot v = s*A + B
// of a row.  What it computes: dist < e <=> m > L - e <=> A > T (and
// B > T) with T = 3L - 4e, every real guide counted once.
//
// What bounds it on an H100: operations.  The function needs the
// tetrahedral dot of 3L lanes a pair, 2 * nq * nd * 3L int8 operations at
// 1,979 TOP/s dense (the bound that chip_smoke.py states); the product
// issued is 2 * nq * nd * K with K = 32 ceil((3L + 1) / 32), 64 at L 11..21
// (the 2-bit count's one-hot rows need 96 at L 20).  The database streams
// from L2 at 64 bytes a guide, reused by the 256 queries of a block.
// Beside the tensor pipe, the ALU pipe thresholds every sum, about half an
// operation a pair, and splits each pair row, some 40 operations shared by
// 256 queries.  The design is the 2-bit count's (hamming_count.cu) on the
// ring block of wgmma_common.cuh:
//   * each pair row [s*tetra(even) | tetra(odd) | 0] (s = 4L + 1) becomes
//     two B rows of K bytes, one a guide, with no decode: row 2p is lanes
//     [0, 3L) as stored, then s at lane 3L; row 2p + 1 is stored lanes
//     [3L, 6L) moved down to [0, 3L), then 1 at lane 3L; zeros up to K.
//     A query row is tetra(q) in lanes [0, 3L) and -(T + 1) at lane 3L
//     (T + 1 lies in [1 - L, 3L + 1], an int8).  The even sum is then
//     s*A - s*(T + 1) and the odd one B - (T + 1): a guide counts iff its
//     sum is >= 0, the threshold rides in the product (scale-d 0 on the
//     first k32 step), and one accumulator holds both guides of a pair;
//   * block: one producer warpgroup and four consumer warpgroups of 64
//     queries held as wgmma A fragments (640 threads, one block an SM;
//     setmaxnreg moves registers from the producer to the consumers);
//   * a ring of kStages tiles of 64 pair rows, 128 B rows, one m64n128
//     product's columns in guide order (B row r of the tile at pair row t0
//     is guide 2 t0 + r).  The tile's 8 KB, contiguous in the database,
//     reach a staging ring by cp.async kRawStages - 1 tiles ahead, 16
//     coalesced bytes a thread in turn (chunks loaded by each thread for
//     its own row left the producer waiting on L2 at every tile).  Then
//     producer thread p writes B row p: it reads the 16-byte chunks of
//     pair row t0 + p / 2 that its half needs (stored XOR-swizzled by the
//     row, so that the rows' reads hit distinct banks), moves the odd
//     half's bytes down by 3L (whole words at L % 4 == 0, a funnel shift
//     otherwise; L is a template parameter, 1..21), sets the bias lane and
//     stores the row in the K-major core-matrix layout of
//     wgmma_common.cuh.  The 8-row groups of that layout do not match the
//     rows' contiguous 128 bytes, so the rows pass through registers
//     (packed_common.cuh produce_pairs, which the packed top-k shares);
//   * product: per tile, K / 32 wgmma m64n128k32 s8 x s8 -> s32 (1 step
//     at L <= 10, 2 at L 11..21) in one commit group, the consumers taking
//     turns to issue;
//   * epilogue (gm::count_tile): a thread ANDs the 32 sums of each of its
//     two query rows; if the sign bit survives, none counts (the common
//     case), else the row counts its sums >= 0.  A slot that is not a real
//     guide (the odd slot of the last pair when nd is odd, rows past the
//     split's end or past nd) sums to -c(T + 1), which is >= 0 when
//     4e >= 3L + 1, so the columns at or past the split's last real guide
//     are masked by index, in the split's last tile only (every other tile
//     is whole);
//   * the database is cut into gridDim.y splits of whole tiles so that
//     small query sets still fill the card; each split adds its per-query
//     counts, summed over the quad, with one integer atomicAdd, so the
//     result is exact and does not depend on the order in which blocks
//     finish.
// Targets sm_90a: wgmma and setmaxnreg exist for no other target.
#include <stdint.h>

#include "packed_common.cuh"

namespace {

using gm::kPairTile;
using gm::kQPerBlock;
using gm::kWarpgroup;

constexpr int kStageBytes = gm::kPairStageBytes;
// registers a thread of the producer (a pair row's chunks) and of a
// consumer warpgroup (64 accumulators, 4 or 8 fragment registers)
constexpr int kProducerRegs = 56;
constexpr int kConsumerRegs = 104;

// Byte lanes o..o+3 of a query row's bias lane: -(thresh + 1) at lane
// three_l.
__device__ __forceinline__ uint32_t bias_lane(int o, int three_l, int bias) {
  const int b = three_l - o;
  return b >= 0 && b < 4 ? (static_cast<uint32_t>(bias) & 0xffu) << (8 * b)
                         : 0u;
}

// A consumer warpgroup: its 64 queries against every tile of the split's
// pair rows [lo, hi); guides at or past ghi are not counted.
template <int KS>
__device__ __forceinline__ void consume(const uint32_t* __restrict__ q,
                                        int nq, int three_l, int thresh,
                                        int lo, int hi, int ghi,
                                        int* __restrict__ out, uint32_t ring,
                                        uint32_t full, uint32_t empty) {
  const int g = (threadIdx.x & 31) >> 2, t4 = threadIdx.x & 3;
  // consumer c holds queries 64 c .. 64 c + 63 of the block, its warp w
  // rows 16 w .. 16 w + 15 of those
  const int c = (threadIdx.x - kWarpgroup) / kWarpgroup;
  const int qw = blockIdx.x * kQPerBlock + 64 * c +
                 ((threadIdx.x >> 5) & 3) * 16;
  const int bias = -(thresh + 1);
  // registers 0 and 1: K bytes 32 s + 4t.., rows g and g + 8; 2 and 3:
  // bytes 32 s + 16 + 4t..; lanes past 3L (the query's second copy) zeroed
  uint32_t a[KS][4];
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int qi = qw + 8 * half + g;
    const uint32_t* row = q + static_cast<size_t>(qi) * (4 * gm::kPackedVecs);
#pragma unroll
    for (int s = 0; s < KS; ++s)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int o = 32 * s + 16 * h + 4 * t4;
        const uint32_t w = qi < nq ? row[o / 4] : 0u;
        a[s][2 * h + half] = (w & gm::lanes_below(o, three_l)) |
                             bias_lane(o, three_l, bias);
      }
  }
  // opaque to the compiler, which would otherwise reload the fragments
  // before every product
#pragma unroll
  for (int s = 0; s < KS; ++s)
#pragma unroll
    for (int i = 0; i < 4; ++i) asm volatile("" : "+r"(a[s][i]));
  int cnt[2] = {};
  const int n_tiles = (hi - lo + kPairTile - 1) / kPairTile;
  const uint64_t desc0 = gm::smem_desc(ring, 128, 256 * KS);
  constexpr uint64_t kStageDesc = kStageBytes >> 4;
  int acc[64] = {};
  gm::consume_tiles(
      n_tiles, full, empty, acc,
      [&](int st) {
        gm::wgmma_fence();
#pragma unroll
        for (int s = 0; s < KS; ++s)
          gm::wgmma_m64n128k32_s8(acc, a[s], desc0 + st * kStageDesc + 16 * s,
                                  s == 0 ? 0 : 1);
        gm::wgmma_commit();
      },
      [&](int t) {
        // the tile's real guides: all 128 but in the split's last tile
        const int real = ghi - 2 * (lo + t * kPairTile);
        if (real >= 2 * kPairTile)
          gm::count_tile(cnt, acc);
        else
          gm::count_tile<true>(cnt, acc, real);
      });
  gm::add_row_counts(cnt, out, nq, qw);
}

__global__ void __launch_bounds__(gm::kRingThreads, 1)
    packed_count_kernel(const uint32_t* __restrict__ q, int nq,
                        const int4* __restrict__ db, int nd, int length,
                        int thresh, int rows_per_split,
                        int* __restrict__ out) {
  extern __shared__ __align__(1024) uint8_t smem[];
  const int lo = blockIdx.y * rows_per_split;
  const int hi = min((nd + 1) / 2, lo + rows_per_split);
  // an empty split: the block counts nothing
  if (lo >= hi) return;
  // guides below ghi are real and in this split
  const int ghi = min(2 * hi, nd);
  gm::ring_roles<kStageBytes, kProducerRegs, kConsumerRegs>(
      smem,
      [&](uint8_t* ring, uint32_t full, uint32_t empty) {
        gm::produce_pair_rows<false>(length, db, lo, hi, ring, full, empty);
      },
      [&](uint32_t ring, uint32_t full, uint32_t empty) {
        if (gm::pair_b_steps(length) == 1)
          consume<1>(q, nq, 3 * length, thresh, lo, hi, ghi, out, ring, full,
                     empty);
        else
          consume<2>(q, nq, 3 * length, thresh, lo, hi, ghi, out, ring, full,
                     empty);
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
  const cudaError_t err =
      gm::ring_kernel_ready<kProducerRegs, kConsumerRegs>(packed_count_kernel,
                                                          gm::kPairSmemBytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  // whole tiles a split, so that only the last split has a ragged tile
  const int tiles = (n2 + kPairTile - 1) / kPairTile;
  const int rows_per_split = (tiles + n_splits - 1) / n_splits * kPairTile;
  const dim3 grid((nq + kQPerBlock - 1) / kQPerBlock, n_splits);
  packed_count_kernel<<<grid, gm::kRingThreads, gm::kPairSmemBytes,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(q), nq, static_cast<const int4*>(db), nd,
      length, 3 * length - 4 * editdist, rows_per_split,
      static_cast<int*>(out));
  return static_cast<int>(cudaGetLastError());
}
