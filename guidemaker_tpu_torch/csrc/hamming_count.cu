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
//   * block: wgmma_common.cuh's ring block, one producer warpgroup and
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

#include "mma_common.cuh"
#include "wgmma_common.cuh"

namespace {

using gm::kConsumers;
using gm::kQPerBlock;
using gm::kTile;
using gm::kWarpgroup;

// bytes of one ring stage: kTile rows of at most 4 k32 steps
constexpr int kStageBytes = kTile * 32 * gm::kMaxSteps;
constexpr int kSmemBytes = gm::ring_smem_bytes(kStageBytes);
// registers a thread of the producer and of a consumer warpgroup
constexpr int kProducerRegs = 32;
constexpr int kConsumerRegs = 112;

static_assert(kQPerBlock == kConsumers * 64, "one m64 tile a consumer");
static_assert(kTile == kWarpgroup, "one producer thread a tile row");

// Bases of the block: the last valid base of any of its queries, plus 1;
// 0 when none has a valid base.  Every thread of the block calls it; *nb
// is a shared int.
__device__ __forceinline__ int block_bases(const ulonglong2* __restrict__ q,
                                           int nq, int* nb) {
  const int qi = blockIdx.x * kQPerBlock + threadIdx.x;
  const unsigned long long valid =
      threadIdx.x < kQPerBlock && qi < nq ? q[qi].y : 0ull;
  int need = valid ? (63 - __clzll(valid)) / 2 + 1 : 0;
  need = __reduce_max_sync(0xffffffffu, need);
  if (threadIdx.x == 0) *nb = 0;
  __syncthreads();
  if ((threadIdx.x & 31) == 0 && need) atomicMax(nb, need);
  __syncthreads();
  return *nb;
}

// The code planes of a packed row: bit 2i of m[k][h] is set iff base
// 16 h + i is valid with code k.
__device__ __forceinline__ void code_planes(const ulonglong2 row,
                                            uint32_t (&m)[4][2]) {
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const uint32_t x = static_cast<uint32_t>(row.x >> (32 * h));
    const uint32_t v = static_cast<uint32_t>(row.y >> (32 * h));
    const uint32_t hi = (x >> 1) & 0x55555555u;
    m[0][h] = v & ~hi & ~x;
    m[1][h] = v & ~hi & x;
    m[2][h] = v & hi & ~x;
    m[3][h] = v & hi & x;
  }
}

// Byte j of a code plane's half, spread to a one-hot word: byte b of the
// word is bit 8j + 2b of the plane.  The four bits move to bits 8b with
// one multiply (on the FMA pipe, beside the ALU work): their copies
// shifted by 6b' collide only on bits that the mask drops.
__device__ __forceinline__ uint32_t spread(uint32_t plane, int j) {
  const uint32_t b = (plane >> (8 * j)) & 0x55u;
  return (b * 0x41041u) & 0x01010101u;
}

// The producer warpgroup: thread p decodes row p of every tile of the
// split's rows [lo, hi) into the ring (rows at or past hi decode to
// zeros), with the bias lane if kBias.
template <int KS, bool kBias>
__device__ __forceinline__ void produce(const ulonglong2* __restrict__ db,
                                        int lo, int hi, uint8_t* ring,
                                        uint32_t full, uint32_t empty) {
  const ulonglong2 zero = make_ulonglong2(0ull, 0ull);
  const int p = threadIdx.x;
  const int n_tiles = (hi - lo + kTile - 1) / kTile;
  const int row_off = (p >> 3) * (256 * KS) + (p & 7) * 16;
  ulonglong2 row, next = lo + p < hi ? db[lo + p] : zero;
  gm::produce_tiles<kStageBytes>(
      n_tiles, ring, full, empty,
      [&](int t) {
        row = next;
        const int r = lo + (t + 1) * kTile + p;
        next = r < hi ? db[r] : zero;
      },
      [&](uint8_t* stage) {
        uint4* dst = reinterpret_cast<uint4*>(stage + row_off);
        uint32_t m[4][2];
        code_planes(row, m);
#pragma unroll
        for (int c = 0; c < 2 * KS; ++c) {
          uint32_t w0 = spread(m[0][c >> 2], c & 3);
          // the bias lane: code-0 byte of base 8 KS - 1, byte 3 of word 0
          // of the last chunk
          if (kBias && c == 2 * KS - 1)
            w0 = (w0 & 0x00ffffffu) | 0x01000000u;
          dst[8 * c] = make_uint4(w0, spread(m[1][c >> 2], c & 3),
                                  spread(m[2][c >> 2], c & 3),
                                  spread(m[3][c >> 2], c & 3));
        }
      });
}

// The m64 tile's product with the ring stage at descriptor desc, KS k32
// steps in one commit group: the sums start at the bias lane's product
// (kBias) or at bias.
template <int KS, bool kBias>
__device__ __forceinline__ void product(int (&d)[64],
                                        const uint32_t (&a)[KS][4],
                                        uint64_t desc, int bias) {
  if constexpr (!kBias) {
#pragma unroll
    for (int i = 0; i < 64; ++i) d[i] = bias;
  }
  gm::wgmma_fence();
#pragma unroll
  for (int s = 0; s < KS; ++s)
    gm::wgmma_m64n128k32_s8(d, a[s], desc + 16 * s, kBias && s == 0 ? 0 : 1);
  gm::wgmma_commit();
}

// A consumer warpgroup: its 64 queries against every tile of the split.
template <int KS, bool kBias>
__device__ __forceinline__ void consume(const ulonglong2* __restrict__ q,
                                        int nq, int lo, int hi, int thresh,
                                        int* __restrict__ out, uint32_t ring,
                                        uint32_t full, uint32_t empty) {
  const ulonglong2 zero = make_ulonglong2(0ull, 0ull);
  const int g = (threadIdx.x & 31) >> 2, t4 = threadIdx.x & 3;
  // consumer c holds queries 64 c .. 64 c + 63 of the block, its warp w
  // rows 16 w .. 16 w + 15 of those
  const int c = (threadIdx.x - kWarpgroup) / kWarpgroup;
  const int qw = blockIdx.x * kQPerBlock + 64 * c +
                 ((threadIdx.x >> 5) & 3) * 16;
  const int bias = -(thresh + 1);
  uint32_t a[KS][4];
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int qi = qw + 8 * half + g;
    const ulonglong2 row = qi < nq ? q[qi] : zero;
    uint32_t m[4][2];
    code_planes(row, m);
    // the lane's plane t, selected without indexing registers at run time
    uint32_t mine[2];
#pragma unroll
    for (int h = 0; h < 2; ++h)
      mine[h] = t4 == 0 ? m[0][h] : t4 == 1 ? m[1][h] : t4 == 2 ? m[2][h]
                                                                : m[3][h];
    // registers 0 and 1: chunk 2s, word t; 2 and 3: chunk 2s + 1, word t
#pragma unroll
    for (int s = 0; s < KS; ++s) {
      a[s][half] = spread(mine[s >> 1], (2 * s) & 3);
      a[s][2 + half] = spread(mine[s >> 1], (2 * s + 1) & 3);
    }
    // the bias lane: register 2 + half of the last step in lane t 0, byte
    // 3 (the block's base 8 KS - 1 is invalid, so the byte was 0)
    if (kBias && t4 == 0)
      a[KS - 1][2 + half] |= (static_cast<uint32_t>(bias) & 0xffu) << 24;
  }
  // opaque to the compiler, which would otherwise recompute the fragments
  // from the planes before every product
#pragma unroll
  for (int s = 0; s < KS; ++s)
#pragma unroll
    for (int i = 0; i < 4; ++i) asm volatile("" : "+r"(a[s][i]));
  int cnt[2] = {};
  const int n_tiles = (hi - lo + kTile - 1) / kTile;
  const uint64_t desc0 = gm::smem_desc(ring, 128, 256 * KS);
  constexpr uint64_t kStageDesc = kStageBytes >> 4;
  int acc[64] = {};
  gm::consume_tiles(
      n_tiles, full, empty, acc,
      [&](int st) {
        product<KS, kBias>(acc, a, desc0 + st * kStageDesc, bias);
      },
      [&](int) { gm::count_tile(cnt, acc); });
  gm::add_row_counts(cnt, out, nq, qw);
}

#define GM_COUNT_CASES(CALL)            \
  case 0: CALL(1, false); break;        \
  case 1: CALL(1, true); break;         \
  case 2: CALL(2, false); break;        \
  case 3: CALL(2, true); break;         \
  case 4: CALL(3, false); break;        \
  case 5: CALL(3, true); break;         \
  case 6: CALL(4, false); break;        \
  case 7: CALL(4, true); break;         \
  default: break;

__global__ void __launch_bounds__(gm::kRingThreads, 1)
    count_kernel(const ulonglong2* __restrict__ q, int nq,
                 const ulonglong2* __restrict__ db, int nd, int thresh,
                 int rows_per_split, int* __restrict__ out) {
  extern __shared__ __align__(1024) uint8_t smem[];
  __shared__ int nb_shared;
  const int lo = blockIdx.y * rows_per_split;
  const int hi = min(nd, lo + rows_per_split);
  const int nb = block_bases(q, nq, &nb_shared);
  // no query of the block has a valid base, or the split is empty: the
  // block counts nothing
  if (nb == 0 || lo >= hi) return;
  const int ks = (nb + 7) / 8;
  const int cfg = 2 * (ks - 1) + (nb % 8 != 0);
  gm::ring_roles<kStageBytes, kProducerRegs, kConsumerRegs>(
      smem,
      [&](uint8_t* ring, uint32_t full, uint32_t empty) {
#define GM_PRODUCE(KS, B) produce<KS, B>(db, lo, hi, ring, full, empty)
        switch (cfg) { GM_COUNT_CASES(GM_PRODUCE) }
#undef GM_PRODUCE
      },
      [&](uint32_t ring, uint32_t full, uint32_t empty) {
#define GM_CONSUME(KS, B) \
  consume<KS, B>(q, nq, lo, hi, thresh, out, ring, full, empty)
        switch (cfg) { GM_COUNT_CASES(GM_CONSUME) }
#undef GM_CONSUME
      });
}

#undef GM_COUNT_CASES

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
