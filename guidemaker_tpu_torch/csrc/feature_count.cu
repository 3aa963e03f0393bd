// Count kernel over bit-packed binary feature rows: for each query row, the
// number of database rows whose feature dot product exceeds thresh, on the
// tensor cores' 1-bit product through Hopper's warpgroup product (wgmma).
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
// wgmma m64n128k256 .b1 .and.popc.
//
// What bounds it on an H100: operations, 2 * nq * nd * 64G bit
// operations.  NVIDIA's data sheet gives no 1-bit rate; chip_smoke.py's
// phase 2 measures the b1 mma.sync and b1 wgmma rates with csrc/mma_rate.cu
// (the b1 wgmma issues 8.05 times the operations of the s8 wgmma, as b1
// mma.sync does of s8 mma.sync), so at L 20 a tile of pairs takes 5 k256
// steps where the int8 form of the 64 lanes a gram position would take 36
// k32 steps.  Beside the products, the database rows are 8G bytes each
// (144 at L 20) and every block streams its split of them from L2: at
// genome size that stream alone takes about as long as the products
// (tools/feature_variants.py), so the producer has to keep it moving.
// The design:
//   * block: wgmma_common.cuh's ring block, as the 2-bit count
//     (hamming_count.cu) runs it: one producer warpgroup and four consumer
//     warpgroups (640 threads, one block an SM; setmaxnreg gives the
//     consumers the registers the producer does not need), each consumer
//     holding 64 queries, one m64 tile, as wgmma A fragments in registers
//     for the whole database walk: 4S registers, the units 8s + t (register
//     0 row g, 1 row g + 8) and 8s + 4 + t (registers 2 and 3) of its rows'
//     k256 step s.  Above 5 steps (guides of more than 22 bases) they would
//     spill beside the 64 sums, so the block stages its 256 queries once in
//     shared memory and A goes by descriptor;
//   * B: the feature rows as they stand, with no decode.  A k256 step is
//     32 bytes of a row, words 4s..4s+3, and a row takes S = ceil(G / 4)
//     steps (5 at L 20), a template parameter 1..8 set from n_words.  A
//     ring stage holds 128 rows as 2S columns of 16-byte chunks,
//     [chunk][row][16 bytes]: word w of row r at byte
//     (w / 2) 2048 + 16 r + (w % 2) 8, the K-major core matrices of 8 rows
//     x 16 bytes that wgmma reads with a leading byte offset of 2048
//     (along K) and a stride byte offset of 128 (8 rows on);
//   * the producer: when G is even and the rows lie on 16 bytes (guides of
//     even length), one thread copies each tile with the tensor memory
//     accelerator (TMA), a 3-dimensional tensor map over db whose box is
//     the stage: 2 words, 128 rows 8G bytes apart, G / 2 chunks 16 bytes
//     apart.  Rows past nd come as zeros, and the `full` barrier counts
//     the bytes.  Otherwise (odd G: a row is not whole 16-byte chunks)
//     warp w of the producer copies tiles w, w + 4, ... into stage w by
//     8-byte cp.async, each copy instruction 8 rows x 4 words, so that its
//     stores fill whole shared-memory wavefronts; it zero-fills rows past
//     the split's end, waits for its copies and fences them for wgmma's
//     async proxy before its arrivals on the stage's `full` barrier.  At
//     L 20 the count takes 1.5 times as long with the cp.async producer as
//     with the TMA (tools/feature_variants.py);
//   * words G..4S-1 of a row add nothing: the query rows hold them as
//     zero, and the AND ignores whatever the stage holds there, so nothing
//     writes them.  A query past nq is a zero row, and a database row past
//     the split's end (every split but the last ends on a tile) is a zero
//     row: their dot 0 is never > thresh >= 0, so the epilogue needs no
//     column mask, and only the final write checks nq;
//   * product: per tile, S wgmma m64n128k256 b1 in one commit group, the
//     consumers taking turns to issue.  An AND-popcount only adds, so no
//     bias lane can carry the threshold: the sums are set to -(thresh + 1)
//     before each tile's first step (thresh <= 64G = 1,920 at L 32, far
//     inside int32), one operation a pair, and a pair counts iff its sum
//     is >= 0;
//   * epilogue: the 2-bit count's (gm::count_tile and add_row_counts): a
//     thread ANDs each of its two query rows' 32 sums and counts only a
//     row whose sign bit does not survive; the database is cut into
//     gridDim.y splits of whole tiles so that small query sets still fill
//     the card, and each split adds its quad-summed per-query counts with
//     one integer atomicAdd, so the result is exact and order-free.
// Targets sm_90a: wgmma and setmaxnreg exist for no other target.
#include <cuda.h>
#include <stdint.h>

#include "mma_common.cuh"
#include "wgmma_common.cuh"

namespace {

using gm::kQPerBlock;
using gm::kTile;
using gm::kWarpgroup;

// the widest row: 30 words, for 32-base guides
constexpr int kMaxWords = 30;
// registers a thread of the producer and of a consumer warpgroup (the
// consumers' 64 sums and 20 A registers at 5 steps spilled at 104)
constexpr int kProducerRegs = 32;
constexpr int kConsumerRegs = 112;
// the cp.async producer: one warp a stage, each of its 32 lanes arriving
// for 4 threads of the kWarpgroup that a `full` barrier waits for
constexpr int kProducerWarps = kWarpgroup / 32;
constexpr int kLaneArrivals = kWarpgroup / 32;

static_assert(kQPerBlock == gm::kConsumers * 64, "one m64 tile a consumer");
static_assert(kProducerWarps == gm::kStages, "one producer warp a stage");

// k256 steps of a row of n_words words
__host__ __device__ constexpr int feature_steps(int n_words) {
  return (n_words + 3) / 4;
}

// whether a consumer's A fragments, 4S registers, stay in shared memory
// instead: above 5 steps they would spill beside the 64 sums
__host__ __device__ constexpr bool smem_a(int steps) { return steps > 5; }

// bytes of one ring stage: kTile rows of S k256 steps
__host__ __device__ constexpr int stage_bytes(int steps) {
  return kTile * 32 * steps;
}

// after the ring and its barriers: the block's queries, if smem_a
__host__ __device__ constexpr int a_offset(int steps) {
  return gm::ring_smem_bytes(stage_bytes(steps));
}

__host__ __device__ constexpr int smem_bytes(int steps) {
  return a_offset(steps) + (smem_a(steps) ? kQPerBlock * 32 * steps : 0);
}

static_assert(a_offset(1) % 16 == 0 && stage_bytes(1) % 128 == 0,
              "core matrices on 16 bytes, TMA destinations on 128");

// The byte of word w of row r in a tile of n_rows rows stored as
// [chunk][row][16 bytes], and the tile's wgmma descriptor at shared
// address addr: K-major core matrices of 8 rows x 16 bytes, 16 n_rows
// bytes apart along K and 128 bytes apart along the rows.  The k256 step
// s starts 32 n_rows s bytes in.
__device__ __forceinline__ int word_offset(int r, int w, int n_rows) {
  return (w >> 1) * 16 * n_rows + r * 16 + (w & 1) * 8;
}

__device__ __forceinline__ uint64_t tile_desc(uint32_t addr, int n_rows) {
  return gm::smem_desc(addr, 16 * n_rows, 128);
}

// The producer warpgroup: the split's tiles of rows [lo, hi) into the
// ring, by TMA (tma: thread 0 alone) or by 8-byte cp.async (warp w fills
// stage w with tiles w, w + 4, ...; lane l copies rows 8 j + l / 4, words
// 4 c + l % 4, rows at or past hi zero-filled).
template <int S>
__device__ __forceinline__ void produce_features(
    const CUtensorMap* map, bool tma,
    const unsigned long long* __restrict__ db, int n_words, int lo, int hi,
    uint8_t* ring, uint32_t full, uint32_t empty) {
  const int n_tiles = (hi - lo + kTile - 1) / kTile;
  const uint32_t ring_addr =
      static_cast<uint32_t>(__cvta_generic_to_shared(ring));
  if (tma) {
    if (threadIdx.x != 0) return;
    const uint32_t bytes = kTile * 8 * n_words;
    for (int t = 0; t < n_tiles; ++t) {
      const int st = t & (gm::kStages - 1);
      gm::mbar_wait(empty + 8 * st, ((t / gm::kStages) & 1) ^ 1);
      gm::mbar_arrive_expect_tx(full + 8 * st, bytes);
      gm::mbar_arrive(full + 8 * st, kWarpgroup - 1);
      gm::tma_load_3d(ring_addr + st * stage_bytes(S), map, 0,
                      lo + t * kTile, 0, full + 8 * st);
    }
    return;
  }
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int row_l = lane >> 2, col_l = lane & 3;
  const uint32_t dst = ring_addr + warp * stage_bytes(S) +
                       word_offset(row_l, col_l, kTile);
  for (int t = warp; t < n_tiles; t += kProducerWarps) {
    gm::mbar_wait(empty + 8 * warp, ((t / gm::kStages) & 1) ^ 1);
    const int t0 = lo + t * kTile, rows = min(kTile, hi - t0);
    const unsigned long long* row =
        db + static_cast<size_t>(t0 + row_l) * n_words + col_l;
    // loops left rolled, which keeps the producer in its registers
#pragma unroll 1
    for (int r = row_l; r < kTile; r += 8) {
      const bool in = r < rows;
      const unsigned long long* from = in ? row : db;
      const uint32_t to = dst + 16 * (r - row_l);
#pragma unroll 1
      for (int c = 0; 4 * c + col_l < n_words; ++c)
        gm::cp_async<8>(to + 32 * kTile * c, from + 4 * c, in ? 8 : 0);
      row += 8 * n_words;
    }
    gm::cp_async_commit();
    gm::cp_async_wait<0>();
    gm::fence_proxy_async();
    gm::mbar_arrive(full + 8 * warp, kLaneArrivals);
  }
}

// The block's 256 queries, past nq zero, as four 64-row tiles at a, one a
// consumer, each [chunk][row][16 bytes] with words n_words..4S - 1 zero;
// every thread of the block stages its share and fences it for wgmma,
// before the block's first barrier.
template <int S>
__device__ __forceinline__ void stage_queries(
    const unsigned long long* __restrict__ q, int nq, int n_words,
    uint8_t* a) {
  for (int e = threadIdx.x; e < kQPerBlock * 4 * S; e += gm::kRingThreads) {
    const int row = e / (4 * S), w = e % (4 * S);
    const int qi = blockIdx.x * kQPerBlock + row;
    const unsigned long long x =
        qi < nq && w < n_words ? q[static_cast<size_t>(qi) * n_words + w]
                               : 0ull;
    *reinterpret_cast<unsigned long long*>(
        a + (row >> 6) * (64 * 32 * S) + word_offset(row & 63, w, 64)) = x;
  }
  gm::fence_proxy_async();
}

// The A fragments of the warp's 16 query rows qw .. qw + 15: register
// 2h + half of step s holds 32-bit unit 8s + 4h + t of row 8 half + g.  A
// unit past the row's 2 n_words, and a query past nq, are zero.
template <int S>
__device__ __forceinline__ void feature_a(uint32_t (&a)[S][4],
                                          const uint32_t* __restrict__ q,
                                          int nq, int n_words, int qw) {
  const int g = (threadIdx.x & 31) >> 2, t = threadIdx.x & 3;
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int qi = qw + 8 * half + g;
    const uint32_t* row =
        q + static_cast<size_t>(qi < nq ? qi : 0) * (2 * n_words);
#pragma unroll
    for (int s = 0; s < S; ++s)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int u = 8 * s + 4 * h + t;
        a[s][2 * h + half] = qi < nq && u < 2 * n_words ? row[u] : 0u;
      }
  }
  // opaque to the compiler, which could otherwise load the fragments
  // again before every product
#pragma unroll
  for (int s = 0; s < S; ++s)
#pragma unroll
    for (int i = 0; i < 4; ++i) asm volatile("" : "+r"(a[s][i]));
}

// A consumer warpgroup: its 64 queries against every tile of the split,
// A in registers, or staged in shared memory (smem_a).
template <int S>
__device__ __forceinline__ void consume_features(
    const uint32_t* __restrict__ q, int nq, int n_words, int lo, int hi,
    int thresh, int* __restrict__ out, uint32_t ring, uint32_t full,
    uint32_t empty) {
  // consumer c holds queries 64 c .. 64 c + 63 of the block, its warp w
  // rows 16 w .. 16 w + 15 of those
  const int c = (threadIdx.x - kWarpgroup) / kWarpgroup;
  const int qw = blockIdx.x * kQPerBlock + 64 * c +
                 ((threadIdx.x >> 5) & 3) * 16;
  const int bias = -(thresh + 1);
  int cnt[2] = {};
  const int n_tiles = (hi - lo + kTile - 1) / kTile;
  const uint64_t desc0 = tile_desc(ring, kTile);
  // descriptor steps, in 16-byte units: a stage, a k256 step of B and of A
  constexpr uint64_t kStageDesc = stage_bytes(S) >> 4;
  constexpr uint64_t kStepDesc = 2 * kTile, kStepDescA = 2 * 64;
  int acc[64] = {};
  auto epilogue = [&](int) { gm::count_tile(cnt, acc); };
  if constexpr (smem_a(S)) {
    const uint64_t adesc =
        tile_desc(ring + a_offset(S) + c * (64 * 32 * S), 64);
    gm::consume_tiles(
        n_tiles, full, empty, acc,
        [&](int st) {
#pragma unroll
          for (int i = 0; i < 64; ++i) acc[i] = bias;
          gm::wgmma_fence();
#pragma unroll
          for (int s = 0; s < S; ++s)
            gm::wgmma_m64n128k256_b1_ss(
                acc, adesc + kStepDescA * s,
                desc0 + st * kStageDesc + kStepDesc * s, 1);
          gm::wgmma_commit();
        },
        epilogue);
  } else {
    uint32_t a[S][4];
    feature_a<S>(a, q, nq, n_words, qw);
    gm::consume_tiles(
        n_tiles, full, empty, acc,
        [&](int st) {
#pragma unroll
          for (int i = 0; i < 64; ++i) acc[i] = bias;
          gm::wgmma_fence();
#pragma unroll
          for (int s = 0; s < S; ++s)
            gm::wgmma_m64n128k256_b1(
                acc, a[s], desc0 + st * kStageDesc + kStepDesc * s, 1);
          gm::wgmma_commit();
        },
        epilogue);
  }
  gm::add_row_counts(cnt, out, nq, qw);
}

template <int S>
__global__ void __launch_bounds__(gm::kRingThreads, 1)
    feature_count_kernel(const uint32_t* __restrict__ q, int nq,
                         const unsigned long long* __restrict__ db, int nd,
                         int n_words, int thresh, int rows_per_split,
                         int* __restrict__ out,
                         const __grid_constant__ CUtensorMap map, bool tma) {
  extern __shared__ __align__(1024) uint8_t smem[];
  const int lo = blockIdx.y * rows_per_split;
  const int hi = min(nd, lo + rows_per_split);
  if (lo >= hi) return;
  if constexpr (smem_a(S))
    stage_queries<S>(reinterpret_cast<const unsigned long long*>(q), nq,
                     n_words, smem + a_offset(S));
  gm::ring_roles<stage_bytes(S), kProducerRegs, kConsumerRegs>(
      smem,
      [&](uint8_t* ring, uint32_t full, uint32_t empty) {
        produce_features<S>(&map, tma, db, n_words, lo, hi, ring, full,
                            empty);
      },
      [&](uint32_t ring, uint32_t full, uint32_t empty) {
        consume_features<S>(q, nq, n_words, lo, hi, thresh, out, ring, full,
                            empty);
      });
}

// cuTensorMapEncodeTiled, from the driver through the runtime, so that the
// library needs no link to the driver's own library
typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType,
                                cuuint32_t, void*, const cuuint64_t*,
                                const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave,
                                CUtensorMapSwizzle, CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

EncodeTiled encode_tiled() {
  void* fn = nullptr;
  cudaDriverEntryPointQueryResult status;
  if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &fn,
                              cudaEnableDefault, &status) != cudaSuccess ||
      status != cudaDriverEntryPointSuccess)
    return nullptr;
  return reinterpret_cast<EncodeTiled>(fn);
}

// The TMA's map of db's rows of n_words (even) words as a ring stage sees
// them: dimension 0 the two words of a 16-byte chunk, 1 the nd rows
// (8 n_words bytes apart), 2 the n_words / 2 chunks of a row (16 bytes
// apart); a box is 128 rows of every chunk.
cudaError_t feature_map(CUtensorMap* map, const void* db, int nd,
                        int n_words) {
  static const EncodeTiled encode = encode_tiled();
  if (!encode) return cudaErrorNotSupported;
  const cuuint64_t dims[3] = {2, static_cast<cuuint64_t>(nd),
                              static_cast<cuuint64_t>(n_words / 2)};
  const cuuint64_t strides[2] = {8ull * n_words, 16};
  const cuuint32_t box[3] = {2, kTile, static_cast<cuuint32_t>(n_words / 2)};
  const cuuint32_t unit[3] = {1, 1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_UINT64, 3,
                const_cast<void*>(db), dims, strides, box, unit,
                CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE,
                CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS
             ? cudaSuccess
             : cudaErrorInvalidValue;
}

template <int S>
int launch(const void* q, int nq, const void* db, int nd, int n_words,
           int thresh, int n_splits, void* out, cudaStream_t stream) {
  constexpr int bytes = smem_bytes(S);
  cudaError_t err = gm::ring_kernel_ready<kProducerRegs, kConsumerRegs>(
      feature_count_kernel<S>, bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  CUtensorMap map = {};
  const bool tma =
      n_words % 2 == 0 && (reinterpret_cast<uintptr_t>(db) & 15) == 0;
  if (tma && (err = feature_map(&map, db, nd, n_words)) != cudaSuccess)
    return static_cast<int>(err);
  // whole tiles a split, so that only the last split has a ragged tile
  const int tiles = (nd + kTile - 1) / kTile;
  const int rows_per_split = (tiles + n_splits - 1) / n_splits * kTile;
  const dim3 grid((nq + kQPerBlock - 1) / kQPerBlock, n_splits);
  feature_count_kernel<S><<<grid, gm::kRingThreads, bytes, stream>>>(
      static_cast<const uint32_t*>(q), nq,
      static_cast<const unsigned long long*>(db), nd, n_words, thresh,
      rows_per_split, static_cast<int*>(out), map, tma);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// q (nq, n_words) and db (nd, n_words) int64 feature rows, n_words 1..30;
// thresh >= 0; out (nq,) int32, zeroed by the caller.  Returns
// cudaGetLastError() after the launch, or the error that kept it from
// launching.
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
