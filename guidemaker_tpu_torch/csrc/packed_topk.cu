// Packed-pair top-k kernel: for each query, the k smallest packed keys
// (dist << 24) | idx over the whole database, ascending, with two database
// guides per 128-lane int8 row (packed_common.cuh), on the int8 tensor
// cores through Hopper's warpgroup product (wgmma).
//
// Replaces the JAX package's Pallas kernel
// guidemaker_tpu/knn/pallas_packed.py:_topk_kernel (launched by
// _packed_topk), which ran the packed rows' int8 product on the TPU's
// matrix unit, decoded both guides' sums from the one dot v = s*A + B of a
// row and merged two candidate keys a row into its running list.  What it
// computes: the distances (3L - A) >> 2 of guide 2j and (3L - B) >> 2 of
// guide 2j + 1; the odd slot of the last row is no guide when nd is odd.
// Keys are unique per query, so the order of insertion does not matter.
//
// What bounds it on an H100: operations, the tetrahedral dot of 3L lanes a
// pair, 2 * nq * nd * 3L int8 operations at 1,979 TOP/s dense (the bound
// that chip_smoke.py states); the product issued is 2 * nq * nd * K with
// K = 32 ceil((3L + 1) / 32), 64 at L 11..21, as in packed_count.cu.
// Building a key and testing it against a running top-K list is CUDA-core
// work that would cost several times the product if every pair paid it, so
// the design is the packed count's product under the 2-bit top-k's gated
// epilogue (hamming_topk.cu), and the common pair costs what the count's
// threshold costs:
//   * block: the packed count's (packed_count.cu, packed_common.cuh,
//     wgmma_common.cuh): one producer warpgroup stages 64 pair rows a tile
//     by cp.async and splits each into two B rows of K bytes, one a guide,
//     into a 4-stage shared-memory ring; four consumer warpgroups of 64
//     queries hold their A fragments (the query's lanes [0, 3L)) in
//     registers and take turns to issue K / 32 wgmma m64n128k32 s8 a tile,
//     640 threads, one block an SM (setmaxnreg: producer 64, consumers 104
//     registers; the consumers cannot have K2's 112, with which the
//     producer, at 32, spills, and the A fragments take only 4 or 8);
//   * units: the count's even B rows carry s * tetra(guide), whose sums
//     reach about +-7,400 at L 21, but the epilogue packs a lane's sums to
//     bytes.  The producer writes the top-k's even rows in units (+-s to
//     +-1, one prmt and one logic operation a word, shared by 256 queries),
//     so both guides of a pair sum to 3L - 4h + b, in [-4L - 1, 4L + 3];
//   * the gate rides in the product: each row's sums start at its bias
//     b = 4 dK - 3L - 1, dK its gate distance (L + 1 while its lists are not
//     full), so a pair's sum 4 (dK - h) - 1 is >= 0 iff its distance h is
//     below dK, and h = (3L + b - sum) >> 2 (wgmma_common.cuh TetraCode).
//     b lies in [-3L - 1, L + 3], an int8, in lane K - 1 of the row's A
//     fragment, where every B row holds 1.  The packed count's bias lane,
//     3L, falls in another k32 step, register, thread of the quad and byte
//     at each L, and the consumer is built for its step count, not for L;
//     lane K - 1 (>= 3L at every L, free in the query rows) is byte 3 of
//     register 2 (row g) or 3 (row g + 8) of the last step in lane t 3 of
//     the quad at every L.  The epilogue rewrites it there after the tile's
//     wgmma_wait when the gate moves, and the next product's wgmma_fence
//     orders the write before the register is read;
//   * epilogue and lists: the 2-bit top-k's (wgmma_common.cuh QuadLists,
//     RowLists, on TetraCode): a chain of ANDs over each row's 32 sums and
//     a sign test; only a lane with a sum >= 0 turns its own candidates
//     into keys, and the exact key compare decides each insertion.  For
//     K <= 32 (K, k rounded up to a power of two, a template parameter)
//     each thread keeps a sub-list of K keys for each of its two rows over
//     its own columns in shared memory (2 K ints a thread, 128 KB at K 32),
//     gated by the quad's four sub-lists and merged by the quad at the end
//     of the split; for K 64 and 128 each row keeps one list in shared
//     memory (132,096 B at K 128), which the quad's lanes fill in turn.
//     Beside the ring and the staging stages (65,600 B) that is at most
//     196,672 and 197,696 B of the 227 KB a block may hold.  knum 3 and 5
//     and the control checks' k 1 take K 4, 8 and 1;
//   * padding columns (rows past the split, the odd slot of the last pair
//     when nd is odd) carry only the bias lanes' 1s, so their sum is the
//     row's bias alone, >= 0 while its lists are not full (b = L + 3); the
//     epilogue drops every column at or past min(split end, nd) by index.
//     Column c of the tile at pair row t0 is guide 2 t0 + c;
//   * the database is cut into gridDim.y splits of whole tiles to fill the
//     card (the wrapper's plan; an empty split writes empty lists); each
//     split writes its own sorted lists to (nq, n_splits, K), and
//     gm::merge_kernel (topk_common.cuh) folds the splits into the final
//     (nq, k) by key, so ties go to the lower index.
// Targets sm_90a: wgmma and setmaxnreg exist for no other target.
#include <stdint.h>

#include <type_traits>

#include "packed_common.cuh"
#include "topk_common.cuh"

namespace {

using gm::kPairTile;
using gm::kQPerBlock;
using gm::kWarpgroup;

constexpr int kStageBytes = gm::kPairStageBytes;
// registers a thread of the producer (a pair row's chunks) and of a
// consumer warpgroup (64 accumulators, 4 or 8 fragment registers, the
// epilogue): the block's whole 96 a thread (ring_roles)
constexpr int kProducerRegs = 64;
constexpr int kConsumerRegs = 104;
constexpr int kConsumerThreads = gm::kConsumers * kWarpgroup;
// the largest K whose sub-lists fit in shared memory beside the ring
constexpr int kSubListK = 32;

template <int K>
using Lists =
    std::conditional_t<(K <= kSubListK),
                       gm::QuadLists<K, kConsumerThreads, gm::TetraCode>,
                       gm::RowLists<K, gm::TetraCode>>;

// dynamic shared memory of the kernel at K: the ring and the staging
// stages, then the lists
template <int K>
constexpr int smem_bytes() {
  if constexpr (K <= kSubListK)
    return gm::kPairSmemBytes + 4 * 2 * K * kConsumerThreads;
  else
    return gm::kPairSmemBytes + 4 * gm::RowLists<K>::ints(kQPerBlock);
}

// The lane's bias lane, byte 3 of register 2 + half of the last k32 step in
// lane t 3 of the quad (K byte K - 1), set to bias[half] for its row
// 8 half + g.
template <int KS>
__device__ __forceinline__ void set_bias_lane(uint32_t (&a)[KS][4],
                                              const int (&bias)[2]) {
  if ((threadIdx.x & 3) != 3) return;
#pragma unroll
  for (int half = 0; half < 2; ++half)
    a[KS - 1][2 + half] = (a[KS - 1][2 + half] & 0x00ffffffu) |
                          (static_cast<uint32_t>(bias[half]) & 0xffu) << 24;
}

// A consumer warpgroup: the lists of its 64 queries over the split's pair
// rows [lo, hi), whose guides below ghi are real, written to partial.
template <int K, int KS>
__device__ __forceinline__ void consume(const uint32_t* __restrict__ q,
                                        int nq, int lo, int hi, int ghi,
                                        int length, int* __restrict__ partial,
                                        int* list_smem, uint32_t ring,
                                        uint32_t full, uint32_t empty) {
  // consumer c holds queries 64 c .. 64 c + 63 of the block, its warp w
  // rows 16 w .. 16 w + 15 of those, the lane rows g and g + 8 of the warp
  const int c = (threadIdx.x - kWarpgroup) / kWarpgroup;
  const int warp_row = 64 * c + ((threadIdx.x >> 5) & 3) * 16;
  const int row = warp_row + ((threadIdx.x & 31) >> 2);
  const int t4 = threadIdx.x & 3, three_l = 3 * length;
  // registers 0 and 1: K bytes 32 s + 4t.., rows g and g + 8; 2 and 3:
  // bytes 32 s + 16 + 4t..; lanes past 3L (the query's second copy) zeroed
  uint32_t a[KS][4];
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int qi = blockIdx.x * kQPerBlock + row + 8 * half;
    const uint32_t* qrow =
        q + static_cast<size_t>(qi) * (4 * gm::kPackedVecs);
#pragma unroll
    for (int s = 0; s < KS; ++s)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int o = 32 * s + 16 * h + 4 * t4;
        const uint32_t w = qi < nq ? qrow[o / 4] : 0u;
        a[s][2 * h + half] = w & gm::lanes_below(o, three_l);
      }
  }
  // the lists start empty: dK = L + 1
  int bias[2];
  bias[0] = bias[1] = gm::TetraCode::bias(length + 1, length);
  set_bias_lane(a, bias);
  // the epilogue keeps each row's dbase = 3L + b = 4 dK - 1, which does not
  // depend on L, and turns it into its bias only when the gate moves
  int dbase[2] = {3 * length + bias[0], 3 * length + bias[1]};
  // the guide of the tile's first column
  int col0 = 2 * lo;
  // opaque to the compiler, which would otherwise reload the fragments
  // before every product
#pragma unroll
  for (int s = 0; s < KS; ++s)
#pragma unroll
    for (int i = 0; i < 4; ++i) asm volatile("" : "+r"(a[s][i]));
  Lists<K> lists(list_smem, row, threadIdx.x - kWarpgroup);
  const int n_tiles = (hi - lo + kPairTile - 1) / kPairTile;
  const uint64_t desc0 = gm::smem_desc(ring, 128, 256 * KS);
  constexpr uint64_t kStageDesc = kStageBytes >> 4;
  int acc[64] = {};
  gm::consume_tiles(
      n_tiles, full, empty, acc,
      [&](int st) {
        gm::wgmma_fence();
        // the first step takes the accumulators as outputs only, so that
        // their registers are free from the epilogue to this product
        gm::wgmma_m64n128k32_s8_fresh(acc, a[0], desc0 + st * kStageDesc);
#pragma unroll
        for (int s = 1; s < KS; ++s)
          gm::wgmma_m64n128k32_s8(acc, a[s],
                                  desc0 + st * kStageDesc + 16 * s, 1);
        gm::wgmma_commit();
      },
      [&](int) {
        const bool put = lists.tile(acc, dbase, col0, ghi);
        col0 += 2 * kPairTile;
        if (!__any_sync(0xffffffffu, put)) return;
        int b[2];
        lists.gate(length, b);
        set_bias_lane(a, b);
#pragma unroll
        for (int h = 0; h < 2; ++h) dbase[h] = 3 * length + b[h];
      });
  // the lane's row again, read afresh so that it holds no register across
  // the loop (kcap 32 spilled without)
  uint32_t tid;
  asm volatile("mov.u32 %0, %%tid.x;\n" : "=r"(tid));
  const int out_row = 64 * ((tid - kWarpgroup) / kWarpgroup) +
                      ((tid >> 5) & 3) * 16 + ((tid & 31) >> 2);
  int* out[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int qi = blockIdx.x * kQPerBlock + out_row + 8 * h;
    out[h] = qi < nq ? partial + (static_cast<size_t>(qi) * gridDim.y +
                                  blockIdx.y) * K
                     : nullptr;
  }
  lists.write(out);
}

template <int K>
__global__ void __launch_bounds__(gm::kRingThreads, 1)
    packed_topk_kernel(const uint32_t* __restrict__ q, int nq,
                       const int4* __restrict__ db, int nd, int length,
                       int rows_per_split, int* __restrict__ partial) {
  extern __shared__ __align__(1024) uint8_t smem[];
  const int lo = blockIdx.y * rows_per_split;
  const int hi = min((nd + 1) / 2, lo + rows_per_split);
  if (lo >= hi) {
    // an empty split: its lists hold no key, for the merge to read
    const int qi = blockIdx.x * kQPerBlock + threadIdx.x;
    if (threadIdx.x < kQPerBlock && qi < nq)
      for (int i = 0; i < K; ++i)
        partial[(static_cast<size_t>(qi) * gridDim.y + blockIdx.y) * K + i] =
            gm::kInfKey;
    return;
  }
  // guides below ghi are real and in this split
  const int ghi = min(2 * hi, nd);
  int* lists = reinterpret_cast<int*>(smem + gm::kPairSmemBytes);
  gm::ring_roles<kStageBytes, kProducerRegs, kConsumerRegs>(
      smem,
      [&](uint8_t* ring, uint32_t full, uint32_t empty) {
        gm::produce_pair_rows<true>(length, db, lo, hi, ring, full, empty);
      },
      [&](uint32_t ring, uint32_t full, uint32_t empty) {
        if (gm::pair_b_steps(length) == 1)
          consume<K, 1>(q, nq, lo, hi, ghi, length, partial, lists, ring,
                        full, empty);
        else
          consume<K, 2>(q, nq, lo, hi, ghi, length, partial, lists, ring,
                        full, empty);
      });
}

template <int K>
int launch(const void* q, int nq, const void* db, int nd, int length, int k,
           int n_splits, void* partial, void* out, cudaStream_t stream) {
  constexpr int kSmem = smem_bytes<K>();
  const cudaError_t err =
      gm::ring_kernel_ready<kProducerRegs, kConsumerRegs>(
          packed_topk_kernel<K>, kSmem);
  if (err != cudaSuccess) return static_cast<int>(err);
  // whole tiles a split, so that only the last split has a ragged tile
  const int tiles = ((nd + 1) / 2 + kPairTile - 1) / kPairTile;
  const int rows_per_split = (tiles + n_splits - 1) / n_splits * kPairTile;
  const dim3 grid((nq + kQPerBlock - 1) / kQPerBlock, n_splits);
  packed_topk_kernel<K><<<grid, gm::kRingThreads, kSmem, stream>>>(
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
