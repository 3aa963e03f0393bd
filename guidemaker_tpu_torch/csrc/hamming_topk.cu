// Top-k kernel: for each query, the k smallest packed keys
// (dist << 24) | idx over the whole database, ascending, with the match
// counts taken on the int8 tensor cores through Hopper's warpgroup product
// (wgmma).
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
// chip_smoke.py states, as in hamming_count.cu).  Building a key and
// testing it against a running top-K list is CUDA-core work that would cost
// several times the product if every pair paid it, so the design makes the
// product the count kernel's and the common pair cost what the count's
// threshold costs:
//   * block: the count kernel's (hamming_count.cu, onehot_wgmma.cuh,
//     wgmma_common.cuh): one producer warpgroup decodes the split's packed
//     database rows into a 4-stage shared-memory ring of 128-row one-hot
//     tiles, four consumer warpgroups of 64 queries hold their A fragments
//     in registers and take turns to issue KS wgmma m64n128k32 s8 a tile
//     (KS, 1..4, from the last valid base of the block's queries), 640
//     threads, one block an SM;
//   * the gate rides in the product: each row's sums start at its bias
//     b = dK - L - 1, dK its gate distance (L + 1 while its lists are not
//     full), so a sum is >= 0 iff the pair is closer than dK.  The bias sits
//     in the bias lane of the row's A fragment (onehot_wgmma.cuh), which the
//     epilogue rewrites after the tile's wgmma_wait when the gate moves (the
//     next product's wgmma_fence orders the write before it is read); blocks
//     with no spare lane start the accumulators at the bias instead;
//   * epilogue (wgmma_common.cuh): a chain of ANDs over each row's 32 sums
//     and a sign test, as the count's; only a row with a sum >= 0 goes on,
//     and the exact key compare decides each insertion.  Once the lists
//     fill, most tiles cost what they cost the count kernel;
//   * lists, K (k rounded up to a power of two) a template parameter: for
//     K <= 32 each thread keeps a sub-list of K keys for each of its two
//     rows over its own columns, in shared memory (2 K ints a thread,
//     128 KB at K 32 beside the 65.6 KB ring; registers for K 8 spilled
//     beside the 64 accumulators), gated by the quad's four sub-lists
//     (wgmma_common.cuh: QuadLists; a shuffle round when a list changes)
//     and merged by the quad at the end of the split; for K 64 and 128
//     each row keeps one list in shared memory (256 rows x (K + 1) ints,
//     132 KB at K 128), which the quad's lanes fill in turn (RowLists).
//     knum 3 and 5 and the control checks' k 1 take K 4, 8 and 1;
//   * a lane turns only its own candidates into keys (a mask of its sums
//     >= 0, the sums packed to bytes), so a warp takes as many turns as its
//     busiest lane, not one for each sum that some lane passes;
//   * padding rows past the split carry the bias lane's 1, so a padding
//     column can pass a zero bias; the epilogue drops it by index;
//   * a block whose queries are all N runs the 1-step product on zeros:
//     every pair is at distance L, and the lists take the lowest indices;
//   * the database is cut into gridDim.y splits of whole tiles to fill the
//     card (the wrapper's plan; an empty split writes empty lists); each
//     split writes its own sorted lists to (nq, n_splits, K), and
//     gm::merge_kernel (topk_common.cuh) folds the splits into the final
//     (nq, k) by key, so ties go to the lower index.
// Targets sm_90a: wgmma and setmaxnreg exist for no other target.
#include <stdint.h>

#include <type_traits>

#include "onehot_wgmma.cuh"
#include "topk_common.cuh"

namespace {

using gm::kQPerBlock;
using gm::kTile;
using gm::kWarpgroup;

constexpr int kStageBytes = gm::kOnehotStageBytes;
constexpr int kRingBytes = gm::ring_smem_bytes(kStageBytes);
// registers a thread of the producer and of a consumer warpgroup
constexpr int kProducerRegs = 32;
constexpr int kConsumerRegs = 112;
constexpr int kConsumerThreads = gm::kConsumers * kWarpgroup;
// the largest K whose sub-lists fit in shared memory beside the ring
constexpr int kSubListK = 32;

template <int K>
using Lists = std::conditional_t<(K <= kSubListK),
                                 gm::QuadLists<K, kConsumerThreads>,
                                 gm::RowLists<K>>;

// dynamic shared memory of the kernel at K: the ring, then the lists
template <int K>
constexpr int smem_bytes() {
  if constexpr (K <= kSubListK)
    return kRingBytes + 4 * 2 * K * kConsumerThreads;
  else
    return kRingBytes + 4 * gm::RowLists<K>::ints(kQPerBlock);
}

// A consumer warpgroup: the lists of its 64 queries over the split's rows
// [lo, hi), written to partial.
template <int K, int KS, bool kBias>
__device__ __forceinline__ void consume(const ulonglong2* __restrict__ q,
                                        int nq, int lo, int hi, int length,
                                        int* __restrict__ partial,
                                        int* list_smem, uint32_t ring,
                                        uint32_t full, uint32_t empty) {
  // consumer c holds queries 64 c .. 64 c + 63 of the block, its warp w
  // rows 16 w .. 16 w + 15 of those, the lane rows g and g + 8 of the warp
  const int c = (threadIdx.x - kWarpgroup) / kWarpgroup;
  const int warp_row = 64 * c + ((threadIdx.x >> 5) & 3) * 16;
  const int row = warp_row + ((threadIdx.x & 31) >> 2);
  uint32_t a[KS][4];
  // the lists start empty: bias 0
  gm::onehot_a<KS, kBias>(a, q, nq, blockIdx.x * kQPerBlock + warp_row, 0);
  int bias[2] = {0, 0};
  Lists<K> lists(list_smem, row, threadIdx.x - kWarpgroup);
  const int n_tiles = (hi - lo + kTile - 1) / kTile;
  const uint64_t desc0 = gm::smem_desc(ring, 128, 256 * KS);
  constexpr uint64_t kStageDesc = kStageBytes >> 4;
  int acc[64] = {};
  gm::consume_tiles(
      n_tiles, full, empty, acc,
      [&](int st) {
        gm::onehot_product<KS, kBias, true>(
            acc, a, desc0 + st * kStageDesc, bias[0], bias[1]);
      },
      [&](int t) {
        // dist = L + bias - sum
        const int dbase[2] = {length + bias[0], length + bias[1]};
        const bool put = lists.tile(acc, dbase, lo + t * kTile, hi);
        if (!__any_sync(0xffffffffu, put)) return;
        lists.gate(length, bias);
        if constexpr (kBias) gm::set_bias_lane(a, bias);
      });
  int* out[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int qi = blockIdx.x * kQPerBlock + row + 8 * h;
    out[h] = qi < nq ? partial + (static_cast<size_t>(qi) * gridDim.y +
                                  blockIdx.y) * K
                     : nullptr;
  }
  lists.write(out);
}

template <int K>
__global__ void __launch_bounds__(gm::kRingThreads, 1)
    topk_kernel(const ulonglong2* __restrict__ q, int nq,
                const ulonglong2* __restrict__ db, int nd, int length,
                int rows_per_split, int* __restrict__ partial) {
  extern __shared__ __align__(1024) uint8_t smem[];
  __shared__ int nb_shared;
  const int lo = blockIdx.y * rows_per_split;
  const int hi = min(nd, lo + rows_per_split);
  if (lo >= hi) {
    // an empty split: its lists hold no key, for the merge to read
    const int qi = blockIdx.x * kQPerBlock + threadIdx.x;
    if (threadIdx.x < kQPerBlock && qi < nq)
      for (int i = 0; i < K; ++i)
        partial[(static_cast<size_t>(qi) * gridDim.y + blockIdx.y) * K + i] =
            gm::kInfKey;
    return;
  }
  // a block whose queries are all N takes the 1-step product of zeros
  const int nb = max(1, gm::block_bases(q, nq, &nb_shared));
  const int cfg = gm::onehot_config(nb);
  int* lists = reinterpret_cast<int*>(smem + kRingBytes);
  gm::ring_roles<kStageBytes, kProducerRegs, kConsumerRegs>(
      smem,
      [&](uint8_t* ring, uint32_t full, uint32_t empty) {
#define GM_PRODUCE(KS, B) \
  gm::produce_onehot<KS, B>(db, lo, hi, ring, full, empty)
        switch (cfg) { GM_ONEHOT_CASES(GM_PRODUCE) }
#undef GM_PRODUCE
      },
      [&](uint32_t ring, uint32_t full, uint32_t empty) {
#define GM_CONSUME(KS, B)                                              \
  consume<K, KS, B>(q, nq, lo, hi, length, partial, lists, ring,     \
                    full, empty)
        switch (cfg) { GM_ONEHOT_CASES(GM_CONSUME) }
#undef GM_CONSUME
      });
}

template <int K>
int launch(const void* q, int nq, const void* db, int nd, int length, int k,
           int n_splits, void* partial, void* out, cudaStream_t stream) {
  constexpr int kSmem = smem_bytes<K>();
  const cudaError_t err =
      gm::ring_kernel_ready<kProducerRegs, kConsumerRegs>(topk_kernel<K>,
                                                          kSmem);
  if (err != cudaSuccess) return static_cast<int>(err);
  // whole tiles a split, so that only the last split has a ragged tile
  const int tiles = (nd + kTile - 1) / kTile;
  const int rows_per_split = (tiles + n_splits - 1) / n_splits * kTile;
  const dim3 grid((nq + kQPerBlock - 1) / kQPerBlock, n_splits);
  topk_kernel<K><<<grid, gm::kRingThreads, kSmem, stream>>>(
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
