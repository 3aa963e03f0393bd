// Packed-pair top-k kernel: for each query, the k smallest packed keys
// (dist << 24) | idx over the whole database, ascending, with two database
// guides per 128-lane int8 row (packed_common.cuh).
//
// Replaces the JAX package's Pallas kernel
// guidemaker_tpu/knn/pallas_packed.py:_topk_kernel (launched by
// _packed_topk).  What it computes: v = q . d per (query, row); A and B
// decoded from v; the distances (3L - A) >> 2 of guide 2j and
// (3L - B) >> 2 of guide 2j + 1, as two candidate keys; the odd key of
// the last row is dropped when nd is odd.  Keys are unique per query, so
// the order in which candidates are inserted does not matter.
//
// What bounds it on an H100: integer issue, as in packed_count.cu (32
// dp4a per row), plus one compare per guide against the thread's K-th key
// and, for the rare keys that beat it, a branch-free insertion of K
// min/max pairs.  The design follows hamming_topk.cu:
//   * one query row per thread in 32 registers, and its running top-K
//     list in registers (K is k rounded up to a power of two);
//   * database rows staged in shared memory and read as broadcasts;
//   * the database is cut into gridDim.y splits to fill the card; each
//     split writes its own sorted list, and gm::merge_kernel
//     (topk_common.cuh) folds the splits into the final (nq, k).
// 128 threads a block, as the query row and the list share the register
// file (about 32 + K registers a thread).  A later PR would run the
// product on the tensor cores (int8 mma.sync or wgmma).
#include <stdint.h>

#include "packed_common.cuh"
#include "topk_common.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int kTile = 256;  // database rows per shared-memory tile (32 KB)

template <int K>
__global__ void __launch_bounds__(kThreads)
    packed_topk_kernel(const int4* __restrict__ q, int nq,
                       const int4* __restrict__ db, int n2, int nd,
                       int length, int s, float inv_s, int rows_per_split,
                       int* __restrict__ partial) {
  __shared__ int4 tile[kTile * gm::kPackedVecs];
  const int qi = blockIdx.x * kThreads + threadIdx.x;
  int qr[4 * gm::kPackedVecs];
  if (qi < nq) {
    gm::load_row(q + static_cast<size_t>(qi) * gm::kPackedVecs, qr);
  } else {
#pragma unroll
    for (int i = 0; i < 4 * gm::kPackedVecs; ++i) qr[i] = 0;
  }
  int best[K];
#pragma unroll
  for (int i = 0; i < K; ++i) best[i] = gm::kInfKey;
  const int three_l = 3 * length;
  const int lo = blockIdx.y * rows_per_split;
  const int hi = min(n2, lo + rows_per_split);
  for (int t = lo; t < hi; t += kTile) {
    const int rows = min(kTile, hi - t);
    __syncthreads();
    const int4* src = db + static_cast<size_t>(t) * gm::kPackedVecs;
    for (int i = threadIdx.x; i < rows * gm::kPackedVecs; i += kThreads)
      tile[i] = src[i];
    __syncthreads();
    for (int r = 0; r < rows; ++r) {
      const int v = gm::packed_dot(qr, tile + r * gm::kPackedVecs);
      const int a = gm::decode_even(v, length, inv_s);
      const int b = v - s * a;
      const int even = 2 * (t + r);
      const int key_e = (((three_l - a) >> 2) << gm::kIdxBits) | even;
      if (key_e < best[K - 1]) gm::insert<K>(best, key_e);
      const int key_o = (((three_l - b) >> 2) << gm::kIdxBits) | (even + 1);
      if (even + 1 < nd && key_o < best[K - 1]) gm::insert<K>(best, key_o);
    }
  }
  if (qi < nq) {
    int* o = partial + (static_cast<size_t>(qi) * gridDim.y + blockIdx.y) * K;
#pragma unroll
    for (int i = 0; i < K; ++i) o[i] = best[i];
  }
}

template <int K>
int launch(const void* q, int nq, const void* db, int nd, int length, int k,
           int n_splits, void* partial, void* out, cudaStream_t stream) {
  const int n2 = (nd + 1) / 2;
  const int s = 4 * length + 1;
  const float inv_s = 1.0f / static_cast<float>(s);
  const int rows_per_split = (n2 + n_splits - 1) / n_splits;
  const dim3 grid((nq + kThreads - 1) / kThreads, n_splits);
  packed_topk_kernel<K><<<grid, kThreads, 0, stream>>>(
      static_cast<const int4*>(q), nq, static_cast<const int4*>(db), n2, nd,
      length, s, inv_s, rows_per_split, static_cast<int*>(partial));
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
