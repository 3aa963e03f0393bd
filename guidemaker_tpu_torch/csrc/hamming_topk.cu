// Top-k kernel: for each query, the k smallest packed keys
// (dist << 24) | idx over the whole database, ascending.
//
// Replaces two Pallas kernels of the JAX package:
// guidemaker_tpu/knn/pallas_stream.py:_stream_kernel (launched by
// _stream_topk) and guidemaker_tpu/knn/pallas_hamming.py:_kernel (launched
// by _pallas_topk).  They compute the same top-k; their split existed only
// because of the TPU's cost per grid step, so one kernel serves both here.
//
// What bounds it on an H100: integer instruction throughput.  Each pair
// costs the match count of the count kernel plus one compare against the
// thread's current K-th key; the rare keys that beat it pay a branch-free
// insertion of K min/max pairs.  The design:
//   * one query per thread, its running top-K list in registers (K is k
//     rounded up to a power of two, a template parameter, so every index
//     into the list is static);
//   * database tiles staged in shared memory and read as broadcasts;
//   * the database is cut into gridDim.y splits to fill the card; each
//     split writes its own sorted list to (nq, n_splits, K), and
//     gm::merge_kernel (topk_common.cuh) folds the splits into the final
//     (nq, k).
// At K = 128 the list takes most of a thread's registers, which limits the
// blocks an SM holds; that is accepted for now (knum is at most 20).
#include <stdint.h>

#include "hamming_common.cuh"
#include "topk_common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kTile = 1024;

template <int K>
__global__ void __launch_bounds__(kThreads)
    topk_kernel(const ulonglong2* __restrict__ q, int nq,
                const ulonglong2* __restrict__ db, int nd, int length,
                int rows_per_split, int* __restrict__ partial) {
  __shared__ ulonglong2 tile[kTile];
  const int qi = blockIdx.x * kThreads + threadIdx.x;
  const ulonglong2 qr = qi < nq ? q[qi] : make_ulonglong2(0ull, 0ull);
  int best[K];
#pragma unroll
  for (int i = 0; i < K; ++i) best[i] = gm::kInfKey;
  const int lo = blockIdx.y * rows_per_split;
  const int hi = min(nd, lo + rows_per_split);
  for (int t = lo; t < hi; t += kTile) {
    const int rows = min(kTile, hi - t);
    __syncthreads();
    for (int r = threadIdx.x; r < rows; r += kThreads) tile[r] = db[t + r];
    __syncthreads();
#pragma unroll 4
    for (int r = 0; r < rows; ++r) {
      const int key =
          ((length - gm::matches(qr, tile[r])) << gm::kIdxBits) | (t + r);
      if (key < best[K - 1]) gm::insert<K>(best, key);
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
  const int rows_per_split = (nd + n_splits - 1) / n_splits;
  const dim3 grid((nq + kThreads - 1) / kThreads, n_splits);
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
  if (nq <= 0 || nd <= 0 || k < 1 || k > kcap || n_splits <= 0 ||
      n_splits > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  GM_DISPATCH_KCAP(kcap, launch, q, nq, db, nd, length, k, n_splits, partial,
                   out, s)
}
