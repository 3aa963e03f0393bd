// Count kernel: for each query, the number of database rows at Hamming
// distance < editdist (matches > L - editdist).
//
// Replaces the JAX package's Pallas count kernel
// (guidemaker_tpu/knn/pallas_stream.py:_count_kernel, launched by
// _stream_count), which one-hot encoded the guides and counted matches as
// an int8 matrix product on the TPU's matrix unit.
//
// What bounds it on an H100: integer instruction throughput, not bytes.
// Each pair costs about a dozen 32-bit logic operations and two popcounts
// (a quarter-rate instruction), while every database row staged in shared
// memory is reused by all the queries of a block.  The design follows:
//   * each thread holds kQpt queries in registers, so one 16-byte shared
//     memory broadcast feeds kQpt pairs and a block of kThreads * kQpt
//     queries reads the database once from L2;
//   * the database is cut into gridDim.y splits so that small query sets
//     still fill the card; each split adds its counts with one integer
//     atomicAdd per query, so the result is exact and does not depend on
//     the order in which blocks finish;
//   * the ragged edge is masked by nd, so no padding rows exist.
#include <stdint.h>

#include "hamming_common.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int kQpt = 4;
constexpr int kTile = 512;

__global__ void __launch_bounds__(kThreads)
    count_kernel(const ulonglong2* __restrict__ q, int nq,
                 const ulonglong2* __restrict__ db, int nd, int thresh,
                 int rows_per_split, int* __restrict__ out) {
  __shared__ ulonglong2 tile[kTile];
  const int q0 = blockIdx.x * kThreads * kQpt + threadIdx.x;
  ulonglong2 qr[kQpt];
  int cnt[kQpt];
#pragma unroll
  for (int i = 0; i < kQpt; ++i) {
    const int qi = q0 + i * kThreads;
    // a row past nq is all-invalid: it matches nothing and is not written
    qr[i] = qi < nq ? q[qi] : make_ulonglong2(0ull, 0ull);
    cnt[i] = 0;
  }
  const int lo = blockIdx.y * rows_per_split;
  const int hi = min(nd, lo + rows_per_split);
  for (int t = lo; t < hi; t += kTile) {
    const int rows = min(kTile, hi - t);
    __syncthreads();
    for (int r = threadIdx.x; r < rows; r += kThreads) tile[r] = db[t + r];
    __syncthreads();
#pragma unroll 4
    for (int r = 0; r < rows; ++r) {
      const ulonglong2 d = tile[r];
#pragma unroll
      for (int i = 0; i < kQpt; ++i) cnt[i] += gm::matches(qr[i], d) > thresh;
    }
  }
#pragma unroll
  for (int i = 0; i < kQpt; ++i) {
    const int qi = q0 + i * kThreads;
    if (qi < nq && cnt[i] != 0) atomicAdd(out + qi, cnt[i]);
  }
}

}  // namespace

// q (nq, 2) and db (nd, 2) packed rows; out (nq,) int32, zeroed by the
// caller.  Returns cudaGetLastError() after the launch.
extern "C" int gm_hamming_count(const void* q, int nq, const void* db, int nd,
                                int thresh, int n_splits, void* out,
                                void* stream) {
  if (nq <= 0 || nd <= 0 || n_splits <= 0 || n_splits > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const int rows_per_split = (nd + n_splits - 1) / n_splits;
  const dim3 grid((nq + kThreads * kQpt - 1) / (kThreads * kQpt), n_splits);
  count_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const ulonglong2*>(q), nq,
      static_cast<const ulonglong2*>(db), nd, thresh, rows_per_split,
      static_cast<int*>(out));
  return static_cast<int>(cudaGetLastError());
}
