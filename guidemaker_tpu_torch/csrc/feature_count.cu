// Count kernel over bit-packed binary feature rows: for each query row, the
// number of database rows whose feature dot product exceeds thresh.
//
// Replaces the JAX package's Pallas count kernel
// (guidemaker_tpu/knn/pallas_stream.py:_count_kernel, launched by
// _stream_count) where the Levenshtein retention filter calls it on
// positional 3-gram features (guidemaker_tpu/knn/leven.py:684-686 and
// 786-789): int8 rows of (L-2)*64 lanes, one lane per (gram position, gram
// value), multiplied on the TPU's matrix unit.  Every feature is 0 or 1, so
// here a row is n_words = L-2 64-bit words, word p holding the 64 gram
// channels of position p (guidemaker_tpu_torch/knn/features.py), and the
// dot of two rows is the sum over p of popcount(q[p] & d[p]).
//
// What bounds it on an H100: POPC, a quarter-rate instruction, two for
// each 64-bit word: 36 a pair for 20-mers.  The design follows
// hamming_count.cu:
//   * each thread holds kQpt query rows in registers, as NW2 16-byte
//     chunks (n_words rounded up to even; NW2 is a template parameter, so
//     every index into the rows is static); the pad word is zero and adds
//     nothing to a dot;
//   * database tiles are staged in shared memory in the same padded form
//     (coalesced word loads) and read as 16-byte broadcasts, each feeding
//     kQpt queries;
//   * the database is cut into gridDim.y splits so that small query sets
//     still fill the card; each split adds its counts with one integer
//     atomicAdd per query, so the result is exact and order-free;
//   * the ragged edge is masked by nd, so no padding rows exist.
#include <stdint.h>

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;
constexpr int kQpt = 2;
constexpr int kTile = 128;
// the widest row: 30 words, for 32-base guides
constexpr int kMaxWords = 30;

template <int NW2>
__global__ void __launch_bounds__(kThreads)
    feature_count_kernel(const unsigned long long* __restrict__ q, int nq,
                         const unsigned long long* __restrict__ db, int nd,
                         int n_words, int thresh, int rows_per_split,
                         int* __restrict__ out) {
  __shared__ ulonglong2 tile[kTile * NW2];
  unsigned long long* words = reinterpret_cast<unsigned long long*>(tile);
  // the pad word of every row (n_words odd) is never staged: zero it once
  if (n_words & 1)
    for (int r = threadIdx.x; r < kTile; r += kThreads)
      words[r * 2 * NW2 + 2 * NW2 - 1] = 0ull;

  const int q0 = blockIdx.x * kThreads * kQpt + threadIdx.x;
  ulonglong2 qr[kQpt][NW2];
  int cnt[kQpt];
#pragma unroll
  for (int i = 0; i < kQpt; ++i) {
    const int qi = q0 + i * kThreads;
    const unsigned long long* row = q + static_cast<size_t>(qi) * n_words;
#pragma unroll
    for (int w = 0; w < NW2; ++w) {
      // a row past nq is all zero: it counts nothing and is not written
      qr[i][w].x = qi < nq && 2 * w < n_words ? row[2 * w] : 0ull;
      qr[i][w].y = qi < nq && 2 * w + 1 < n_words ? row[2 * w + 1] : 0ull;
    }
    cnt[i] = 0;
  }
  const int lo = blockIdx.y * rows_per_split;
  const int hi = min(nd, lo + rows_per_split);
  for (int t = lo; t < hi; t += kTile) {
    const int rows = min(kTile, hi - t);
    const unsigned long long* src = db + static_cast<size_t>(t) * n_words;
    __syncthreads();
    for (int e = threadIdx.x; e < rows * n_words; e += kThreads) {
      const int r = e / n_words;
      words[r * 2 * NW2 + (e - r * n_words)] = src[e];
    }
    __syncthreads();
#pragma unroll 2
    for (int r = 0; r < rows; ++r) {
      int s[kQpt];
#pragma unroll
      for (int i = 0; i < kQpt; ++i) s[i] = 0;
#pragma unroll
      for (int w = 0; w < NW2; ++w) {
        const ulonglong2 d = tile[r * NW2 + w];
#pragma unroll
        for (int i = 0; i < kQpt; ++i)
          s[i] += __popcll(qr[i][w].x & d.x) + __popcll(qr[i][w].y & d.y);
      }
#pragma unroll
      for (int i = 0; i < kQpt; ++i) cnt[i] += s[i] > thresh;
    }
  }
#pragma unroll
  for (int i = 0; i < kQpt; ++i) {
    const int qi = q0 + i * kThreads;
    if (qi < nq && cnt[i] != 0) atomicAdd(out + qi, cnt[i]);
  }
}

template <int NW2>
int launch(const void* q, int nq, const void* db, int nd, int n_words,
           int thresh, int n_splits, void* out, cudaStream_t stream) {
  const int rows_per_split = (nd + n_splits - 1) / n_splits;
  const dim3 grid((nq + kThreads * kQpt - 1) / (kThreads * kQpt), n_splits);
  feature_count_kernel<NW2><<<grid, kThreads, 0, stream>>>(
      static_cast<const unsigned long long*>(q), nq,
      static_cast<const unsigned long long*>(db), nd, n_words, thresh,
      rows_per_split, static_cast<int*>(out));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// q (nq, n_words) and db (nd, n_words) int64 feature rows, n_words 1..30;
// out (nq,) int32, zeroed by the caller.  Returns cudaGetLastError() after
// the launch.
extern "C" int gm_feature_count(const void* q, int nq, const void* db, int nd,
                                int n_words, int thresh, int n_splits,
                                void* out, void* stream) {
  if (nq <= 0 || nd <= 0 || n_words < 1 || n_words > kMaxWords ||
      n_splits <= 0 || n_splits > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch ((n_words + 1) / 2) {
#define GM_CASE(N) \
  case N:          \
    return launch<N>(q, nq, db, nd, n_words, thresh, n_splits, out, s);
    GM_CASE(1) GM_CASE(2) GM_CASE(3) GM_CASE(4) GM_CASE(5)
    GM_CASE(6) GM_CASE(7) GM_CASE(8) GM_CASE(9) GM_CASE(10)
    GM_CASE(11) GM_CASE(12) GM_CASE(13) GM_CASE(14) GM_CASE(15)
#undef GM_CASE
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
