// Levenshtein top-k kernel: for each query, the k smallest packed keys
// (leven_dist << 24) | idx over the whole database, ascending.
//
// Replaces the JAX package's Levenshtein top-k
// (guidemaker_tpu/knn/leven.py:leven_block_myers with _topk_tiles_leven,
// launched by leven_topk), which XLA compiled for the TPU's vector unit.
//
// The distance is Myers' bit-parallel edit distance (Myers 1999, in
// Hyyro's form for global distance).  The query is the pattern: base i is
// bit i of a 32-bit word, and the vertical delta vectors Pv/Mv advance one
// database base (text character) a step.  Peq[c] has bit i set iff query
// base i is c (A, C, G, T); an N sets no bit, and a database N selects an
// all-zero eq, so an N matches nothing on either side, at every length, as
// in the 2-bit Hamming kernels.  After L steps the final column's vertical
// deltas telescope: D = L + popcount(Pv) - popcount(Mv) over the pattern
// bits.  Bits above the pattern carry garbage that only moves upward (a
// carry or a left shift) and is masked at the end.
//
// What bounds it on an H100: integer issue, about 15 logic, add and select
// operations a text character, some 300 a pair at L 20; a database row is
// one 16-byte broadcast from shared memory for all of them.  The design
// follows hamming_topk.cu:
//   * one query per thread, its Peq masks and running top-K list in
//     registers (K, k rounded up to a power of two, is a template
//     parameter, so every index into the list is static);
//   * database tiles staged in shared memory and read as broadcasts;
//   * the database is cut into gridDim.y splits to fill the card; each
//     split writes its own sorted list to (nq, n_splits, K), and
//     gm::merge_kernel (topk_common.cuh) folds the splits into (nq, k),
//     selecting on packed keys only, so ties break by database index.
#include <stdint.h>

#include "hamming_common.cuh"
#include "topk_common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kTile = 1024;

// Bit i set iff base i of the packed row is the valid base c: the
// positions where the code word equals c replicated in every 2-bit slot,
// compressed from the even bits of 64 to 32 bits.
__device__ __forceinline__ unsigned base_mask(const ulonglong2 r, int c) {
  const unsigned long long x = r.x ^ (0x5555555555555555ull * c);
  unsigned long long m = ~(x | (x >> 1)) & r.y & 0x5555555555555555ull;
  m = (m | (m >> 1)) & 0x3333333333333333ull;
  m = (m | (m >> 2)) & 0x0F0F0F0F0F0F0F0Full;
  m = (m | (m >> 4)) & 0x00FF00FF00FF00FFull;
  m = (m | (m >> 8)) & 0x0000FFFF0000FFFFull;
  m = (m | (m >> 16)) & 0x00000000FFFFFFFFull;
  return static_cast<unsigned>(m);
}

// Edit distance between the pattern of masks p0..p3 (length bases) and the
// packed database row d.
__device__ __forceinline__ int myers(unsigned p0, unsigned p1, unsigned p2,
                                     unsigned p3, const ulonglong2 d,
                                     int length, unsigned mask) {
  unsigned pv = ~0u, mv = 0u;
  unsigned cw = static_cast<unsigned>(d.x);
  unsigned vw = static_cast<unsigned>(d.y);
#pragma unroll
  for (int j = 0; j < 32; ++j) {
    if (j == length) break;
    if (j == 16) {
      cw = static_cast<unsigned>(d.x >> 32);
      vw = static_cast<unsigned>(d.y >> 32);
    }
    const int sh = 2 * (j & 15);
    const unsigned lo = (cw >> sh) & 1u ? p1 : p0;
    const unsigned hi = (cw >> sh) & 1u ? p3 : p2;
    unsigned eq = (cw >> sh) & 2u ? hi : lo;
    eq = (vw >> sh) & 1u ? eq : 0u;
    const unsigned xv = eq | mv;
    const unsigned xh = (((eq & pv) + pv) ^ pv) | eq;
    const unsigned ph = (mv | ~(xh | pv)) << 1 | 1u;
    const unsigned mh = (pv & xh) << 1;
    pv = mh | ~(xv | ph);
    mv = ph & xv;
  }
  return length + __popc(pv & mask) - __popc(mv & mask);
}

template <int K>
__global__ void __launch_bounds__(kThreads)
    leven_topk_kernel(const ulonglong2* __restrict__ q, int nq,
                      const ulonglong2* __restrict__ db, int nd, int length,
                      int rows_per_split, int* __restrict__ partial) {
  __shared__ ulonglong2 tile[kTile];
  const int qi = blockIdx.x * kThreads + threadIdx.x;
  const ulonglong2 qr = qi < nq ? q[qi] : make_ulonglong2(0ull, 0ull);
  const unsigned p0 = base_mask(qr, 0), p1 = base_mask(qr, 1);
  const unsigned p2 = base_mask(qr, 2), p3 = base_mask(qr, 3);
  const unsigned mask = length == 32 ? ~0u : (1u << length) - 1u;
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
    for (int r = 0; r < rows; ++r) {
      const int key =
          (myers(p0, p1, p2, p3, tile[r], length, mask) << gm::kIdxBits) |
          (t + r);
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
  leven_topk_kernel<K><<<grid, kThreads, 0, stream>>>(
      static_cast<const ulonglong2*>(q), nq,
      static_cast<const ulonglong2*>(db), nd, length, rows_per_split,
      static_cast<int*>(partial));
  return gm::launch_merge<K>(partial, nq, n_splits, k, out, stream);
}

}  // namespace

// q (nq, 2) and db (nd, 2) packed rows of guides of length 1..32; partial
// (nq, n_splits, kcap) and out (nq, k) int32, allocated by the caller;
// kcap is k rounded up to a power of two <= 128.  Returns the first CUDA
// error of the two launches.
extern "C" int gm_leven_topk(const void* q, int nq, const void* db, int nd,
                             int length, int k, int kcap, int n_splits,
                             void* partial, void* out, void* stream) {
  if (nq <= 0 || nd <= 0 || length < 1 || length > 32 || k < 1 ||
      k > kcap || n_splits <= 0 || n_splits > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  GM_DISPATCH_KCAP(kcap, launch, q, nq, db, nd, length, k, n_splits, partial,
                   out, s)
}
