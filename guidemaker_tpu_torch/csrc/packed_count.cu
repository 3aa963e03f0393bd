// Packed-pair count kernel: for each query, the number of database guides
// at Hamming distance < editdist, with two database guides per 128-lane
// int8 row (packed_common.cuh).
//
// Replaces the JAX package's Pallas kernel
// guidemaker_tpu/knn/pallas_packed.py:_count_kernel (launched by
// _packed_count), which ran the same product on the TPU's int8 matrix
// unit.  What it computes: v = q . d per (query, row); A and B decoded
// from v; dist < e <=> m > L - e <=> A > T (and B > T) with T = 3L - 4e;
// the odd slot of the last row is masked by its global guide index when nd
// is odd (a zero slot decodes to m = L/4, not to "no match").
//
// What bounds it on an H100: integer issue.  Each row (two guides) costs
// 32 dp4a, eight 16-byte shared-memory broadcasts and a dozen decode and
// compare instructions, against about a dozen logic operations and two
// popcounts per guide in hamming_count.cu.  The design is the simple one:
//   * one query row per thread, held as 32 int32 words in registers;
//   * database rows staged in shared memory and read as broadcasts;
//   * the grid is query blocks x database splits, so that small query
//     sets still fill the card; each split adds its count with one
//     integer atomicAdd per query, exact and independent of block order.
// A later PR would run exactly these rows through the tensor cores (int8
// mma.sync or wgmma), the form of the product that the TPU's MXU ran.
#include <stdint.h>

#include "packed_common.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int kTile = 256;  // database rows per shared-memory tile (32 KB)

__global__ void __launch_bounds__(kThreads)
    packed_count_kernel(const int4* __restrict__ q, int nq,
                        const int4* __restrict__ db, int n2, int nd,
                        int length, int thresh, int s, float inv_s,
                        int rows_per_split, int* __restrict__ out) {
  __shared__ int4 tile[kTile * gm::kPackedVecs];
  const int qi = blockIdx.x * kThreads + threadIdx.x;
  int qr[4 * gm::kPackedVecs];
  if (qi < nq) {
    gm::load_row(q + static_cast<size_t>(qi) * gm::kPackedVecs, qr);
  } else {
#pragma unroll
    for (int i = 0; i < 4 * gm::kPackedVecs; ++i) qr[i] = 0;
  }
  int cnt = 0;
  const int lo = blockIdx.y * rows_per_split;
  const int hi = min(n2, lo + rows_per_split);
  for (int t = lo; t < hi; t += kTile) {
    const int rows = min(kTile, hi - t);
    __syncthreads();
    const int4* src = db + static_cast<size_t>(t) * gm::kPackedVecs;
    for (int i = threadIdx.x; i < rows * gm::kPackedVecs; i += kThreads)
      tile[i] = src[i];
    __syncthreads();
#pragma unroll 2
    for (int r = 0; r < rows; ++r) {
      const int v = gm::packed_dot(qr, tile + r * gm::kPackedVecs);
      const int a = gm::decode_even(v, length, inv_s);
      const int b = v - s * a;
      // the even slot of every row is a real guide; the odd one is not
      // when it is the last row of an odd nd
      cnt += (a > thresh) + ((b > thresh) & (2 * (t + r) + 1 < nd));
    }
  }
  if (qi < nq && cnt != 0) atomicAdd(out + qi, cnt);
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
  const int s = 4 * length + 1;
  const float inv_s = 1.0f / static_cast<float>(s);
  const int rows_per_split = (n2 + n_splits - 1) / n_splits;
  const dim3 grid((nq + kThreads - 1) / kThreads, n_splits);
  packed_count_kernel<<<grid, kThreads, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int4*>(q), nq, static_cast<const int4*>(db), n2, nd,
      length, 3 * length - 4 * editdist, s, inv_s, rows_per_split,
      static_cast<int*>(out));
  return static_cast<int>(cudaGetLastError());
}
