// Shared pieces of the mma.sync kernels on the tensor cores: the block
// shape, the ldmatrix addressing of a shared-memory tile, the mma.sync
// wrappers (s8 m16n8k32, b1 m16n8k256), one warp's product with 32 rows of
// a tile, the count epilogue and a cp.async tile ring.  The 3-gram count
// (feature_count.cu) shares all of these, with the 1-bit product; the
// tensor-core rate probe (mma_rate.cu) the wrappers.  The wgmma kernels
// (onehot_wgmma.cuh, packed_common.cuh) take its block and tile heights
// and its cp.async.
//
// Block: 8 warps; each holds 2 m16 tiles (32 queries) as A fragments in
// registers for the whole database loop.  Database tiles of 128 rows lie in
// shared memory at a row stride of 32 * steps + 16 bytes, an odd number of
// 16-byte units, so the 8 row addresses of an ldmatrix phase fall in 8
// different bank groups, and are read with ldmatrix.x4, one per k32 step
// for two n8 tiles.  A warp multiplies 4 n8 tiles (32 database rows)
// before its epilogue, which gives the tensor pipe 8 independent
// accumulator chains.
//
// In the accumulator layout, lane 4g + t holds, for m16 tile mt and n8
// tile nt, acc[mt][nt][i] = the sum of query row 16 mt + 8 (i >> 1) + g of
// the warp with database row 8 nt + 2t + (i & 1) of the batch.
#pragma once

#include <stdint.h>

#include "hamming_common.cuh"

namespace gm {

constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;
// m16 tiles of queries a warp holds
constexpr int kMTiles = 2;
constexpr int kQPerBlock = kWarps * 16 * kMTiles;
// n8 tiles of database rows a warp multiplies before one epilogue
constexpr int kNTiles = 4;
constexpr int kBatch = 8 * kNTiles;
// database rows a shared-memory tile
constexpr int kTile = 128;
// k32 steps of a 32-base row
constexpr int kMaxSteps = 4;

static_assert(kNTiles % 2 == 0 && kTile % kBatch == 0,
              "one ldmatrix.x4 a k32 step covers two n8 tiles");

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

// d += a x b over one k32 step of int8 lanes (32 bytes a row).
__device__ __forceinline__ void mma_s8(int (&d)[4], const uint32_t (&a)[4],
                                       uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// d += popcount(a & b) over one k256 step of 1-bit lanes (32 bytes a row).
// Its fragments are mma_s8's with each byte read as 8 consecutive k lanes,
// so the same registers, loads and ldmatrix addresses feed either.
__device__ __forceinline__ void mma_b1(int (&d)[4], const uint32_t (&a)[4],
                                       uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k256.row.col.s32.b1.b1.s32.and.popc "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// mma_b1 if kB1, else mma_s8.
template <bool kB1>
__device__ __forceinline__ void mma_step(int (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  if constexpr (kB1)
    mma_b1(d, a, b0, b1);
  else
    mma_s8(d, a, b0, b1);
}

// The lane's ldmatrix.x4 address of tile row 0: lanes 8m..8m+7 address
// the rows of matrix m = (n8 tile m >> 1, 16-byte half m & 1 of the k32
// step).
template <int KS>
__device__ __forceinline__ uint32_t ldsm_src(const uint8_t* tile) {
  const int lane = threadIdx.x & 31;
  return static_cast<uint32_t>(__cvta_generic_to_shared(tile)) +
         (((lane >> 4) << 3) + (lane & 7)) * (32 * KS + 16) +
         ((lane >> 3) & 1) * 16;
}

// acc += the warp's 32 queries times tile rows n0..n0+31, KS steps of 32
// bytes a row: int8 lanes, or 1-bit lanes if kB1.
template <int KS, bool kB1 = false>
__device__ __forceinline__ void mma_batch(int (&acc)[kMTiles][kNTiles][4],
                                          const uint32_t (&a)[kMTiles][KS][4],
                                          uint32_t src, int n0) {
  constexpr int kStride = 32 * KS + 16;
  uint32_t b[KS][kNTiles / 2][4];
#pragma unroll
  for (int s = 0; s < KS; ++s)
#pragma unroll
    for (int p = 0; p < kNTiles / 2; ++p)
      ldsm_x4(b[s][p], src + (n0 + 16 * p) * kStride + 32 * s);
#pragma unroll
  for (int mt = 0; mt < kMTiles; ++mt)
#pragma unroll
    for (int nt = 0; nt < kNTiles; ++nt)
#pragma unroll
      for (int s = 0; s < KS; ++s)
        mma_step<kB1>(acc[mt][nt], a[mt][s], b[s][nt >> 1][2 * (nt & 1)],
                      b[s][nt >> 1][2 * (nt & 1) + 1]);
}

// The count epilogue of one batch, whose sums started at -(thresh + 1), so
// that a pair counts iff its sum is >= 0.  A thread ANDs its sums: if the
// sign bit survives, none counts (the common case: close pairs are rare),
// else each sum >= 0 adds one to the counter of its query row
// 16 mt + 8 half + g.
template <int NT>
__device__ __forceinline__ void count_batch(int (&cnt)[kMTiles][2],
                                            const int (&acc)[kMTiles][NT][4]) {
  int all = -1;
#pragma unroll
  for (int mt = 0; mt < kMTiles; ++mt)
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int i = 0; i < 4; ++i) all &= acc[mt][nt][i];
  if (all < 0) return;
#pragma unroll
  for (int mt = 0; mt < kMTiles; ++mt)
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int i = 0; i < 4; ++i) cnt[mt][i >> 1] += acc[mt][nt][i] >= 0;
}

// The end of a count kernel: the quad's four threads hold the same query
// rows' counts over other columns; their sum for each query qw + 16 mt +
// 8 half + g below nq is added to out with one integer atomicAdd, so the
// result is exact and does not depend on the order in which blocks finish.
__device__ __forceinline__ void add_counts(const int (&cnt)[kMTiles][2],
                                           int* __restrict__ out, int nq,
                                           int qw) {
  const int g = (threadIdx.x & 31) >> 2, t = threadIdx.x & 3;
#pragma unroll
  for (int mt = 0; mt < kMTiles; ++mt) {
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      int c = cnt[mt][half];
      c += __shfl_xor_sync(0xffffffffu, c, 1);
      c += __shfl_xor_sync(0xffffffffu, c, 2);
      const int qi = qw + mt * 16 + half * 8 + g;
      if (t == 0 && qi < nq && c != 0) atomicAdd(out + qi, c);
    }
  }
}

// Copy N (8 or 16) bytes from global src to shared dst without passing
// through registers; src_bytes 0 writes N zero bytes instead.
template <int N>
__device__ __forceinline__ void cp_async(uint32_t dst, const void* src,
                                         int src_bytes) {
  static_assert(N == 8 || N == 16, "8- or 16-byte copies");
  if constexpr (N == 16)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
                 :
                 : "r"(dst), "l"(src), "r"(src_bytes)
                 : "memory");
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n"
                 :
                 : "r"(dst), "l"(src), "r"(src_bytes)
                 : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Wait until at most N of this thread's cp.async groups are in flight.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" : : "n"(N) : "memory");
}

// Every thread of the block walks the split's database rows [lo, hi) in
// tiles of kTile through a ring of two shared-memory buffers at ring, each
// kTile rows of 32 * KS + 16 bytes: load(dst, t0) starts the cp.async
// copies of the tile at row t0 into the buffer at shared address dst
// (zero-filling rows at or past hi), and batch(src, t0, n0) is called for
// each kRows-row batch of each tile, src being the lane's ldmatrix address
// of the current buffer's row 0 (ldsm_src<KS>).
template <int KS, int kRows, typename Load, typename Batch>
__device__ __forceinline__ void tile_ring(int lo, int hi, uint8_t* ring,
                                          Load&& load, Batch&& batch) {
  constexpr int kBuf = kTile * (32 * KS + 16);
  static_assert(kTile % kRows == 0, "whole batches a tile");
  const uint32_t base =
      static_cast<uint32_t>(__cvta_generic_to_shared(ring));
  const uint32_t src = ldsm_src<KS>(ring);
  if (lo < hi) load(base, lo);
  cp_async_commit();
  int buf = 0;
  for (int t0 = lo; t0 < hi; t0 += kTile, buf ^= 1) {
    if (t0 + kTile < hi) load(base + (buf ^ 1) * kBuf, t0 + kTile);
    cp_async_commit();
    cp_async_wait<1>();  // this tile's copies are done
    __syncthreads();     // ... and every thread's
    const int rows = min(kTile, hi - t0);
#pragma unroll 1
    for (int n0 = 0; n0 < rows; n0 += kRows) batch(src + buf * kBuf, t0, n0);
    __syncthreads();  // every warp is done with the buffer refilled next
  }
  cp_async_wait<0>();
}

}  // namespace gm
