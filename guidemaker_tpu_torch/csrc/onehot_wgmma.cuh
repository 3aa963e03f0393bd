// The one-hot side of the wgmma ring block (wgmma_common.cuh) that the
// 2-bit count (hamming_count.cu) and the 2-bit top-k (hamming_topk.cu)
// share: the block's bases, the decode of a packed row (hamming_common.cuh)
// into one-hot words, the producer that decodes the database into the ring,
// the consumers' A fragments with the bias lane, and the product of an m64
// tile of queries with a ring stage.
//
// Layout: one-hot rows of K = 32 KS bytes for KS k32 steps, KS (1..4) taken
// per block from the last valid base of any of its queries (20-mers: 3).  A
// 16-byte chunk c holds bases 4c .. 4c + 3 code-major: byte 4k + b is 1 iff
// base 4c + b is valid with code k (any order of K gives the same product,
// as long as queries and database share it; this one decodes with a
// multiply a word).  An N, a base past L, a query past nq and a database row
// past the split decode to zeros, which match nothing, so the int8 product
// of two rows is their match count.
//
// The bias lane: when the block's bases leave a base slot of its K unused
// (nb % 8 != 0, every 20-mer block), slot 8 KS - 1's code-0 byte, K byte
// 32 KS - 13, holds each query row's bias in its A fragment and 1 in every
// database row (padding rows past the split included), so that the first
// k32 step can overwrite the accumulators (scale-d 0) and every sum starts
// at its row's bias.  In the A fragment the byte lies in lane t 0 of the
// quad, register 2 (row g) or 3 (row g + 8) of the last k32 step, byte 3:
// a kernel whose bias changes writes it there.  Blocks whose bases fill
// their K (L 8, 16, 24, 32 with a valid last base) set the accumulators to
// the bias before each product instead, one more operation a pair.
#pragma once

#include <stdint.h>

#include "mma_common.cuh"
#include "wgmma_common.cuh"

namespace gm {

// bytes of one ring stage: kTile rows of at most 4 k32 steps
constexpr int kOnehotStageBytes = kTile * 32 * kMaxSteps;

static_assert(kQPerBlock == kConsumers * 64, "one m64 tile a consumer");
static_assert(kTile == kWarpgroup, "one producer thread a tile row");

// Bases of the block: the last valid base of any of its queries, plus 1;
// 0 when none has a valid base.  Every thread of the block calls it; *nb
// is a shared int.
__device__ __forceinline__ int block_bases(const ulonglong2* __restrict__ q,
                                           int nq, int* nb) {
  const int qi = blockIdx.x * kQPerBlock + threadIdx.x;
  const unsigned long long valid =
      threadIdx.x < kQPerBlock && qi < nq ? q[qi].y : 0ull;
  int need = valid ? (63 - __clzll(valid)) / 2 + 1 : 0;
  need = __reduce_max_sync(0xffffffffu, need);
  if (threadIdx.x == 0) *nb = 0;
  __syncthreads();
  if ((threadIdx.x & 31) == 0 && need) atomicMax(nb, need);
  __syncthreads();
  return *nb;
}

// The configuration of a block of nb > 0 bases, 2 (KS - 1) + (bias lane),
// that GM_ONEHOT_CASES dispatches.
__device__ __forceinline__ int onehot_config(int nb) {
  return 2 * ((nb + 7) / 8 - 1) + (nb % 8 != 0);
}

// CALL(KS, kBias) for each configuration of onehot_config.
#define GM_ONEHOT_CASES(CALL)           \
  case 0: CALL(1, false); break;        \
  case 1: CALL(1, true); break;         \
  case 2: CALL(2, false); break;        \
  case 3: CALL(2, true); break;         \
  case 4: CALL(3, false); break;        \
  case 5: CALL(3, true); break;         \
  case 6: CALL(4, false); break;        \
  case 7: CALL(4, true); break;         \
  default: break;

// The code planes of a packed row: bit 2i of m[k][h] is set iff base
// 16 h + i is valid with code k.
__device__ __forceinline__ void code_planes(const ulonglong2 row,
                                            uint32_t (&m)[4][2]) {
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const uint32_t x = static_cast<uint32_t>(row.x >> (32 * h));
    const uint32_t v = static_cast<uint32_t>(row.y >> (32 * h));
    const uint32_t hi = (x >> 1) & 0x55555555u;
    m[0][h] = v & ~hi & ~x;
    m[1][h] = v & ~hi & x;
    m[2][h] = v & hi & ~x;
    m[3][h] = v & hi & x;
  }
}

// Byte j of a code plane's half, spread to a one-hot word: byte b of the
// word is bit 8j + 2b of the plane.  The four bits move to bits 8b with
// one multiply (on the FMA pipe, beside the ALU work): their copies
// shifted by 6b' collide only on bits that the mask drops.
__device__ __forceinline__ uint32_t spread(uint32_t plane, int j) {
  const uint32_t b = (plane >> (8 * j)) & 0x55u;
  return (b * 0x41041u) & 0x01010101u;
}

// The producer warpgroup: thread p decodes row p of every tile of the
// split's rows [lo, hi) into the ring (rows at or past hi decode to
// zeros), with the bias lane if kBias.
template <int KS, bool kBias>
__device__ __forceinline__ void produce_onehot(
    const ulonglong2* __restrict__ db, int lo, int hi, uint8_t* ring,
    uint32_t full, uint32_t empty) {
  const ulonglong2 zero = make_ulonglong2(0ull, 0ull);
  const int p = threadIdx.x;
  const int n_tiles = (hi - lo + kTile - 1) / kTile;
  const int row_off = (p >> 3) * (256 * KS) + (p & 7) * 16;
  ulonglong2 row, next = lo + p < hi ? db[lo + p] : zero;
  produce_tiles<kOnehotStageBytes>(
      n_tiles, ring, full, empty,
      [&](int t) {
        row = next;
        const int r = lo + (t + 1) * kTile + p;
        next = r < hi ? db[r] : zero;
      },
      [&](uint8_t* stage) {
        uint4* dst = reinterpret_cast<uint4*>(stage + row_off);
        uint32_t m[4][2];
        code_planes(row, m);
#pragma unroll
        for (int c = 0; c < 2 * KS; ++c) {
          uint32_t w0 = spread(m[0][c >> 2], c & 3);
          // the bias lane: code-0 byte of base 8 KS - 1, byte 3 of word 0
          // of the last chunk
          if (kBias && c == 2 * KS - 1)
            w0 = (w0 & 0x00ffffffu) | 0x01000000u;
          dst[8 * c] = make_uint4(w0, spread(m[1][c >> 2], c & 3),
                                  spread(m[2][c >> 2], c & 3),
                                  spread(m[3][c >> 2], c & 3));
        }
      });
}

// The A fragments of the warp's 16 query rows qw .. qw + 15 (rows past nq
// decode to zeros), with bias in the bias lane of both of the lane's rows
// if kBias.
template <int KS, bool kBias>
__device__ __forceinline__ void onehot_a(uint32_t (&a)[KS][4],
                                         const ulonglong2* __restrict__ q,
                                         int nq, int qw, int bias) {
  const ulonglong2 zero = make_ulonglong2(0ull, 0ull);
  const int g = (threadIdx.x & 31) >> 2, t4 = threadIdx.x & 3;
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int qi = qw + 8 * half + g;
    const ulonglong2 row = qi < nq ? q[qi] : zero;
    uint32_t m[4][2];
    code_planes(row, m);
    // the lane's plane t, selected without indexing registers at run time
    uint32_t mine[2];
#pragma unroll
    for (int h = 0; h < 2; ++h)
      mine[h] = t4 == 0 ? m[0][h] : t4 == 1 ? m[1][h] : t4 == 2 ? m[2][h]
                                                                : m[3][h];
    // registers 0 and 1: chunk 2s, word t; 2 and 3: chunk 2s + 1, word t
#pragma unroll
    for (int s = 0; s < KS; ++s) {
      a[s][half] = spread(mine[s >> 1], (2 * s) & 3);
      a[s][2 + half] = spread(mine[s >> 1], (2 * s + 1) & 3);
    }
    // the bias lane: register 2 + half of the last step in lane t 0, byte
    // 3 (the block's base 8 KS - 1 is invalid, so the byte was 0)
    if (kBias && t4 == 0)
      a[KS - 1][2 + half] |= (static_cast<uint32_t>(bias) & 0xffu) << 24;
  }
  // opaque to the compiler, which would otherwise recompute the fragments
  // from the planes before every product
#pragma unroll
  for (int s = 0; s < KS; ++s)
#pragma unroll
    for (int i = 0; i < 4; ++i) asm volatile("" : "+r"(a[s][i]));
}

// The lane's bias lane set to bias[half] for its row 8 half + g (kBias
// blocks; lane t 0 of each quad holds the byte).
template <int KS>
__device__ __forceinline__ void set_bias_lane(uint32_t (&a)[KS][4],
                                              const int (&bias)[2]) {
  if ((threadIdx.x & 3) != 0) return;
#pragma unroll
  for (int half = 0; half < 2; ++half)
    a[KS - 1][2 + half] = (a[KS - 1][2 + half] & 0x00ffffffu) |
                          (static_cast<uint32_t>(bias[half]) & 0xffu) << 24;
}

// The m64 tile's product with the ring stage at descriptor desc, KS k32
// steps in one commit group: the sums start at the bias lane's product
// (kBias) or at bias0 for the lane's row g and bias1 for its row g + 8.
// With kFresh the first step of a kBias product takes d as an output only
// (wgmma_m64n128k32_s8_fresh), for a kernel that needs d's registers
// between its epilogue and the next product.
template <int KS, bool kBias, bool kFresh = false>
__device__ __forceinline__ void onehot_product(int (&d)[64],
                                               const uint32_t (&a)[KS][4],
                                               uint64_t desc, int bias0,
                                               int bias1) {
  if constexpr (!kBias) {
#pragma unroll
    for (int i = 0; i < 64; ++i) d[i] = i & 2 ? bias1 : bias0;
  }
  wgmma_fence();
#pragma unroll
  for (int s = 0; s < KS; ++s) {
    if (kBias && kFresh && s == 0)
      wgmma_m64n128k32_s8_fresh(d, a[s], desc);
    else
      wgmma_m64n128k32_s8(d, a[s], desc + 16 * s, kBias && s == 0 ? 0 : 1);
  }
  wgmma_commit();
}

}  // namespace gm
