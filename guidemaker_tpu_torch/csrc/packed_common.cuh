// The packed-pair side of the wgmma ring block (wgmma_common.cuh) that the
// packed count (packed_count.cu) and the packed top-k (packed_topk.cu)
// share: the row layout, lanes_below, the ring's tile and stage sizes, and
// the producer that stages the database's pair rows by cp.async and splits
// each into two B rows, one a guide.
//
// Layout (guidemaker_tpu_torch/knn/packed.py).  Each base maps to a vertex
// of the regular tetrahedron in {-1,+1}^3 (A, C, G, T; N -> 0), so two
// bases dot to 3 if equal and -1 if not, and L bases to 4m - L for m
// matches.  A query row is the int8 row [tetra(q) | tetra(q) | 0] and a
// database row holds two guides, [s * tetra(even) | tetra(odd) | 0], with
// s = 4L + 1 and 6L <= 128 lanes (L <= 21).
//
// B rows.  Pair row p of a tile becomes B rows 2p (the even guide) and
// 2p + 1 (the odd one) of K = 32 pair_b_steps(L) bytes, with no decode: row
// 2p is lanes [0, 3L) as stored, then s at lane 3L; row 2p + 1 is stored
// lanes [3L, 6L) moved down to [0, 3L), then 1 at lane 3L; zeros up to K.
// A query row's lanes [0, 3L) then dot row 2p to s * A and row 2p + 1 to
// B, with A = 4 m_even - L and B = 4 m_odd - L, plus the bias lane's
// product; B row r of the tile at pair row t0 is guide 2 t0 + r, so one
// m64n128 product's columns come in guide order.  The count keeps the
// scale s (it needs only the sign of s (A - T - 1)).  The top-k (kUnit)
// maps the even row's bytes to units, +-s to +-1 and the bias lane's s to
// 1, so that both sums of a pair, A and B plus a bias in [-3L - 1, L + 3],
// fit the int8 bytes its epilogue packs them to (wgmma_common.cuh
// row_bytes); and it sets lane K - 1 of every row to 1, its bias lane
// (K - 1 >= 3L at every L, and the query rows are zero from lane 3L on, so
// the lane is free; at L 21 it is lane 3L itself).
//
// A zero slot (a pair row past the split's end, the odd slot of the last
// row when nd is odd) is no guide but carries the bias lanes, so its sum
// is the query's bias alone: both kernels' epilogues mask columns by their
// global guide index.
//
// The kernels are never fed an N: an N is the zero vector here and would
// count as a quarter match, so the index routes guides with N to the 2-bit
// kernels (KnnIndex's N gate).
#pragma once

#include <stdint.h>

#include "mma_common.cuh"
#include "wgmma_common.cuh"

namespace gm {

// int4 words of one 128-lane int8 row
constexpr int kPackedVecs = 8;
// pair rows a tile: two B rows each, the 128 columns of one m64n128
// product
constexpr int kPairTile = 64;
// k32 steps of the widest B row (L 11..21)
constexpr int kPairMaxSteps = 2;
constexpr int kPairStageBytes = 2 * kPairTile * 32 * kPairMaxSteps;
// the pair rows as stored, staged by cp.async kRawStages - 1 tiles ahead
// of the producer: kPairTile rows of 128 bytes a stage, after the ring
constexpr int kRawStages = 4;
constexpr int kRawBytes = kPairTile * 16 * kPackedVecs;
constexpr int kRawOffset = ring_smem_bytes(kPairStageBytes);
// dynamic shared memory of the ring and the staging stages
constexpr int kPairSmemBytes = kRawOffset + kRawStages * kRawBytes;
// the producer warpgroup's named barrier (the consumers' turns take
// 1..kConsumers)
constexpr uint32_t kPairProducerBar = 1 + kConsumers;

static_assert(2 * kPairTile == kWarpgroup, "one producer thread a B row");
static_assert((kRawStages & (kRawStages - 1)) == 0 && kRawStages >= 2,
              "a power-of-two staging ring");
static_assert(kRawBytes % (16 * kWarpgroup) == 0, "whole copies a thread");
static_assert(kRawOffset % 16 == 0, "16-byte copies");
static_assert(kQPerBlock == kConsumers * 64, "one m64 tile a consumer");

// k32 steps of a B row of L bases: lanes [0, 3L) and the bias lane 3L
__host__ __device__ constexpr int pair_b_steps(int length) {
  return (3 * length + 1 + 31) / 32;
}

// the longest guide two of which fit a 128-lane row (6L <= 128)
constexpr int kMaxPairLength = 16 * kPackedVecs / 6;
static_assert(pair_b_steps(kMaxPairLength) <= kPairMaxSteps,
              "the bias lane fits K for every L a row holds");

// The bytes of the 4-byte word at lane offset o whose lanes are < n.
__device__ __forceinline__ uint32_t lanes_below(int o, int n) {
  const int keep = min(max(n - o, 0), 4);
  return keep == 4 ? 0xffffffffu : (1u << (8 * keep)) - 1u;
}

// Each byte of x, 0 or an odd +-c with c < 128, as 0 or +-1: its sign
// spread over the byte (prmt's sign mode), or its low bit.
__device__ __forceinline__ uint32_t unit_bytes(uint32_t x) {
  uint32_t sign;
  asm("prmt.b32 %0, %1, %2, 0xba98;\n" : "=r"(sign) : "r"(x), "r"(0u));
  return sign | (x & 0x01010101u);
}

// The producer warpgroup: thread p writes B row p of every tile of the
// split's pair rows [lo, hi), half p & 1 of pair row t0 + p / 2 (rows at
// or past hi are zeros and carry only the bias lanes), in units if kUnit.
// The tiles reach shared memory by cp.async, kRawStages - 1 ahead, each
// thread copying 16 bytes in turn (chunk u of row r lands at
// 16 (u ^ (r & 7)), so that the rows' reads below hit distinct banks;
// chunks loaded by each thread for its own row left the producer waiting
// on L2 at every tile); the producer's named barrier tells every thread
// that the tile's copies are done and the stage refilled next has been
// read.  Then the thread reads the chunks that its half needs, moves the
// odd half's bytes down by 3L (whole words at L % 4 == 0, a funnel shift
// otherwise), sets the bias lanes and stores the row in the K-major
// core-matrix layout of wgmma_common.cuh.  The 8-row groups of that layout
// do not match the rows' contiguous 128 bytes, so the rows pass through
// registers.
template <int L, bool kUnit>
__device__ __forceinline__ void produce_pairs(const int4* __restrict__ db,
                                              int lo, int hi, uint8_t* ring,
                                              uint32_t full, uint32_t empty) {
  // lane 3L is byte kShift / 8 of word kJ of a row
  constexpr int kJ = 3 * L / 4, kShift = 8 * (3 * L % 4);
  constexpr int KS = pair_b_steps(L);
  // the even half needs the row's words 0..kJ; the odd half words
  // kJ..2 kJ + 1, from chunk kJ / 4 on: its word j is bytes 3L + 4j ..
  constexpr int kEvenChunks = kJ / 4 + 1;
  constexpr int kOddChunks = (2 * kJ + 1) / 4 - kJ / 4 + 1;
  constexpr int kChunks = kEvenChunks > kOddChunks ? kEvenChunks : kOddChunks;
  static_assert(kJ / 4 + kChunks <= kPackedVecs, "within the row");
  static_assert(kJ < 8 * KS, "the bias lane within K");
  constexpr uint32_t kBelow = (1u << kShift) - 1u;
  constexpr int kCopies = kRawBytes / 16 / kWarpgroup;
  const int p = threadIdx.x;
  const bool odd = p & 1;
  const int n_tiles = (hi - lo + kPairTile - 1) / kPairTile;
  const int row_off = (p >> 3) * (256 * KS) + (p & 7) * 16;
  const uint32_t bias = odd ? 1u : static_cast<uint32_t>(4 * L + 1);
  const uint8_t* raw = ring + kRawOffset;
  const uint32_t raw_addr =
      static_cast<uint32_t>(__cvta_generic_to_shared(raw));
  // the thread's row of a stage, and its first chunk
  const int r = p >> 1, base = odd ? kJ / 4 : 0;
  auto copy = [&](int t) {
    const uint32_t dst = raw_addr + (t & (kRawStages - 1)) * kRawBytes;
    const int t0 = lo + t * kPairTile;
#pragma unroll
    for (int k = 0; k < kCopies; ++k) {
      const int c = p + kWarpgroup * k;
      const int row = c / kPackedVecs, u = c % kPackedVecs;
      const bool in = t0 + row < hi;
      cp_async<16>(
          dst + 16 * (kPackedVecs * row + (u ^ (row & 7))),
          db + (in ? static_cast<size_t>(t0 + row) * kPackedVecs + u : 0),
          in ? 16 : 0);
    }
  };
#pragma unroll
  for (int t = 0; t < kRawStages - 1; ++t) {
    if (t < n_tiles) copy(t);
    cp_async_commit();
  }
  uint32_t v[4 * kChunks];
  produce_tiles<kPairStageBytes>(
      n_tiles, ring, full, empty,
      [&](int t) {
        cp_async_wait<kRawStages - 2>();
        bar_sync<kWarpgroup>(kPairProducerBar);
        if (t + kRawStages - 1 < n_tiles) copy(t + kRawStages - 1);
        cp_async_commit();
        const uint4* row = reinterpret_cast<const uint4*>(
            raw + (t & (kRawStages - 1)) * kRawBytes) +
            kPackedVecs * r;
#pragma unroll
        for (int i = 0; i < kChunks; ++i) {
          const uint4 x = odd || i < kEvenChunks ? row[(base + i) ^ (r & 7)]
                                                 : make_uint4(0, 0, 0, 0);
          v[4 * i] = x.x;
          v[4 * i + 1] = x.y;
          v[4 * i + 2] = x.z;
          v[4 * i + 3] = x.w;
        }
      },
      [&](uint8_t* stage) {
        uint32_t w[8 * KS];
#pragma unroll
        for (int j = 0; j < 8 * KS; ++j) {
          if (j > kJ) {
            w[j] = 0u;
            continue;
          }
          uint32_t moved = v[kJ % 4 + j];
          if constexpr (kShift != 0)
            moved = __funnelshift_r(moved, v[kJ % 4 + j + 1], kShift);
          w[j] = odd ? moved : v[j];
          // the bias lane; the odd half's bytes past it are stored zeros,
          // the even half's are the odd guide's lanes
          if (j == kJ) w[j] = (w[j] & kBelow) | bias << kShift;
          // the odd half's bytes are units already
          if constexpr (kUnit)
            if (!odd) w[j] = unit_bytes(w[j]);
        }
        // the top-k's bias lane, K - 1
        if constexpr (kUnit) w[8 * KS - 1] |= 0x01000000u;
        uint4* dst = reinterpret_cast<uint4*>(stage + row_off);
#pragma unroll
        for (int c = 0; c < 2 * KS; ++c)
          dst[8 * c] = make_uint4(w[4 * c], w[4 * c + 1], w[4 * c + 2],
                                  w[4 * c + 3]);
      });
  cp_async_wait<0>();
}

#define GM_PACKED_LENGTHS(CALL)                                             \
  CALL(1) CALL(2) CALL(3) CALL(4) CALL(5) CALL(6) CALL(7) CALL(8) CALL(9) \
  CALL(10) CALL(11) CALL(12) CALL(13) CALL(14) CALL(15) CALL(16) CALL(17) \
  CALL(18) CALL(19) CALL(20) CALL(21)

// produce_pairs<L, kUnit> for the length L of the split's guides (1..21),
// L being a template parameter of the producer.
template <bool kUnit>
__device__ __forceinline__ void produce_pair_rows(int length,
                                                  const int4* __restrict__ db,
                                                  int lo, int hi,
                                                  uint8_t* ring, uint32_t full,
                                                  uint32_t empty) {
#define GM_PRODUCE(L) \
  case L: produce_pairs<L, kUnit>(db, lo, hi, ring, full, empty); break;
  switch (length) { GM_PACKED_LENGTHS(GM_PRODUCE) default: break; }
#undef GM_PRODUCE
}

#undef GM_PACKED_LENGTHS

}  // namespace gm
