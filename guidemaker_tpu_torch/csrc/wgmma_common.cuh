// Hopper's warpgroup path to the tensor cores, for the count kernels
// (hamming_count.cu, packed_count.cu, feature_count.cu), the top-k kernels
// (hamming_topk.cu, packed_topk.cu) and the tensor-core rate probe
// (mma_rate.cu): the shared-memory matrix descriptor, the s8 wgmma
// m64n128k32 and the b1 wgmma m64n128k256 .and.popc products with A in
// registers (the b1 also with A in shared memory), their fences, commit
// and wait, the mbarriers of a shared-memory ring, the tensor memory
// accelerator's tile copy, named barriers, and setmaxnreg, all inline PTX
// for sm_90a (wgmma and setmaxnreg exist for no other target); then the
// block these kernels are built on (ring_roles, produce_tiles,
// consume_tiles), its count epilogue (count_tile) and its top-k epilogue
// (QuadLists, RowLists) for one-hot and tetrahedral rows.
//
// The block: one producer warpgroup fills a ring of kStages shared-memory
// tiles of 128 B rows, each signalled on its `full` mbarrier; kConsumers
// consumer warpgroups each hold 64 query rows, one m64 tile, as A
// fragments in registers, multiply them by every tile and signal its
// `empty` mbarrier.  The consumers take turns to issue (a ring of named
// barriers), so that while one thresholds its sums the others' products
// keep the tensor pipe busy; left to themselves they wait on the same tile
// and threshold at the same time.  Each consumer waits for its own commit
// group before its epilogue: a group left in flight across the loop's
// back-edge makes ptxas serialise every wgmma (note C7514).  setmaxnreg
// gives the consumers the registers that the producer does not need.
//
// B layout: K-major without swizzle, in core matrices of 8 rows x 16
// bytes, each 128 contiguous bytes (row i of the core matrix at byte
// 16 i).  Row r, K byte k of a B tile of kRows rows and K = 32 KS bytes
// lies at
//     (r / 8) * 256 KS + (k / 16) * 128 + (r % 8) * 16 + k % 16,
// so the core matrices of one 8-row group are contiguous along K (leading
// byte offset 128) and the 8-row groups follow each other (stride byte
// offset 256 KS).  The k32 step s starts 256 s bytes into the tile.  A b1
// k256 step is the same 32 bytes a row, in the same B and A layouts, with
// each byte read as 8 consecutive k lanes.  (The 3-gram count stores its
// tiles chunk-major instead, the same core matrices at other offsets, so
// that the TMA can write them: feature_count.cu.)
//
// A fragments (wgmma with A in registers, .s8): warp w of the warpgroup
// holds rows 16 w .. 16 w + 15 of the m64 tile in the layout of
// mma.m16n8k32's A (onehot_wgmma.cuh onehot_a): lane 4g + t holds in
// register 0 row g, K bytes 4t..4t+3, in 1 row g + 8, the same bytes, in
// 2 and 3 the same rows at K bytes 16 + 4t .. 16 + 4t + 3.
//
// Accumulators (m64nNk32 .s32): lane 4g + t of warp w holds in d[4j + i]
// the sum of row 16 w + g + 8 (i >> 1) with column 8 j + 2 t + (i & 1).
#pragma once

#include <stdint.h>

#include "hamming_common.cuh"
#include "topk_common.cuh"

namespace gm {

// The 64-bit shared-memory matrix descriptor of a tile at shared address
// addr, K-major without swizzle (layout type 0): start address, leading
// byte offset (between core matrices adjacent along K) and stride byte
// offset (between 8-row groups), each in 16-byte units.
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr, uint32_t lbo,
                                              uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3ffff) >> 4) |
         static_cast<uint64_t>((lbo & 0x3ffff) >> 4) << 16 |
         static_cast<uint64_t>((sbo & 0x3ffff) >> 4) << 32;
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

// Wait until at most N of the warpgroup's committed wgmma groups are in
// flight.
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" : : "n"(N) : "memory");
}

// Ties the registers of d to this point of the program, so that the
// compiler neither reads them before a wgmma_wait that completes their
// product nor writes them after the wgmma that reads them is issued.
template <int N>
__device__ __forceinline__ void fence_regs(int (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(d[i]) : : "memory");
}

// d (+)= a x B over one k32 step: 64 rows of s8 A in registers (4 a
// thread), 128 rows of s8 B at the descriptor; d = a x B when scale_d is
// 0.  Asynchronous: d holds the sums after the wgmma_wait that completes
// the group it was committed in.
__device__ __forceinline__ void wgmma_m64n128k32_s8(int (&d)[64],
                                                    const uint32_t (&a)[4],
                                                    uint64_t desc,
                                                    int scale_d) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, "
      "%41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, "
      "%54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p;\n"
      "}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]),
        "+r"(d[5]), "+r"(d[6]), "+r"(d[7]), "+r"(d[8]), "+r"(d[9]),
        "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]),
        "+r"(d[15]), "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]),
        "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]), "+r"(d[24]),
        "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]),
        "+r"(d[30]), "+r"(d[31]), "+r"(d[32]), "+r"(d[33]), "+r"(d[34]),
        "+r"(d[35]), "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]),
        "+r"(d[40]), "+r"(d[41]), "+r"(d[42]), "+r"(d[43]), "+r"(d[44]),
        "+r"(d[45]), "+r"(d[46]), "+r"(d[47]), "+r"(d[48]), "+r"(d[49]),
        "+r"(d[50]), "+r"(d[51]), "+r"(d[52]), "+r"(d[53]), "+r"(d[54]),
        "+r"(d[55]), "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]),
        "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc),
        "r"(scale_d)
      : "memory");
}

// d = a x B over one k32 step, as wgmma_m64n128k32_s8 with scale_d 0, but
// with d an output only: the compiler may take d's registers as dead from
// the last read of the previous sums to this product.
__device__ __forceinline__ void wgmma_m64n128k32_s8_fresh(
    int (&d)[64], const uint32_t (&a)[4], uint64_t desc) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, 0, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, "
      "%41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, "
      "%54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p;\n"
      "}\n"
      : "=r"(d[0]), "=r"(d[1]), "=r"(d[2]), "=r"(d[3]), "=r"(d[4]),
        "=r"(d[5]), "=r"(d[6]), "=r"(d[7]), "=r"(d[8]), "=r"(d[9]),
        "=r"(d[10]), "=r"(d[11]), "=r"(d[12]), "=r"(d[13]), "=r"(d[14]),
        "=r"(d[15]), "=r"(d[16]), "=r"(d[17]), "=r"(d[18]), "=r"(d[19]),
        "=r"(d[20]), "=r"(d[21]), "=r"(d[22]), "=r"(d[23]), "=r"(d[24]),
        "=r"(d[25]), "=r"(d[26]), "=r"(d[27]), "=r"(d[28]), "=r"(d[29]),
        "=r"(d[30]), "=r"(d[31]), "=r"(d[32]), "=r"(d[33]), "=r"(d[34]),
        "=r"(d[35]), "=r"(d[36]), "=r"(d[37]), "=r"(d[38]), "=r"(d[39]),
        "=r"(d[40]), "=r"(d[41]), "=r"(d[42]), "=r"(d[43]), "=r"(d[44]),
        "=r"(d[45]), "=r"(d[46]), "=r"(d[47]), "=r"(d[48]), "=r"(d[49]),
        "=r"(d[50]), "=r"(d[51]), "=r"(d[52]), "=r"(d[53]), "=r"(d[54]),
        "=r"(d[55]), "=r"(d[56]), "=r"(d[57]), "=r"(d[58]), "=r"(d[59]),
        "=r"(d[60]), "=r"(d[61]), "=r"(d[62]), "=r"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc)
      : "memory");
}

// d (+)= popcount(a & B) over one k256 step of 1-bit lanes: 64 rows of A
// in registers, 128 rows of B at the descriptor, each 32 bytes, in the
// layouts of the s8 k32 step with each byte read as 8 consecutive k lanes;
// d = popcount(a & B) when scale_d is 0.  Asynchronous as
// wgmma_m64n128k32_s8.
__device__ __forceinline__ void wgmma_m64n128k256_b1(int (&d)[64],
                                                     const uint32_t (&a)[4],
                                                     uint64_t desc,
                                                     int scale_d) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k256.s32.b1.b1.and.popc "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, "
      "%41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, "
      "%54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p;\n"
      "}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]),
        "+r"(d[5]), "+r"(d[6]), "+r"(d[7]), "+r"(d[8]), "+r"(d[9]),
        "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]),
        "+r"(d[15]), "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]),
        "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]), "+r"(d[24]),
        "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]),
        "+r"(d[30]), "+r"(d[31]), "+r"(d[32]), "+r"(d[33]), "+r"(d[34]),
        "+r"(d[35]), "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]),
        "+r"(d[40]), "+r"(d[41]), "+r"(d[42]), "+r"(d[43]), "+r"(d[44]),
        "+r"(d[45]), "+r"(d[46]), "+r"(d[47]), "+r"(d[48]), "+r"(d[49]),
        "+r"(d[50]), "+r"(d[51]), "+r"(d[52]), "+r"(d[53]), "+r"(d[54]),
        "+r"(d[55]), "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]),
        "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc),
        "r"(scale_d)
      : "memory");
}

// wgmma_m64n128k256_b1 with A, 64 rows of 32 bytes, at the shared-memory
// descriptor adesc in B's layout, for a kernel whose A fragments would not
// fit in its registers beside the sums.
__device__ __forceinline__ void wgmma_m64n128k256_b1_ss(int (&d)[64],
                                                        uint64_t adesc,
                                                        uint64_t bdesc,
                                                        int scale_d) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k256.s32.b1.b1.and.popc "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, "
      "%41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, "
      "%54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p;\n"
      "}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]),
        "+r"(d[5]), "+r"(d[6]), "+r"(d[7]), "+r"(d[8]), "+r"(d[9]),
        "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]),
        "+r"(d[15]), "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]),
        "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]), "+r"(d[24]),
        "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]),
        "+r"(d[30]), "+r"(d[31]), "+r"(d[32]), "+r"(d[33]), "+r"(d[34]),
        "+r"(d[35]), "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]),
        "+r"(d[40]), "+r"(d[41]), "+r"(d[42]), "+r"(d[43]), "+r"(d[44]),
        "+r"(d[45]), "+r"(d[46]), "+r"(d[47]), "+r"(d[48]), "+r"(d[49]),
        "+r"(d[50]), "+r"(d[51]), "+r"(d[52]), "+r"(d[53]), "+r"(d[54]),
        "+r"(d[55]), "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]),
        "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63])
      : "l"(adesc), "l"(bdesc), "r"(scale_d)
      : "memory");
}

// Makes this thread's ordinary shared-memory stores visible to the async
// proxy that wgmma reads B through.
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n"
               :
               : "r"(bar), "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_init_fence() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n"
               :
               : "r"(bar)
               : "memory");
}

// count arrivals on the barrier at once.
__device__ __forceinline__ void mbar_arrive(uint32_t bar, int count) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0], %1;\n"
               :
               : "r"(bar), "r"(count)
               : "memory");
}

// One arrival on the barrier that also expects bytes more of asynchronous
// copies (tma_load_3d) before its phase can complete.
__device__ __forceinline__ void mbar_arrive_expect_tx(uint32_t bar,
                                                      uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               :
               : "r"(bar), "r"(bytes)
               : "memory");
}

// The tensor memory accelerator's copy of the box of the 3-dimensional
// tensor map at generic address map whose first element is at
// coordinates (c0, c1, c2), to shared address dst; elements out of the
// tensor's bounds are written as zeros, and the barrier at bar counts
// the box's bytes when they have landed.  The copy goes through the
// async proxy, as wgmma's reads do.
__device__ __forceinline__ void tma_load_3d(uint32_t dst, const void* map,
                                            int c0, int c1, int c2,
                                            uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%2, %3, %4}], [%5];\n"
      :
      : "r"(dst), "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1),
        "r"(c2), "r"(bar)
      : "memory");
}

// Wait until the phase of the barrier with parity `parity` has completed.
// A barrier starts in phase 0, so a wait for parity 1 returns at once.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  } while (!done);
}

// Named barrier `id` (1..15; 0 is __syncthreads') of N threads, a
// multiple of 32: bar_sync waits until N threads have arrived, bar_arrive
// arrives without waiting.
template <int N>
__device__ __forceinline__ void bar_sync(uint32_t id) {
  asm volatile("bar.sync %0, %1;\n" : : "r"(id), "n"(N) : "memory");
}

template <int N>
__device__ __forceinline__ void bar_arrive(uint32_t id) {
  asm volatile("bar.arrive %0, %1;\n" : : "r"(id), "n"(N) : "memory");
}

// Give the warpgroup's threads N registers each (setmaxnreg): fewer for
// a warpgroup that only moves data, more for one that holds accumulators.
template <int N>
__device__ __forceinline__ void regs_dec() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" : : "n"(N));
}

template <int N>
__device__ __forceinline__ void regs_inc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" : : "n"(N));
}

constexpr int kWarpgroup = 128;
constexpr int kConsumers = 4;
constexpr int kRingThreads = kWarpgroup * (1 + kConsumers);
constexpr int kStages = 4;
// registers a thread of a kRingThreads block at one block an SM: 65,536 /
// 640, rounded down to a multiple of 8
constexpr int kRingRegs = 96;

static_assert((kStages & (kStages - 1)) == 0, "a power-of-two ring");
static_assert((kConsumers & (kConsumers - 1)) == 0, "a power-of-two turn");

// Shared memory of a ring of kStages stages of stage_bytes, then the
// `full` and the `empty` mbarrier of each stage.
__host__ __device__ constexpr int ring_smem_bytes(int stage_bytes) {
  return kStages * stage_bytes + 2 * 8 * kStages;
}

// The roles of the block on the ring at smem (ring_smem_bytes(kStageBytes)
// of dynamic shared memory): thread 0 sets up the barriers, then the
// producer warpgroup keeps kProducerRegs registers a thread and runs
// produce(ring, full, empty), the ring as a pointer, and the consumer
// warpgroups take kConsumerRegs and run consume(ring, full, empty), the
// ring as a shared address.  Every thread of the block calls it.
template <int kStageBytes, int kProducerRegs, int kConsumerRegs,
          typename Produce, typename Consume>
__device__ __forceinline__ void ring_roles(uint8_t* smem, Produce&& produce,
                                           Consume&& consume) {
  static_assert(kWarpgroup * (kProducerRegs + kConsumers * kConsumerRegs) <=
                    kRingThreads * kRingRegs,
                "the block's registers");
  const uint32_t ring = static_cast<uint32_t>(__cvta_generic_to_shared(smem));
  const uint32_t full = ring + kStages * kStageBytes,
                 empty = full + 8 * kStages;
  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(full + 8 * s, kWarpgroup);
      mbar_init(empty + 8 * s, kConsumers * kWarpgroup);
    }
    mbar_init_fence();
  }
  __syncthreads();
  if (threadIdx.x < kWarpgroup) {
    regs_dec<kProducerRegs>();
    produce(smem, full, empty);
  } else {
    regs_inc<kConsumerRegs>();
    consume(ring, full, empty);
  }
}

// The producer's walk over n_tiles tiles: for tile t, fetch(t) issues the
// loads that need no stage, the thread waits until the tile's stage is
// free, fill(stage) writes it through the pointer stage, and the stage's
// `full` barrier is signalled.
template <int kStageBytes, typename Fetch, typename Fill>
__device__ __forceinline__ void produce_tiles(int n_tiles, uint8_t* ring,
                                              uint32_t full, uint32_t empty,
                                              Fetch&& fetch, Fill&& fill) {
  for (int t = 0; t < n_tiles; ++t) {
    const int st = t & (kStages - 1);
    fetch(t);
    mbar_wait(empty + 8 * st, ((t / kStages) & 1) ^ 1);
    fill(ring + st * kStageBytes);
    fence_proxy_async();
    mbar_arrive(full + 8 * st);
  }
}

// A consumer warpgroup's walk over n_tiles tiles: for tile t, wait until
// its stage st is full, take the turn, product(st) issues the products
// into acc in one commit group, pass the turn, wait for the group, free
// the stage, and epilogue(t) reads acc.  Consumer c issues after named
// barrier 1 + c, then opens the next consumer's; the last opens consumer
// 0's once ahead, and not after its last tile, so that every barrier's
// arrivals and waits match.
template <typename Product, typename Epilogue>
__device__ __forceinline__ void consume_tiles(int n_tiles, uint32_t full,
                                              uint32_t empty, int (&acc)[64],
                                              Product&& product,
                                              Epilogue&& epilogue) {
  const int c = (threadIdx.x - kWarpgroup) / kWarpgroup;
  const uint32_t mine_bar = 1 + c, next_bar = 1 + ((c + 1) & (kConsumers - 1));
  constexpr int kPair = 2 * kWarpgroup;
  if (c == kConsumers - 1) bar_arrive<kPair>(next_bar);
  for (int t = 0; t < n_tiles; ++t) {
    const int st = t & (kStages - 1);
    mbar_wait(full + 8 * st, (t / kStages) & 1);
    bar_sync<kPair>(mine_bar);
    product(st);
    if (c < kConsumers - 1 || t + 1 < n_tiles) bar_arrive<kPair>(next_bar);
    wgmma_wait<0>();
    fence_regs(acc);
    mbar_arrive(empty + 8 * st);
    epilogue(t);
  }
}

// The AND of each of the lane's two rows' 32 sums, in one chain a row (a
// tree of the same ANDs made both count kernels 2.3 to 9 times slower):
// its sign bit survives iff no sum of the row is >= 0.  Query row 8 h + g
// of the warp's 16 holds d[4j + 2h + c] (j 0..15, c 0..1), column
// 8 j + 2 t + c.
__device__ __forceinline__ void and_rows(int (&all)[2], const int (&d)[64]) {
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    all[h] = d[2 * h] & d[2 * h + 1];
#pragma unroll
    for (int j = 1; j < 16; ++j)
      all[h] &= d[4 * j + 2 * h] & d[4 * j + 2 * h + 1];
  }
}

// The count epilogue of an m64 tile's sums: a pair counts iff its sum is
// >= 0 and, if kMasked, its column is below limit.  Where and_rows leaves
// a row's sign bit, none counts, the common case; a row where some counts
// adds 32 less its negative (or masked) sums to cnt[h], one shift-add a
// sum.
template <bool kMasked = false>
__device__ __forceinline__ void count_tile(int (&cnt)[2], const int (&d)[64],
                                           int limit = 0) {
  int all[2];
  and_rows(all, d);
  if ((all[0] & all[1]) < 0) return;
  // column 8 j + 2 t + c is below limit iff 8 j + c < limit - 2 t
  const int below = limit - 2 * (threadIdx.x & 3);
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    if (all[h] < 0) continue;
    unsigned neg = 0;
#pragma unroll
    for (int j = 0; j < 16; ++j)
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        unsigned x = static_cast<unsigned>(d[4 * j + 2 * h + c]);
        if constexpr (kMasked) x |= 8 * j + c < below ? 0u : 0x80000000u;
        neg += x >> 31;
      }
    cnt[h] += 32 - static_cast<int>(neg);
  }
}

// The quad's four threads hold the same query rows' counts over other
// columns: one integer atomicAdd of their sum a row, for the rows qw + g
// (cnt[0]) and qw + 8 + g (cnt[1]) below nq.
__device__ __forceinline__ void add_row_counts(const int (&cnt)[2],
                                               int* __restrict__ out, int nq,
                                               int qw) {
  const int g = (threadIdx.x & 31) >> 2, t = threadIdx.x & 3;
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    int n = cnt[half];
    n += __shfl_xor_sync(0xffffffffu, n, 1);
    n += __shfl_xor_sync(0xffffffffu, n, 2);
    const int qi = qw + 8 * half + g;
    if (t == 0 && qi < nq && n != 0) atomicAdd(out + qi, n);
  }
}

// The top-k epilogue of the wgmma block (hamming_topk.cu, packed_topk.cu),
// beside the count's: each sum started at its row's bias b, set from dK,
// the row's gate distance (L + 1 while its lists are not full), so that
// the sum is >= 0 iff the pair's distance is below dK (Code, below, says
// how for each row code).  Only pairs with a sum >= 0 on a column below the
// split's end hi (padding columns past it carry the bias lane and can
// pass) are turned into keys (dist << 24) | col, and the exact key compare
// decides each insertion (topk_common.cuh insert), so the lists do not
// depend on the gate or on the order of insertion.  Within a split the
// tiles come in ascending column order, which makes a gate at dK itself
// safe: a pair at distance dK loses to every key of distance <= dK that an
// earlier tile gave.

// The row codes of the top-k epilogue: bias(dk, L), the bias b of a row
// whose gate distance is dk, and kShift: a pair's distance is
// (dbase - sum) >> kShift, dbase being a number of the row that the kernel
// passes.  One-hot rows (onehot_wgmma.cuh): a pair at distance h sums to
// L - h + b, so b = dK - L - 1 and h = dbase - sum with dbase = L + b.
struct OnehotCode {
  static constexpr int kShift = 0;
  __device__ __forceinline__ static int bias(int dk, int length) {
    return dk - length - 1;
  }
};

// Tetrahedral rows in units (packed_common.cuh): a pair at distance h sums
// to 3L - 4h + b, so b = 4 dK - 3L - 1 makes the sum 4 (dK - h) - 1, and
// h = (dbase - sum) >> 2 exactly with dbase = 3L + b = 4 dK - 1.  b lies
// in [-3L - 1, L + 3].
struct TetraCode {
  static constexpr int kShift = 2;
  __device__ __forceinline__ static int bias(int dk, int length) {
    return 4 * dk - 3 * length - 1;
  }
};

// The candidates of the lane's row h: bit i = 2j + c set iff its sum with
// column col0 + 8j + 2t + c is >= 0 (one funnel shift a sum gathers the
// sign bits) and the column lies below hi.
__device__ __forceinline__ unsigned row_candidates(const int (&d)[64], int h,
                                                   int col0, int hi) {
  // four chains of 8, for latency: chain r gathers sums 8r .. 8r + 7
  unsigned part[4] = {};
#pragma unroll
  for (int i = 7; i >= 0; --i)
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int n = 8 * r + i;
      part[r] = __funnelshift_l(
          static_cast<unsigned>(d[4 * (n >> 1) + 2 * h + (n & 1)]), part[r],
          1);
    }
  const unsigned neg = part[0] | part[1] << 8 | part[2] << 16 |
                       part[3] << 24;
  // the lane's column 8j + c past its first lies below hi iff 8j + c < r
  const int r = hi - col0 - 2 * static_cast<int>(threadIdx.x & 3);
  if (r >= 128) return ~neg;
  if (r <= 0) return 0u;
  const int j = r >> 3, e = r & 7;
  const unsigned below = ((1u << 2 * j) - 1) |
                         (e >= 2 ? 3u : e) << 2 * j;
  return ~neg & below;
}

// The lane's 32 sums of row h as bytes (they lie in [-33, 32] on one-hot
// rows of L <= 32, in [-4L - 1, 4L + 3] on tetrahedral rows of L <= 21):
// byte i % 4 of w[i / 4] holds sum i = 2j + c.
__device__ __forceinline__ void row_bytes(uint32_t (&w)[8],
                                          const int (&d)[64], int h) {
#pragma unroll
  for (int k = 0; k < 8; ++k)
    w[k] = __byte_perm(__byte_perm(d[8 * k + 2 * h], d[8 * k + 2 * h + 1],
                                   0x0040),
                       __byte_perm(d[8 * k + 4 + 2 * h],
                                   d[8 * k + 5 + 2 * h], 0x0040),
                       0x5410);
}

// Sum i of row_bytes, selected without indexing registers at run time.
__device__ __forceinline__ int byte_sum(const uint32_t (&w)[8], int i) {
  const bool b4 = i & 4, b8 = i & 8, b16 = i & 16;
  const uint32_t x0 = b4 ? w[1] : w[0], x1 = b4 ? w[3] : w[2];
  const uint32_t x2 = b4 ? w[5] : w[4], x3 = b4 ? w[7] : w[6];
  const uint32_t y0 = b8 ? x1 : x0, y1 = b8 ? x3 : x2;
  return static_cast<int8_t>((b16 ? y1 : y0) >> 8 * (i & 3));
}

// put(key) for each candidate of row_candidates, in ascending column, its
// key (dist << 24) | col with dist = (dbase - sum) >> Code::kShift.  A lane
// loops over its own candidates only, so a warp takes as many turns as its
// busiest lane.
template <typename Code, typename Put>
__device__ __forceinline__ void each_candidate(unsigned m,
                                               const uint32_t (&w)[8],
                                               int dbase, int col0,
                                               Put&& put) {
  const int lane_col = col0 + 2 * static_cast<int>(threadIdx.x & 3);
  while (m) {
    const int i = __ffs(m) - 1;
    m &= m - 1;
    put((((dbase - byte_sum(w, i)) >> Code::kShift) << kIdxBits) |
        (lane_col + 8 * (i >> 1) + (i & 1)));
  }
}

// The top-k lists of a wgmma block for K <= 32: each lane keeps, for each
// of its two rows, the K smallest keys over its own columns (8j + 2t + c),
// a sub-list, in shared memory: key i of row h of the lane in slot `slot`
// (of kSlots lanes) at lists[(2i + h) kSlots + slot], so that a warp's
// lanes touch 32 consecutive ints, and each lane reads and writes only its
// own keys (registers for K 8 spilled beside the 64 accumulators, and ran
// no faster at K 1 to 4).  A key of the row's top K stays in its lane's
// sub-list, which drops a key only for K smaller ones, so at the end of
// the split the K smallest of the quad's four sub-lists are the row's top
// K.  The gate: at the start of a tile every sub-list's keys come from
// earlier tiles, so from lower columns, and K of them at a distance <= x
// mean that no pair of the tile at a distance >= x can enter the row's top
// K.  Such an x is the K-th distance of one sub-list, the larger K/2-th of
// two, or the largest K/4-th of four; the gate is the least of these over
// the quad (the K-th distance of the four sub-lists together at K <= 2).
// Code (OnehotCode, TetraCode) turns sums into distances and the gate into
// biases.
template <int K, int kSlots, typename Code = OnehotCode>
struct QuadLists {
  int* at;

  // Empty lists; slot is the lane's among the block's consumer lanes (the
  // row is RowLists').
  __device__ __forceinline__ QuadLists(int* lists, int, int slot)
      : at(lists + slot) {
#pragma unroll
    for (int i = 0; i < 2 * K; ++i) at[i * kSlots] = kInfKey;
  }

  __device__ __forceinline__ int get(int h, int i) const {
    return at[(2 * i + h) * kSlots];
  }

  __device__ __forceinline__ void read(int h, int (&l)[K]) const {
#pragma unroll
    for (int i = 0; i < K; ++i) l[i] = get(h, i);
  }

  // Insert k into row h's sub-list if it beats its K-th key; true iff so.
  __device__ __forceinline__ bool insert_key(int h, int k) {
    int l[K];
    read(h, l);
    if (k >= l[K - 1]) return false;
    insert<K>(l, k);
#pragma unroll
    for (int i = 0; i < K; ++i) at[(2 * i + h) * kSlots] = l[i];
    return true;
  }

  // Insert the keys of the tile's sums >= 0 on columns below hi; true iff
  // one went in.
  __device__ __forceinline__ bool tile(const int (&d)[64],
                                       const int (&dbase)[2], int col0,
                                       int hi) {
    int all[2];
    and_rows(all, d);
    if ((all[0] & all[1]) < 0) return false;
    bool put = false;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      if (all[h] < 0) continue;
      const unsigned m = row_candidates(d, h, col0, hi);
      uint32_t w[8];
      row_bytes(w, d, h);
      each_candidate<Code>(m, w, dbase[h], col0,
                           [&](int k) { put |= insert_key(h, k); });
    }
    return put;
  }

  // The distances of the lane's keys i of both rows, capped at L + 1, in
  // bytes 0 and 1.
  __device__ __forceinline__ unsigned dists(int i, int length) const {
    return static_cast<unsigned>(min(get(0, i) >> kIdxBits, length + 1)) |
           static_cast<unsigned>(min(get(1, i) >> kIdxBits, length + 1))
               << 8;
  }

  // The biases of the lane's rows from the quad's gate, both rows'
  // distances riding in two bytes of a word through the shuffles.  Every
  // lane of the warp calls it.
  __device__ __forceinline__ void gate(int length, int (&bias)[2]) const {
    constexpr unsigned kAll = 0xffffffffu;
    // one sub-list's K keys
    unsigned g = dists(K - 1, length);
    g = __vminu4(g, __shfl_xor_sync(kAll, g, 1));
    g = __vminu4(g, __shfl_xor_sync(kAll, g, 2));
    if constexpr (K >= 2) {
      // two sub-lists' K/2 keys each: the second least K/2-th distance
      const unsigned a = dists(K / 2 - 1, length);
      const unsigned b = __shfl_xor_sync(kAll, a, 1);
      const unsigned lo = __vminu4(a, b), hi = __vmaxu4(a, b);
      const unsigned lo2 = __shfl_xor_sync(kAll, lo, 2);
      const unsigned hi2 = __shfl_xor_sync(kAll, hi, 2);
      g = __vminu4(g, __vminu4(__vmaxu4(lo, lo2), __vminu4(hi, hi2)));
    }
    if constexpr (K >= 4) {
      // four sub-lists' K/4 keys each: the largest K/4-th distance
      unsigned a = dists(K / 4 - 1, length);
      a = __vmaxu4(a, __shfl_xor_sync(kAll, a, 1));
      a = __vmaxu4(a, __shfl_xor_sync(kAll, a, 2));
      g = __vminu4(g, a);
    }
    bias[0] = Code::bias(static_cast<int>(g & 0xffu), length);
    bias[1] = Code::bias(static_cast<int>(g >> 8), length);
  }

  // The quad's merge of its sub-lists of each row into the row's K
  // smallest keys (a butterfly of two steps, after which every lane of the
  // quad holds them), written to out[h] unless it is null, each lane
  // writing the keys i with i % 4 == t.  Every lane of the warp calls it.
  __device__ __forceinline__ void write(int* const (&out)[2]) const {
    const int t = threadIdx.x & 3;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      int key[K];
      read(h, key);
#pragma unroll
      for (int m = 1; m <= 2; m <<= 1) {
        int other[K];
#pragma unroll
        for (int i = 0; i < K; ++i)
          other[i] = __shfl_xor_sync(0xffffffffu, key[i], m);
#pragma unroll
        for (int i = 0; i < K; ++i)
          if (other[i] < key[K - 1]) insert<K>(key, other[i]);
      }
      if (out[h])
#pragma unroll
        for (int i = 0; i < K; ++i)
          if ((i & 3) == t) out[h][i] = key[i];
    }
  }
};

// The top-k lists of a wgmma block for K whose sub-lists would not fit in
// shared memory beside the ring: one ascending list of K keys a row in
// shared memory (rows K + 1 ints apart, so that the 8 rows a warp's lanes
// of one t touch fall in different banks), shared by the row's quad, whose
// four lanes insert in turn.  The gate is the list's K-th distance, exact;
// Code as QuadLists'.
template <int K, typename Code = OnehotCode>
struct RowLists {
  static constexpr int kStride = K + 1;
  // shared ints a block of rows rows needs
  static constexpr int ints(int rows) { return rows * kStride; }

  int* list[2];

  // The lists of the lane's rows row and row + 8 of lists, the quad's
  // lanes filling them with kInfKey (slot is QuadLists').  Every lane of
  // the warp calls it.
  __device__ __forceinline__ RowLists(int* lists, int row, int)
      : list{lists + row * kStride, lists + (row + 8) * kStride} {
    const int t = threadIdx.x & 3;
#pragma unroll
    for (int h = 0; h < 2; ++h)
      for (int i = t; i < K; i += 4) list[h][i] = kInfKey;
    __syncwarp();
  }

  // Insert key into the ascending list l, dropping its largest.
  __device__ __forceinline__ static void insert_at(int* l, int key) {
    int i = K - 1;
#pragma unroll 1
    for (; i > 0; --i) {
      const int prev = l[i - 1];
      if (prev < key) break;
      l[i] = prev;
    }
    l[i] = key;
  }

  // Insert the keys of the tile's sums >= 0 on columns below hi, the
  // quad's lanes in turn; true iff one went in.  Every lane of the warp
  // calls it.
  __device__ __forceinline__ bool tile(const int (&d)[64],
                                       const int (&dbase)[2], int col0,
                                       int hi) {
    int all[2];
    and_rows(all, d);
    if (!__any_sync(0xffffffffu, (all[0] & all[1]) >= 0)) return false;
    unsigned m[2];
    uint32_t w[2][8];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      m[h] = all[h] < 0 ? 0u : row_candidates(d, h, col0, hi);
      row_bytes(w[h], d, h);
    }
    const int t = threadIdx.x & 3;
    bool put = false;
#pragma unroll 1
    for (int turn = 0; turn < 4; ++turn) {
      if (turn == t)
#pragma unroll
        for (int h = 0; h < 2; ++h)
          each_candidate<Code>(m[h], w[h], dbase[h], col0, [&](int k) {
            if (k < list[h][K - 1]) {
              insert_at(list[h], k);
              put = true;
            }
          });
      __syncwarp();
    }
    return put;
  }

  // The biases of the lane's rows from the list's K-th distance, capped at
  // L + 1.
  __device__ __forceinline__ void gate(int length, int (&bias)[2]) const {
#pragma unroll
    for (int h = 0; h < 2; ++h)
      bias[h] = Code::bias(min(list[h][K - 1] >> kIdxBits, length + 1),
                           length);
  }

  // Each row's list written to out[h] unless it is null, each lane of the
  // quad writing the keys i with i % 4 == t.
  __device__ __forceinline__ void write(int* const (&out)[2]) const {
    const int t = threadIdx.x & 3;
#pragma unroll
    for (int h = 0; h < 2; ++h)
      if (out[h])
        for (int i = t; i < K; i += 4) out[h][i] = list[h][i];
  }
};

// Readies kernel, built on ring_roles with these register counts, for a
// launch with smem_bytes of dynamic shared memory on the current device.
// Per call: the attribute belongs to the current device's copy of the
// kernel, and the sharded backend calls on several cards.  setmaxnreg
// hands registers between the warpgroups of the block's own allocation,
// so a kernel built with fewer than the roles' sum would wait forever at
// regs_inc: it is refused.
template <int kProducerRegs, int kConsumerRegs, typename Kernel>
inline cudaError_t ring_kernel_ready(Kernel* kernel, int smem_bytes) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
  if (err != cudaSuccess) return err;
  cudaFuncAttributes attr;
  err = cudaFuncGetAttributes(&attr, kernel);
  if (err != cudaSuccess) return err;
  if (attr.numRegs * kRingThreads <
      kWarpgroup * (kProducerRegs + kConsumers * kConsumerRegs))
    return cudaErrorInvalidConfiguration;
  return cudaSuccess;
}

}  // namespace gm
