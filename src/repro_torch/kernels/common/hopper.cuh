// Hopper (sm_90a) building blocks shared by the port's kernels: TMA tile
// loads into shared memory, mbarriers, warpgroup matrix multiplies
// (wgmma) with their shared-memory descriptors, register rebalancing
// between warpgroups, and the host-side tensor-map encoder.
//
// The libraries link against the CUDA runtime only (no -lcuda), so the
// driver's cuTensorMapEncodeTiled is looked up at run time through
// cudaGetDriverEntryPoint; <cuda.h> is included for its types alone.

#pragma once

#include <cuda.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace hopper {

// ---------------------------------------------------------------------------
// shared memory addresses, mbarriers
// ---------------------------------------------------------------------------

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_addr(bar)),
               "r"(count)
               : "memory");
}

// Makes the barriers' initialisation visible to the async proxy (TMA).
__device__ __forceinline__ void fence_barrier_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(
                   smem_addr(bar))
               : "memory");
}

// Arrive, and expect `bytes` more from TMA before the phase completes.
__device__ __forceinline__ void mbar_arrive_expect_tx(uint64_t* bar,
                                                      uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
          smem_addr(bar)),
      "r"(bytes)
      : "memory");
}

// Expect `bytes` more from TMA before the phase completes, without
// arriving.
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar,
                                               uint32_t bytes) {
  asm volatile(
      "mbarrier.expect_tx.relaxed.cta.shared::cta.b64 [%0], %1;\n" ::"r"(
          smem_addr(bar)),
      "r"(bytes)
      : "memory");
}

// Wait until the phase of parity `parity` has completed.  A barrier
// starts in phase 0, so waiting on parity 1 returns at once: a producer
// waits on its empty barriers with the flipped parity.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = smem_addr(bar);
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
  }
}

// ---------------------------------------------------------------------------
// TMA
// ---------------------------------------------------------------------------

// The byte offset of row r, byte b of a tile whose rows are row_bytes wide
// (128, 64 or 32) as TMA swizzles it: the 16-byte chunk index XOR the
// row's place in the pattern (the tile based 1024-aligned).
__device__ __forceinline__ uint32_t swizzled(int r, int b, int row_bytes) {
  const uint32_t off = r * row_bytes + b;
  const uint32_t mask = row_bytes / 16 - 1;  // 7, 3 or 1
  return off ^ (((off >> 7) & mask) << 4);
}

// One box of a 4-d tensor map into shared memory; completion is counted
// in bytes on `bar`.  Coordinates are innermost first.
__device__ __forceinline__ void tma_load_4d(void* dst, const CUtensorMap* map,
                                            uint64_t* bar, int c0, int c1,
                                            int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.tile"
      ".mbarrier::complete_tx::bytes [%0], [%1, {%3, %4, %5, %6}], [%2];\n"
      ::"r"(smem_addr(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_addr(bar)), "r"(c0),
      "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

// One box of shared memory out to a 4-d tensor map; parts of the box
// outside the tensor are not written.  Completion is tracked by bulk
// groups (bulk_commit, bulk_wait_read).
__device__ __forceinline__ void tma_store_4d(const CUtensorMap* map,
                                             const void* src, int c0, int c1,
                                             int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.global.shared::cta.bulk_group"
      " [%0, {%2, %3, %4, %5}], [%1];\n" ::"l"(
          reinterpret_cast<uint64_t>(map)),
      "r"(smem_addr(src)), "r"(c0), "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

__device__ __forceinline__ void bulk_commit() {
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}

// Wait until the committed stores have read their shared memory.
__device__ __forceinline__ void bulk_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
}

// Wait until the committed stores are done.
__device__ __forceinline__ void bulk_wait() {
  asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
}

// Makes this thread's writes to shared memory visible to TMA.
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// The same box into L2 only: no shared memory, no barrier.
__device__ __forceinline__ void tma_prefetch_4d(const CUtensorMap* map,
                                                int c0, int c1, int c2,
                                                int c3) {
  asm volatile(
      "cp.async.bulk.prefetch.tensor.4d.L2.global.tile [%0, {%1, %2, %3, "
      "%4}];\n" ::"l"(reinterpret_cast<uint64_t>(map)),
      "r"(c0), "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

__device__ __forceinline__ void prefetch_tensormap(const CUtensorMap* map) {
  asm volatile("prefetch.tensormap [%0];\n" ::"l"(
                   reinterpret_cast<uint64_t>(map))
               : "memory");
}

// ---------------------------------------------------------------------------
// register rebalancing between warpgroups (all four warps execute it)
// ---------------------------------------------------------------------------

template <int R>
__device__ __forceinline__ void regs_dealloc() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(R));
}

template <int R>
__device__ __forceinline__ void regs_alloc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(R));
}

// ---------------------------------------------------------------------------
// wgmma
// ---------------------------------------------------------------------------

// Shared-memory matrix descriptor.  `swizzle_bytes` is the row width of
// the tile as TMA wrote it (128, 64 or 32 bytes, with the same swizzle);
// the tile's 8-row groups lie 8 rows apart (SBO).  The leading byte
// offset is not read by these layouts: a K-major operand steps along K
// inside one swizzle row, an MN-major one is one swizzle row wide.
// The swizzle pattern repeats every 8 rows, so a tile's base is aligned
// to 8 x its row width.
__device__ __forceinline__ uint64_t smem_desc(const void* p,
                                              int swizzle_bytes) {
  const uint32_t layout =
      swizzle_bytes == 128 ? 1u : (swizzle_bytes == 64 ? 2u : 3u);
  uint64_t d = (smem_addr(p) & 0x3FFFFu) >> 4;
  d |= uint64_t{1} << 16;                                  // LBO (unused)
  d |= uint64_t((8u * swizzle_bytes) >> 4) << 32;          // SBO
  d |= uint64_t(layout) << 62;
  return d;
}

// The descriptor of an MN-major operand more than one swizzle atom wide
// (128-byte swizzle: 64 bf16 values along MN, as a TMA box of 64 x rows
// wrote it).  Its atoms lie `atom_bytes` apart along MN (the leading
// byte offset) and its 8-row groups along K 1024 bytes apart (SBO).
__device__ __forceinline__ uint64_t smem_desc_mn128(const void* p,
                                                    uint32_t atom_bytes) {
  uint64_t d = (smem_addr(p) & 0x3FFFFu) >> 4;
  d |= uint64_t((atom_bytes >> 4) & 0x3FFFu) << 16;       // LBO
  d |= uint64_t(1024u >> 4) << 32;                         // SBO
  d |= uint64_t(1) << 62;                                  // 128-byte swizzle
  return d;
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Keeps the compiler from moving reads or writes of accumulator registers
// across the asynchronous wgmma that owns them.
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

#define HOPPER_F8(d, i)                                                    \
  "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3]),              \
      "+f"(d[i + 4]), "+f"(d[i + 5]), "+f"(d[i + 6]), "+f"(d[i + 7])

// d (64 x 128, f32) {=, +=} A (64 x 16) B^T (128 x 16); A and B bf16 in
// shared memory, both K-major.  Accumulator layout: warp w of the group
// holds rows 16w..16w+15; lane (g = lane/4, t = lane%4) holds, for each
// 8-column chunk j, d[4j+0..1] = (row g, cols 8j+2t, +1) and d[4j+2..3]
// = (row g+8, the same cols).
__device__ __forceinline__ void wgmma_m64n128k16_ss(float (&d)[64],
                                                    uint64_t desc_a,
                                                    uint64_t desc_b,
                                                    int accumulate) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, "
      "%41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, "
      "%54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, 0, 0;\n"
      "}\n"
      : HOPPER_F8(d, 0), HOPPER_F8(d, 8), HOPPER_F8(d, 16),
        HOPPER_F8(d, 24), HOPPER_F8(d, 32), HOPPER_F8(d, 40),
        HOPPER_F8(d, 48), HOPPER_F8(d, 56)
      : "l"(desc_a), "l"(desc_b), "r"(accumulate));
}

// d (64 x N, f32) {=, +=} A (64 x 16) B (16 x N); A bf16 from registers
// (the mma.m16n8k16 A fragment of each warp's 16 rows), B bf16 in shared
// memory, MN-major (N contiguous, read transposed).
template <int N>
__device__ __forceinline__ void wgmma_rs_tb(float (&d)[N / 2],
                                            const uint32_t (&a)[4],
                                            uint64_t desc_b, int accumulate);

template <>
__device__ __forceinline__ void wgmma_rs_tb<64>(float (&d)[32],
                                                const uint32_t (&a)[4],
                                                uint64_t desc_b,
                                                int accumulate) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n"
      "}\n"
      : HOPPER_F8(d, 0), HOPPER_F8(d, 8), HOPPER_F8(d, 16), HOPPER_F8(d, 24)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b),
        "r"(accumulate));
}

template <>
__device__ __forceinline__ void wgmma_rs_tb<32>(float (&d)[16],
                                                const uint32_t (&a)[4],
                                                uint64_t desc_b,
                                                int accumulate) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15}, {%16, %17, %18, %19}, %20, p, 1, 1, 1;\n"
      "}\n"
      : HOPPER_F8(d, 0), HOPPER_F8(d, 8)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b),
        "r"(accumulate));
}

template <>
__device__ __forceinline__ void wgmma_rs_tb<16>(float (&d)[8],
                                                const uint32_t (&a)[4],
                                                uint64_t desc_b,
                                                int accumulate) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %13, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7}, {%8, %9, %10, %11}, %12, "
      "p, 1, 1, 1;\n"
      "}\n"
      : HOPPER_F8(d, 0)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b),
        "r"(accumulate));
}

#define HOPPER_F4(d, i) \
  "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3])

// d (64 x N, f32) {=, +=} A (64 x 16) B (16 x N), A and B bf16 in shared
// memory.  TA = 1 reads A M-major (M contiguous, transposed), TA = 0
// K-major; TB likewise for B (1: N contiguous).  The accumulator layout
// is wgmma_m64n128k16_ss's, N/8 column chunks of it.  N is 8 to 64 in
// steps of 8, or 256; wgmma_ss<N, TA, TB>(...) picks the instruction.
template <int N>
struct WgmmaSS;

template <>
struct WgmmaSS<8> {
  template <int TA, int TB>
  static __device__ __forceinline__ void run(float (&d)[4], uint64_t desc_a,
                                             uint64_t desc_b, int accumulate) {
    asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %6, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n8k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3}, "
      "%4, %5, p, 1, 1, %7, %8;\n"
      "}\n"
      : HOPPER_F4(d, 0)
      : "l"(desc_a), "l"(desc_b), "r"(accumulate), "n"(TA), "n"(TB));
  }
};

template <>
struct WgmmaSS<16> {
  template <int TA, int TB>
  static __device__ __forceinline__ void run(float (&d)[8], uint64_t desc_a,
                                             uint64_t desc_b, int accumulate) {
    asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %10, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7}, "
      "%8, %9, p, 1, 1, %11, %12;\n"
      "}\n"
      : HOPPER_F8(d, 0)
      : "l"(desc_a), "l"(desc_b), "r"(accumulate), "n"(TA), "n"(TB));
  }
};

template <>
struct WgmmaSS<24> {
  template <int TA, int TB>
  static __device__ __forceinline__ void run(float (&d)[12], uint64_t desc_a,
                                             uint64_t desc_b, int accumulate) {
    asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %14, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n24k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11}, "
      "%12, %13, p, 1, 1, %15, %16;\n"
      "}\n"
      : HOPPER_F8(d, 0), HOPPER_F4(d, 8)
      : "l"(desc_a), "l"(desc_b), "r"(accumulate), "n"(TA), "n"(TB));
  }
};

template <>
struct WgmmaSS<32> {
  template <int TA, int TB>
  static __device__ __forceinline__ void run(float (&d)[16], uint64_t desc_a,
                                             uint64_t desc_b, int accumulate) {
    asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15}, "
      "%16, %17, p, 1, 1, %19, %20;\n"
      "}\n"
      : HOPPER_F8(d, 0), HOPPER_F8(d, 8)
      : "l"(desc_a), "l"(desc_b), "r"(accumulate), "n"(TA), "n"(TB));
  }
};

template <>
struct WgmmaSS<40> {
  template <int TA, int TB>
  static __device__ __forceinline__ void run(float (&d)[20], uint64_t desc_a,
                                             uint64_t desc_b, int accumulate) {
    asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %22, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n40k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19}, "
      "%20, %21, p, 1, 1, %23, %24;\n"
      "}\n"
      : HOPPER_F8(d, 0), HOPPER_F8(d, 8), HOPPER_F4(d, 16)
      : "l"(desc_a), "l"(desc_b), "r"(accumulate), "n"(TA), "n"(TB));
  }
};

template <>
struct WgmmaSS<48> {
  template <int TA, int TB>
  static __device__ __forceinline__ void run(float (&d)[24], uint64_t desc_a,
                                             uint64_t desc_b, int accumulate) {
    asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %26, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n48k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23}, "
      "%24, %25, p, 1, 1, %27, %28;\n"
      "}\n"
      : HOPPER_F8(d, 0), HOPPER_F8(d, 8), HOPPER_F8(d, 16)
      : "l"(desc_a), "l"(desc_b), "r"(accumulate), "n"(TA), "n"(TB));
  }
};

template <>
struct WgmmaSS<56> {
  template <int TA, int TB>
  static __device__ __forceinline__ void run(float (&d)[28], uint64_t desc_a,
                                             uint64_t desc_b, int accumulate) {
    asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %30, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n56k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27}, "
      "%28, %29, p, 1, 1, %31, %32;\n"
      "}\n"
      : HOPPER_F8(d, 0), HOPPER_F8(d, 8), HOPPER_F8(d, 16), HOPPER_F4(d, 24)
      : "l"(desc_a), "l"(desc_b), "r"(accumulate), "n"(TA), "n"(TB));
  }
};

template <>
struct WgmmaSS<64> {
  template <int TA, int TB>
  static __device__ __forceinline__ void run(float (&d)[32], uint64_t desc_a,
                                             uint64_t desc_b, int accumulate) {
    asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, %35, %36;\n"
      "}\n"
      : HOPPER_F8(d, 0), HOPPER_F8(d, 8), HOPPER_F8(d, 16), HOPPER_F8(d, 24)
      : "l"(desc_a), "l"(desc_b), "r"(accumulate), "n"(TA), "n"(TB));
  }
};

template <>
struct WgmmaSS<256> {
  template <int TA, int TB>
  static __device__ __forceinline__ void run(float (&d)[128], uint64_t desc_a,
                                             uint64_t desc_b, int accumulate) {
    asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, "
      "%41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, "
      "%54, %55, %56, %57, %58, %59, %60, %61, %62, %63, %64, %65, %66, "
      "%67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, "
      "%93, %94, %95, %96, %97, %98, %99, %100, %101, %102, %103, %104, "
      "%105, %106, %107, %108, %109, %110, %111, %112, %113, %114, %115, "
      "%116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, "
      "%127}, "
      "%128, %129, p, 1, 1, %131, %132;\n"
      "}\n"
      : HOPPER_F8(d, 0), HOPPER_F8(d, 8), HOPPER_F8(d, 16), HOPPER_F8(d, 24),
        HOPPER_F8(d, 32), HOPPER_F8(d, 40), HOPPER_F8(d, 48),
        HOPPER_F8(d, 56), HOPPER_F8(d, 64), HOPPER_F8(d, 72),
        HOPPER_F8(d, 80), HOPPER_F8(d, 88), HOPPER_F8(d, 96),
        HOPPER_F8(d, 104), HOPPER_F8(d, 112), HOPPER_F8(d, 120)
      : "l"(desc_a), "l"(desc_b), "r"(accumulate), "n"(TA), "n"(TB));
  }
};

template <int N, int TA, int TB>
__device__ __forceinline__ void wgmma_ss(float (&d)[N / 2], uint64_t desc_a,
                                         uint64_t desc_b, int accumulate) {
  WgmmaSS<N>::template run<TA, TB>(d, desc_a, desc_b, accumulate);
}

#undef HOPPER_F4
#undef HOPPER_F8

// ---------------------------------------------------------------------------
// host: tensor maps
// ---------------------------------------------------------------------------

using EncodeTiledFn = CUresult (*)(CUtensorMap*, CUtensorMapDataType,
                                   cuuint32_t, void*, const cuuint64_t*,
                                   const cuuint64_t*, const cuuint32_t*,
                                   const cuuint32_t*, CUtensorMapInterleave,
                                   CUtensorMapSwizzle,
                                   CUtensorMapL2promotion,
                                   CUtensorMapFloatOOBfill);

// The driver's cuTensorMapEncodeTiled, or nullptr if the driver lacks it.
inline EncodeTiledFn encode_tiled() {
  static EncodeTiledFn fn = nullptr;
  if (fn == nullptr) {
    void* ptr = nullptr;
    cudaDriverEntryPointQueryResult found = cudaDriverEntryPointSymbolNotFound;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &ptr, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &ptr, cudaEnableDefault, &found);
#endif
    if (err == cudaSuccess && found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiledFn>(ptr);
  }
  return fn;
}

// A 4-d bf16 tensor map (dims innermost first, strides in elements for
// dims 1..3) read in boxes of box[0] x box[1] x 1 x 1, swizzled by the
// box's row width (box[0] x 2 bytes: 128, 64 or 32).  Rows past the end
// read as zeros.  Returns false if the driver refuses the map.
inline bool encode_bf16_4d(CUtensorMap* map, const void* base,
                           const long long (&dims)[4],
                           const long long (&strides)[3], int box0,
                           int box1) {
  const EncodeTiledFn fn = encode_tiled();
  if (fn == nullptr) return false;
  cuuint64_t gdim[4], gstride[3];
  for (int i = 0; i < 4; ++i) gdim[i] = static_cast<cuuint64_t>(dims[i]);
  for (int i = 0; i < 3; ++i)
    gstride[i] = static_cast<cuuint64_t>(strides[i]) * 2;
  const cuuint32_t box[4] = {static_cast<cuuint32_t>(box0),
                             static_cast<cuuint32_t>(box1), 1, 1};
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  const CUtensorMapSwizzle swizzle =
      box0 * 2 == 128 ? CU_TENSOR_MAP_SWIZZLE_128B
                      : (box0 * 2 == 64 ? CU_TENSOR_MAP_SWIZZLE_64B
                                        : CU_TENSOR_MAP_SWIZZLE_32B);
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(base),
            gdim, gstride, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle,
            CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

}  // namespace hopper
