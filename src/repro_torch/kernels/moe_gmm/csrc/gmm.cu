// Grouped expert matmul for Hopper (sm_90a), written by hand.
//
// Replaces the Pallas TPU kernel
//   src/repro/kernels/moe_gmm/kernel.py::gmm  (body _gmm_kernel)
// and computes what it computes, per expert e:
//
//   out[e] = x[e] @ w[e]      accumulated in f32, stored once in x's dtype
//
// Layout: x (B,E,C,D) with any strides on B, E and C and D contiguous (the
// MoE layer's expert buffers, read in place; the Pallas signature (E,C,D)
// is B = 1); w (E,D,F) with F contiguous; out (B,E,C,F) contiguous.  D and
// F are multiples of 8, strides multiples of 8 elements and base pointers
// 16-byte aligned (the wrapper checks), so every row moves in 16-byte
// chunks and TMA can read x and w in place.  C may be ragged: the
// reference's capacity pads to a multiple of 8, not of a tile.
//
// What bounds it on an H100, at granite-moe-1b-a400m's serving shapes
// (D = 1024, F = 512, E = 32, B = 3, bf16): the prefill product (C = 320)
// is 32.2 GFLOP against 128 MB of x, w and out, ~250 FLOP per byte, just
// under the card's ~295 FLOP/byte bf16 ridge: bytes bound it, narrowly,
// so it has to run near the tensor cores' rate too.  The decode product
// (C = 8, 24 rows an expert) moves the 33.5 MB weight bank for 0.8 GFLOP:
// bytes bound it by far, and what counts is how many weight bytes are in
// flight on every SM.  So bf16 has two kernels; the wrapper picks one by
// the rows an expert holds (ops.py, NARROW_MAX_ROWS):
//
// * wide (many rows: prefill).  A persistent wgmma GEMM fed by TMA.  One
//   block an SM walks output tiles of 128 rows x 256 columns, expert by
//   expert, so an expert's weights stay in L2 while its row tiles run.
//   A tile's rows are two 64-row half-tiles, each inside one batch row b
//   ((b, c) rows are not contiguous across b in a strided buffer); an
//   expert has B * ceil(C/64) of them, and rows past C arrive as zeros.
//   A producer warp keeps a 3-stage ring of TMA loads in flight (x: two
//   64 x 64 boxes through a 4-d map over (D, C, E, B); w: four 64-column
//   boxes, MN-major); two consumer warpgroups each run m64n256k16 wgmmas
//   on one half-tile, A = x K-major, B = w MN-major over four swizzle
//   atoms.  setmaxnreg moves the producer's registers to them.  The f32
//   sums are rounded once to bf16, staged in shared memory and stored by
//   TMA, which leaves out rows past C and columns past F.
// * narrow (at most 64 rows: decode).  A and B swap: out[e]^T = w[e]^T
//   x[e]^T, so a 64-column slice of w fills wgmma's 64-row side (A,
//   M-major) and the expert's few rows are its N (B, K-major), N = B *
//   ceil(C/8) * 8, instantiated for every multiple of 8 up to 64.  An
//   item is (expert, 64 columns) over all of D, so one block sums each
//   output in full: no split of D, no reduction across blocks, the same
//   result every run.  As many blocks (one warpgroup each) as the SMs
//   hold at once walk the items; each keeps an 8-stage ring of TMA loads
//   in flight (an 8 KB weight tile and one 8-row x box, one 128-byte
//   swizzle group, a row group), numbered across its items, so the ring
//   runs on from one item into the next and every SM has tens of KB of
//   weights in flight.
// * narrow pair (72 to 256 rows: decode at 9 to 32 slots, short
//   prompts).  The same swap at N = 128, 192 or 256 (the next above the
//   expert's rows; rows past them are dropped).  The bound is still the
//   weights read once: at mixtral's decode at 32 slots (D = 4096, F =
//   14336, E = 8, N = 256) 946.6 MB, 0.28 ms a product, but the tensor
//   cores' 240 GFLOP take 0.24 ms, nearly as long, so loads and products
//   have to overlap, and the first design's one warpgroup, its 64-column
//   items (which reload x from L2 once for every 64 columns: 4x the
//   weights' bytes at N = 256) and its 320-KB ring at N = 256 do not fit.
//   An item is (expert, 256 columns) over all of D, taken by a cluster of
//   two blocks on adjacent 128-column slices; one block still sums each
//   output in full.  In each block a producer warp keeps a ring of 4 to 6
//   stages in flight (two 64-column weight tiles of its own, and the
//   expert's rows of the k-tile as one 4-d box over (D, C, E, B), which
//   the cluster's first block loads once and TMA multicasts into both);
//   two consumer warpgroups each run m64nNk16 wgmmas on 64 of its columns
//   (setmaxnreg as in the wide kernel).  So each weight tile leaves
//   device memory once a product and x leaves L2 once for every 256
//   columns: N x 128 bytes a k-tile against the weights' 256 x 128, never
//   more.  The clusters that fit at once share the items evenly.
// * f32: CUDA cores (tensor cores would round to tf32 and break the
//   reference's 1e-5 normalised f32 tolerance), 4 x 4 outputs a thread.
//
// The tensor maps of x (and of out, for the wide kernel) are encoded at
// each call; the weights' map comes from the wrapper, which caches it
// keyed by exactly what it holds (address, dims, strides, box).  A map
// the driver refuses makes the call return ERR_TENSOR_MAP.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>
#include <cstring>

#include "common/hopper.cuh"

namespace {

constexpr int BM = 64;  // f32 kernel: output rows (b, c) per block
constexpr int BN = 64;  // f32 kernel: output columns per block

struct Params {
  const void* x;
  const void* w;
  void* o;
  int B, E, C, D, F;
  long long sxb, sxe, sxc;  // x strides in elements (D contiguous)
  long long swe, swd;       // w strides in elements (F contiguous)
};

// Row m < B * C of expert e: (b, c) = (m / C, m % C).
__device__ __forceinline__ long long x_row(const Params& p, int e, int m) {
  const int b = m / p.C, c = m - b * p.C;
  return b * p.sxb + e * p.sxe + c * p.sxc;
}

__device__ __forceinline__ long long out_row(const Params& p, int e, int m) {
  const int b = m / p.C, c = m - b * p.C;
  return ((static_cast<long long>(b) * p.E + e) * p.C + c) * p.F;
}

// ===========================================================================
// bf16: shared by both kernels
// ===========================================================================

constexpr int TK = 64;               // depths a k-tile: one 128-byte row
constexpr int BOX = 64 * TK * 2;     // a 64 x 64 bf16 box, 8 KB
constexpr int KSTEPS = TK / 16;      // wgmma k16 steps a k-tile

__device__ __forceinline__ void named_sync(int id, int n) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(n) : "memory");
}

// ===========================================================================
// bf16, wide: persistent wgmma GEMM fed by TMA
// ===========================================================================

constexpr int WD_BN = 256;                   // output columns a tile
constexpr int WD_WBOXES = WD_BN / 64;        // w boxes a stage
constexpr int WD_STAGES = 3;
constexpr int WD_STAGE = 2 * BOX + WD_WBOXES * BOX;  // x halves + w: 48 KB
constexpr int WD_OUT = WD_WBOXES * BOX;      // one group's staged out, 32 KB
constexpr int WD_SMEM_OUT = WD_STAGES * WD_STAGE;
constexpr int WD_SMEM_BARS = WD_SMEM_OUT + 2 * WD_OUT;
constexpr int WD_SMEM = WD_SMEM_BARS + 2 * WD_STAGES * 8 + 1024;  // + align
constexpr int WD_THREADS = 384;  // producer group + two consumer groups
constexpr int WD_CONSUMER_WARPS = 8;
// setmaxnreg moves registers only within the block's own allocation:
// 384 threads launched at 168 (65536 / 384, rounded down to 8)
constexpr int WD_PRODUCER_REGS = 40;
constexpr int WD_CONSUMER_REGS = 232;
static_assert(WD_PRODUCER_REGS * 128 + WD_CONSUMER_REGS * 256 ==
                  168 * WD_THREADS,
              "register split");
static_assert(WD_SMEM <= 232448, "shared memory");

struct WideParams {
  CUtensorMap x, w, o;
  int E, D, F;
  int mc;      // half-tiles a batch row: ceil(C / 64)
  int halves;  // half-tiles an expert: B * mc
  int mt, nt;  // 128-row and 256-column tiles an expert
  int items;   // E * mt * nt
};

struct WideItem {
  int e, n0;
  int b[2], c0[2];
  bool valid[2];
  int nw;  // w boxes inside F
};

__device__ __forceinline__ WideItem wide_item(const WideParams& p, int it) {
  WideItem w;
  w.e = it / (p.mt * p.nt);
  const int r = it - w.e * p.mt * p.nt;
  const int m = r / p.nt;
  w.n0 = (r - m * p.nt) * WD_BN;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int idx = 2 * m + h;
    w.valid[h] = idx < p.halves;
    w.b[h] = idx / p.mc;
    w.c0[h] = (idx - w.b[h] * p.mc) * 64;
  }
  const int left = (p.F - w.n0 + 63) / 64;
  w.nw = left < WD_WBOXES ? left : WD_WBOXES;
  return w;
}

__global__ void __launch_bounds__(WD_THREADS, 1)
    gmm_wide_kernel(const __grid_constant__ WideParams p) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem =
      smem_raw + ((1024 - (hopper::smem_addr(smem_raw) & 1023)) & 1023);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + WD_SMEM_BARS);
  uint64_t* empty = full + WD_STAGES;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int nk = (p.D + TK - 1) / TK;

  if (threadIdx.x == 0) {
    for (int s = 0; s < WD_STAGES; ++s) {
      hopper::mbar_init(&full[s], 1);                    // the producer
      hopper::mbar_init(&empty[s], WD_CONSUMER_WARPS);   // a lane a warp
    }
    hopper::fence_barrier_init();
  }
  __syncthreads();

  if (warp < 4) {
    // ---- producer: one thread issues every load ------------------------
    hopper::regs_dealloc<WD_PRODUCER_REGS>();
    if (threadIdx.x != 0) return;
    hopper::prefetch_tensormap(&p.x);
    hopper::prefetch_tensormap(&p.w);
    int stage = 0;
    uint32_t phase = 0;
    for (int it = blockIdx.x; it < p.items; it += gridDim.x) {
      const WideItem w = wide_item(p, it);
      const uint32_t bytes =
          (int(w.valid[0]) + int(w.valid[1])) * BOX + w.nw * BOX;
      for (int kt = 0; kt < nk; ++kt) {
        hopper::mbar_wait(&empty[stage], phase ^ 1);
        unsigned char* buf = smem + stage * WD_STAGE;
        hopper::mbar_arrive_expect_tx(&full[stage], bytes);
        const int k0 = kt * TK;
#pragma unroll
        for (int h = 0; h < 2; ++h)
          if (w.valid[h])
            hopper::tma_load_4d(buf + h * BOX, &p.x, &full[stage], k0,
                                w.c0[h], w.e, w.b[h]);
        for (int a = 0; a < w.nw; ++a)
          hopper::tma_load_4d(buf + (2 + a) * BOX, &p.w, &full[stage],
                              w.n0 + 64 * a, k0, w.e, 0);
        if (++stage == WD_STAGES) {
          stage = 0;
          phase ^= 1;
        }
      }
    }
    return;
  }

  // ---- consumers: 64 rows (one half-tile) a warpgroup ------------------
  hopper::regs_alloc<WD_CONSUMER_REGS>();
  const int cg = warp / 4 - 1;              // consumer group 0 or 1
  const int row0 = (warp % 4) * 16 + (lane / 4);  // and row0 + 8
  const int tq = lane % 4;
  const bool leader = threadIdx.x % 128 == 0;
  unsigned char* out_s = smem + WD_SMEM_OUT + cg * WD_OUT;
  int stage = 0;
  uint32_t phase = 0;
  bool stored = false;  // a TMA store may still read out_s
  float acc[WD_BN / 2];
  for (int it = blockIdx.x; it < p.items; it += gridDim.x) {
    const WideItem w = wide_item(p, it);
    if (!w.valid[cg]) {
      // no rows for this group: keep step with the ring
      for (int kt = 0; kt < nk; ++kt) {
        hopper::mbar_wait(&full[stage], phase);
        if (lane == 0) hopper::mbar_arrive(&empty[stage]);
        if (++stage == WD_STAGES) {
          stage = 0;
          phase ^= 1;
        }
      }
      continue;
    }
    int prev = 0;
    for (int kt = 0; kt < nk; ++kt) {
      hopper::mbar_wait(&full[stage], phase);
      const unsigned char* buf = smem + stage * WD_STAGE;
      hopper::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < KSTEPS; ++kk)
        hopper::wgmma_ss<WD_BN, 0, 1>(
            acc, hopper::smem_desc(buf + cg * BOX + kk * 32, 128),
            hopper::smem_desc_mn128(buf + 2 * BOX + kk * 16 * 128, BOX),
            kt > 0 || kk > 0);
      hopper::wgmma_commit();
      hopper::wgmma_wait<1>();  // tile kt-1's products are done
      if (kt > 0 && lane == 0) hopper::mbar_arrive(&empty[prev]);
      prev = stage;
      if (++stage == WD_STAGES) {
        stage = 0;
        phase ^= 1;
      }
    }
    hopper::wgmma_wait<0>();
    hopper::fence_regs(acc);
    if (lane == 0) hopper::mbar_arrive(&empty[prev]);

    // out: rounded once, staged as four swizzled 64 x 64 boxes, stored by
    // TMA (rows past C and columns past F are left out)
    if (leader && stored) hopper::bulk_wait_read();
    named_sync(1 + cg, 128);
#pragma unroll
    for (int j = 0; j < WD_BN / 8; ++j)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = row0 + 8 * h;
        const uint32_t off = (j / 8) * BOX + r * 128 +
                             (((j % 8) ^ (r % 8)) * 16) + 4 * tq;
        *reinterpret_cast<__nv_bfloat162*>(out_s + off) =
            __floats2bfloat162_rn(acc[4 * j + 2 * h], acc[4 * j + 2 * h + 1]);
      }
    hopper::fence_proxy_async();
    named_sync(1 + cg, 128);
    if (leader) {
      for (int a = 0; a < w.nw; ++a)
        hopper::tma_store_4d(&p.o, out_s + a * BOX, w.n0 + 64 * a,
                             w.c0[cg], w.e, w.b[cg]);
      hopper::bulk_commit();
      stored = true;
    }
  }
  if (leader) hopper::bulk_wait();
}

// ===========================================================================
// bf16, narrow: weights as wgmma's A, the few rows as its N
// ===========================================================================

constexpr int NR_STAGES = 8;
constexpr int NR_THREADS = 128;  // one warpgroup

struct NarrowParams {
  CUtensorMap x, w;
  __nv_bfloat16* o;
  int E, C, D, F;
  int gpr;    // 8-row groups a batch row: ceil(C / 8)
  int nf;     // 64-column slices of F
  int items;  // E * nf
};

template <int N>
struct NarrowSmem {
  static constexpr int STAGE = BOX + N * TK * 2;  // w tile + N x rows
  static constexpr int BARS = NR_STAGES * STAGE;
  static constexpr int BYTES = BARS + NR_STAGES * 8 + 1024;  // + align
};

template <int N>
__global__ void __launch_bounds__(NR_THREADS)
    gmm_narrow_kernel(const __grid_constant__ NarrowParams p) {
  using L = NarrowSmem<N>;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem =
      smem_raw + ((1024 - (hopper::smem_addr(smem_raw) & 1023)) & 1023);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + L::BARS);
  const int tid = threadIdx.x;
  const int nk = (p.D + TK - 1) / TK;
  // this block's items are blockIdx.x + i * gridDim.x; its k-tiles are
  // numbered across them, so the ring runs on from one item to the next
  const int my_items = (p.items - blockIdx.x + gridDim.x - 1) / gridDim.x;
  const int n_tiles = my_items * nk;

  if (tid == 0) {
    for (int s = 0; s < NR_STAGES; ++s) hopper::mbar_init(&full[s], 1);
    hopper::fence_barrier_init();
  }
  __syncthreads();

  // tile q into stage q % NR_STAGES: the w box (64 depths x 64 columns,
  // M-major) and one 8-row x box a group
  auto issue = [&](int q) {
    const int s = q % NR_STAGES;
    const int it = blockIdx.x + (q / nk) * gridDim.x;
    const int e = it / p.nf, n0 = (it - e * p.nf) * 64;
    const int k0 = (q % nk) * TK;
    unsigned char* buf = smem + s * L::STAGE;
    hopper::mbar_arrive_expect_tx(&full[s], L::STAGE);
    hopper::tma_load_4d(buf, &p.w, &full[s], n0, k0, e, 0);
#pragma unroll
    for (int g = 0; g < N / 8; ++g) {
      const int b = g / p.gpr;
      hopper::tma_load_4d(buf + BOX + g * 1024, &p.x, &full[s], k0,
                          (g - b * p.gpr) * 8, e, b);
    }
  };
  if (tid == 0) {
    hopper::prefetch_tensormap(&p.x);
    hopper::prefetch_tensormap(&p.w);
    for (int q = 0; q < n_tiles && q < NR_STAGES; ++q) issue(q);
  }

  const int col0 = (tid / 32) * 16 + (tid % 32) / 4, tq = tid % 4;
  const int rows_b = 8 * p.gpr;  // rows a batch row holds in N
  int q = 0;
  for (int it = blockIdx.x; it < p.items; it += gridDim.x) {
    const int e = it / p.nf, n0 = (it - e * p.nf) * 64;
    float acc[N / 2];
    for (int kt = 0; kt < nk; ++kt, ++q) {
      const int s = q % NR_STAGES;
      hopper::mbar_wait(&full[s], (q / NR_STAGES) & 1);
      const unsigned char* buf = smem + s * L::STAGE;
      hopper::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < KSTEPS; ++kk)
        hopper::wgmma_ss<N, 1, 0>(
            acc, hopper::smem_desc(buf + kk * 16 * 128, 128),
            hopper::smem_desc(buf + BOX + kk * 32, 128), kt > 0 || kk > 0);
      hopper::wgmma_commit();
      hopper::wgmma_wait<0>();
      hopper::fence_regs(acc);
      if (q + NR_STAGES < n_tiles) {
        __syncthreads();  // every warp is done with stage s
        if (tid == 0) issue(q + NR_STAGES);
      }
    }
    // out^T fragments: thread holds columns col0 and col0 + 8 of rows
    // 8j + 2tq and + 1; rows past C (padding of a batch row) are dropped
#pragma unroll
    for (int j = 0; j < N / 8; ++j)
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int row = 8 * j + 2 * tq + r;
        const int b = row / rows_b, c = row - b * rows_b;
        if (c >= p.C) continue;
        __nv_bfloat16* orow =
            p.o + ((static_cast<long long>(b) * p.E + e) * p.C + c) * p.F +
            n0;
#pragma unroll
        for (int h = 0; h < 2; ++h)
          if (n0 + col0 + 8 * h < p.F)
            orow[col0 + 8 * h] = __float2bfloat16_rn(acc[4 * j + 2 * h + r]);
      }
  }
}

// ===========================================================================
// bf16, narrow pair: 72 to 256 rows, a cluster of two blocks shares x
// ===========================================================================

// A block is the wide kernel's: a producer group and two consumer groups
// (WD_THREADS, setmaxnreg WD_PRODUCER_REGS / WD_CONSUMER_REGS).
constexpr int NP_CLUSTER = 2;     // blocks a cluster, on adjacent columns
constexpr int NP_COLS = 128;      // output columns a block, 64 a consumer group
constexpr int NP_SPAN = NP_CLUSTER * NP_COLS;  // columns a cluster's item
constexpr int NP_RING = 200 * 1024;  // shared memory for the ring

struct PairParams {
  CUtensorMap x, w;
  __nv_bfloat16* o;
  int B, E, C, D, F;
  int rows_b;        // rows a batch row holds in N: 8 * ceil(C / 8)
  int nf;            // NP_SPAN-column slices of F
  int items;         // E * nf, one a cluster at a time
  uint32_t x_bytes;  // an expert's x box of one k-tile: B * rows_b rows
};

template <int N>
struct PairSmem {
  static constexpr int X = N * TK * 2;        // the expert's rows, N x 64
  static constexpr int STAGE = X + 2 * BOX;   // + a weight tile a group
  static constexpr int STAGES = NP_RING / STAGE;  // 6, 5 or 4
  static constexpr int BARS = STAGES * STAGE;
  static constexpr int BYTES = BARS + 2 * STAGES * 8 + 1024;  // + align
};

template <int N>
__global__ void __cluster_dims__(NP_CLUSTER, 1, 1)
    __launch_bounds__(WD_THREADS, 1)
    gmm_narrow_kernel_pair(const __grid_constant__ PairParams p) {
  using L = PairSmem<N>;
  static_assert(L::BYTES <= 232448, "shared memory");
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem =
      smem_raw + ((1024 - (hopper::smem_addr(smem_raw) & 1023)) & 1023);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + L::BARS);
  uint64_t* empty = full + L::STAGES;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const uint32_t rank = hopper::cluster_rank();
  const int first = hopper::cluster_id_x();
  const int step = hopper::cluster_count_x();
  const int nk = (p.D + TK - 1) / TK;

  if (threadIdx.x == 0) {
    for (int s = 0; s < L::STAGES; ++s) {
      hopper::mbar_init(&full[s], 1);  // the producer
      // rank 0's x lands in both blocks: its stages wait for both
      hopper::mbar_init(&empty[s], rank == 0
                                       ? NP_CLUSTER * WD_CONSUMER_WARPS
                                       : WD_CONSUMER_WARPS);
    }
    hopper::fence_barrier_init();
  }
  hopper::cluster_sync();  // the peer's barriers exist before any arrives

  if (warp < 4) {
    // ---- producer: one thread issues every load ------------------------
    hopper::regs_dealloc<WD_PRODUCER_REGS>();
    if (threadIdx.x == 0) {
      hopper::prefetch_tensormap(&p.x);
      hopper::prefetch_tensormap(&p.w);
      int stage = 0;
      uint32_t phase = 0;
      for (int it = first; it < p.items; it += step) {
        const int e = it / p.nf;
        const int n0 = (it - e * p.nf) * NP_SPAN + rank * NP_COLS;
        const int left = (p.F - n0 + 63) / 64;  // w boxes inside F
        const int nw = n0 >= p.F ? 0 : (left < 2 ? left : 2);
        const uint32_t bytes = p.x_bytes + nw * BOX;
        for (int kt = 0; kt < nk; ++kt) {
          hopper::mbar_wait(&empty[stage], phase ^ 1);
          unsigned char* buf = smem + stage * L::STAGE;
          hopper::mbar_arrive_expect_tx(&full[stage], bytes);
          const int k0 = kt * TK;
          if (rank == 0)
            hopper::tma_load_4d_multicast(buf, &p.x, &full[stage], k0, 0, e,
                                          0, (1u << NP_CLUSTER) - 1);
          for (int a = 0; a < nw; ++a)
            hopper::tma_load_4d(buf + L::X + a * BOX, &p.w, &full[stage],
                                n0 + 64 * a, k0, e, 0);
          if (++stage == L::STAGES) {
            stage = 0;
            phase ^= 1;
          }
        }
      }
    }
  } else {
    // ---- consumers: 64 columns a warpgroup, all N rows -----------------
    hopper::regs_alloc<WD_CONSUMER_REGS>();
    const int cg = warp / 4 - 1;  // consumer group 0 or 1
    const int col0 = (warp % 4) * 16 + lane / 4, tq = lane % 4;
    // a stage is free once this block's warps and, for rank 0's, the
    // peer's warps are done with it
    auto release = [&](int s) {
      if (lane != 0) return;
      hopper::mbar_arrive(&empty[s]);
      if (rank != 0) hopper::mbar_arrive_cluster(&empty[s], 0);
    };
    int stage = 0;
    uint32_t phase = 0;
    for (int it = first; it < p.items; it += step) {
      const int e = it / p.nf;
      const int n0 = (it - e * p.nf) * NP_SPAN + rank * NP_COLS + cg * 64;
      float acc[N / 2];
      int prev = 0;
      for (int kt = 0; kt < nk; ++kt) {
        hopper::mbar_wait(&full[stage], phase);
        const unsigned char* buf = smem + stage * L::STAGE;
        const unsigned char* wt = buf + L::X + cg * BOX;
        hopper::wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < KSTEPS; ++kk)
          hopper::wgmma_ss<N, 1, 0>(
              acc, hopper::smem_desc(wt + kk * 16 * 128, 128),
              hopper::smem_desc(buf + kk * 32, 128), kt > 0 || kk > 0);
        hopper::wgmma_commit();
        hopper::wgmma_wait<1>();  // tile kt-1's products are done
        if (kt > 0) release(prev);
        prev = stage;
        if (++stage == L::STAGES) {
          stage = 0;
          phase ^= 1;
        }
      }
      hopper::wgmma_wait<0>();
      hopper::fence_regs(acc);
      release(prev);
      // out^T fragments: thread holds columns col0 and col0 + 8 of rows
      // 8j + 2tq and + 1; rows past C in a batch row, rows past the last
      // batch row and columns past F are dropped
#pragma unroll
      for (int j = 0; j < N / 8; ++j)
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const int row = 8 * j + 2 * tq + r;
          const int b = row / p.rows_b, c = row - b * p.rows_b;
          if (b >= p.B || c >= p.C) continue;
          __nv_bfloat16* orow =
              p.o + ((static_cast<long long>(b) * p.E + e) * p.C + c) * p.F +
              n0;
#pragma unroll
          for (int h = 0; h < 2; ++h)
            if (n0 + col0 + 8 * h < p.F)
              orow[col0 + 8 * h] = __float2bfloat16_rn(acc[4 * j + 2 * h + r]);
        }
    }
  }
  // no block leaves while its peer may still write to it or arrive on it
  hopper::cluster_sync();
}

// ===========================================================================
// f32: CUDA cores
// ===========================================================================

constexpr int NT = 256;    // 16 x 16 threads, 4 x 4 outputs each
constexpr int F_BK = 16;   // depth of one staged k-tile

__global__ void __launch_bounds__(NT) gmm_f32_kernel(const Params p) {
  __shared__ float Xt[F_BK][BM + 4];  // x tile, transposed (k-major)
  __shared__ float Wsm[F_BK][BN];

  const int tid = threadIdx.x, ty = tid / 16, tx = tid % 16;
  const int e = blockIdx.z;
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  const int M = p.B * p.C;
  const float* xg = static_cast<const float*>(p.x);
  const float* wg = static_cast<const float*>(p.w) + e * p.swe;

  // Copy duty: x rows ty + 16 i at depth tx; w depths tid / 64 + 4 i at
  // column tid % 64.  Thread (ty, tx) computes rows ty + 16 i, columns
  // tx + 16 j.
  const float* xrow[4];
  bool xok[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int m = m0 + ty + 16 * i;
    xok[i] = m < M;
    xrow[i] = xg + (xok[i] ? x_row(p, e, m) : 0);
  }
  const int wn = tid % 64;
  const bool wcol = n0 + wn < p.F;

  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  for (int k0 = 0; k0 < p.D; k0 += F_BK) {
    const int k = k0 + tx;
#pragma unroll
    for (int i = 0; i < 4; ++i)
      Xt[tx][ty + 16 * i] = (xok[i] && k < p.D) ? xrow[i][k] : 0.f;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int kw = tid / 64 + 4 * i;
      Wsm[kw][wn] = (wcol && k0 + kw < p.D)
                        ? wg[(k0 + kw) * p.swd + n0 + wn]
                        : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < F_BK; ++kk) {
      float a[4], b[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = Xt[kk][ty + 16 * i];
#pragma unroll
      for (int j = 0; j < 4; ++j) b[j] = Wsm[kk][tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }

  float* og = static_cast<float*>(p.o);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int m = m0 + ty + 16 * i;
    if (m >= M) continue;
    float* orow = og + out_row(p, e, m);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int n = n0 + tx + 16 * j;
      if (n < p.F) orow[n] = acc[i][j];
    }
  }
}

// Returned when the driver refuses a tensor map (or lacks the encoder).
constexpr int ERR_TENSOR_MAP = -1;

// What a launch asks of the runtime that does not change: the kernel's
// shared-memory limit set, its blocks an SM and the device's SM count,
// each asked once a device (a launch costs host time on the serving path).
constexpr int MAX_DEVICES = 64;
struct LaunchInfo {
  bool ready;
  int sms, resident;  // blocks an SM holds at once (clusters: the device)
};

// For a kernel launched in clusters of `cluster` blocks, `resident` is the
// clusters the whole device holds at once.
template <typename Kernel>
cudaError_t launch_info(Kernel kernel, int threads, int bytes,
                        LaunchInfo (&cache)[MAX_DEVICES], LaunchInfo* out,
                        int cluster = 1) {
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return err;
  LaunchInfo fresh{};
  LaunchInfo& info = device < MAX_DEVICES ? cache[device] : fresh;
  if (!info.ready) {
    err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (err == cudaSuccess)
      err = cudaDeviceGetAttribute(&info.sms, cudaDevAttrMultiProcessorCount,
                                   device);
    if (err == cudaSuccess && cluster == 1)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&info.resident,
                                                          kernel, threads,
                                                          bytes);
    if (err == cudaSuccess && cluster > 1) {
      cudaLaunchConfig_t config{};
      config.gridDim = dim3(info.sms / cluster * cluster);
      config.blockDim = dim3(threads);
      config.dynamicSmemBytes = bytes;
      err = cudaOccupancyMaxActiveClusters(&info.resident, kernel, &config);
    }
    if (err != cudaSuccess) return err;
    info.ready = true;
  }
  *out = info;
  return cudaSuccess;
}

// x (B,E,C,D) as a 4-d map, innermost first: (D, C, E, B), read in boxes
// of one k-tile x `rows` x one expert x `batch`.
bool encode_x(CUtensorMap* map, const Params& a, int rows, int batch = 1) {
  const long long dims[4] = {a.D, a.C, a.E, a.B};
  const long long strides[3] = {a.sxc, a.sxe, a.sxb};
  return hopper::encode_bf16_4d(map, a.x, dims, strides, TK, rows, 1, batch);
}

cudaError_t launch_wide(const Params& a, const CUtensorMap& wmap,
                        cudaStream_t stream, int* refused) {
  WideParams p{};
  // out (B,E,C,F) contiguous, as (F, C, E, B)
  const long long odims[4] = {a.F, a.C, a.E, a.B};
  const long long ostr[3] = {a.F, static_cast<long long>(a.C) * a.F,
                             static_cast<long long>(a.E) * a.C * a.F};
  if (!encode_x(&p.x, a, 64) ||
      !hopper::encode_bf16_4d(&p.o, a.o, odims, ostr, 64, 64)) {
    *refused = 1;
    return cudaSuccess;
  }
  p.w = wmap;
  p.E = a.E;
  p.D = a.D;
  p.F = a.F;
  p.mc = (a.C + 63) / 64;
  p.halves = a.B * p.mc;
  p.mt = (p.halves + 1) / 2;
  p.nt = (a.F + WD_BN - 1) / WD_BN;
  p.items = a.E * p.mt * p.nt;
  static LaunchInfo cache[MAX_DEVICES];
  LaunchInfo info;
  const cudaError_t err =
      launch_info(gmm_wide_kernel, WD_THREADS, WD_SMEM, cache, &info);
  if (err != cudaSuccess) return err;
  // one persistent block an SM, or one a tile if there are fewer
  const int grid = p.items < info.sms ? p.items : info.sms;
  gmm_wide_kernel<<<grid, WD_THREADS, WD_SMEM, stream>>>(p);
  return cudaGetLastError();
}

template <int N>
cudaError_t launch_narrow(const NarrowParams& p, cudaStream_t stream) {
  constexpr int bytes = NarrowSmem<N>::BYTES;
  static LaunchInfo cache[MAX_DEVICES];
  LaunchInfo info;
  const cudaError_t err = launch_info(gmm_narrow_kernel<N>, NR_THREADS,
                                      bytes, cache, &info);
  if (err != cudaSuccess) return err;
  // every block resident at once, each walking the same number of items
  // (uneven shares left the last blocks streaming alone)
  const int slots = info.sms * (info.resident > 0 ? info.resident : 1);
  const int per = (p.items + slots - 1) / slots;
  const int grid = (p.items + per - 1) / per;
  gmm_narrow_kernel<N><<<grid, NR_THREADS, bytes, stream>>>(p);
  return cudaGetLastError();
}

template <int N>
cudaError_t launch_pair(const PairParams& p, cudaStream_t stream) {
  constexpr int bytes = PairSmem<N>::BYTES;
  static LaunchInfo cache[MAX_DEVICES];
  LaunchInfo info;
  const cudaError_t err = launch_info(gmm_narrow_kernel_pair<N>, WD_THREADS,
                                      bytes, cache, &info, NP_CLUSTER);
  if (err != cudaSuccess) return err;
  // every cluster resident at once, each walking the same number of items
  const int slots = info.resident > 0 ? info.resident : info.sms / NP_CLUSTER;
  const int per = (p.items + slots - 1) / slots;
  const int clusters = (p.items + per - 1) / per;
  gmm_narrow_kernel_pair<N>
      <<<clusters * NP_CLUSTER, WD_THREADS, bytes, stream>>>(p);
  return cudaGetLastError();
}

// 72 to 256 rows an expert: the pair kernel at the next of N = 128, 192
// and 256; the rows past the x box's are never written and dropped.
cudaError_t launch_pair_any(const Params& a, const CUtensorMap& wmap,
                            cudaStream_t stream, int* refused) {
  PairParams p{};
  p.rows_b = (a.C + 7) / 8 * 8;
  if (!encode_x(&p.x, a, p.rows_b, a.B)) {
    *refused = 1;
    return cudaSuccess;
  }
  p.w = wmap;
  p.o = static_cast<__nv_bfloat16*>(a.o);
  p.B = a.B;
  p.E = a.E;
  p.C = a.C;
  p.D = a.D;
  p.F = a.F;
  p.nf = (a.F + NP_SPAN - 1) / NP_SPAN;
  p.items = a.E * p.nf;
  const int n = a.B * p.rows_b;
  p.x_bytes = static_cast<uint32_t>(n) * TK * 2;
  if (n <= 128) return launch_pair<128>(p, stream);
  if (n <= 192) return launch_pair<192>(p, stream);
  if (n <= 256) return launch_pair<256>(p, stream);
  return cudaErrorInvalidValue;
}

cudaError_t launch_narrow_any(const Params& a, const CUtensorMap& wmap,
                              cudaStream_t stream, int* refused) {
  if (a.B * ((a.C + 7) / 8) * 8 > 64)
    return launch_pair_any(a, wmap, stream, refused);
  NarrowParams p{};
  if (!encode_x(&p.x, a, 8)) {
    *refused = 1;
    return cudaSuccess;
  }
  p.w = wmap;
  p.o = static_cast<__nv_bfloat16*>(a.o);
  p.E = a.E;
  p.C = a.C;
  p.D = a.D;
  p.F = a.F;
  p.gpr = (a.C + 7) / 8;
  p.nf = (a.F + 63) / 64;
  p.items = a.E * p.nf;
  switch (a.B * p.gpr * 8) {
    case 8: return launch_narrow<8>(p, stream);
    case 16: return launch_narrow<16>(p, stream);
    case 24: return launch_narrow<24>(p, stream);
    case 32: return launch_narrow<32>(p, stream);
    case 40: return launch_narrow<40>(p, stream);
    case 48: return launch_narrow<48>(p, stream);
    case 56: return launch_narrow<56>(p, stream);
    case 64: return launch_narrow<64>(p, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// Plain C interface, loaded with ctypes.

// Encodes the tensor map of w (E,D,F), F contiguous, read in 64 x 64
// boxes by both bf16 kernels, into the 128 bytes at `map`: 0, or
// ERR_TENSOR_MAP if the driver refuses it.  The map holds only w's
// address, its dims and strides and the box, so a caller may keep it for
// any w with the same values.
extern "C" int moe_gmm_encode_weights(void* map, const void* w, int E, int D,
                                      int F, long long swe, long long swd) {
  // (F, D, E, 1): the last dim only makes the map 4-d
  const long long dims[4] = {F, D, E, 1};
  const long long strides[3] = {swd, swe, swe * E};
  CUtensorMap m;
  if (!hopper::encode_bf16_4d(&m, w, dims, strides, 64, TK))
    return ERR_TENSOR_MAP;
  std::memcpy(map, &m, sizeof(m));
  return 0;
}

// Launches one kernel: `kernel` 0 is f32, 1 the bf16 wide kernel, 2 the
// bf16 narrow kernel (at most 256 rows an expert); `wmap` is w's map from
// moe_gmm_encode_weights (bf16 only).  Returns 0
// when the launch was accepted, else a cudaError_t or ERR_TENSOR_MAP.
// The caller has checked shapes, strides, alignment and dtypes.
extern "C" int moe_gmm(const void* x, const void* w, void* o, int B, int E,
                       int C, int D, int F, long long sxb, long long sxe,
                       long long sxc, long long swe, long long swd,
                       int kernel, const void* wmap,
                       void* stream) {
  Params p;
  p.x = x;
  p.w = w;
  p.o = o;
  p.B = B;
  p.E = E;
  p.C = C;
  p.D = D;
  p.F = F;
  p.sxb = sxb;
  p.sxe = sxe;
  p.sxc = sxc;
  p.swe = swe;
  p.swd = swd;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (kernel == 0) {
    const dim3 grid((F + BN - 1) / BN, (B * C + BM - 1) / BM, E);
    gmm_f32_kernel<<<grid, NT, 0, st>>>(p);
    return cudaGetLastError();
  }
  if (wmap == nullptr) return cudaErrorInvalidValue;
  CUtensorMap wm;
  std::memcpy(&wm, wmap, sizeof(wm));
  int refused = 0;
  cudaError_t err = cudaErrorInvalidValue;
  if (kernel == 1)
    err = launch_wide(p, wm, st, &refused);
  else if (kernel == 2)
    err = launch_narrow_any(p, wm, st, &refused);
  if (refused) return ERR_TENSOR_MAP;
  return err;
}

extern "C" const char* moe_gmm_error_string(int err) {
  if (err == ERR_TENSOR_MAP)
    return "cuTensorMapEncodeTiled refused a tensor map of x, w or out "
           "(or the driver has no such entry point)";
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
