// Mamba2 chunked SSD scan for Hopper (sm_90a), written by hand.
//
// Replaces the Pallas TPU kernel
//   src/repro/kernels/mamba2_ssd/kernel.py::ssd_fwd  (body _ssd_kernel)
// and computes what it computes, plus an initial state.  For each batch
// row b and head h, chunk by chunk, with cum = cumsum(a) inside the chunk:
//
//   y      = (L o C B^T) X + (C state^T) o exp(cum)
//            L[i,j] = exp(cum_i - cum_j) for i >= j, else 0
//   state' = exp(cum_last) state + (X o exp(cum_last - cum))^T B
//
// Layout: xdt (B,S,H,P) and B, C (B,S,N) with any strides on the leading
// dims and the last dim contiguous, read in place (no copy folds (B,H)
// into rows); a (B,S,H) f32 with any strides; init (B,H,P,N) f32
// contiguous or null; y (B,S,H,P) contiguous in xdt's dtype; the final
// state (B,H,P,N) f32 contiguous.  P is a multiple of 16, N one of 16, 32,
// 64, 128; strides are multiples of 8 elements and base pointers 16-byte
// aligned (the wrapper checks), so rows move in 16-byte chunks.  S may be
// ragged: rows past S act as a = 0 and x = B = C = 0 and are not stored.
//
// The Pallas kernel carries the state in VMEM across the grid's
// sequential chunk axis.  Blocks on Hopper run in no order, so here one
// block owns a (b, h, 64 columns of P: the whole head at P 64; 32 or 16
// where P is no multiple of 64) and walks the chunks of 64 rows in a
// loop; the state's rows p depend only on column p of X, so splitting P
// is exact.
//
// What bounds it on an H100: at zamba2-2.7b's prefill (B 3, S 1024, H 80,
// P 64, N 64, bf16) the reference algorithm's 20.1 GFLOP against 68.6 MB
// of x, y, a, B, C and the state put the bound at the memory rate, ~0.0205
// ms.  The design before this one ran every step of a chunk on one chain
// between two block barriers, 480 blocks of 32 columns: 0.118 ms,
// bound by the latency of that chain (its first batch row alone took 0.76
// of the time of all three).  Taken apart (tools/ssd_probe.py variants),
// its loads, barriers and stores alone took 0.065 ms.
//
// Design (bf16, the served dtype).  Only the state recurrence has to run
// in order: with U_c = (X_c o w_c)^T B_c, state_{c+1} = exp(cum_last)
// state_c + U_c, and the decays, the masked scores M = L o (C B^T), the
// intra-chunk y = M X and U_c depend on no state; y's term
// exp(cum) o (C state_c^T) hangs off the chain and feeds nothing in it.
// So a block's two warpgroups run apart, on mbarriers, with no block
// barrier in the loop:
//   the chain (warps 0 to 3) holds the f32 state as the accumulators of a
//     wgmma m64nNk16 (rows p, one warp a 16 of them), for the whole
//     sequence.  Per chunk: the decays (each warp scans the chunk's 64 a
//     itself, loaded two chunks ahead); the state as bf16 hi + lo into
//     the state slot, the chunk's cum beside it; then state = exp(cum_last) state +
//     (X o w)^T B, two wgmma a k-step with (X o w)^T from registers
//     (ldmatrix, scaled, split into hi + lo) and B from shared memory;
//   the output warps (warps 4 to 7) take chunk c's slot and inputs:
//     y = C (state hi + lo)^T and S = C B^T, wgmma with both operands in
//     shared memory; the slot is freed once the first has read it; the
//     decays L of the scores while they run; y scaled by exp(cum) by rows;
//     M = L o S from S's accumulators, split into hi + lo A fragments;
//     y += M X (two wgmma a k-step); y staged in X's place in the input
//     slot and stored by TMA.
// The chain runs up to RING chunks ahead of the output warps.  X, B and C
// arrive by TMA boxes (rows past S as zeros) in NIN input slots, each
// loaded again once both warpgroups are done with it and its y has left.
// Exponentials are ex2.approx of log2(e)-scaled differences of cum (about
// 2^-22 relative, as expf).
//
// One block a head, not Mamba2's usual split into kernels over (b, h,
// chunk): a split writes every chunk's f32 state to device memory and
// reads it back, 63 MB at this shape and chunk 64, about 190 MB more
// traffic against the 68.6 MB bound.  Nor several heads a block: B and C
// are shared by the heads, but loading them only once a block (tried by
// the probe's nobc) saved 0.002 ms, and the scores, which several heads
// would share, are 4 of a chunk's 28 wgmma.  At B3 that is 240 blocks of
// 256 threads and 91 KB on 132 SMs, two an SM (128 registers a thread):
// 108 SMs hold two heads, 24 one.  Half a head a block (480 blocks, each
// computing all the head's decays and scores) took 0.075 ms.
//
// Times (tools/ssd_probe.py and chip_smoke.py on an NVIDIA H100 80GB
// HBM3 at 700 W, device time, cold L2): 0.0440 to 0.0450 ms at B3, the
// first batch row alone 0.56 to 0.60 of that; the design before it 0.118
// to 0.120 in the same runs.  Taken apart: loads,
// hand-offs and the stores of y alone 0.033 ms; the hi + lo pairs'
// second products and splits 0.008; the scores and M X 0.009; the state
// update 0.007; the decays 0.005.  What is left is the latency of the
// hand-offs and loads around the products (the skeleton moves its bytes
// at about 2 TB/s) more than the products themselves.
//
// Precision: every f32 operand goes into the tensor cores as a bf16 hi +
// lo pair, about 16 mantissa bits: M, the state and X o w.  C B^T of bf16
// inputs is exact products summed in f32.  The state is carried in f32
// and never rounded below it from chunk to chunk.  (Rounding M to bf16
// once moved zamba2's prefill logits by 5.3% of their largest value
// against the plain version, past the 5% allowed.)
//
// * f32: CUDA cores (tensor cores would round to tf32, about 1e-3
//   relative), 256 threads a block, one chain of every step (not served).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>
#include <type_traits>

#include "common/hopper.cuh"

namespace {

constexpr int Q = 64;  // rows per chunk: one wgmma M tile
constexpr unsigned FULL = 0xffffffffu;

// cum of one chunk's 64 decays, by one warp: lane l holds rows 2l and
// 2l + 1 (c0, c1); total is the chunk's sum.
__device__ __forceinline__ void chunk_cum(const float (&v)[2], int lane,
                                          float& c0, float& c1,
                                          float& total) {
  float incl = v[0] + v[1];
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const float t = __shfl_up_sync(FULL, incl, o);
    if (lane >= o) incl += t;
  }
  const float prev = __shfl_up_sync(FULL, incl, 1);
  total = __shfl_sync(FULL, incl, 31);
  c0 = (lane ? prev : 0.f) + v[0];
  c1 = c0 + v[1];
}

// cum, exp(cum_last - cum) and exp(cum) of one chunk's 64 decays, by one
// warp: lane l holds rows 2l and 2l + 1.
__device__ __forceinline__ void chunk_decays(const float (&v)[2], int lane,
                                             float* cum_s, float* w_s,
                                             float* e_s) {
  float c0, c1, total;
  chunk_cum(v, lane, c0, c1, total);
  cum_s[2 * lane] = c0;
  cum_s[2 * lane + 1] = c1;
  w_s[2 * lane] = expf(total - c0);
  w_s[2 * lane + 1] = expf(total - c1);
  e_s[2 * lane] = expf(c0);
  e_s[2 * lane + 1] = expf(c1);
}

// The decays of rows 2 * lane and 2 * lane + 1 of chunk c (0 past S).
__device__ __forceinline__ void load_decays(const float* ag, long long sas,
                                            int S, int c, int lane,
                                            float (&v)[2]) {
#pragma unroll
  for (int k = 0; k < 2; ++k) {
    const int s = c * Q + 2 * lane + k;
    v[k] = s < S ? ag[s * sas] : 0.f;
  }
}

// ===========================================================================
// bf16: the state chain and the output warps on wgmma
// ===========================================================================

constexpr int RING = 1;  // state slots between the chain and the output warps
constexpr int NIN = 3;   // input slots (X, B, C of a chunk)
constexpr int SLACK = 1024;  // shared memory to align the base

constexpr float LOG2E = 1.4426950408889634f;

// 2^x on the special-function unit (relative error about 2^-22, as good
// as expf's for these operands); results below 2^-126 flush to zero
__device__ __forceinline__ float exp2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);  // .x in the low half
  return *reinterpret_cast<uint32_t*>(&v);
}

// (x0, x1) as a bf16 pair and the bf16 pair of what that rounding left:
// hi + lo carries about 16 mantissa bits of each f32 value.
__device__ __forceinline__ void split_bf16(float x0, float x1, uint32_t& hi,
                                           uint32_t& lo) {
  __nv_bfloat162 h = __floats2bfloat162_rn(x0, x1);
  const float2 hf = __bfloat1622float2(h);
  hi = *reinterpret_cast<uint32_t*>(&h);
  lo = pack_bf16(x0 - hf.x, x1 - hf.y);
}

// The bf16 pair v times (w0, w1), in f32, split as above.
__device__ __forceinline__ void scale_split(uint32_t v, float w0, float w1,
                                            uint32_t& hi, uint32_t& lo) {
  const float2 f =
      __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&v));
  split_bf16(f.x * w0, f.y * w1, hi, lo);
}

// Four 8x8 b16 matrices, transposed on the way in: lanes 8i..8i+7 give
// the row addresses of matrix i, register i receives matrix i.
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4],
                                                  const void* smem_ptr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(hopper::smem_addr(smem_ptr)));
}

// Keeps A fragments alive until the wgmma that reads them is done.
__device__ __forceinline__ void keep(uint32_t (&f)[4][4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) asm volatile("" : "+r"(f[i][e])::"memory");
}

// Shared memory of a block, in bytes from a 1024-aligned base, for PB
// columns of P and state dim N.  A tile of rows whose values fill no more
// than one swizzle row (128 bytes, 64 bf16) is one region; B, C and the
// state at N 128 are two regions of 64 columns.  Every region starts
// 1024-aligned and is swizzled by its row width, as TMA writes it.
//   NIN input slots: X [Q][PB] (then the chunk's y, once every warp is
//     done with the slot), B [NR][Q][NSW], C [NR][Q][NSW];
//   RING state slots: the state's hi [NR][PB][NSW] and lo parts;
//   cum [RING][Q] beside them; mbarriers: landed, freed [NIN], full,
//   empty [RING]; and slack to align the base.
template <int PB, int N>
struct Cfg {
  static constexpr int NSW = N < 64 ? N : 64;  // values a region's row
  static constexpr int NR = N / NSW;           // regions
  static constexpr int KS = NSW / 16;          // k-steps over a region
  static constexpr int XB = Q * PB * 2;        // X tile bytes
  static constexpr int RB = Q * NSW * 2;       // a region of B or C
  static constexpr int IN = XB + 2 * NR * RB;  // an input slot
  static constexpr int STILE = (PB * NSW * 2 + 1023) / 1024 * 1024;
  static constexpr int SLOT = 2 * NR * STILE;
  static constexpr int CUM = NIN * IN + RING * SLOT;
  static constexpr int BARS = CUM + RING * Q * 4;
  static constexpr int BYTES = BARS + 8 * (2 * NIN + 2 * RING) + SLACK;
  static constexpr int NT = 256;
  // blocks an SM holds: 228 KB, less 1 KB the system keeps for each
  static constexpr int FIT = 233472 / (BYTES + 1024);
  static constexpr int MIN_BLOCKS = FIT >= 2 ? 2 : 1;
  static_assert(BYTES <= 232448, "shared memory of one block");
};

struct TmaParams {
  // x and y boxes of PB columns by Q rows, 4-d maps over (P, S, H, B); B
  // and C boxes of NSW columns by Q rows, over (N, S, B, 1)
  CUtensorMap xmap, ymap, bmap, cmap;
  const float* a;
  const float* init;  // null: zero initial state
  float* state;
  int S, H, P;
  long long sab, sas, sah;  // a strides
};

template <int PB, int N>
__global__ void __launch_bounds__(Cfg<PB, N>::NT, Cfg<PB, N>::MIN_BLOCKS)
    ssd_bf16_kernel(const __grid_constant__ TmaParams p) {
  using C = Cfg<PB, N>;
  constexpr int NSW = C::NSW, NR = C::NR, KS = C::KS, SW = NSW * 2;

  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem =
      smem_raw + ((1024 - (hopper::smem_addr(smem_raw) & 1023)) & 1023);
  unsigned char* inputs = smem;             // NIN input slots
  unsigned char* slots = smem + NIN * C::IN;  // RING state slots
  float* cums = reinterpret_cast<float*>(smem + C::CUM);  // [RING][Q]
  uint64_t* landed = reinterpret_cast<uint64_t*>(smem + C::BARS);
  uint64_t* freed = landed + NIN;  // an input slot read by all 8 warps
  uint64_t* full = freed + NIN;    // a state slot written by the chain
  uint64_t* empty = full + RING;   // a state slot read by the output warps

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;    // accumulator row, column pair
  const int lm = lane >> 3, lr = lane & 7;  // ldmatrix matrix, row
  const int p0 = blockIdx.x * PB, h = blockIdx.y, b = blockIdx.z;
  const int nc = (p.S + Q - 1) / Q;

  if (tid == 0) {
    for (int s = 0; s < NIN; ++s) {
      hopper::mbar_init(&landed[s], 1);
      hopper::mbar_init(&freed[s], 8);
    }
    for (int s = 0; s < RING; ++s) {
      hopper::mbar_init(&full[s], 4);
      hopper::mbar_init(&empty[s], 4);
    }
    hopper::fence_barrier_init();
  }
  __syncthreads();

  // chunk c's X, B and C into input slot c % NIN, by thread 128
  auto issue = [&](int c) {
    unsigned char* in = inputs + (c % NIN) * C::IN;
    uint64_t* bar = &landed[c % NIN];
    hopper::mbar_arrive_expect_tx(bar, C::IN);
    hopper::tma_load_4d(in, &p.xmap, bar, p0, c * Q, h, b);
#pragma unroll
    for (int r = 0; r < NR; ++r) {
      hopper::tma_load_4d(in + C::XB + r * C::RB, &p.bmap, bar, r * NSW,
                          c * Q, b, 0);
      hopper::tma_load_4d(in + C::XB + (NR + r) * C::RB, &p.cmap, bar,
                          r * NSW, c * Q, b, 0);
    }
  };
  const bool issuer = tid == 128;
  if (issuer)
    for (int c = 0; c < min(NIN, nc); ++c) issue(c);

  if (warp < 4) {
    // ---------------------------------------------------------------
    // The chain.  Warp w holds rows p = 16 w .. + 16 of the state (all
    // N columns) as wgmma accumulators: st[r][4 j + e] is row 16 w + g +
    // 8 (e / 2), column 64 r + 8 j + 2 t + e % 2.  Rows past PB stay 0.
    // ---------------------------------------------------------------
    const int wr = 16 * warp;
    const bool live = wr < PB;
    const long long st_base =
        (static_cast<long long>(b) * p.H + h) * p.P * N +
        static_cast<long long>(p0) * N;
    float st[NR][NSW / 2];
#pragma unroll
    for (int r = 0; r < NR; ++r)
#pragma unroll
      for (int i = 0; i < NSW / 2; ++i) {
        const int row = wr + g + 8 * ((i >> 1) & 1);
        const int col = r * NSW + 8 * (i >> 2) + 2 * t + (i & 1);
        st[r][i] =
            (live && p.init) ? p.init[st_base + row * N + col] : 0.f;
      }
    const float* ag = p.a + b * p.sab + h * p.sah;
    float v[2], vn[2];  // the decays of chunks c and c + 1
    load_decays(ag, p.sas, p.S, 0, lane, v);
    load_decays(ag, p.sas, p.S, 1, lane, vn);

    for (int c = 0; c < nc; ++c) {
      const int si = c % NIN, ss = c % RING;
      // cum of the chunk, its total; the decays two chunks on loaded
      float c0, c1, total;
      chunk_cum(v, lane, c0, c1, total);
      v[0] = vn[0];
      v[1] = vn[1];
      if (c + 2 < nc) load_decays(ag, p.sas, p.S, c + 2, lane, vn);
      const float dec = exp2_approx(total * LOG2E);
      const float w0 = exp2_approx((total - c0) * LOG2E);
      const float w1 = exp2_approx((total - c1) * LOG2E);

      // the state before chunk c, as bf16 hi + lo, into slot ss; cum
      // beside it
      if (c >= RING) hopper::mbar_wait(&empty[ss], ((c / RING) - 1) & 1);
      unsigned char* slot = slots + ss * C::SLOT;
      if (live) {
#pragma unroll
        for (int r = 0; r < NR; ++r)
#pragma unroll
          for (int j = 0; j < NSW / 8; ++j)
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              const uint32_t off = r * C::STILE +
                                   hopper::swizzled(wr + g + 8 * e,
                                                    (8 * j + 2 * t) * 2, SW);
              split_bf16(st[r][4 * j + 2 * e], st[r][4 * j + 2 * e + 1],
                         *reinterpret_cast<uint32_t*>(slot + off),
                         *reinterpret_cast<uint32_t*>(slot + NR * C::STILE +
                                                      off));
            }
      }
      if (warp == 0)
        reinterpret_cast<float2*>(cums + ss * Q)[lane] = make_float2(c0, c1);
      hopper::fence_proxy_async();
      __syncwarp();
      if (lane == 0) hopper::mbar_arrive(&full[ss]);

      // state = exp(cum_last) state + (X o w)^T B: A[p][j] = X[j][p] w_j,
      // k-step kk's fragments from rows j = 16 kk .. of X, transposed
      hopper::mbar_wait(&landed[si], (c / NIN) & 1);
      const unsigned char* in = inputs + si * C::IN;
      uint32_t ahi[4][4], alo[4][4];
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        // w of columns j = 16 kk + 2 t, + 1 (lane 8 kk + t) and + 8, + 9
        const float wa = __shfl_sync(FULL, w0, 8 * kk + t);
        const float wb = __shfl_sync(FULL, w1, 8 * kk + t);
        const float wc = __shfl_sync(FULL, w0, 8 * kk + t + 4);
        const float wd = __shfl_sync(FULL, w1, 8 * kk + t + 4);
        if (live) {
          uint32_t xa[4];
          ldmatrix_x4_trans(
              xa, in + hopper::swizzled(16 * kk + (lm >> 1) * 8 + lr,
                                        (wr + (lm & 1) * 8) * 2, PB * 2));
          scale_split(xa[0], wa, wb, ahi[kk][0], alo[kk][0]);
          scale_split(xa[1], wa, wb, ahi[kk][1], alo[kk][1]);
          scale_split(xa[2], wc, wd, ahi[kk][2], alo[kk][2]);
          scale_split(xa[3], wc, wd, ahi[kk][3], alo[kk][3]);
        } else {
#pragma unroll
          for (int q = 0; q < 4; ++q) ahi[kk][q] = alo[kk][q] = 0u;
        }
      }
#pragma unroll
      for (int r = 0; r < NR; ++r) {
#pragma unroll
        for (int i = 0; i < NSW / 2; ++i) st[r][i] *= dec;
        hopper::fence_regs(st[r]);
      }
      hopper::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
#pragma unroll
        for (int r = 0; r < NR; ++r) {
          const uint64_t d =
              hopper::smem_desc(in + C::XB + r * C::RB + kk * 16 * SW, SW);
          hopper::wgmma_rs_tb<NSW>(st[r], ahi[kk], d, 1);
          hopper::wgmma_rs_tb<NSW>(st[r], alo[kk], d, 1);
        }
      hopper::wgmma_commit();
      hopper::wgmma_wait<0>();
#pragma unroll
      for (int r = 0; r < NR; ++r) hopper::fence_regs(st[r]);
      keep(ahi);
      keep(alo);
      __syncwarp();
      if (lane == 0) hopper::mbar_arrive(&freed[si]);
    }

    if (live) {
#pragma unroll
      for (int r = 0; r < NR; ++r)
#pragma unroll
        for (int j = 0; j < NSW / 8; ++j)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int row = wr + g + 8 * e, col = r * NSW + 8 * j + 2 * t;
            *reinterpret_cast<float2*>(p.state + st_base + row * N + col) =
                make_float2(st[r][4 * j + 2 * e], st[r][4 * j + 2 * e + 1]);
          }
    }
  } else {
    // ---------------------------------------------------------------
    // The output warps.  Warp 4 + w computes rows i = 16 w .. + 16 of
    // each chunk's y (all PB columns) and of its scores.
    // ---------------------------------------------------------------
    const int wr = 16 * (warp - 4);
    for (int c = 0; c < nc; ++c) {
      const int si = c % NIN, ss = c % RING;
      hopper::mbar_wait(&full[ss], (c / RING) & 1);
      hopper::mbar_wait(&landed[si], (c / NIN) & 1);
      const unsigned char* in = inputs + si * C::IN;
      const unsigned char* bs = in + C::XB;
      const unsigned char* cs = bs + NR * C::RB;
      const unsigned char* slot = slots + ss * C::SLOT;
      const float* cum = cums + ss * Q;

      // y = C (state hi + lo)^T, then S = C B^T; k-steps over N
      float y[PB / 2], s[Q / 2];
      hopper::wgmma_fence();
#pragma unroll
      for (int part = 0; part < 2; ++part)
#pragma unroll
        for (int r = 0; r < NR; ++r)
#pragma unroll
          for (int k = 0; k < KS; ++k)
            hopper::wgmma_ss<PB, 0, 0>(
                y, hopper::smem_desc(cs + r * C::RB + k * 32, SW),
                hopper::smem_desc(
                    slot + (part * NR + r) * C::STILE + k * 32, SW),
                part || r || k);
      hopper::wgmma_commit();
#pragma unroll
      for (int r = 0; r < NR; ++r)
#pragma unroll
        for (int k = 0; k < KS; ++k)
          hopper::wgmma_ss<Q, 0, 0>(
              s, hopper::smem_desc(cs + r * C::RB + k * 32, SW),
              hopper::smem_desc(bs + r * C::RB + k * 32, SW), r || k);
      hopper::wgmma_commit();
      // the last chunk's y has left its input slot: chunk c - 1 + NIN may
      // load there
      if (issuer && c > 0 && c - 1 + NIN < nc) {
        hopper::bulk_wait_read();
        issue(c - 1 + NIN);
      }
      // while they run, L of each score this thread holds (the layout of
      // S's accumulators: element 4 j + 2 e + x is row wr + g + 8 e,
      // column 8 j + 2 t + x); column chunks wholly above the warp's
      // diagonal are 0
      const float ci[2] = {cum[wr + g], cum[wr + g + 8]};
      float L[Q / 2];
#pragma unroll
      for (int j = 0; j < Q / 8; ++j) {
        const float2 cj = reinterpret_cast<const float2*>(cum)[4 * j + t];
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int row = wr + g + 8 * e, col = 8 * j + 2 * t;
          const bool live = 8 * j <= wr + 15;
          L[4 * j + 2 * e] =
              live && col <= row ? exp2_approx((ci[e] - cj.x) * LOG2E) : 0.f;
          L[4 * j + 2 * e + 1] = live && col + 1 <= row
                                     ? exp2_approx((ci[e] - cj.y) * LOG2E)
                                     : 0.f;
        }
      }
      hopper::wgmma_wait<1>();
      hopper::fence_regs(y);
      __syncwarp();
      if (lane == 0) hopper::mbar_arrive(&empty[ss]);  // the slot is read

      // y scaled by exp(cum) of its rows
      const float e0 = exp2_approx(ci[0] * LOG2E);
      const float e1 = exp2_approx(ci[1] * LOG2E);
#pragma unroll
      for (int i = 0; i < PB / 2; ++i) y[i] *= (i & 2) ? e1 : e0;

      // M = L o S as the A fragments of M X, hi + lo: k-step kk takes the
      // accumulator chunks 2 kk and 2 kk + 1 (as flash's P)
      hopper::wgmma_wait<0>();
      hopper::fence_regs(s);
      uint32_t mhi[4][4], mlo[4][4];
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const int i = 4 * (2 * kk + (q >> 1)) + 2 * (q & 1);
          split_bf16(s[i] * L[i], s[i + 1] * L[i + 1], mhi[kk][q],
                     mlo[kk][q]);
        }
      hopper::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        const uint64_t d = hopper::smem_desc(in + kk * 16 * PB * 2, PB * 2);
        hopper::wgmma_rs_tb<PB>(y, mhi[kk], d, 1);
        hopper::wgmma_rs_tb<PB>(y, mlo[kk], d, 1);
      }
      hopper::wgmma_commit();
      hopper::wgmma_wait<0>();
      hopper::fence_regs(y);
      keep(mhi);
      keep(mlo);
      __syncwarp();
      if (lane == 0) hopper::mbar_arrive(&freed[si]);

      // y into X's place once all 8 warps are done with the input slot,
      // swizzled as the y map's boxes, then one TMA store, which leaves
      // out rows past S
      hopper::mbar_wait(&freed[si], (c / NIN) & 1);
      unsigned char* ys = inputs + si * C::IN;
#pragma unroll
      for (int e = 0; e < 2; ++e)
#pragma unroll
        for (int j = 0; j < PB / 8; ++j)
          *reinterpret_cast<__nv_bfloat162*>(
              ys + hopper::swizzled(wr + g + 8 * e, (8 * j + 2 * t) * 2,
                                    PB * 2)) =
              __floats2bfloat162_rn(y[4 * j + 2 * e], y[4 * j + 2 * e + 1]);
      hopper::fence_proxy_async();
      asm volatile("bar.sync 1, 128;\n" ::: "memory");
      if (issuer) {
        hopper::tma_store_4d(&p.ymap, ys, p0, c * Q, h, b);
        hopper::bulk_commit();
      }
    }
    if (issuer) hopper::bulk_wait();  // y written before the block ends
  }
}

// ===========================================================================
// f32: CUDA cores
// ===========================================================================

constexpr int F_NT = 256;

struct Params {
  const void* x;
  const float* a;
  const void* Bm;
  const void* Cm;
  const float* init;  // null: zero initial state
  void* y;
  float* state;
  int B, S, H, P;
  long long sxb, sxs, sxh;  // xdt strides in elements (P contiguous)
  long long sab, sas, sah;  // a strides
  long long sbb, sbs;       // B strides (N contiguous)
  long long scb, scs;       // C strides (N contiguous)
};


template <int PB, int N>
struct F32Smem {
  static constexpr int BST = N + 1;  // B, C and state rows
  static constexpr int MST = Q + 1;  // masked scores rows
  static constexpr int BYTES =
      (Q * PB + 2 * Q * BST + Q * MST + PB * BST + 3 * Q) * 4;
};

template <int PB, int N>
__global__ void __launch_bounds__(F_NT) ssd_f32_kernel(const Params p) {
  constexpr int BST = F32Smem<PB, N>::BST, MST = F32Smem<PB, N>::MST;
  constexpr int SPT = PB * N / F_NT;  // state elements per thread
  constexpr int YC = PB / 4;          // y columns per thread
  static_assert(PB * N % F_NT == 0, "state split");

  extern __shared__ float smem[];
  float* Xs = smem;          // [Q][PB]
  float* Bs = Xs + Q * PB;   // [Q][BST]
  float* Cs = Bs + Q * BST;  // [Q][BST]
  float* Ms = Cs + Q * BST;  // [Q][MST]
  float* St = Ms + Q * MST;  // [PB][BST]
  float* cum_s = St + PB * BST;
  float* w_s = cum_s + Q;
  float* e_s = w_s + Q;

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int p0 = blockIdx.x * PB, h = blockIdx.y, b = blockIdx.z;
  const int nc = (p.S + Q - 1) / Q;
  const float* xg =
      static_cast<const float*>(p.x) + b * p.sxb + h * p.sxh + p0;
  const float* bg = static_cast<const float*>(p.Bm) + b * p.sbb;
  const float* cg = static_cast<const float*>(p.Cm) + b * p.scb;
  const float* ag = p.a + b * p.sab + h * p.sah;
  float* yg = static_cast<float*>(p.y);

  const long long st_base =
      (static_cast<long long>(b) * p.H + h) * p.P * N + p0 * N;
  float st[SPT];
#pragma unroll
  for (int t = 0; t < SPT; ++t) {
    const int idx = tid + F_NT * t;
    st[t] = p.init ? p.init[st_base + idx] : 0.f;  // row idx / N of the tile
    St[(idx / N) * BST + idx % N] = st[t];
  }

  for (int c = 0; c < nc; ++c) {
    const int s0 = c * Q;
    for (int e = tid; e < Q * PB; e += F_NT) {
      const int r = e / PB, col = e % PB;
      Xs[e] = s0 + r < p.S ? xg[(s0 + r) * p.sxs + col] : 0.f;
    }
    for (int e = tid; e < Q * N; e += F_NT) {
      const int r = e / N, n = e % N;
      const bool ok = s0 + r < p.S;
      Bs[r * BST + n] = ok ? bg[(s0 + r) * p.sbs + n] : 0.f;
      Cs[r * BST + n] = ok ? cg[(s0 + r) * p.scs + n] : 0.f;
    }
    if (warp == 0) {
      float v[2];
      load_decays(ag, p.sas, p.S, c, lane, v);
      chunk_decays(v, lane, cum_s, w_s, e_s);
    }
    __syncthreads();

    // M = L o (C B^T): rows ty*4 + ii, columns tx + 16*jj
    const int ty = tid >> 4, tx = tid & 15;
#pragma unroll
    for (int ii = 0; ii < 4; ++ii) {
      const int i = ty * 4 + ii;
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        const int j = tx + 16 * jj;
        float acc = 0.f;
        if (j <= i) {
#pragma unroll 8
          for (int n = 0; n < N; ++n)
            acc = fmaf(Cs[i * BST + n], Bs[j * BST + n], acc);
          acc *= expf(cum_s[i] - cum_s[j]);
        }
        Ms[i * MST + j] = acc;
      }
    }
    __syncthreads();

    // y = M X + exp(cum) o (C state^T): row tid / 4, columns tid % 4 + 4k
    {
      const int row = tid >> 2;
#pragma unroll
      for (int k = 0; k < YC; ++k) {
        const int col = (tid & 3) + 4 * k;
        float yd = 0.f, yo = 0.f;
        for (int j = 0; j <= row; ++j)
          yd = fmaf(Ms[row * MST + j], Xs[j * PB + col], yd);
#pragma unroll 8
        for (int n = 0; n < N; ++n)
          yo = fmaf(Cs[row * BST + n], St[col * BST + n], yo);
        if (s0 + row < p.S)
          yg[((static_cast<long long>(b) * p.S + s0 + row) * p.H + h) * p.P +
             p0 + col] = yd + e_s[row] * yo;
      }
    }

    // state = exp(cum_last) state + (X o w)^T B
    const float dec = e_s[Q - 1];
#pragma unroll
    for (int t = 0; t < SPT; ++t) {
      const int idx = tid + F_NT * t, pr = idx / N, n = idx % N;
      float acc = 0.f;
#pragma unroll 8
      for (int j = 0; j < Q; ++j)
        acc = fmaf(Xs[j * PB + pr] * w_s[j], Bs[j * BST + n], acc);
      st[t] = fmaf(dec, st[t], acc);
    }
    // Every thread is done with this chunk's tiles, decays and state.
    __syncthreads();
#pragma unroll
    for (int t = 0; t < SPT; ++t) {
      const int idx = tid + F_NT * t;
      St[(idx / N) * BST + idx % N] = st[t];
    }
  }
#pragma unroll
  for (int t = 0; t < SPT; ++t) p.state[st_base + tid + F_NT * t] = st[t];
}


template <int PB, int N>
cudaError_t launch_f32(const Params& p, cudaStream_t stream) {
  auto kernel = ssd_f32_kernel<PB, N>;
  constexpr int bytes = F32Smem<PB, N>::BYTES;
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return err;
  kernel<<<dim3(p.P / PB, p.H, p.B), F_NT, bytes, stream>>>(p);
  return cudaGetLastError();
}

template <int PB, int N>
cudaError_t launch_bf16(const TmaParams& p, int B, cudaStream_t stream) {
  using C = Cfg<PB, N>;
  auto kernel = ssd_bf16_kernel<PB, N>;
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, C::BYTES);
  if (err != cudaSuccess) return err;
  kernel<<<dim3(p.P / PB, p.H, B), C::NT, C::BYTES, stream>>>(p);
  return cudaGetLastError();
}

// fn(std::integral_constant<int, N>()) for the state dims built
template <typename Fn>
cudaError_t by_n(int N, Fn fn) {
  switch (N) {
    case 16:
      return fn(std::integral_constant<int, 16>());
    case 32:
      return fn(std::integral_constant<int, 32>());
    case 64:
      return fn(std::integral_constant<int, 64>());
    case 128:
      return fn(std::integral_constant<int, 128>());
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// Plain C interface, loaded with ctypes.  Returns a cudaError_t (0 = the
// launch was accepted), or -1 if cuTensorMapEncodeTiled refused a tensor
// map; `dtype` is 0 for float32, 1 for bfloat16 (x, B, C and y; a and the
// states are f32).  `init` may be null (zero state).  The caller has
// checked shapes, strides, alignment and dtypes.
extern "C" int mamba2_ssd(const void* x, const float* a, const void* Bm,
                          const void* Cm, const float* init, void* y,
                          float* state, int B, int S, int H, int P, int N,
                          long long sxb, long long sxs, long long sxh,
                          long long sab, long long sas, long long sah,
                          long long sbb, long long sbs, long long scb,
                          long long scs, int dtype, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (P % 16 || (dtype != 0 && dtype != 1)) return cudaErrorInvalidValue;
  if (dtype == 0) {
    const Params f{x,   a,   Bm,  Cm,  init, y,   state, B,   S,   H, P,
                   sxb, sxs, sxh, sab, sas,  sah, sbb,   sbs, scb, scs};
    return by_n(N, [&](auto n) {
      return P % 32 == 0 ? launch_f32<32, decltype(n)::value>(f, st)
                         : launch_f32<16, decltype(n)::value>(f, st);
    });
  }
  // bf16: whole heads where P allows, else 32 or 16 columns a block
  const int pb = P % 64 == 0 ? 64 : P % 32 == 0 ? 32 : 16;
  const int nsw = N < 64 ? N : 64;
  TmaParams t;
  const long long xdims[4] = {P, S, H, B}, xstr[3] = {sxs, sxh, sxb};
  const long long ystr[3] = {1LL * H * P, P, 1LL * S * H * P};
  const long long bdims[4] = {N, S, B, 1}, bstr[3] = {sbs, sbb, sbb},
                  cstr[3] = {scs, scb, scb};
  if (!hopper::encode_bf16_4d(&t.xmap, x, xdims, xstr, pb, Q) ||
      !hopper::encode_bf16_4d(&t.ymap, y, xdims, ystr, pb, Q) ||
      !hopper::encode_bf16_4d(&t.bmap, Bm, bdims, bstr, nsw, Q) ||
      !hopper::encode_bf16_4d(&t.cmap, Cm, bdims, cstr, nsw, Q))
    return -1;
  t.a = a;
  t.init = init;
  t.state = state;
  t.S = S;
  t.H = H;
  t.P = P;
  t.sab = sab;
  t.sas = sas;
  t.sah = sah;
  return by_n(N, [&](auto n) {
    constexpr int n_ = decltype(n)::value;
    return pb == 64   ? launch_bf16<64, n_>(t, B, st)
           : pb == 32 ? launch_bf16<32, n_>(t, B, st)
                      : launch_bf16<16, n_>(t, B, st);
  });
}

extern "C" const char* mamba2_ssd_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
