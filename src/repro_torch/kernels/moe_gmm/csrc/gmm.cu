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
// chunks.  C may be ragged: the reference's capacity pads to a multiple of
// 8, not of a tile.
//
// One block computes a 64 x 64 tile of one expert's output.  Its 64 rows
// are taken from the expert's B * C rows (b, c) = (m / C, m % C), so all
// batch rows of an expert share one pass over its weights: at decode
// (C = 8, B = 3) one tile row holds every token the expert admitted.
// Grid: (F tiles, row tiles, E), with a loop over D inside the block.
//
// What bounds it on an H100, at granite-moe-1b-a400m's serving shapes
// (D = 1024, F = 512, E = 32, B = 3, bf16): the prefill product (C = 320)
// is 32.2 GFLOP against 128 MB of x, w and out, ~250 FLOP per byte, just
// under the card's ~295 FLOP/byte bf16 ridge: bytes bound it, narrowly.
// The decode product (C = 8) moves the 33.5 MB weight bank for 0.8 GFLOP:
// bytes bound it by far.  The design streams each weight tile once per
// row tile through a cp.async ring and keeps the sums in registers.
//
// * bf16 (the served model's dtype): tensor cores through mma.sync
//   m16n8k16 with f32 accumulation.  Four warps, 2 x 2 over the tile, 32 x
//   32 each.  x and w tiles (64 x 32, 32 x 64) are staged through a
//   3-stage cp.async ring in shared memory, rows past the expert's B * C,
//   columns past F and depths past D zero-filled; A fragments are read from
//   shared memory, B fragments with ldmatrix.trans.  Not done yet (later
//   work): wgmma, TMA, larger tiles and warp specialisation.
// * f32: CUDA cores (tensor cores would round to tf32 and break the
//   reference's 1e-5 normalised f32 tolerance), 4 x 4 outputs a thread.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int BM = 64;  // output rows (b, c) per block
constexpr int BN = 64;  // output columns per block

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
// bf16: tensor cores (mma.sync m16n8k16, f32 accumulate)
// ===========================================================================

constexpr int TC_NT = 128;       // 4 warps, 2 x 2 over the 64 x 64 tile
constexpr int TC_BK = 32;        // depth of one staged k-tile
constexpr int STAGES = 3;        // cp.async ring
constexpr int XST = TC_BK + 8;   // x tile row stride: 80 bytes, no conflicts
constexpr int WST = BN + 8;      // w tile row stride: 144 bytes, no conflicts

__device__ __forceinline__ uint32_t ld_u32(const __nv_bfloat16* ptr) {
  return *reinterpret_cast<const uint32_t*>(ptr);
}

// c += a (16x16, row) * b (16x8, col); bf16 in, f32 accumulate.
__device__ __forceinline__ void mma_bf16(float (&c)[4],
                                         const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Four 8x8 b16 matrices, transposed on the way in: lanes 8i..8i+7 give
// the row addresses of matrix i, register i receives matrix i.
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4],
                                                  const void* smem_ptr) {
  const unsigned addr =
      static_cast<unsigned>(__cvta_generic_to_shared(smem_ptr));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

// 16 bytes global -> shared, asynchronously; zeros when !valid (src-size
// 0: nothing is read, `src` need only be a valid address).
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool valid) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :
               : "r"(d), "l"(src), "r"(valid ? 16 : 0));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__global__ void __launch_bounds__(TC_NT) gmm_bf16_kernel(const Params p) {
  using bf16 = __nv_bfloat16;
  // raw 16-bit storage (no constructors in shared memory), used as bf16
  __shared__ __align__(16) uint16_t Xraw[STAGES][BM * XST];
  __shared__ __align__(16) uint16_t Wraw[STAGES][TC_BK * WST];
  auto Xs = reinterpret_cast<bf16(*)[BM * XST]>(Xraw);
  auto Ws = reinterpret_cast<bf16(*)[TC_BK * WST]>(Wraw);

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, tig = lane & 3;  // mma fragment row / column pair
  const int e = blockIdx.z;
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  const int M = p.B * p.C;
  const bf16* xg = static_cast<const bf16*>(p.x);
  const bf16* wg = static_cast<const bf16*>(p.w) + e * p.swe;

  // Copy duty per k-tile: x rows xr and xr + 32 at chunk xc, w rows wr and
  // wr + 16 at chunk wc (16-byte chunks of 8 elements).
  const int xr = tid >> 2, xc = (tid & 3) * 8;
  const int wr = tid >> 3, wc = (tid & 7) * 8;
  const bf16* xsrc[2];
  bool xok[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int m = m0 + xr + 32 * i;
    xok[i] = m < M;
    xsrc[i] = xg + (xok[i] ? x_row(p, e, m) : 0) + xc;
  }
  const bool wcol = n0 + wc < p.F;

  auto load_tile = [&](int stage, int k0) {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const bool ok = xok[i] && k0 + xc < p.D;
      cp_async16(&Xs[stage][(xr + 32 * i) * XST + xc], ok ? xsrc[i] + k0 : xg,
                 ok);
    }
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int k = k0 + wr + 16 * i;
      const bool ok = wcol && k < p.D;
      cp_async16(&Ws[stage][(wr + 16 * i) * WST + wc],
                 ok ? wg + k * p.swd + n0 + wc : wg, ok);
    }
  };

  const int wm = (warp >> 1) * 32, wn = (warp & 1) * 32;
  float acc[2][4][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[i][j][c] = 0.f;

  const int nk = (p.D + TC_BK - 1) / TC_BK;
#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < nk) load_tile(s, s * TC_BK);
    cp_async_commit();
  }
  const int lm = lane >> 3, lr = lane & 7;  // ldmatrix matrix / row
  for (int kt = 0; kt < nk; ++kt) {
    // Tile kt has landed; every warp is done with the stage refilled next.
    cp_async_wait<STAGES - 2>();
    __syncthreads();
    const int next = kt + STAGES - 1;
    if (next < nk) load_tile(next % STAGES, next * TC_BK);
    cp_async_commit();

    const bf16* xs = Xs[kt % STAGES];
    const bf16* ws = Ws[kt % STAGES];
#pragma unroll
    for (int kk = 0; kk < TC_BK; kk += 16) {
      uint32_t a[2][4];
#pragma unroll
      for (int mt = 0; mt < 2; ++mt) {
        const bf16* lo = xs + (wm + mt * 16 + g) * XST + kk + tig * 2;
        const bf16* hi = lo + 8 * XST;
        a[mt][0] = ld_u32(lo);
        a[mt][1] = ld_u32(hi);
        a[mt][2] = ld_u32(lo + 8);
        a[mt][3] = ld_u32(hi + 8);
      }
#pragma unroll
      for (int j = 0; j < 4; j += 2) {
        uint32_t bv[4];
        ldmatrix_x4_trans(bv, ws + (kk + (lm & 1) * 8 + lr) * WST + wn +
                                  j * 8 + (lm >> 1) * 8);
#pragma unroll
        for (int mt = 0; mt < 2; ++mt) {
          mma_bf16(acc[mt][j], a[mt], bv[0], bv[1]);
          mma_bf16(acc[mt][j + 1], a[mt], bv[2], bv[3]);
        }
      }
    }
  }
  cp_async_wait<0>();

  bf16* og = static_cast<bf16*>(p.o);
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int m = m0 + wm + mt * 16 + g + 8 * h;
      if (m >= M) continue;
      bf16* orow = og + out_row(p, e, m);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int n = n0 + wn + j * 8 + tig * 2;  // F even: n + 1 < F too
        if (n < p.F)
          *reinterpret_cast<__nv_bfloat162*>(orow + n) =
              __floats2bfloat162_rn(acc[mt][j][2 * h], acc[mt][j][2 * h + 1]);
      }
    }
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

}  // namespace

// Plain C interface, loaded with ctypes.  Returns a cudaError_t (0 = the
// launch was accepted); `dtype` is 0 for float32, 1 for bfloat16.  The
// caller has checked shapes, strides, alignment and dtypes.
extern "C" int moe_gmm(const void* x, const void* w, void* o, int B, int E,
                       int C, int D, int F, long long sxb, long long sxe,
                       long long sxc, long long swe, long long swd,
                       int dtype, void* stream) {
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
  const dim3 grid((F + BN - 1) / BN, (B * C + BM - 1) / BM, E);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    gmm_f32_kernel<<<grid, NT, 0, st>>>(p);
  else if (dtype == 1)
    gmm_bf16_kernel<<<grid, TC_NT, 0, st>>>(p);
  else
    return cudaErrorInvalidValue;
  return cudaGetLastError();
}

extern "C" const char* moe_gmm_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
