// Mamba2 chunked SSD scan for Hopper (sm_90a), written by hand.
//
// Replaces the Pallas TPU kernel
//   src/repro/kernels/mamba2_ssd/kernel.py::ssd_fwd  (body _ssd_kernel)
// and computes what it computes, plus an initial state.  For each batch
// row b and head h, chunk by chunk, with cum = cumsum(a) inside the chunk:
//
//   y      = (L o C B^T) X + (C state^T) o exp(cum)
//            L[i,j] = exp(cum_i - cum_j) for i >= j, else 0
//   state' = exp(cum_last) state + (B o exp(cum_last - cum))^T X
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
// block owns a (b, h, 32 or 16 columns of P) and walks the chunks in a
// loop; the state's rows p depend only on column p of X, so splitting P
// is exact.  At zamba2-2.7b's prefill (B 3, H 80, P 64) that is 480
// blocks on 132 SMs.  B and C are shared across heads and come from L2.
//
// What bounds it on an H100: at that prefill shape (S 1024, N 64, bf16)
// the reference algorithm's 20.1 GFLOP against 68.6 MB of x, y, a, B, C
// and the state put the bound at the memory rate, ~0.0205 ms.  The design
// reads each input once (the next chunk's X, B and C are fetched by
// cp.async while the current chunk is computed, a double-buffered ring)
// and keeps everything else on chip: the f32 state lives in registers as
// the accumulators of its own update, for the whole sequence.
//
// * bf16 (the served dtype): tensor cores through mma.sync m16n8k16 with
//   f32 accumulation; chunks of 64 rows, four warps of 16 rows each.
//   C B^T (bf16 inputs, exact products) skips the key tiles above the
//   diagonal.  Every other product has an f32 operand: the masked, decayed
//   scores M for M X, the state for C state^T, X o decay for the state
//   update.  Each goes in as a bf16 hi + lo split, two mma, about 16
//   mantissa bits, so y matches the plain version's f32 sums to about
//   1e-5 relative before its one rounding, and the state is never rounded
//   below f32 from chunk to chunk.  (Rounding M to bf16 once, as flash
//   rounds P, moved zamba2's prefill logits by 5.3% of their largest value
//   against the plain version.)  Not done yet (later work): wgmma, TMA
//   and a larger chunk.
// * f32: CUDA cores (tensor cores would round to tf32, about 1e-3
//   relative), 256 threads a block.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int Q = 64;  // rows per chunk
constexpr unsigned FULL = 0xffffffffu;

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

// cum, exp(cum_last - cum) and exp(cum) of one chunk's 64 decays, by one
// warp: lane l holds rows 2l and 2l + 1.
__device__ __forceinline__ void chunk_decays(const float (&v)[2], int lane,
                                             float* cum_s, float* w_s,
                                             float* e_s) {
  float incl = v[0] + v[1];
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const float t = __shfl_up_sync(FULL, incl, o);
    if (lane >= o) incl += t;
  }
  const float prev = __shfl_up_sync(FULL, incl, 1);
  const float total = __shfl_sync(FULL, incl, 31);
  const float c0 = (lane ? prev : 0.f) + v[0];
  const float c1 = c0 + v[1];
  cum_s[2 * lane] = c0;
  cum_s[2 * lane + 1] = c1;
  w_s[2 * lane] = expf(total - c0);
  w_s[2 * lane + 1] = expf(total - c1);
  e_s[2 * lane] = expf(c0);
  e_s[2 * lane + 1] = expf(c1);
}

// The decays of rows 2 * lane and 2 * lane + 1 of chunk c (0 past S).
__device__ __forceinline__ void load_decays(const Params& p, const float* ag,
                                            int c, int lane, float (&v)[2]) {
#pragma unroll
  for (int k = 0; k < 2; ++k) {
    const int s = c * Q + 2 * lane + k;
    v[k] = s < p.S ? ag[s * p.sas] : 0.f;
  }
}

// ===========================================================================
// bf16: tensor cores (mma.sync m16n8k16, f32 accumulate)
// ===========================================================================

constexpr int TC_NT = 128;  // 4 warps x 16 chunk rows

__device__ __forceinline__ uint32_t ld_u32(const __nv_bfloat16* ptr) {
  return *reinterpret_cast<const uint32_t*>(ptr);
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

// Two 8x8 b16 matrices, transposed: lanes 0..7 and 8..15 give the rows.
__device__ __forceinline__ void ldmatrix_x2_trans(uint32_t (&r)[2],
                                                  const void* smem_ptr) {
  const unsigned addr =
      static_cast<unsigned>(__cvta_generic_to_shared(smem_ptr));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0,%1}, [%2];\n"
      : "=r"(r[0]), "=r"(r[1])
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

template <int PB, int N>
struct TcSmem {
  static constexpr int XST = PB + 8;  // row strides: 16-byte rows whose 8
  static constexpr int BST = N + 8;   // ldmatrix rows fall on other banks
  // X, B, C double-buffered; the state's hi and lo halves; cum, w, e
  static constexpr int BYTES =
      (2 * Q * XST + 4 * Q * BST + 2 * PB * BST) * 2 + 3 * Q * 4;
};

template <int PB, int N>
__global__ void __launch_bounds__(TC_NT) ssd_bf16_kernel(const Params p) {
  using bf16 = __nv_bfloat16;
  constexpr int XST = TcSmem<PB, N>::XST, BST = TcSmem<PB, N>::BST;
  constexpr int NK = Q / 8;    // key n-tiles of C B^T
  constexpr int NP = PB / 8;   // n-tiles of y over P
  constexpr int KN = N / 16;   // k-steps over N
  constexpr int WM = PB / 16;  // warps over the state's rows (P)
  constexpr int WN = 4 / WM;   // warps over its columns (N)
  constexpr int SN = (N / 8 + WN - 1) / WN;  // state n-tiles per warp
  static_assert(PB == 16 || PB == 32, "P tile");
  static_assert(N % 16 == 0 && Q == 16 * (TC_NT / 32), "tile shape");

  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* Xs = reinterpret_cast<bf16*>(smem_raw);  // [2][Q][XST]
  bf16* Bs = Xs + 2 * Q * XST;                   // [2][Q][BST]
  bf16* Cs = Bs + 2 * Q * BST;                   // [2][Q][BST]
  bf16* Sh = Cs + 2 * Q * BST;                   // state, hi: [PB][BST]
  bf16* Sl = Sh + PB * BST;                      // state, lo: [PB][BST]
  float* cum_s = reinterpret_cast<float*>(Sl + PB * BST);
  float* w_s = cum_s + Q;  // exp(cum_last - cum_j)
  float* e_s = w_s + Q;    // exp(cum_i)

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, tig = lane & 3;  // mma fragment row / column pair
  const int lm = lane >> 3, lr = lane & 7;  // ldmatrix matrix / row
  const int p0 = blockIdx.x * PB, h = blockIdx.y, b = blockIdx.z;
  const int nc = (p.S + Q - 1) / Q;

  const bf16* xg =
      static_cast<const bf16*>(p.x) + b * p.sxb + h * p.sxh + p0;
  const bf16* bg = static_cast<const bf16*>(p.Bm) + b * p.sbb;
  const bf16* cg = static_cast<const bf16*>(p.Cm) + b * p.scb;
  const float* ag = p.a + b * p.sab + h * p.sah;
  bf16* yg = static_cast<bf16*>(p.y);

  auto load_chunk = [&](int buf, int c) {
    constexpr int XCH = PB / 8, BCH = N / 8;  // 16-byte chunks per row
    const int s0 = c * Q;
    for (int e = tid; e < Q * XCH; e += TC_NT) {
      const int r = e / XCH, col = (e % XCH) * 8;
      const bool ok = s0 + r < p.S;
      cp_async16(Xs + (buf * Q + r) * XST + col,
                 ok ? xg + (s0 + r) * p.sxs + col : xg, ok);
    }
    for (int e = tid; e < Q * BCH; e += TC_NT) {
      const int r = e / BCH, col = (e % BCH) * 8;
      const bool ok = s0 + r < p.S;
      cp_async16(Bs + (buf * Q + r) * BST + col,
                 ok ? bg + (s0 + r) * p.sbs + col : bg, ok);
      cp_async16(Cs + (buf * Q + r) * BST + col,
                 ok ? cg + (s0 + r) * p.scs + col : cg, ok);
    }
  };

  // The state: warp (wm, wn) holds rows wm*16 .. +15 and n-tiles
  // wn + WN*t as mma accumulators, f32, for the whole sequence.
  const int wm = warp % WM, wn = warp / WM;
  const long long st_base =
      (static_cast<long long>(b) * p.H + h) * p.P * N + p0 * N;
  float st[SN][4];
#pragma unroll
  for (int t = 0; t < SN; ++t)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int nt = wn + WN * t;
      const int row = wm * 16 + g + 8 * (e >> 1);
      const int col = nt * 8 + tig * 2 + (e & 1);
      st[t][e] = (nt < N / 8 && p.init) ? p.init[st_base + row * N + col]
                                        : 0.f;
    }
  // its bf16 hi + lo copy in shared memory, the B operand of C state^T
  auto write_state = [&]() {
#pragma unroll
    for (int t = 0; t < SN; ++t) {
      const int nt = wn + WN * t;
      if (nt >= N / 8) continue;
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int off = (wm * 16 + g + 8 * r) * BST + nt * 8 + tig * 2;
        split_bf16(st[t][2 * r], st[t][2 * r + 1],
                   *reinterpret_cast<uint32_t*>(Sh + off),
                   *reinterpret_cast<uint32_t*>(Sl + off));
      }
    }
  };

  write_state();
  float a_next[2] = {0.f, 0.f};
  if (warp == 0) load_decays(p, ag, 0, lane, a_next);
  load_chunk(0, 0);
  cp_async_commit();

  const int r0 = warp * 16 + g;  // this thread's chunk rows: r0, r0 + 8
  for (int c = 0; c < nc; ++c) {
    const int buf = c & 1;
    if (c + 1 < nc) load_chunk(buf ^ 1, c + 1);
    cp_async_commit();
    if (warp == 0) {
      const float v[2] = {a_next[0], a_next[1]};
      if (c + 1 < nc) load_decays(p, ag, c + 1, lane, a_next);
      chunk_decays(v, lane, cum_s, w_s, e_s);
    }
    // Chunk c has landed; the decays and the state copy are visible.
    cp_async_wait<1>();
    __syncthreads();
    const bf16* xs = Xs + buf * Q * XST;
    const bf16* bs = Bs + buf * Q * BST;
    const bf16* cs = Cs + buf * Q * BST;

    // -- C fragments of the warp's 16 rows (A operand over N) -------------
    uint32_t cf[KN][4];
#pragma unroll
    for (int kk = 0; kk < KN; ++kk) {
      const bf16* lo = cs + r0 * BST + kk * 16 + tig * 2;
      const bf16* hi = lo + 8 * BST;
      cf[kk][0] = ld_u32(lo);
      cf[kk][1] = ld_u32(hi);
      cf[kk][2] = ld_u32(lo + 8);
      cf[kk][3] = ld_u32(hi + 8);
    }

    // -- M = L o (C B^T): key tiles up to the diagonal --------------------
    const float ci[2] = {cum_s[r0], cum_s[r0 + 8]};
    float sc[NK][4];
#pragma unroll
    for (int j = 0; j < NK; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) sc[j][e] = 0.f;
      if (j <= 2 * warp + 1) {
        const bf16* krow = bs + (j * 8 + g) * BST + tig * 2;
#pragma unroll
        for (int kk = 0; kk < KN; ++kk)
          mma_bf16(sc[j], cf[kk], ld_u32(krow + kk * 16),
                   ld_u32(krow + kk * 16 + 8));
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int i = r0 + 8 * (e >> 1), col = j * 8 + tig * 2 + (e & 1);
          sc[j][e] = col <= i ? sc[j][e] * expf(ci[e >> 1] - cum_s[col])
                              : 0.f;
        }
      }
    }

    // -- y = M X, M as hi + lo (the scores' accumulator fragments are the
    //    A fragments, as flash's P is) --------------------------------------
    float yacc[NP][4];
#pragma unroll
    for (int j = 0; j < NP; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) yacc[j][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < Q / 16; ++kk) {
      if (kk > warp) continue;
      uint32_t ahi[4], alo[4];
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int j = 2 * kk + (q >> 1), e = 2 * (q & 1);
        split_bf16(sc[j][e], sc[j][e + 1], ahi[q], alo[q]);
      }
      const bf16* vrow =
          xs + (kk * 16 + (lm & 1) * 8 + lr) * XST + (lm >> 1) * 8;
#pragma unroll
      for (int j = 0; j < NP; j += 2) {
        uint32_t bv[4];
        ldmatrix_x4_trans(bv, vrow + j * 8);
        mma_bf16(yacc[j], ahi, bv[0], bv[1]);
        mma_bf16(yacc[j], alo, bv[0], bv[1]);
        mma_bf16(yacc[j + 1], ahi, bv[2], bv[3]);
        mma_bf16(yacc[j + 1], alo, bv[2], bv[3]);
      }
    }

    // -- y += exp(cum) o (C state^T), the state as hi + lo ----------------
    float yoff[NP][4];
#pragma unroll
    for (int j = 0; j < NP; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) yoff[j][e] = 0.f;
      const bf16* sh = Sh + (j * 8 + g) * BST + tig * 2;
      const bf16* sl = Sl + (j * 8 + g) * BST + tig * 2;
#pragma unroll
      for (int kk = 0; kk < KN; ++kk) {
        mma_bf16(yoff[j], cf[kk], ld_u32(sh + kk * 16),
                 ld_u32(sh + kk * 16 + 8));
        mma_bf16(yoff[j], cf[kk], ld_u32(sl + kk * 16),
                 ld_u32(sl + kk * 16 + 8));
      }
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int s = c * Q + r0 + 8 * r;
      if (s >= p.S) continue;
      const float ei = e_s[r0 + 8 * r];
      bf16* yrow = yg + ((static_cast<long long>(b) * p.S + s) * p.H + h) *
                            p.P + p0 + tig * 2;
#pragma unroll
      for (int j = 0; j < NP; ++j) {
        const int e = 2 * r;
        *reinterpret_cast<__nv_bfloat162*>(yrow + j * 8) =
            __floats2bfloat162_rn(yacc[j][e] + ei * yoff[j][e],
                                  yacc[j][e + 1] + ei * yoff[j][e + 1]);
      }
    }

    // -- state = exp(cum_last) state + (X o w)^T B, X o w as hi + lo ------
    const float dec = e_s[Q - 1];
#pragma unroll
    for (int t = 0; t < SN; ++t)
#pragma unroll
      for (int e = 0; e < 4; ++e) st[t][e] *= dec;
#pragma unroll
    for (int kk = 0; kk < Q / 16; ++kk) {
      // A[p][j] = X[j][p] w_j: matrix i holds rows j = kk*16 + (i>>1)*8 ..,
      // columns p = wm*16 + (i&1)*8 ..
      uint32_t xa[4], ahi[4], alo[4];
      ldmatrix_x4_trans(
          xa, xs + (kk * 16 + (lm >> 1) * 8 + lr) * XST + wm * 16 +
                  (lm & 1) * 8);
      const int j0 = kk * 16 + tig * 2;
      const float w0 = w_s[j0], w1 = w_s[j0 + 1];
      const float w8 = w_s[j0 + 8], w9 = w_s[j0 + 9];
      scale_split(xa[0], w0, w1, ahi[0], alo[0]);
      scale_split(xa[1], w0, w1, ahi[1], alo[1]);
      scale_split(xa[2], w8, w9, ahi[2], alo[2]);
      scale_split(xa[3], w8, w9, ahi[3], alo[3]);
#pragma unroll
      for (int t = 0; t < SN; ++t) {
        const int nt = wn + WN * t;
        if (nt >= N / 8) continue;
        uint32_t bv[2];
        ldmatrix_x2_trans(bv, bs + (kk * 16 + (lane & 15)) * BST + nt * 8);
        mma_bf16(st[t], ahi, bv[0], bv[1]);
        mma_bf16(st[t], alo, bv[0], bv[1]);
      }
    }
    // Every warp is done with this chunk's buffers, decays and state copy.
    __syncthreads();
    write_state();
  }
  cp_async_wait<0>();

#pragma unroll
  for (int t = 0; t < SN; ++t) {
    const int nt = wn + WN * t;
    if (nt >= N / 8) continue;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = wm * 16 + g + 8 * r;
      *reinterpret_cast<float2*>(p.state + st_base + row * N + nt * 8 +
                                 tig * 2) =
          make_float2(st[t][2 * r], st[t][2 * r + 1]);
    }
  }
}

// ===========================================================================
// f32: CUDA cores
// ===========================================================================

constexpr int F_NT = 256;

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
      load_decays(p, ag, c, lane, v);
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

template <typename Kernel>
cudaError_t launch(Kernel kernel, int threads, int bytes, int pb,
                   const Params& p, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return err;
  const dim3 grid(p.P / pb, p.H, p.B);
  kernel<<<grid, threads, bytes, stream>>>(p);
  return cudaGetLastError();
}

template <int PB, int N>
cudaError_t launch_dtype(int dtype, const Params& p, cudaStream_t st) {
  if (dtype == 0)
    return launch(ssd_f32_kernel<PB, N>, F_NT, F32Smem<PB, N>::BYTES, PB, p,
                  st);
  if (dtype == 1)
    return launch(ssd_bf16_kernel<PB, N>, TC_NT, TcSmem<PB, N>::BYTES, PB, p,
                  st);
  return cudaErrorInvalidValue;
}

template <int PB>
cudaError_t launch_n(int N, int dtype, const Params& p, cudaStream_t st) {
  if (N == 16) return launch_dtype<PB, 16>(dtype, p, st);
  if (N == 32) return launch_dtype<PB, 32>(dtype, p, st);
  if (N == 64) return launch_dtype<PB, 64>(dtype, p, st);
  if (N == 128) return launch_dtype<PB, 128>(dtype, p, st);
  return cudaErrorInvalidValue;
}

}  // namespace

// Plain C interface, loaded with ctypes.  Returns a cudaError_t (0 = the
// launch was accepted); `dtype` is 0 for float32, 1 for bfloat16 (x, B, C
// and y; a and the states are f32).  `init` may be null (zero state).  The
// caller has checked shapes, strides, alignment and dtypes.
extern "C" int mamba2_ssd(const void* x, const float* a, const void* Bm,
                          const void* Cm, const float* init, void* y,
                          float* state, int B, int S, int H, int P, int N,
                          long long sxb, long long sxs, long long sxh,
                          long long sab, long long sas, long long sah,
                          long long sbb, long long sbs, long long scb,
                          long long scs, int dtype, void* stream) {
  Params p;
  p.x = x;
  p.a = a;
  p.Bm = Bm;
  p.Cm = Cm;
  p.init = init;
  p.y = y;
  p.state = state;
  p.B = B;
  p.S = S;
  p.H = H;
  p.P = P;
  p.sxb = sxb;
  p.sxs = sxs;
  p.sxh = sxh;
  p.sab = sab;
  p.sas = sas;
  p.sah = sah;
  p.sbb = sbb;
  p.sbs = sbs;
  p.scb = scb;
  p.scs = scs;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (P % 32 == 0) return launch_n<32>(N, dtype, p, st);
  if (P % 16 == 0) return launch_n<16>(N, dtype, p, st);
  return cudaErrorInvalidValue;
}

extern "C" const char* mamba2_ssd_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
