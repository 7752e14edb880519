// RWKV6 WKV recurrence for Hopper (sm_90a), written by hand.
//
// Replaces the Pallas TPU kernel
//   src/repro/kernels/rwkv6_wkv/kernel.py::wkv_fwd  (body _wkv_kernel)
// and computes what it computes, plus an initial state.  For each batch
// row b and head h, chunk by chunk (16 rows), with the decay products
// excl_t = prod_{s<t} w_s and incl_t = prod_{s<=t} w_s inside the chunk
// (w clamped below at 1e-8):
//
//   r~     = r * excl                    k~ = k / max(incl, 1e-37)
//   y      = tril_-1(r~ k~^T) v + diag(sum_p r u k) v + r~ state
//   state' = (state + k~^T v) * incl_last
//
// state[p, q] is [k_dim, v_dim]: r~ state contracts over p.
//
// Layout: r, k, v (B,S,H,P) in one dtype (f32 or bf16) and w (B,S,H,P)
// f32, each with the last dim contiguous and any strides on the leading
// dims that are multiples of 16 bytes (a base too), read in place by TMA
// (no copy folds (B,H) into rows); u (H,P) f32
// contiguous; init (B,H,P,P) f32 contiguous or null; y (B,S,H,P)
// contiguous in r's dtype; the final state (B,H,P,P) f32 contiguous.
// P is 16, 32, 64 or 128 (the wrapper checks).  S may be ragged: rows
// past S act as w = 1 and r = k = v = 0; they are not read, and y's rows
// there are not stored.
//
// Arithmetic: f64, from the inputs as given to y and the state, which are
// rounded once to f32 (and y then to r's dtype), as the plain version
// does.  The chunk stays the reference's 16 rows and its factors are
// formed as products of the decays, so k~ stays below e^80 |k| at the
// rate cap of 5 and no w in (0, 1) gives inf or NaN; 1 / incl of a row is
// the reciprocal of its half-chunk's last incl times the decays after the
// row (a reciprocal a row where that last incl falls below the clamp,
// never at the model's rate cap).  f64 is for agreement: in a bf16 model
// y is rounded to bf16 before the group norm, and y from two f32
// computations that differ in the last bit now and then lands on another
// bf16 value; rwkv6-7b carries those flips through 32 layers to 8.6% of
// the largest prefill logit.  Two f64 computations of y, summed in any
// order, round to the same f32 value all but never, so the kernel and the
// plain version give the same bf16 activations (tests/test_torch_wkv.py
// checks this kernel's order on the CPU).
//
// What bounds it.  At rwkv6-7b's prefill (B 3, S 1024, H 64, P 64, bf16
// r, k, v and y, f32 w and states) the bytes, 157.3 MB, take 0.047 ms at
// an H100's 3.35 TB/s, and the reference algorithm's 4.03 GFLOP 0.060 ms
// at its f64 tensor-core rate.  The kernel before this one walked a
// (b, h, 32 columns) block's 64 chunks with every step of a chunk on one
// chain (decays, bonus, two block barriers, scores, r~ state, the update,
// scores v) in the Ampere shape mma.m8n8k4, which gets half the f64
// tensor rate (tools/wkv_probe.py mma on an NVIDIA H100 80GB HBM3 at
// 700 W: 33.5 against 66.7 TFLOP/s for m16n8k4): 0.3817 ms on that card,
// the latency of that chain (B1 alone took 0.73 of B3's time).
//
// Design.  Only the state recurrence has to run in order: with
// U_c = k~_c^T v_c, state_{c+1} = (state_c + U_c) * incl_last_c, and the
// decays, r~, k~, the bonus, the masked scores and U_c's factors depend
// on no state.  The Pallas kernel carries the state in VMEM across the
// grid's sequential chunk axis; here one block owns a (b, h) (64 columns
// of v and of the state: the whole head at P <= 64, half of it at P 128)
// and its two warpgroups run apart, handing chunks over through a ring of
// two shared-memory slots on mbarriers, with no block barrier in the loop:
//   producers (warps 0 to 3): chunk c's inputs, TMA boxes of r, k, w and
//     v loaded three chunks ahead; the decays, one thread a (column, half
//     of the rows), running products joined by a shuffle; r~, k~,
//     incl_last, each 16 columns' bonus sums r u k (shuffles), v in f64;
//     a named barrier of their own; then warps 0 and 1 the masked scores
//     with the bonus on the diagonal (mma.m16n8k4), into slot c % 2;
//   the chain (warps 4 to 7): each warp holds a 16-column slice of the
//     state, transposed, as mma.m16n8k4 accumulators for the whole
//     sequence.  Per chunk it takes y = r~ state + scores v straight from
//     those accumulators (as the B operand, its k order permuted to their
//     column order), then state = (state + k~^T v) * incl_last, frees the
//     slot and stores y.
// Each head's decays and scores are computed once.  Two blocks share an
// SM (setmaxnreg gives the chain 144 registers a thread, the producers
// 112): at rwkv6-7b's prefill 192 blocks on 132 SMs, 60 of which hold two.
//
// Times at that shape (chip_smoke.py's timing phase, cold L2, device
// time; NVIDIA H100 80GB HBM3, 700 W): this design 0.1812 to 0.1850 ms
// (B1 alone 0.62 to 0.63 of B3's time); the one before it 0.3817 to
// 0.3822; f32 FMAs before that 0.99.  Parts taken out (tools/wkv_probe.py
// variants, same card): no decays, scores or state products 0.078 ms; the
// chain's products added back 0.155; the producers' decays and scores
// then add the rest.  The chain's products run about at the f64 tensor
// rate but add to, rather than overlap, the hand-offs, loads and stores
// around them.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "common/hopper.cuh"

namespace {

constexpr int T = 16;  // rows per chunk (the reference's CHUNK)
constexpr unsigned FULL = 0xffffffffu;
// columns of v and of the state a block owns: the whole head at P <= 64,
// its decays and scores computed once (32 would make two blocks a head at
// P 64, each computing all of them)
constexpr int COLS = 64;
constexpr int RING = 2;  // chunks of tiles between producers and chain
constexpr int LEAD = 3;  // chunks of inputs loaded ahead

// Block shape for head dim P and dtype E: QB columns of v and of the
// state; warpgroup 0 (warps 0 to 3) produces (inputs, decays, scores),
// warps 4 .. 4 + QG - 1 of warpgroup 1 run the chain, each on 16 columns
// of the state.  Where two blocks share an SM, setmaxnreg moves registers
// from the producers to the chain.
//
// A ring slot holds f64 tiles.  Those read as an mma's A operand (two
// doubles a lane: rows m and m + 8) are stored as pairs, so that one
// 16-byte load fills the operand: r~ [8][PP][2] (r~[t][p] at
// [t % 8][p][t / 8]), the scores [8][SCR][2] and v [T][VR][2] (v[t][q],
// q = 16 g + 8 i + x, at [t][8 g + x][i]).  k~ [T][KS] is read a double a
// lane.  Row strides (PP odd, KS = P + 4, SCR = 20, VR = 2 mod 8 pairs)
// put the lanes of one load on different banks.
template <typename E, int P>
struct Cfg {
  static constexpr int QB = COLS < P ? COLS : P;
  static constexpr int NP = 128, NT = 256;  // producer threads, threads
  static constexpr int QG = QB / 16;          // chain warps
  static constexpr int R = RING, L = LEAD;
  static constexpr int ITEMS = 2 * P;  // (column, half of the rows) items
  static constexpr int DI = (ITEMS + NP - 1) / NP;
  static constexpr int PP = P + 1, KS = P + 4, SCR = T + 4, VR = QB / 2 + 2;
  // offsets in doubles: r~ pairs, k~, score pairs, incl_last [P], each 16
  // columns' bonus sums [P / 16][T], v pairs
  static constexpr int KT = 16 * PP, SC = KT + T * KS, BL = SC + 16 * SCR,
                       BO = BL + P, VO = BO + (P / 16) * T;
  static constexpr int SLOT = ((VO + 2 * T * VR) * 8 + 127) / 128 * 128;
  // an input slot, one TMA box each: r, k [T][P] E, w [T][P] f32, v
  // [T][QB] E
  static constexpr int ES = sizeof(E);
  static constexpr int IN = T * (2 * P * ES + 4 * P + QB * ES);
  static constexpr int BYTES = R * SLOT + L * IN + 8 * (2 * R + L);
  static constexpr int FIT = 232448 / (BYTES + 1024);
  static constexpr int MIN_BLOCKS = FIT >= 2 ? 2 : 1;
  // registers a producer and a chain thread hold where two blocks share
  // an SM (the launch gives each 65536 / (2 * 256) = 128)
  static constexpr int PRODUCER_REGS = 112, CHAIN_REGS = 144;
};

struct Params {
  // r, k, w (boxes of T rows by P columns) and v (T rows by QB columns)
  // as 4-d tensor maps over (P, S, H, B)
  CUtensorMap rmap, kmap, wmap, vmap;
  const float* u;
  const float* init;  // null: zero initial state
  void* y;
  float* state;
  int B, S, H, P;
};

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
// two neighbouring values of y, rounded to f32 and then to y's dtype
__device__ __forceinline__ void store2(float* dst, double a, double b) {
  *reinterpret_cast<float2*>(dst) =
      make_float2(static_cast<float>(a), static_cast<float>(b));
}
__device__ __forceinline__ void store2(__nv_bfloat16* dst, double a,
                                       double b) {
  *reinterpret_cast<__nv_bfloat162*>(dst) = __floats2bfloat162_rn(
      static_cast<float>(a), static_cast<float>(b));
}

// c (16 x 8) += a (16 x 4, row) * b (4 x 8, col), f64 on the tensor
// cores.  Lane l holds a[l / 4][l % 4] (a0) and a[l / 4 + 8][l % 4] (a1),
// b[l % 4][l / 4], and c[l / 4 + 8 i][2 (l % 4) + e] in c[2 i + e].
__device__ __forceinline__ void dmma(double (&c)[4], double a0, double a1,
                                     double b) {
  asm("mma.sync.aligned.m16n8k4.row.col.f64.f64.f64.f64 "
      "{%0,%1,%2,%3}, {%4,%5}, {%6}, {%0,%1,%2,%3};\n"
      : "+d"(c[0]), "+d"(c[1]), "+d"(c[2]), "+d"(c[3])
      : "d"(a0), "d"(a1), "d"(b));
}

__device__ __forceinline__ double2 ld2(const double* p) {
  return *reinterpret_cast<const double2*>(p);
}

// An arrival that releases nothing: its thread only read what the barrier
// guards, and its stores to y need not have landed.
__device__ __forceinline__ void arrive_relaxed(uint64_t* bar) {
  asm volatile("mbarrier.arrive.relaxed.cta.shared::cta.b64 _, [%0];\n" ::"r"(
                   hopper::smem_addr(bar))
               : "memory");
}

template <typename E, int P>
__global__ void __launch_bounds__(Cfg<E, P>::NT, Cfg<E, P>::MIN_BLOCKS)
    wkv_kernel(const __grid_constant__ Params p) {
  using C = Cfg<E, P>;
  constexpr int QB = C::QB, QG = C::QG, R = C::R, L = C::L, NP = C::NP;
  constexpr int PP = C::PP, KS = C::KS, SCR = C::SCR, VR = C::VR;
  constexpr int ES = C::ES;
  constexpr int H8 = T / 2;  // rows of a column a decay item covers
  static_assert(C::ITEMS % 32 == 0, "whole warps an item");

  extern __shared__ __align__(128) unsigned char smem[];
  unsigned char* slots = smem;                  // R ring slots
  unsigned char* inputs = slots + R * C::SLOT;  // L input slots
  uint64_t* full = reinterpret_cast<uint64_t*>(inputs + L * C::IN);
  uint64_t* empty = full + R;    // [R] a slot read by every chain warp
  uint64_t* landed = empty + R;  // [L] an input slot loaded

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int gid = lane >> 2, tig = lane & 3;  // fragment row, column
  const int h = blockIdx.y, b = blockIdx.z;
  const int q0 = blockIdx.x * QB;  // the block's columns of v
  const int nc = (p.S + T - 1) / T;

  if (tid == 0) {
    for (int s = 0; s < R; ++s) {
      hopper::mbar_init(&full[s], NP / 32);
      hopper::mbar_init(&empty[s], QG);
    }
    for (int s = 0; s < L; ++s) hopper::mbar_init(&landed[s], 1);
    hopper::fence_barrier_init();
  }
  __syncthreads();

  if constexpr (C::MIN_BLOCKS == 2) {
    if (warp < 4)
      hopper::regs_dealloc<C::PRODUCER_REGS>();
    else
      hopper::regs_alloc<C::CHAIN_REGS>();
  }

  if (warp < 4) {
    // ---------------------------------------------------------------
    // Producers.  Chunk c: its inputs landed (loaded LEAD chunks ahead);
    // its ring slot read by every chain warp; the decays of all P
    // columns and v into the slot; then warps 0 and 1 the scores.
    // ---------------------------------------------------------------
    // chunk c into input slot c % L by TMA (rows past S read as zeros),
    // by lane 0 of warp 2 (warps 0 and 1 run more of the score work)
    auto issue = [&](int c) {
      unsigned char* in = inputs + (c % L) * C::IN;
      uint64_t* bar = &landed[c % L];
      hopper::mbar_arrive_expect_tx(bar, C::IN);
      hopper::tma_load_4d(in, &p.rmap, bar, 0, c * T, h, b);
      hopper::tma_load_4d(in + T * P * ES, &p.kmap, bar, 0, c * T, h, b);
      hopper::tma_load_4d(in + 2 * T * P * ES, &p.wmap, bar, 0, c * T, h,
                          b);
      hopper::tma_load_4d(in + T * P * (2 * ES + 4), &p.vmap, bar, q0,
                          c * T, h, b);
    };
    double up[C::DI];  // the bonus u of each item's column
#pragma unroll
    for (int d = 0; d < C::DI; ++d) {
      const int it = tid + NP * d;
      up[d] = it < C::ITEMS ? p.u[h * P + (it >> 5) * 16 + (it & 15)] : 0.0;
    }
    const bool issuer = warp == 2 && lane == 0;
    if (issuer)
      for (int c = 0; c < min(L, nc); ++c) issue(c);

    for (int c = 0; c < nc; ++c) {
      const int s = c % R;
      double* so = reinterpret_cast<double*>(slots + s * C::SLOT);
      const unsigned char* in = inputs + (c % L) * C::IN;
      const E* ir = reinterpret_cast<const E*>(in);
      const E* ik = ir + T * P;
      const float* iw = reinterpret_cast<const float*>(ik + T * P);
      const E* iv = reinterpret_cast<const E*>(iw + T * P);
      const int n = min(T, p.S - c * T);  // rows below S
      hopper::mbar_wait(&landed[c % L], (c / L) & 1);

      // This thread's inputs and v, read into registers before any store
      // to the slot (so the reads need not wait for the stores).  Rows
      // past S as w = 1, r = k = v = 0.  Item it = tid + NP d is column
      // 16 (it / 32) + it % 16, rows half 8 .. + 8 (half = lane / 16), so
      // each half-warp reads and writes 16 neighbouring columns of a row.
      const int half = lane >> 4;
      float xw[C::DI][H8], xr[C::DI][H8], xk[C::DI][H8];
#pragma unroll
      for (int d = 0; d < C::DI; ++d) {
        const int col = ((tid + NP * d) >> 5) * 16 + (lane & 15);
#pragma unroll
        for (int s8 = 0; s8 < H8; ++s8) {
          const int t = half * H8 + s8;
          const bool ok = t < n && (C::ITEMS % NP == 0 || tid + NP * d <
                                                              C::ITEMS);
          xw[d][s8] = ok ? iw[t * P + col] : 1.f;
          xr[d][s8] = ok ? to_f32(ir[t * P + col]) : 0.f;
          xk[d][s8] = ok ? to_f32(ik[t * P + col]) : 0.f;
        }
      }
      constexpr int VT = (T * QB + NP - 1) / NP;
      float xv[VT];
#pragma unroll
      for (int a = 0; a < VT; ++a) {
        const int e = tid + NP * a;
        xv[a] = e < T * QB && e / QB < n ? to_f32(iv[e]) : 0.f;
      }
      // the slot read by every chain warp (chunk c - R)
      if (c >= R) hopper::mbar_wait(&empty[s], ((c / R) - 1) & 1);

      // Decays of this thread's items, all items in step so that their
      // chains overlap: prefix products over each item's 8 rows, the two
      // halves of a column joined by a shuffle; 1 / incl of each row as
      // one reciprocal, of the last row's, times the decays after the row
      // (where incl falls below the clamp, never at the model's rate cap
      // of 5, one reciprocal a row); r~, k~ and incl_last; the bonus
      // terms r u k summed over each warp's 16 columns by recursive
      // halving (lane bits 3, 2, 1 pick the row a lane keeps, bit 0 the
      // last exchange).
      double wd[C::DI][H8], pre[C::DI][H8], base[C::DI];
#pragma unroll
      for (int d = 0; d < C::DI; ++d)
#pragma unroll
        for (int s8 = 0; s8 < H8; ++s8)
          // max(w, 1e-8) in f64, compared in f32: an f32 above 1e-8f is
          // above 1e-8, one at or below it is below
          wd[d][s8] = xw[d][s8] > 1e-8f ? static_cast<double>(xw[d][s8])
                                        : 1e-8;
#pragma unroll
      for (int d = 0; d < C::DI; ++d) {
        double prod = 1.0;
#pragma unroll
        for (int s8 = 0; s8 < H8; ++s8) {
          prod *= wd[d][s8];
          pre[d][s8] = prod;
        }
      }
      double inv[C::DI][H8];  // 1 / incl of each row
#pragma unroll
      for (int d = 0; d < C::DI; ++d) {
        const double other = __shfl_xor_sync(FULL, pre[d][H8 - 1], 16);
        base[d] = half ? other : 1.0;  // the decay of the rows before
      }
#pragma unroll
      for (int d = 0; d < C::DI; ++d) {
        const double last = base[d] * pre[d][H8 - 1];
        if (last >= 1e-37) {
          double x = __drcp_rn(last);
#pragma unroll
          for (int s8 = H8 - 1; s8 >= 0; --s8) {
            inv[d][s8] = x;
            x *= wd[d][s8];
          }
        } else {
#pragma unroll
          for (int s8 = 0; s8 < H8; ++s8)
            inv[d][s8] = __drcp_rn(fmax(base[d] * pre[d][s8], 1e-37));
        }
      }
      const bool b3 = lane & 8, b2 = lane & 4, b1 = lane & 2;
#pragma unroll
      for (int d = 0; d < C::DI; ++d) {
        const int it = tid + NP * d, col = (it >> 5) * 16 + (lane & 15);
        const bool active = C::ITEMS % NP == 0 || it < C::ITEMS;
        double ruk[H8];
#pragma unroll
        for (int s8 = 0; s8 < H8; ++s8) {
          const int t = half * H8 + s8;
          const double rv = xr[d][s8], kv = xk[d][s8];
          if (active) {
            so[2 * (s8 * PP + col) + half] =
                rv * (s8 ? base[d] * pre[d][s8 - 1] : base[d]);
            so[C::KT + t * KS + col] = kv * inv[d][s8];
          }
          ruk[s8] = rv * up[d] * kv;
        }
        if (active && half) so[C::BL + col] = base[d] * pre[d][H8 - 1];
        double r4[4], r2[2];
#pragma unroll
        for (int i = 0; i < 4; ++i)
          r4[i] = (b3 ? ruk[i + 4] : ruk[i]) +
                  __shfl_xor_sync(FULL, b3 ? ruk[i] : ruk[i + 4], 8);
#pragma unroll
        for (int i = 0; i < 2; ++i)
          r2[i] = (b2 ? r4[i + 2] : r4[i]) +
                  __shfl_xor_sync(FULL, b2 ? r4[i] : r4[i + 2], 4);
        double r1 = (b1 ? r2[1] : r2[0]) +
                    __shfl_xor_sync(FULL, b1 ? r2[0] : r2[1], 2);
        r1 += __shfl_xor_sync(FULL, r1, 1);
        if (active && !(lane & 1))
          so[C::BO + (col / 16) * T + half * H8 + 4 * b3 + 2 * b2 + b1] = r1;
      }
      // v into the slot, f64 pairs
#pragma unroll
      for (int a = 0; a < VT; ++a) {
        const int e = tid + NP * a, q = e % QB;
        if (e < T * QB)
          so[C::VO + 2 * ((e / QB) * VR + (q >> 4) * 8 + (q & 7)) +
             ((q >> 3) & 1)] = static_cast<double>(xv[a]);
      }
      // every producer warp is done with input slot c % L (chunk c + L
      // may land there) and has written the decays the scores read
      asm volatile("bar.sync 1, %0;\n" ::"n"(NP) : "memory");
      if (issuer && c + L < nc) issue(c + L);

      // Score job of warps 0 and 1: columns j = 8 warp .. + 8 of r~ k~^T
      // over all of p (k-step (n, e) takes p = 8 n + 2 tig + e, the
      // chain's order), strictly below the diagonal, the bonus on it,
      // zero above.  Four accumulators shorten the chain of products.
      // Warps 2 and 3 have nothing more to write.
      if (warp < 2) {
        const double* kt = so + C::KT;
        const int j0 = 8 * warp;
        double acc[4][4] = {};
#pragma unroll
        for (int n = 0; n < P / 8; ++n)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const double2 a = ld2(so + 2 * (gid * PP + 8 * n + 2 * tig + e));
            dmma(acc[(2 * n + e) & 3], a.x, a.y,
                 kt[(j0 + gid) * KS + 8 * n + 2 * tig + e]);
          }
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int i = gid + 8 * (e >> 1), j = j0 + 2 * tig + (e & 1);
          double sc = j < i ? (acc[0][e] + acc[1][e]) + (acc[2][e] + acc[3][e])
                            : 0.0;
          if (j == i) {
#pragma unroll
            for (int ww = 0; ww < P / 16; ++ww) sc += so[C::BO + ww * T + i];
          }
          so[C::SC + 2 * (gid * SCR + j) + (e >> 1)] = sc;
        }
      }
      __syncwarp();
      if (lane == 0) hopper::mbar_arrive(&full[s]);
    }
  } else if (warp - 4 < QG) {
    // ---------------------------------------------------------------
    // The chain.  This warp holds S^T[q][p] for its 16 columns q =
    // q0 + 16 qg .. + 16 and all P rows p, tile n (8 rows p) as the
    // accumulators of an m16n8 mma: lane holds S^T[16 qg + gid + 8 i]
    // [8 n + 2 tig + e] in st[n][2 i + e].  Per chunk: y = r~ state (the
    // state as it lies as the B operand, the k order permuted to its
    // columns: k-step (n, e) takes p = 8 n + 2 tig + e) + scores v; then
    // state = (state + k~^T v) * incl_last.
    // ---------------------------------------------------------------
    const int qg = warp - 4;
    const long long st_base = (static_cast<long long>(b) * p.H + h) * P * P;
    double st[P / 8][4];
#pragma unroll
    for (int n = 0; n < P / 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int pp = 8 * n + 2 * tig + (e & 1);
        const int qq = q0 + 16 * qg + gid + 8 * (e >> 1);
        st[n][e] = p.init ? p.init[st_base + pp * P + qq] : 0.0;
      }
    E* yg = static_cast<E*>(p.y) + h * P + q0 + 16 * qg + 2 * tig;
    for (int c = 0; c < nc; ++c) {
      const int s = c % R;
      hopper::mbar_wait(&full[s], (c / R) & 1);
      const double* rt =
          reinterpret_cast<const double*>(slots + s * C::SLOT);
      const double* kt = rt + C::KT;
      const double* sc = rt + C::SC;
      const double* bl = rt + C::BL;
      // v[4 j + tig][16 qg + 8 i + gid]: va[j].x (i = 0) and .y (i = 1)
      double2 va[4];
#pragma unroll
      for (int j = 0; j < 4; ++j)
        va[j] = ld2(rt + C::VO + 2 * ((4 * j + tig) * VR + 8 * qg + gid));
      // y tiles i (8 columns q = 16 qg + 8 i + ..), two accumulators each
      double y[2][2][4] = {};
#pragma unroll
      for (int n = 0; n < P / 8; ++n)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const double2 a = ld2(rt + 2 * (gid * PP + 8 * n + 2 * tig + e));
          dmma(y[0][n & 1], a.x, a.y, st[n][e]);
          dmma(y[1][n & 1], a.x, a.y, st[n][2 + e]);
        }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const double2 a = ld2(sc + 2 * (gid * SCR + 4 * j + tig));
        dmma(y[0][j & 1], a.x, a.y, va[j].x);
        dmma(y[1][j & 1], a.x, a.y, va[j].y);
      }
      // state = (state + k~^T v) * incl_last: m = q, n = p, k = t
#pragma unroll
      for (int n = 0; n < P / 8; ++n) {
#pragma unroll
        for (int j = 0; j < 4; ++j)
          dmma(st[n], va[j].x, va[j].y,
               kt[(4 * j + tig) * KS + 8 * n + gid]);
        const double2 dd = ld2(bl + 8 * n + 2 * tig);
        st[n][0] *= dd.x;
        st[n][1] *= dd.y;
        st[n][2] *= dd.x;
        st[n][3] *= dd.y;
      }
      __syncwarp();
      if (lane == 0) arrive_relaxed(&empty[s]);
      // y, two neighbouring columns a store, rows below S
#pragma unroll
      for (int e = 0; e < 4; e += 2) {
        const int row = c * T + gid + 4 * e;
        if (row < p.S) {
          E* dst = yg + (static_cast<long long>(b) * p.S + row) * p.H * P;
          store2(dst, y[0][0][e] + y[0][1][e],
                 y[0][0][e + 1] + y[0][1][e + 1]);
          store2(dst + 8, y[1][0][e] + y[1][1][e],
                 y[1][0][e + 1] + y[1][1][e + 1]);
        }
      }
    }
#pragma unroll
    for (int n = 0; n < P / 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int pp = 8 * n + 2 * tig + (e & 1);
        const int qq = q0 + 16 * qg + gid + 8 * (e >> 1);
        p.state[st_base + pp * P + qq] = static_cast<float>(st[n][e]);
      }
  }
}

// A tensor map over (P, S, H, B) of `base` (strides in elements), read in
// boxes of `cols` columns by T rows; rows past S read as zeros.
bool encode_rows(CUtensorMap* map, const void* base, bool bf16, int P,
                 int S, int H, int B, long long ss, long long sh,
                 long long sb, int cols) {
  const hopper::EncodeTiledFn fn = hopper::encode_tiled();
  if (fn == nullptr) return false;
  const int es = bf16 ? 2 : 4;
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(P),
                              static_cast<cuuint64_t>(S),
                              static_cast<cuuint64_t>(H),
                              static_cast<cuuint64_t>(B)};
  const cuuint64_t strides[3] = {static_cast<cuuint64_t>(ss * es),
                                 static_cast<cuuint64_t>(sh * es),
                                 static_cast<cuuint64_t>(sb * es)};
  const cuuint32_t box[4] = {static_cast<cuuint32_t>(cols), T, 1, 1};
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  return fn(map,
            bf16 ? CU_TENSOR_MAP_DATA_TYPE_BFLOAT16
                 : CU_TENSOR_MAP_DATA_TYPE_FLOAT32,
            4, const_cast<void*>(base), dims, strides, box, elem,
            CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE,
            CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <typename E, int P>
cudaError_t launch_p(const Params& p, cudaStream_t stream) {
  using C = Cfg<E, P>;
  auto kernel = wkv_kernel<E, P>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, C::BYTES);
  if (err != cudaSuccess) return err;
  const dim3 grid(P / C::QB, p.H, p.B);
  kernel<<<grid, C::NT, C::BYTES, stream>>>(p);
  return cudaGetLastError();
}

template <typename E>
cudaError_t launch(const Params& p, cudaStream_t stream) {
  switch (p.P) {
    case 16:
      return launch_p<E, 16>(p, stream);
    case 32:
      return launch_p<E, 32>(p, stream);
    case 64:
      return launch_p<E, 64>(p, stream);
    case 128:
      return launch_p<E, 128>(p, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// Plain C interface, loaded with ctypes.  Returns a cudaError_t (0 = the
// launch was accepted), or -1 if cuTensorMapEncodeTiled refused a tensor
// map; `dtype` is 0 for float32, 1 for bfloat16 (r, k, v and y; w, u and
// the states are f32).  `init` may be null (zero state).  The caller has
// checked shapes, dtypes and strides (the last dim contiguous, the others
// and the bases multiples of 16 bytes).
extern "C" int rwkv6_wkv(const void* r, const void* k, const void* v,
                         const float* w, const float* u, const float* init,
                         void* y, float* state, int B, int S, int H, int P,
                         long long srb, long long srs, long long srh,
                         long long skb, long long sks, long long skh,
                         long long svb, long long svs, long long svh,
                         long long swb, long long sws, long long swh,
                         int dtype, void* stream) {
  if (dtype != 0 && dtype != 1) return cudaErrorInvalidValue;
  if (P != 16 && P != 32 && P != 64 && P != 128) return cudaErrorInvalidValue;
  const bool bf16 = dtype == 1;
  const int qb = COLS < P ? COLS : P;
  Params p;
  if (!encode_rows(&p.rmap, r, bf16, P, S, H, B, srs, srh, srb, P) ||
      !encode_rows(&p.kmap, k, bf16, P, S, H, B, sks, skh, skb, P) ||
      !encode_rows(&p.wmap, w, false, P, S, H, B, sws, swh, swb, P) ||
      !encode_rows(&p.vmap, v, bf16, P, S, H, B, svs, svh, svb, qb))
    return -1;
  p.u = u;
  p.init = init;
  p.y = y;
  p.state = state;
  p.B = B;
  p.S = S;
  p.H = H;
  p.P = P;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return bf16 ? launch<__nv_bfloat16>(p, st) : launch<float>(p, st);
}

extern "C" const char* rwkv6_wkv_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
