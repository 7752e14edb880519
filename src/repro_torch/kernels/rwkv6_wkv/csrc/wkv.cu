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
// f32, each with any strides on the leading dims and the last dim
// contiguous, read in place (no copy folds (B,H) into rows); u (H,P) f32
// contiguous; init (B,H,P,P) f32 contiguous or null; y (B,S,H,P)
// contiguous in r's dtype; the final state (B,H,P,P) f32 contiguous.
// P is 16, 32, 64 or 128 (the wrapper checks).  S may be ragged: rows
// past S act as w = 1 and r = k = v = 0; they are not read, and y's rows
// there are not stored.
//
// Arithmetic: f64, from the inputs as given to y and the state, which are
// rounded once to f32 (and y then to r's dtype), as the plain version
// does.  The reference computes in f32; its chunk of 16 keeps the decay
// factors in f32's range (k~ reaches e^80 |k| at the rate cap of 5).  f64
// is for agreement: in a bf16 model y is rounded to bf16 before the group
// norm, and y from two f32 computations that differ in the last bit now
// and then lands on another bf16 value; rwkv6-7b carries those flips
// through 32 layers to 8.6% of the largest prefill logit (plain bf16 vs
// f32: 16.7%).  Two f64 computations of y round to the same f32 value all
// but never, so the kernel and the plain version give the same bf16
// activations.  The products run on the f64 tensor cores (mma.m8n8k4),
// the decays on the CUDA cores.
//
// The Pallas kernel carries the state in VMEM across the grid's
// sequential chunk axis.  Blocks on Hopper run in no order, so here one
// block of four warps owns a (b, h, 32 columns q of v) and walks the
// chunks in a loop.  Column q of y and of the state depends only on
// column q of v and of the state, so splitting v's columns is exact; each
// block recomputes the chunk's decays and scores, which all its columns
// share.  At rwkv6-7b's prefill (B 3, H 64, P 64) that is 384 blocks on
// 132 SMs, three an SM, all resident at once.  A chunk takes two barriers:
//   1. decays, two threads a column (rows 0-7 and 8-15), from the
//      registers the loads filled: prefix products joined by a shuffle;
//      r~ and k~ into shared memory, the bonus sums r u k reduced over a
//      warp's columns by shuffles;
//   2. each warp: one 8 x 8 tile of the scores (masked, the bonus on the
//      diagonal), its tiles of y = r~ state (from a shared copy of the
//      state) and of the state update k~^T v, the state held as the
//      accumulators of those mma for the whole sequence;
//   3. y += scores v, stored; the new state's shared copy; the next
//      chunk's v into the other of two buffers.
// The next chunk's r, k, w and v are loaded into registers after the
// decays and are in flight while the chunk computes.
//
// What bounds it on an H100: at that prefill shape (S 1024, bf16 r, k, v
// and y, f32 w and states) the bytes, 157.3 MB, take 0.047 ms at
// 3.35 TB/s; the reference algorithm's 4.03 GFLOP take 0.060 ms at the
// f64 tensor-core rate.  What limits it is latency: 64 chunks a block in
// order, each a chain of dependent steps (decays, shuffles, mma chains,
// two barriers) that three blocks an SM cannot hide.  Earlier designs,
// timed by chip_smoke.py at that shape: f32 FMAs with the state and the
// decays in shared memory, 0.99 ms; the same in f64, 1.01 ms.  Not done
// yet (later work): several chunks a step so that the chains overlap,
// TMA.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int T = 16;  // rows per chunk (the reference's CHUNK)
constexpr unsigned FULL = 0xffffffffu;

// Block shape for head dim P: QB columns of v, NT = 128 threads (4
// warps); CPT columns of the decays a thread computes (two threads a
// column).  Tiles are the 8 x 8 outputs of mma.m8n8k4: YPW of y (T x QB)
// and SPW of the state (P x QB) a warp.  Row strides of the shared tiles
// (PS, SS, SCS doubles, VS floats; at 32 columns) are 32 bytes past a
// multiple of 128, so a fragment's rows spread over the banks.
template <int P>
struct Cfg {
  static constexpr int QB = P >= 32 ? 32 : P;
  static constexpr int NT = 128;
  static constexpr int CPT = P > NT / 2 ? P / (NT / 2) : 1;
  static constexpr int YPW = (T / 8) * (QB / 8) / 4;
  static constexpr int SPW = (P / 8) * (QB / 8) / 4;
  static constexpr int PS = P + 4, SS = QB + 4, SCS = T + 4, VS = QB + 8;
  // blocks an SM should hold at once (registers capped at 65536 / (NT *
  // MIN_BLOCKS) a thread): at P = 64 three, 168 registers a thread; four
  // (128) spill the prefetched chunk and wait on its loads
  static constexpr int MIN_BLOCKS = P >= 128 ? 2 : 3;
  // warps whose columns hold the decays (16 columns a warp and pass)
  static constexpr int DW = P / 16 < 4 ? P / 16 : 4;
  // f64: r~, k~ (T x PS), state (P x SS), scores (T x SCS), incl_last
  // (P), each warp's share of the bonus sums (4 x T); f32: v, two buffers
  // (T x VS)
  static constexpr int BYTES =
      (2 * T * PS + P * SS + T * SCS + P + 4 * T) * 8 + 2 * T * VS * 4;
};

struct Params {
  const void* r;
  const void* k;
  const void* v;
  const float* w;
  const float* u;
  const float* init;  // null: zero initial state
  void* y;
  float* state;
  int B, S, H, P;
  long long srb, srs, srh;  // r strides in elements (P contiguous)
  long long skb, sks, skh;  // k strides
  long long svb, svs, svh;  // v strides
  long long swb, sws, swh;  // w strides
};

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
// y rounded to f32, then to the output's dtype
__device__ __forceinline__ void store(float* dst, double x) {
  *dst = static_cast<float>(x);
}
__device__ __forceinline__ void store(__nv_bfloat16* dst, double x) {
  *dst = __float2bfloat16_rn(static_cast<float>(x));
}

// c (8 x 8) += a (8 x 4, row) * b (4 x 8, col), f64 on the tensor cores.
// Lane l holds a[l / 4][l % 4], b[l % 4][l / 4] and c[l / 4][2 (l % 4) + e].
__device__ __forceinline__ void dmma(double (&c)[2], double a, double b) {
  asm volatile(
      "mma.sync.aligned.m8n8k4.row.col.f64.f64.f64.f64 "
      "{%0,%1}, {%2}, {%3}, {%0,%1};\n"
      : "+d"(c[0]), "+d"(c[1])
      : "d"(a), "d"(b));
}

template <typename E, int P>
__global__ void __launch_bounds__(Cfg<P>::NT, Cfg<P>::MIN_BLOCKS)
    wkv_kernel(const Params p) {
  constexpr int QB = Cfg<P>::QB, NT = Cfg<P>::NT, CPT = Cfg<P>::CPT;
  constexpr int YPW = Cfg<P>::YPW, SPW = Cfg<P>::SPW;
  constexpr int PS = Cfg<P>::PS, SS = Cfg<P>::SS, SCS = Cfg<P>::SCS;
  constexpr int VS = Cfg<P>::VS;
  constexpr int H8 = T / 2;        // rows of a column a thread decays
  constexpr int LV = T * QB / NT;  // v elements a thread loads
  constexpr int QT = QB / 8;       // tiles across the columns
  static_assert(T * QB % NT == 0 && CPT * NT / 2 >= P && YPW >= 1 &&
                    SPW >= 1 && (T / 8) * (T / 8) == NT / 32,
                "tile split");

  extern __shared__ __align__(16) unsigned char smem[];
  double* rt = reinterpret_cast<double*>(smem);  // [T][PS] r~
  double* kt = rt + T * PS;                      // [T][PS] k~
  double* sm = kt + T * PS;      // [P][SS] state before this chunk
  double* sc = sm + P * SS;      // [T][SCS] scores, bonus on the diagonal
  double* blast = sc + T * SCS;  // [P] incl_last
  double* bonus = blast + P;     // [4][T] each warp's sum_p r u k
  float* vbuf = reinterpret_cast<float*>(bonus + 4 * T);  // [2][T][VS] v

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int gid = lane >> 2, tig = lane & 3;  // fragment row, column
  const int half = tid & 1;  // decay rows half*8 .. half*8 + 7
  const int q0 = blockIdx.x * QB, h = blockIdx.y, b = blockIdx.z;
  const int nc = (p.S + T - 1) / T;
  const E* rg = static_cast<const E*>(p.r) + b * p.srb + h * p.srh;
  const E* kg = static_cast<const E*>(p.k) + b * p.skb + h * p.skh;
  const E* vg = static_cast<const E*>(p.v) + b * p.svb + h * p.svh + q0;
  const float* wg = p.w + b * p.swb + h * p.swh;
  E* yg = static_cast<E*>(p.y);

  // Chunk c into registers, as the decays use it: r, k, w of rows
  // half*8 .. half*8 + 7 of columns tid/2 + NT/2 * cc; and v, element
  // tid + NT * a (row e / QB, column e % QB).  Rows past S as w = 1,
  // r = k = v = 0.
  float pr[CPT][H8], pk[CPT][H8], pw[CPT][H8], pv[LV];
  auto load = [&](int c) {
    const int s0 = c * T + half * H8;
#pragma unroll
    for (int cc = 0; cc < CPT; ++cc) {
      const int col = (tid >> 1) + (NT / 2) * cc;
      if (col >= P) continue;
#pragma unroll
      for (int s = 0; s < H8; ++s) {
        const bool ok = s0 + s < p.S;
        const long long row = s0 + s;
        pr[cc][s] = ok ? to_f32(rg[row * p.srs + col]) : 0.f;
        pk[cc][s] = ok ? to_f32(kg[row * p.sks + col]) : 0.f;
        pw[cc][s] = ok ? wg[row * p.sws + col] : 1.f;
      }
    }
#pragma unroll
    for (int a = 0; a < LV; ++a) {
      const int e = tid + NT * a, s = c * T + e / QB;
      pv[a] = s < p.S ? to_f32(vg[s * p.svs + e % QB]) : 0.f;
    }
  };
  auto put_v = [&](float* vs) {
#pragma unroll
    for (int a = 0; a < LV; ++a) {
      const int e = tid + NT * a;
      vs[(e / QB) * VS + e % QB] = pv[a];
    }
  };

  double up[CPT];  // the bonus u of this thread's decay columns
#pragma unroll
  for (int cc = 0; cc < CPT; ++cc) {
    const int col = (tid >> 1) + (NT / 2) * cc;
    up[cc] = col < P ? p.u[h * P + col] : 0.0;
  }
  // The state, as the accumulators of this warp's SPW tiles: tile t =
  // warp * SPW + ss covers rows 8 (t / QT) .. and columns 8 (t % QT) ..;
  // lane holds [8 (t / QT) + gid][8 (t % QT) + 2 tig + e].  A copy in
  // shared memory feeds r~ state.
  const long long st_base =
      (static_cast<long long>(b) * p.H + h) * P * P + q0;
  double sacc[SPW][2];
#pragma unroll
  for (int ss = 0; ss < SPW; ++ss) {
    const int t = warp * SPW + ss, pr0 = 8 * (t / QT) + gid;
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int qc = 8 * (t % QT) + 2 * tig + e;
      sacc[ss][e] = p.init ? p.init[st_base + pr0 * P + qc] : 0.0;
      sm[pr0 * SS + qc] = sacc[ss][e];
    }
  }
  load(0);
  put_v(vbuf);

  for (int c = 0; c < nc; ++c) {
    float* vs = vbuf + (c & 1) * T * VS;
    // Decays of this thread's rows and columns, from registers; the two
    // halves of a column joined by a shuffle (whole warps take part or
    // sit out together): r~, k~ and incl_last; and the bonus terms
    // r u k, summed over the warp's columns by shuffles.
    double ruk[H8];
#pragma unroll
    for (int s = 0; s < H8; ++s) ruk[s] = 0.0;
#pragma unroll
    for (int cc = 0; cc < CPT; ++cc) {
      const int col = (tid >> 1) + (NT / 2) * cc;
      if (col >= P) continue;
      double pre[H8];  // products of this thread's decays up to row s
      double prod = 1.0;
#pragma unroll
      for (int s = 0; s < H8; ++s) {
        prod *= fmax(static_cast<double>(pw[cc][s]), 1e-8);
        pre[s] = prod;
      }
      const double other = __shfl_xor_sync(FULL, prod, 1);
      const double base = half ? other : 1.0;  // decay of the rows before
#pragma unroll
      for (int s = 0; s < H8; ++s) {
        const int idx = (half * H8 + s) * PS + col;
        const double rv = pr[cc][s], kv = pk[cc][s];
        rt[idx] = rv * (s ? base * pre[s - 1] : base);
        kt[idx] = kv / fmax(base * pre[s], 1e-37);
        ruk[s] += rv * up[cc] * kv;
      }
      if (half) blast[col] = base * pre[H8 - 1];
    }
    if (warp < Cfg<P>::DW) {
#pragma unroll
      for (int s = 0; s < H8; ++s) {
#pragma unroll
        for (int o = 2; o < 32; o <<= 1)
          ruk[s] += __shfl_xor_sync(FULL, ruk[s], o);
      }
      if (lane < 2) {
#pragma unroll
        for (int s = 0; s < H8; ++s)
          bonus[warp * T + half * H8 + s] = ruk[s];
      }
    }
    if (c + 1 < nc) load(c + 1);  // in flight while this chunk computes
    // The tiles, this chunk's v and the state before it are written.
    __syncthreads();

    // Scores, tile (warp / 2, warp % 2) of T x T: r~ k~^T strictly below
    // the diagonal, the bonus sum_p r u k on it, zero above.  Two
    // accumulators halve the chain of dependent mma.
    {
      const int mt = warp >> 1, nt = warp & 1;
      double acc[2][2] = {{0.0, 0.0}, {0.0, 0.0}};
#pragma unroll 4
      for (int kk = 0; kk < P; kk += 8) {
        dmma(acc[0], rt[(8 * mt + gid) * PS + kk + tig],
             kt[(8 * nt + gid) * PS + kk + tig]);
        dmma(acc[1], rt[(8 * mt + gid) * PS + kk + 4 + tig],
             kt[(8 * nt + gid) * PS + kk + 4 + tig]);
      }
      const int i = 8 * mt + gid;
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int j = 8 * nt + 2 * tig + e;
        double sv = j < i ? acc[0][e] + acc[1][e] : 0.0;
        if (j == i) {
          sv = 0.0;
#pragma unroll
          for (int ww = 0; ww < Cfg<P>::DW; ++ww) sv += bonus[ww * T + i];
        }
        sc[i * SCS + j] = sv;
      }
    }

    // y = r~ state (this warp's YPW tiles of T x QB; the scores' part
    // waits for the barrier), two accumulators a tile
    double yacc[YPW][2];
#pragma unroll
    for (int yy = 0; yy < YPW; ++yy) {
      const int t = warp * YPW + yy, mt = t / QT, nt = t % QT;
      double odd[2] = {0.0, 0.0};
      yacc[yy][0] = yacc[yy][1] = 0.0;
#pragma unroll 4
      for (int kk = 0; kk < P; kk += 8) {
        dmma(yacc[yy], rt[(8 * mt + gid) * PS + kk + tig],
             sm[(kk + tig) * SS + 8 * nt + gid]);
        dmma(odd, rt[(8 * mt + gid) * PS + kk + 4 + tig],
             sm[(kk + 4 + tig) * SS + 8 * nt + gid]);
      }
      yacc[yy][0] += odd[0];
      yacc[yy][1] += odd[1];
    }

    // state = (state + k~^T v) * incl_last, in the accumulators
#pragma unroll
    for (int ss = 0; ss < SPW; ++ss) {
      const int t = warp * SPW + ss, mt = t / QT, nt = t % QT;
#pragma unroll
      for (int kk = 0; kk < T; kk += 4)
        dmma(sacc[ss], kt[(kk + tig) * PS + 8 * mt + gid],
             static_cast<double>(vs[(kk + tig) * VS + 8 * nt + gid]));
      const double d = blast[8 * mt + gid];
      sacc[ss][0] *= d;
      sacc[ss][1] *= d;
    }
    // The scores are written; the tiles and the state copy are read.
    __syncthreads();

    // y += scores v; store y and the new state's copy
    const int s0 = c * T;
#pragma unroll
    for (int yy = 0; yy < YPW; ++yy) {
      const int t = warp * YPW + yy, mt = t / QT, nt = t % QT;
#pragma unroll
      for (int kk = 0; kk < T; kk += 4)
        dmma(yacc[yy], sc[(8 * mt + gid) * SCS + kk + tig],
             static_cast<double>(vs[(kk + tig) * VS + 8 * nt + gid]));
      const int i = 8 * mt + gid;
      if (s0 + i < p.S) {
        E* yrow = yg + ((static_cast<long long>(b) * p.S + s0 + i) * p.H +
                        h) * P + q0 + 8 * nt + 2 * tig;
        store(yrow, yacc[yy][0]);
        store(yrow + 1, yacc[yy][1]);
      }
    }
#pragma unroll
    for (int ss = 0; ss < SPW; ++ss) {
      const int t = warp * SPW + ss;
      const int idx = (8 * (t / QT) + gid) * SS + 8 * (t % QT) + 2 * tig;
      sm[idx] = sacc[ss][0];
      sm[idx + 1] = sacc[ss][1];
    }
    // The next chunk's v into the other buffer, last read two barriers
    // ago.  The next chunk's decays write only tiles this chunk read
    // before the barrier; its scores wait for its first barrier.
    if (c + 1 < nc) put_v(vbuf + ((c + 1) & 1) * T * VS);
  }
#pragma unroll
  for (int ss = 0; ss < SPW; ++ss) {
    const int t = warp * SPW + ss, pr0 = 8 * (t / QT) + gid;
#pragma unroll
    for (int e = 0; e < 2; ++e)
      p.state[st_base + pr0 * P + 8 * (t % QT) + 2 * tig + e] =
          static_cast<float>(sacc[ss][e]);
  }
}

template <typename E, int P>
cudaError_t launch_p(const Params& p, cudaStream_t stream) {
  auto kernel = wkv_kernel<E, P>;
  const int bytes = Cfg<P>::BYTES;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return err;
  const dim3 grid(P / Cfg<P>::QB, p.H, p.B);
  kernel<<<grid, Cfg<P>::NT, bytes, stream>>>(p);
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
// launch was accepted); `dtype` is 0 for float32, 1 for bfloat16 (r, k, v
// and y; w, u and the states are f32).  `init` may be null (zero state).
// The caller has checked shapes, strides and dtypes.
extern "C" int rwkv6_wkv(const void* r, const void* k, const void* v,
                         const float* w, const float* u, const float* init,
                         void* y, float* state, int B, int S, int H, int P,
                         long long srb, long long srs, long long srh,
                         long long skb, long long sks, long long skh,
                         long long svb, long long svs, long long svh,
                         long long swb, long long sws, long long swh,
                         int dtype, void* stream) {
  Params p;
  p.r = r;
  p.k = k;
  p.v = v;
  p.w = w;
  p.u = u;
  p.init = init;
  p.y = y;
  p.state = state;
  p.B = B;
  p.S = S;
  p.H = H;
  p.P = P;
  p.srb = srb;
  p.srs = srs;
  p.srh = srh;
  p.skb = skb;
  p.sks = sks;
  p.skh = skh;
  p.svb = svb;
  p.svs = svs;
  p.svh = svh;
  p.swb = swb;
  p.sws = sws;
  p.swh = swh;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch<float>(p, st);
  if (dtype == 1) return launch<__nv_bfloat16>(p, st);
  return cudaErrorInvalidValue;
}

extern "C" const char* rwkv6_wkv_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
