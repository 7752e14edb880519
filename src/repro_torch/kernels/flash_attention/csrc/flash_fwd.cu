// Flash attention forward for Hopper (sm_90a), written by hand.
//
// Replaces the Pallas TPU kernel
//   src/repro/kernels/flash_attention/kernel.py::flash_attention_fwd
//   (body _flash_fwd_kernel)
// and computes what the reference model's attention computes
// (src/repro/models/layers.py::_chunk_mask / _flash_fwd_impl):
//
//   out = softmax(Q K^T / sqrt(D) + mask) V
//   mask(q, k) = k_pos >= 0
//                && (!causal || (k_pos <= q_pos
//                                && (!window || q_pos - k_pos < window)))
//
// with an online softmax in f32 and the reference's guard for rows that
// are fully masked so far (max(m, -1e29), denominator max(l, 1e-30)).  A
// row that stays fully masked gives zeros.
//
// Layout: q (B,S,Hq,D), k/v (B,T,Hkv,D) with any strides on B, S and H and
// D contiguous; out (B,S,Hq,D) contiguous, in q's dtype (f32 or bf16).
// D is one of 16, 32, 64, 80, 128 (the reduced and the published head dims;
// 80 is zamba2-2.7b's shared attention, 2560 / 32).
// GQA without repeating KV: query head h reads kv head h / (Hq / Hkv),
// the mapping jnp.repeat(k, G, axis=2) gives in the reference.
//
// What bounds it on an H100: at the serving prefill shape (B=3, S=T=1024,
// Hq=16, Hkv=8, D=128, bf16, causal) the work is ~12.9 GFLOP per layer
// against ~38 MB of q/k/v/out, ~340 FLOP per byte, above the card's ~295
// FLOP/byte bf16 ridge: the bound is the tensor-core rate.
//
// Two kernels, one per dtype, both one block per (batch*head, 64-row
// query tile), both streaming 64-key K/V tiles through shared memory:
//
// * bf16 (the served model's dtype): tensor cores through mma.sync
//   m16n8k16 with f32 accumulation, FlashAttention-2 style.  Four warps
//   own 16 query rows each; Q lives in registers as A fragments, the
//   scores stay in registers and are re-packed as the A fragments of the
//   P.V product, V's B fragments come from ldmatrix.trans.  The row
//   max/sum are reduced across the 4 lanes that share a row.  Not done
//   yet (later work): wgmma, TMA, double-buffered K/V loads and warp
//   specialisation, so loads and math do not overlap inside a block.
// * f32: CUDA cores (tensor cores would round to tf32 and break the
//   reference's 5e-5 f32 tolerance); K transposed in shared memory for
//   conflict-free score reads, 4 x (4 | D/16) register tiles per thread.
//
// A KV tile none of whose keys can be seen by any query of the tile
// (judged from the positions loaded, not assumed monotone) is skipped,
// which halves the causal work.  Query tiles are issued last tile first,
// so the causal tiles with the most keys start earliest.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <climits>
#include <cmath>
#include <cstdint>
#include <initializer_list>

namespace {

constexpr int BQ = 64;    // query rows per block
constexpr int BK = 64;    // key rows per KV tile
constexpr float NEG_INF = -1e30f;

struct Params {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  const int* q_pos;
  const int* k_pos;
  int B, S, T, Hq, Hkv;
  long long sqb, sqs, sqh;
  long long skb, sks, skh;
  long long svb, svs, svh;
  int window;
  int causal;
  int vec;      // bf16: every row start is 16-byte aligned (uint4 loads)
  float scale;
};

__device__ __forceinline__ bool visible(int qp, int kp, int causal,
                                        int window) {
  if (kp < 0) return false;  // unwritten ring slot
  if (!causal) return true;
  if (kp > qp) return false;
  return window == 0 || (long long)qp - kp < window;
}

// Position range of the block's valid query rows (positions in shared
// memory), for skipping KV tiles.
__device__ __forceinline__ void query_range(const int* qp_s, int nrows,
                                            long long& qmin,
                                            long long& qmax) {
  qmin = LLONG_MAX;
  qmax = LLONG_MIN;
  for (int r = 0; r < nrows; ++r) {
    qmin = min(qmin, (long long)qp_s[r]);
    qmax = max(qmax, (long long)qp_s[r]);
  }
}

// Can key position kp (of tile slot t < T) be seen by some query in
// [qmin, qmax]?
__device__ __forceinline__ bool tile_key_live(int kp, const Params& p,
                                              long long qmin,
                                              long long qmax) {
  return kp >= 0 &&
         (!p.causal ||
          (kp <= qmax && (p.window == 0 || kp > qmin - p.window)));
}

// ===========================================================================
// bf16: tensor cores (mma.sync m16n8k16, f32 accumulate)
// ===========================================================================

constexpr int TC_NT = 128;  // 4 warps x 16 query rows

__device__ __forceinline__ uint32_t ld_u32(const __nv_bfloat16* ptr) {
  return *reinterpret_cast<const uint32_t*>(ptr);
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);  // .x in the low half
  return *reinterpret_cast<uint32_t*>(&v);
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

// Stage a 64 x D tile (rows of `row_stride` elements; rows past `valid`
// are zeros) into shared memory rows of ST elements.
template <int D, int ST>
__device__ __forceinline__ void stage_tile(__nv_bfloat16* dst,
                                           const __nv_bfloat16* src,
                                           long long row_stride, int valid,
                                           int vec, int tid) {
  constexpr int CH = D / 8;  // 16-byte chunks per row
  for (int e = tid; e < BK * CH; e += TC_NT) {
    const int r = e / CH, c = (e % CH) * 8;
    union {
      uint4 u;
      unsigned short h[8];
    } val;
    val.u = make_uint4(0u, 0u, 0u, 0u);
    if (r < valid) {
      const __nv_bfloat16* s = src + r * row_stride + c;
      if (vec) {
        val.u = *reinterpret_cast<const uint4*>(s);
      } else {
        const unsigned short* s16 = reinterpret_cast<const unsigned short*>(s);
#pragma unroll
        for (int i = 0; i < 8; ++i) val.h[i] = s16[i];
      }
    }
    *reinterpret_cast<uint4*>(dst + r * ST + c) = val.u;
  }
}

template <int D>
struct TcSmem {
  static constexpr int ST = D + 8;  // row stride: 16-byte rows, no conflicts
  static constexpr int BYTES = 2 * BK * ST * 2 + (BQ + BK) * 4;
};

template <int D>
__global__ void __launch_bounds__(TC_NT)
    flash_fwd_bf16_kernel(const Params p) {
  using bf16 = __nv_bfloat16;
  constexpr int ST = TcSmem<D>::ST;
  constexpr int KD = D / 16;   // k-steps of Q.K^T over the head dim
  constexpr int ND = D / 8;    // n-tiles of P.V over the head dim
  constexpr int NK = BK / 8;   // n-tiles of Q.K^T over the keys
  static_assert(BQ == BK && BQ == 16 * (TC_NT / 32), "tile shape");

  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* Ks = reinterpret_cast<bf16*>(smem_raw);  // also stages Q
  bf16* Vs = Ks + BK * ST;
  int* kp_s = reinterpret_cast<int*>(Vs + BK * ST);
  int* qp_s = kp_s + BK;

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, tig = lane & 3;  // mma fragment row / column pair
  const int b = blockIdx.x / p.Hq;
  const int h = blockIdx.x % p.Hq;
  const int hk = h / (p.Hq / p.Hkv);
  const int q0 = (gridDim.y - 1 - blockIdx.y) * BQ;
  const int nrows = min(BQ, p.S - q0);

  const bf16* qg = static_cast<const bf16*>(p.q) + b * p.sqb + h * p.sqh +
                   q0 * p.sqs;
  const bf16* kg = static_cast<const bf16*>(p.k) + b * p.skb + hk * p.skh;
  const bf16* vg = static_cast<const bf16*>(p.v) + b * p.svb + hk * p.svh;

  // -- Q tile -> A fragments in registers (rows r0 and r0 + 8) -------------
  stage_tile<D, ST>(Ks, qg, p.sqs, nrows, p.vec, tid);
  if (tid < BQ) qp_s[tid] = tid < nrows ? p.q_pos[q0 + tid] : 0;
  __syncthreads();
  const int r0 = warp * 16 + g;
  uint32_t qf[KD][4];
#pragma unroll
  for (int kk = 0; kk < KD; ++kk) {
    const bf16* lo = Ks + r0 * ST + kk * 16 + tig * 2;
    const bf16* hi = lo + 8 * ST;
    qf[kk][0] = ld_u32(lo);
    qf[kk][1] = ld_u32(hi);
    qf[kk][2] = ld_u32(lo + 8);
    qf[kk][3] = ld_u32(hi + 8);
  }
  const int qp[2] = {qp_s[r0], qp_s[r0 + 8]};
  long long qmin, qmax;
  query_range(qp_s, nrows, qmin, qmax);

  float o[ND][4];
#pragma unroll
  for (int j = 0; j < ND; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[j][e] = 0.f;
  float m[2] = {NEG_INF, NEG_INF}, l[2] = {0.f, 0.f};
  // scores in the log2 domain: exp(x - m) == exp2(x*log2e - m*log2e)
  const float sl2 = p.scale * 1.4426950408889634f;

  for (int t0 = 0; t0 < p.T; t0 += BK) {
    const int valid = min(BK, p.T - t0);
    int kp = -1;
    bool any = false;
    if (tid < BK) {
      kp = tid < valid ? p.k_pos[t0 + tid] : -1;
      any = tile_key_live(kp, p, qmin, qmax);
    }
    // Barrier: every warp is done with the previous tile (and with the Q
    // staged in Ks) before Ks, Vs and kp_s are overwritten.
    if (!__syncthreads_or(any)) continue;
    if (tid < BK) kp_s[tid] = kp;
    stage_tile<D, ST>(Ks, kg + t0 * p.sks, p.sks, valid, p.vec, tid);
    stage_tile<D, ST>(Vs, vg + t0 * p.svs, p.svs, valid, p.vec, tid);
    __syncthreads();

    // -- S = Q K^T: 16 rows x 64 keys per warp ------------------------------
    float s[NK][4];
#pragma unroll
    for (int j = 0; j < NK; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
      const bf16* krow = Ks + (j * 8 + g) * ST + tig * 2;
#pragma unroll
      for (int kk = 0; kk < KD; ++kk)
        mma_bf16(s[j], qf[kk], ld_u32(krow + kk * 16),
                 ld_u32(krow + kk * 16 + 8));
    }

    // -- mask, scale, online softmax (rows r0: e = 0,1; r0 + 8: e = 2,3) ---
    float mx[2] = {NEG_INF, NEG_INF};
#pragma unroll
    for (int j = 0; j < NK; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int c = j * 8 + tig * 2 + (e & 1);
        const float x = visible(qp[e >> 1], kp_s[c], p.causal, p.window)
                            ? s[j][e] * sl2
                            : NEG_INF;
        s[j][e] = x;
        mx[e >> 1] = fmaxf(mx[e >> 1], x);
      }
    float m_safe[2], corr[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      const float m_new = fmaxf(m[r], mx[r]);
      m_safe[r] = fmaxf(m_new, -1e29f);  // fully masked row guard
      corr[r] = exp2f(fmaxf(m[r], -1e29f) - m_safe[r]);
      m[r] = m_new;
    }
    float rs[2] = {0.f, 0.f};
#pragma unroll
    for (int j = 0; j < NK; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float pr = exp2f(s[j][e] - m_safe[e >> 1]);
        s[j][e] = pr;
        rs[e >> 1] += pr;
      }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      rs[r] += __shfl_xor_sync(0xffffffffu, rs[r], 1);
      rs[r] += __shfl_xor_sync(0xffffffffu, rs[r], 2);
      l[r] = l[r] * corr[r] + rs[r];
    }
#pragma unroll
    for (int j = 0; j < ND; ++j) {
      o[j][0] *= corr[0];
      o[j][1] *= corr[0];
      o[j][2] *= corr[1];
      o[j][3] *= corr[1];
    }

    // -- O += P V: P's accumulator fragments are the A fragments -----------
    const int lm = lane >> 3, lr = lane & 7;  // ldmatrix matrix / row
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      const uint32_t a[4] = {pack_bf16(s[2 * kk][0], s[2 * kk][1]),
                             pack_bf16(s[2 * kk][2], s[2 * kk][3]),
                             pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]),
                             pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3])};
      const bf16* vrow = Vs + (kk * 16 + (lm & 1) * 8 + lr) * ST +
                         (lm >> 1) * 8;
#pragma unroll
      for (int j = 0; j < ND; j += 2) {
        uint32_t bv[4];
        ldmatrix_x4_trans(bv, vrow + j * 8);
        mma_bf16(o[j], a, bv[0], bv[1]);
        mma_bf16(o[j + 1], a, bv[2], bv[3]);
      }
    }
  }

  bf16* og = static_cast<bf16*>(p.o);
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = r0 + 8 * r;
    if (row >= nrows) continue;
    const float inv = 1.f / fmaxf(l[r], 1e-30f);
    bf16* orow = og + ((static_cast<long long>(b) * p.S + q0 + row) * p.Hq +
                       h) * D + tig * 2;
#pragma unroll
    for (int j = 0; j < ND; ++j)
      *reinterpret_cast<__nv_bfloat162*>(orow + j * 8) =
          __floats2bfloat162_rn(o[j][2 * r] * inv, o[j][2 * r + 1] * inv);
  }
}

// ===========================================================================
// f32: CUDA cores
// ===========================================================================

constexpr int NT = 256;  // 16 row groups x 16 column groups

// Shared-memory row strides (in floats), padded so that the access
// patterns below are free of bank conflicts.
template <int D>
struct Smem {
  static constexpr int QST = D + 4;   // Qs[BQ][QST]
  static constexpr int KST = BK + 1;  // Kt[D][KST]  (K transposed)
  static constexpr int VST = D;       // Vs[BK][VST]
  static constexpr int PST = BK + 4;  // Ps[BQ][PST] (scores, then probs)
  static constexpr int FLOATS =
      BQ * QST + D * KST + BK * VST + BQ * PST + 3 * BQ;
  static constexpr int BYTES = FLOATS * 4 + (BQ + BK) * 4;
};

template <int D>
__global__ void __launch_bounds__(NT) flash_fwd_f32_kernel(const Params p) {
  using L = Smem<D>;
  constexpr int DJ = D / 16;  // output columns per thread
  extern __shared__ float smem[];
  float* Qs = smem;
  float* Kt = Qs + BQ * L::QST;
  float* Vs = Kt + D * L::KST;
  float* Ps = Vs + BK * L::VST;
  float* m_s = Ps + BQ * L::PST;  // running row max
  float* l_s = m_s + BQ;          // running row sum
  float* c_s = l_s + BQ;          // this tile's rescale factor per row
  int* qp_s = reinterpret_cast<int*>(c_s + BQ);
  int* kp_s = qp_s + BQ;

  const int tid = threadIdx.x;
  const int b = blockIdx.x / p.Hq;
  const int h = blockIdx.x % p.Hq;
  const int hk = h / (p.Hq / p.Hkv);
  const int q0 = (gridDim.y - 1 - blockIdx.y) * BQ;
  const int nrows = min(BQ, p.S - q0);

  const float* qg = static_cast<const float*>(p.q) + b * p.sqb + h * p.sqh;
  const float* kg = static_cast<const float*>(p.k) + b * p.skb + hk * p.skh;
  const float* vg = static_cast<const float*>(p.v) + b * p.svb + hk * p.svh;

  for (int e = tid; e < BQ * D; e += NT) {
    const int r = e / D, d = e % D;
    Qs[r * L::QST + d] = r < nrows ? qg[(q0 + r) * p.sqs + d] : 0.f;
  }
  if (tid < BQ) {
    qp_s[tid] = tid < nrows ? p.q_pos[q0 + tid] : 0;
    m_s[tid] = NEG_INF;
    l_s[tid] = 0.f;
  }
  __syncthreads();
  long long qmin, qmax;
  query_range(qp_s, nrows, qmin, qmax);

  const int rg = tid / 16;  // rows rg*4 .. rg*4+3
  const int cg = tid % 16;  // columns cg + 16*j
  float acc[4][DJ];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < DJ; ++j) acc[i][j] = 0.f;

  for (int t0 = 0; t0 < p.T; t0 += BK) {
    // -- key positions; is any key of the tile visible to any query? ----
    bool any = false;
    if (tid < BK) {
      const int t = t0 + tid;
      const int kp = t < p.T ? p.k_pos[t] : -1;
      kp_s[tid] = kp;
      any = tile_key_live(kp, p, qmin, qmax);
    }
    // also the barrier after the previous tile's P.V reads
    if (!__syncthreads_or(any)) continue;

    // -- stage K (transposed) and V; rows past T are zeros ---------------
    for (int e = tid; e < BK * D; e += NT) {
      const int c = e / D, d = e % D;
      const int t = t0 + c;
      float kv = 0.f, vv = 0.f;
      if (t < p.T) {
        kv = kg[t * p.sks + d];
        vv = vg[t * p.svs + d];
      }
      Kt[d * L::KST + c] = kv;
      Vs[c * L::VST + d] = vv;
    }
    __syncthreads();

    // -- scores S = Q K^T * scale, masked ---------------------------------
    float sc[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) sc[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < D; ++d) {
      float qv[4], kv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) qv[i] = Qs[(rg * 4 + i) * L::QST + d];
#pragma unroll
      for (int j = 0; j < 4; ++j) kv[j] = Kt[d * L::KST + cg + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) sc[i][j] = fmaf(qv[i], kv[j], sc[i][j]);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = rg * 4 + i;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = cg + 16 * j;
        Ps[r * L::PST + c] = visible(qp_s[r], kp_s[c], p.causal, p.window)
                                 ? sc[i][j] * p.scale
                                 : NEG_INF;
      }
    }
    __syncthreads();

    // -- online softmax: 4 neighbouring lanes per row ---------------------
    {
      const int r = tid >> 2, part = tid & 3;
      float* row = Ps + r * L::PST;
      float mx = NEG_INF;
#pragma unroll
      for (int c = 0; c < BK / 4; ++c) mx = fmaxf(mx, row[4 * c + part]);
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float m_old = m_s[r];
      const float m_new = fmaxf(m_old, mx);
      const float m_safe = fmaxf(m_new, -1e29f);  // fully masked row guard
      float sum = 0.f;
#pragma unroll
      for (int c = 0; c < BK / 4; ++c) {
        const float pr = expf(row[4 * c + part] - m_safe);
        row[4 * c + part] = pr;
        sum += pr;
      }
      sum += __shfl_xor_sync(0xffffffffu, sum, 1);
      sum += __shfl_xor_sync(0xffffffffu, sum, 2);
      // the shuffles order every lane's read of m_s[r] before this write
      if (part == 0) {
        const float corr = expf(fmaxf(m_old, -1e29f) - m_safe);
        l_s[r] = l_s[r] * corr + sum;
        m_s[r] = m_new;
        c_s[r] = corr;
      }
    }
    __syncthreads();

    // -- acc = diag(corr) acc + P V ------------------------------------
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float corr = c_s[rg * 4 + i];
#pragma unroll
      for (int j = 0; j < DJ; ++j) acc[i][j] *= corr;
    }
#pragma unroll 4
    for (int c = 0; c < BK; ++c) {
      float pv[4], vv[DJ];
#pragma unroll
      for (int i = 0; i < 4; ++i) pv[i] = Ps[(rg * 4 + i) * L::PST + c];
#pragma unroll
      for (int j = 0; j < DJ; ++j) vv[j] = Vs[c * L::VST + cg + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < DJ; ++j) acc[i][j] = fmaf(pv[i], vv[j], acc[i][j]);
    }
  }

  float* og = static_cast<float*>(p.o);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = rg * 4 + i;
    if (r >= nrows) continue;
    const float denom = fmaxf(l_s[r], 1e-30f);
    float* orow = og + ((static_cast<long long>(b) * p.S + q0 + r) * p.Hq + h) * D;
#pragma unroll
    for (int j = 0; j < DJ; ++j) orow[cg + 16 * j] = acc[i][j] / denom;
  }
}

template <typename Kernel>
cudaError_t launch(Kernel kernel, int threads, int bytes, const Params& p,
                   cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return err;
  const dim3 grid(p.B * p.Hq, (p.S + BQ - 1) / BQ);
  kernel<<<grid, threads, bytes, stream>>>(p);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_f32(const Params& p, cudaStream_t st) {
  return launch(flash_fwd_f32_kernel<D>, NT, Smem<D>::BYTES, p, st);
}

template <int D>
cudaError_t launch_bf16(const Params& p, cudaStream_t st) {
  return launch(flash_fwd_bf16_kernel<D>, TC_NT, TcSmem<D>::BYTES, p, st);
}

}  // namespace

// Plain C interface, loaded with ctypes.  Returns a cudaError_t (0 = the
// launch was accepted); `dtype` is 0 for float32, 1 for bfloat16.  The
// caller has checked shapes, strides and dtypes.
extern "C" int flash_fwd(const void* q, const void* k, const void* v,
                         void* o, const int* q_pos, const int* k_pos, int B,
                         int S, int T, int Hq, int Hkv, int D, long long sqb,
                         long long sqs, long long sqh, long long skb,
                         long long sks, long long skh, long long svb,
                         long long svs, long long svh, int window,
                         int causal, int dtype, void* stream) {
  Params p;
  p.q = q;
  p.k = k;
  p.v = v;
  p.o = o;
  p.q_pos = q_pos;
  p.k_pos = k_pos;
  p.B = B;
  p.S = S;
  p.T = T;
  p.Hq = Hq;
  p.Hkv = Hkv;
  p.sqb = sqb;
  p.sqs = sqs;
  p.sqh = sqh;
  p.skb = skb;
  p.sks = sks;
  p.skh = skh;
  p.svb = svb;
  p.svs = svs;
  p.svh = svh;
  p.window = window;
  p.causal = causal;
  p.scale = static_cast<float>(1.0 / std::sqrt(static_cast<double>(D)));
  // 16-byte row starts for the bf16 kernel's uint4 loads: aligned base
  // pointers and strides that are multiples of 8 elements.
  p.vec = 1;
  for (const void* ptr : {q, k, v})
    if (reinterpret_cast<uintptr_t>(ptr) % 16) p.vec = 0;
  for (long long s : {sqb, sqs, sqh, skb, sks, skh, svb, svs, svh})
    if (s % 8) p.vec = 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    if (D == 16) return launch_f32<16>(p, st);
    if (D == 32) return launch_f32<32>(p, st);
    if (D == 64) return launch_f32<64>(p, st);
    if (D == 80) return launch_f32<80>(p, st);
    if (D == 128) return launch_f32<128>(p, st);
  } else if (dtype == 1) {
    if (D == 16) return launch_bf16<16>(p, st);
    if (D == 32) return launch_bf16<32>(p, st);
    if (D == 64) return launch_bf16<64>(p, st);
    if (D == 80) return launch_bf16<80>(p, st);
    if (D == 128) return launch_bf16<128>(p, st);
  }
  return cudaErrorInvalidValue;
}

extern "C" const char* flash_fwd_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
