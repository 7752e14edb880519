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
// Optionally also the log-sum-exp of each row's scaled scores, which the
// backward pass (plain PyTorch, as the reference's is plain XLA) reads to
// recompute the probabilities: lse (B,Hq,S) f32, in natural-log units,
// max(m, -1e29) + log(max(l, 1e-30)) as _flash_fwd_impl returns it.  A
// null lse pointer writes nothing.  It is stored once a row, by a thread
// that already holds the row's m and l.
//
// Layout: q (B,S,Hq,D), k/v (B,T,Hkv,D) with any strides on B, S and H and
// D contiguous; out (B,S,Hq,D) contiguous, in q's dtype (f32 or bf16).
// D is one of 16, 32, 64, 80, 128 (the reduced and the published head dims;
// 80 is zamba2-2.7b's shared attention, 2560 / 32).
// GQA without repeating KV: query head h reads kv head h / (Hq / Hkv),
// the mapping jnp.repeat(k, G, axis=2) gives in the reference.
//
// What bounds it on an H100, at the served prefill shapes (B=3, S=T=1024,
// bf16, causal; half the score matrix is visible):
// * D 128 (qwen3-0.6b, Hq 16, Hkv 8): 12.9 GFLOP against 37.8 MB, about
//   340 FLOP a byte, above the card's ~295 bf16 ridge: the tensor-core
//   rate (0.013 ms at 989 TFLOP/s).
// * D 80 (zamba2-2.7b, 32 heads, no GQA): 16.1 GFLOP against 62.9 MB:
//   the bytes (0.019 ms at 3.35 TB/s), the operations close behind.
// * D 64 (granite-moe-1b-a400m, Hq 16, Hkv 8): 6.4 GFLOP against 18.9
//   MB: the operations, by a little.
// So the design is the tensor cores' at every served shape: keep them
// fed and keep the loads off the threads that issue the products.
//
// Two kernels, one per dtype.
//
// * bf16 (the served models' dtype), FlashAttention-3 style:
//   - Work items are (batch, head, 128 query rows).  One persistent block
//     an SM walks its share of them, longest first (the last query tiles
//     see the most keys under a causal mask), dealt out in a snake.
//   - A block is three warpgroups.  One warp of the first is the producer:
//     it reads each item's key positions, skips a 128-key tile none of
//     whose keys any query of the item can see, and issues TMA loads of Q
//     (two buffers, so the next item's Q lands while this one runs; it is
//     prefetched into L2 an item ahead) and of K and V (rings of two
//     tiles at D 128, three below), completed on mbarriers.  K and V
//     rounds are freed apart, so the next tile's K loads while V is still
//     in use; a K round with no tile ends an item.
//   - setmaxnreg moves the producer's registers to the two consumer
//     warpgroups, 64 query rows each.  S = Q K^T is a wgmma with both
//     operands in shared memory (K-major); O += P V two wgmmas with P
//     from registers, split into bf16 hi + lo parts (about 16 bits), and
//     V read transposed (MN-major).  Tile j's S is issued with tile
//     j-1's P V, and the softmax of S_j runs while that P V is in
//     flight.  The two groups take turns at the tensor cores (named
//     barriers): one issues while the other runs its softmax.  Row max
//     and sum are reduced across the four lanes that share a row of the
//     accumulator.
//   - TMA reads q, k and v in place through 4-d tensor maps (D, rows,
//     heads, batch) built on the host at each call with the caller's
//     strides; rows past S or T arrive as zeros.  The head dim is split
//     into regions that each fit one swizzle atom: D 16, 32 and 64 one of
//     32-, 64- and 128-byte swizzle; D 128 two 128-byte regions; D 80
//     (160-byte rows fit no atom) one 128-byte region of 64 and one
//     32-byte region of 16, so Q K^T takes five k-steps over both and
//     P V one wgmma of N 64 and one of N 16 (padding D to 128 would cost
//     1.6x the work).
//   - The mask is applied element by element, from the positions, only on
//     tiles the producer did not find visible to every query of the item.
//     The producer hands each item's query positions over beside its Q.
//   - O is staged in the item's Q buffer (its S products are done by then)
//     and stored by TMA, which leaves out rows past S.
// * f32: CUDA cores (tensor cores would round to tf32 and break the
//   reference's 5e-5 f32 tolerance), one block per (batch*head, 64 query
//   rows), 64-key tiles; K transposed in shared memory for conflict-free
//   score reads, 4 x (4 | D/16) register tiles per thread.
//
// Tile skipping is judged from the positions loaded, never assumed
// monotone (ring slots carry -1 and shuffled positions); it halves the
// causal work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <climits>
#include <cmath>
#include <cstdint>

#include "common/hopper.cuh"

namespace {

constexpr float NEG_INF = -1e30f;
constexpr float LN2 = 0.6931471805599453f;

// The C interface's arguments.
struct Params {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  float* lse;  // (B,Hq,S) or null
  const int* q_pos;
  const int* k_pos;
  int B, S, T, Hq, Hkv;
  long long sqb, sqs, sqh;
  long long skb, sks, skh;
  long long svb, svs, svh;
  int window;
  int causal;
  float scale;
};

__device__ __forceinline__ bool visible(int qp, int kp, int causal,
                                        int window) {
  if (kp < 0) return false;  // unwritten ring slot
  if (!causal) return true;
  if (kp > qp) return false;
  return window == 0 || (long long)qp - kp < window;
}

// Can key position kp be seen by some query in [qmin, qmax]?
__device__ __forceinline__ bool tile_key_live(int kp, int causal, int window,
                                              long long qmin,
                                              long long qmax) {
  return kp >= 0 &&
         (!causal || (kp <= qmax && (window == 0 || kp > qmin - window)));
}

// ===========================================================================
// bf16: wgmma fed by TMA
// ===========================================================================

constexpr int WG_BQ = 128;       // query rows a block: 64 a consumer group
constexpr int WG_BK = 128;       // keys a K/V tile
constexpr int WG_THREADS = 384;  // producer group + two consumer groups
constexpr int WG_CONSUMERS = 256;
// setmaxnreg moves registers only within the block's own allocation:
// 384 threads launched at 168 (65536 / 384, rounded down to 8)
constexpr int PRODUCER_REGS = 56;
constexpr int CONSUMER_REGS = 224;
static_assert(PRODUCER_REGS * 128 + CONSUMER_REGS * 256 == 168 * WG_THREADS,
              "register split");
constexpr int SCAN = 8;  // tiles whose positions a warp loads together
static_assert(SCAN * WG_BK == 32 * 32, "the scan reads 32 positions a lane");

struct TmaParams {
  // [0]: head dims 0 .. W0-1; [1]: W0 .. D-1 (D 80 and 128 only); o's
  // boxes are 64 rows, one consumer group's
  CUtensorMap q[2], k[2], v[2], o[2];
  float* lse;  // (B,Hq,S) or null
  const int* q_pos;
  const int* k_pos;
  int B, S, T, Hq, Hkv, window, causal;
  int n_qtiles;      // ceil(S / 128)
  float scale_log2;  // log2(e) / sqrt(D): exp(x - m) = exp2(x' - m')
};

// A block's shared memory, in bytes from a 1024-aligned base.  A tile of
// R rows holds its head dims in one or two regions as TMA wrote them: R
// rows of W0 values (W0 x 2 bytes, the region's swizzle width), then R
// rows of the other W1.  Every region starts 1024-aligned.
template <int D>
struct WgSmem {
  static constexpr int W0 = D < 64 ? D : 64;
  static constexpr int W1 = D - W0;
  static_assert(W0 == 16 || W0 == 32 || W0 == 64, "head dim");
  static_assert(W1 == 0 || W1 == 16 || W1 == 64, "head dim");
  // K and V tiles in flight, each: three where shared memory holds them
  static constexpr int STAGES = D > 80 ? 2 : 3;
  static constexpr int Q_BYTES = WG_BQ * D * 2;
  static constexpr int KV_BYTES = WG_BK * D * 2;
  static constexpr int Q = 0;             // + buffer x Q_BYTES
  static constexpr int K = Q + 2 * Q_BYTES;  // + stage x KV_BYTES
  static constexpr int V = K + STAGES * KV_BYTES;
  static constexpr int KPOS = V + STAGES * KV_BYTES;      // int [stage][BK]
  static constexpr int TILE = KPOS + STAGES * WG_BK * 4;  // int [stage]
  static constexpr int FULL = TILE + STAGES * 4;          // int [stage]
  // int [buffer][BQ]: the query positions beside Q
  static constexpr int QPOS = (FULL + STAGES * 4 + 15) / 16 * 16;
  static constexpr int BARS = QPOS + 2 * WG_BQ * 4;
  // q_full, q_empty [buffer], then k_full, v_full, k_empty, v_empty
  // [stage]; and slack to align the base
  static constexpr int BYTES = BARS + (4 + 4 * STAGES) * 8 + 1024;
  static_assert(BYTES <= 232448, "shared memory of one block");
};

// Positions t .. t+3 (t a multiple of 4, the base 16-byte aligned); -1
// past T.
__device__ __forceinline__ int4 load_pos4(const int* pos, int t, int T) {
  if (t + 3 < T) return __ldg(reinterpret_cast<const int4*>(pos + t));
  int4 r;
  r.x = t < T ? pos[t] : -1;
  r.y = t + 1 < T ? pos[t + 1] : -1;
  r.z = t + 2 < T ? pos[t + 2] : -1;
  r.w = t + 3 < T ? pos[t + 3] : -1;
  return r;
}

// Named barriers (0 is __syncthreads): 1 and 2 between the two consumer
// groups, where one group arrives and the other waits; 3 and 4 within
// one group.
__device__ __forceinline__ void named_sync(int id,
                                           int threads = WG_CONSUMERS) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

__device__ __forceinline__ void named_arrive(int id) {
  asm volatile("bar.arrive %0, %1;\n" ::"r"(id), "n"(WG_CONSUMERS)
               : "memory");
}

// 2^x on the special-function unit; results below 2^-126 flush to zero.
__device__ __forceinline__ float fast_exp2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// P as the A fragments of the P V products, 16 keys each (the
// accumulator chunks 2kk and 2kk + 1), split into two bf16 parts: hi, the
// nearest bf16, and lo, the nearest bf16 to what hi leaves.  hi + lo
// carries P to about 16 bits, so P V over both stays as close to the
// plain version's f32 P V as its f32 sums.  (With P rounded once, on an
// H100, zamba2-2.7b's first-wave prefill logits came out 5.2% of their
// largest value from the plain path's, past chip_smoke.py's 5%.)
struct PFrags {
  uint32_t hi[WG_BK / 16][4];
  uint32_t lo[WG_BK / 16][4];

  __device__ __forceinline__ void pack(const float (&s)[WG_BK / 2]) {
#pragma unroll
    for (int kk = 0; kk < WG_BK / 16; ++kk)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float a = s[8 * kk + 2 * i], b = s[8 * kk + 2 * i + 1];
        const __nv_bfloat162 h = __floats2bfloat162_rn(a, b);  // .x low
        const __nv_bfloat162 l = __floats2bfloat162_rn(
            a - __low2float(h), b - __high2float(h));
        hi[kk][i] = *reinterpret_cast<const uint32_t*>(&h);
        lo[kk][i] = *reinterpret_cast<const uint32_t*>(&l);
      }
  }

  // Keeps the fragments alive until the wgmma that reads them is done.
  __device__ __forceinline__ void keep() {
#pragma unroll
    for (int i = 0; i < WG_BK / 16; ++i)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        asm volatile("" : "+r"(hi[i][e]), "+r"(lo[i][e])::"memory");
  }
};

// One consumer thread's share of O (64 rows x D): the accumulators of the
// N = W0 and N = W1 products, in the wgmma layout (hopper.cuh).
template <int D>
struct Acc {
  static constexpr int W0 = WgSmem<D>::W0, W1 = WgSmem<D>::W1;
  static constexpr int N1 = W1 > 0 ? W1 / 2 : 1;
  float o0[W0 / 2];
  float o1[N1];

  __device__ __forceinline__ void zero() {
#pragma unroll
    for (int i = 0; i < W0 / 2; ++i) o0[i] = 0.f;
#pragma unroll
    for (int i = 0; i < N1; ++i) o1[i] = 0.f;
  }

  __device__ __forceinline__ void fence() {
    hopper::fence_regs(o0);
    hopper::fence_regs(o1);
  }

  // element 4c + e lies on the thread's row e / 2
  __device__ __forceinline__ void scale(const float (&c)[2]) {
#pragma unroll
    for (int i = 0; i < W0 / 2; ++i) o0[i] *= c[(i >> 1) & 1];
#pragma unroll
    for (int i = 0; i < N1; ++i) o1[i] *= c[(i >> 1) & 1];
  }

  // O times inv[r] as bf16 into a tile laid out as Q's (tile: the block's
  // 128 rows, row[r] the thread's two rows; tq its column pair), for TMA
  // to store
  __device__ __forceinline__ void stage(unsigned char* tile,
                                        const int (&row)[2], int tq,
                                        const float (&inv)[2]) const {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
#pragma unroll
      for (int c = 0; c < W0 / 8; ++c)
        *reinterpret_cast<__nv_bfloat162*>(
            tile + hopper::swizzled(row[r], (8 * c + 2 * tq) * 2, W0 * 2)) =
            __floats2bfloat162_rn(o0[4 * c + 2 * r] * inv[r],
                                  o0[4 * c + 2 * r + 1] * inv[r]);
      if constexpr (W1 > 0) {
#pragma unroll
        for (int c = 0; c < W1 / 8; ++c)
          *reinterpret_cast<__nv_bfloat162*>(
              tile + WG_BQ * W0 * 2 +
              hopper::swizzled(row[r], (8 * c + 2 * tq) * 2, W1 * 2)) =
              __floats2bfloat162_rn(o1[4 * c + 2 * r] * inv[r],
                                    o1[4 * c + 2 * r + 1] * inv[r]);
      }
    }
  }
};

// S = Q K^T for the group's 64 rows and a tile's 128 keys: k-steps of 16
// over both head-dim regions of Q (qa0, qa1) and K (ks).
template <int D>
__device__ __forceinline__ void issue_qk(float (&s)[WG_BK / 2],
                                         const unsigned char* qa0,
                                         const unsigned char* qa1,
                                         const unsigned char* ks) {
  constexpr int W0 = WgSmem<D>::W0, W1 = WgSmem<D>::W1;
#pragma unroll
  for (int j = 0; j < W0 / 16; ++j)
    hopper::wgmma_m64n128k16_ss(s, hopper::smem_desc(qa0 + j * 32, W0 * 2),
                                hopper::smem_desc(ks + j * 32, W0 * 2), j > 0);
  if constexpr (W1 > 0) {
#pragma unroll
    for (int j = 0; j < W1 / 16; ++j)
      hopper::wgmma_m64n128k16_ss(
          s, hopper::smem_desc(qa1 + j * 32, W1 * 2),
          hopper::smem_desc(ks + WG_BK * W0 * 2 + j * 32, W1 * 2), 1);
  }
}

// O += P V: V (vs) read transposed; for each 16 keys and region, one
// wgmma with P's hi part and one with its lo part.
template <int D>
__device__ __forceinline__ void issue_pv(Acc<D>& acc, const PFrags& pf,
                                         const unsigned char* vs) {
  constexpr int W0 = WgSmem<D>::W0, W1 = WgSmem<D>::W1;
#pragma unroll
  for (int kk = 0; kk < WG_BK / 16; ++kk) {
    const uint64_t d0 = hopper::smem_desc(vs + kk * 16 * W0 * 2, W0 * 2);
    hopper::wgmma_rs_tb<W0>(acc.o0, pf.hi[kk], d0, 1);
    hopper::wgmma_rs_tb<W0>(acc.o0, pf.lo[kk], d0, 1);
    if constexpr (W1 > 0) {
      const uint64_t d1 = hopper::smem_desc(
          vs + WG_BK * W0 * 2 + kk * 16 * W1 * 2, W1 * 2);
      hopper::wgmma_rs_tb<W1>(acc.o1, pf.hi[kk], d1, 1);
      hopper::wgmma_rs_tb<W1>(acc.o1, pf.lo[kk], d1, 1);
    }
  }
}

// The keys a query at position qp sees: lo < k_pos <= hi (visible() as
// two compares; lo >= -1 also drops unwritten slots).
struct KeyRange {
  int lo, hi;
  __device__ __forceinline__ KeyRange(int lo_, int hi_) : lo(lo_), hi(hi_) {}
  __device__ __forceinline__ KeyRange(int qp, int causal, int window) {
    const long long w = (causal && window) ? (long long)qp - window : -1;
    lo = static_cast<int>(w > -1 ? w : -1);
    hi = causal ? qp : INT_MAX;
  }
  __device__ __forceinline__ bool sees(int kp) const {
    return kp > lo && kp <= hi;
  }
};

// Which tiles of a chunk of SCAN some query of the item sees (bit 4u of
// `live` set for tile u) and which not every query sees (`partial`):
// lane l holds positions 32l .. 32l+31 of the chunk, a quarter of tile
// l / 4.
__device__ __forceinline__ void scan_chunk(const int4 (&kp)[8],
                                           const KeyRange& seen_by_some,
                                           const KeyRange& seen_by_all,
                                           uint32_t& live, uint32_t& partial) {
  bool any = false, every = true;
#pragma unroll
  for (int v = 0; v < 8; ++v) {
    const int x[4] = {kp[v].x, kp[v].y, kp[v].z, kp[v].w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      any |= seen_by_some.sees(x[i]);
      every &= seen_by_all.sees(x[i]);
    }
  }
  live = __ballot_sync(0xffffffffu, any);
  partial = __ballot_sync(0xffffffffu, !every);
}

// One tile of scores in place: mask (unless the producer found every key
// of the tile visible to every query of the block), scale and turn into
// probabilities; update the running max m and sum l and return the
// factor by which O must be rescaled.  Rows: e = 0,1 -> row[0], 2,3 ->
// row[1]; columns 8j + 2tq + (e & 1).  Row max and sum are reduced over
// the four lanes (tq) that share a row.
__device__ __forceinline__ void softmax_tile(
    float (&s)[WG_BK / 2], bool full, const int* kp_s,
    const KeyRange (&row)[2], int tq, float scale_log2, float (&m)[2],
    float (&l)[2], float (&corr)[2]) {
  // the row max of the raw scores: scaling by a positive factor keeps it
  float mx[2] = {NEG_INF, NEG_INF};
  if (full) {
#pragma unroll
    for (int i = 0; i < WG_BK / 2; ++i)
      mx[(i >> 1) & 1] = fmaxf(mx[(i >> 1) & 1], s[i]);
  } else {
#pragma unroll
    for (int j = 0; j < WG_BK / 8; ++j) {
      const int2 kp = *reinterpret_cast<const int2*>(kp_s + 8 * j + 2 * tq);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        if (!row[e >> 1].sees((e & 1) ? kp.y : kp.x))
          s[4 * j + e] = NEG_INF;  // exp2 of it is 0 whatever the max
        mx[e >> 1] = fmaxf(mx[e >> 1], s[4 * j + e]);
      }
    }
  }
  float m_safe[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
    const float m_new = fmaxf(m[r], mx[r] * scale_log2);
    m_safe[r] = fmaxf(m_new, -1e29f);  // fully masked row guard
    corr[r] = fast_exp2(fmaxf(m[r], -1e29f) - m_safe[r]);
    m[r] = m_new;
  }
  float rs[2] = {0.f, 0.f};
#pragma unroll
  for (int i = 0; i < WG_BK / 2; ++i) {
    s[i] = fast_exp2(fmaf(s[i], scale_log2, -m_safe[(i >> 1) & 1]));
    rs[(i >> 1) & 1] += s[i];
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    rs[r] += __shfl_xor_sync(0xffffffffu, rs[r], 1);
    rs[r] += __shfl_xor_sync(0xffffffffu, rs[r], 2);
    l[r] = l[r] * corr[r] + rs[r];
  }
}

// A position in a ring of N buffers and the parity of its round.
template <int N>
struct Ring {
  int stage = 0;
  uint32_t phase = 0;
  __device__ __forceinline__ void next() {
    if (++stage == N) {
      stage = 0;
      phase ^= 1;
    }
  }
};

// The blocks are persistent: one an SM, each walking work items (batch,
// head, 128-row query tile).  Items are numbered longest first (the last
// query tiles see the most keys under a causal mask) and dealt out in a
// snake, so each block gets long and short ones alike.  The producer
// loads the next item's Q and tiles while the consumers finish the last.
struct WorkItem {
  int b, h, q0;
};

struct WorkItems {
  int n, grid, bh, n_qtiles, Hq;

  // The k-th item of block x, or -1 if it has none; -2 past the end.
  __device__ __forceinline__ int get(int k, int x) const {
    const int base = k * grid;
    if (base >= n) return -2;
    const int w = base + ((k & 1) ? grid - 1 - x : x);
    return w < n ? w : -1;
  }

  __device__ __forceinline__ WorkItem decode(int w) const {
    const int bh_w = w % bh;
    return {bh_w / Hq, bh_w % Hq, (n_qtiles - 1 - w / bh) * WG_BQ};
  }
};

template <int D>
__global__ void __launch_bounds__(WG_THREADS, 1)
    flash_fwd_bf16_kernel(const __grid_constant__ TmaParams p) {
  using L = WgSmem<D>;
  constexpr int W0 = L::W0, W1 = L::W1;

  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem =
      smem_raw + ((1024 - (hopper::smem_addr(smem_raw) & 1023)) & 1023);
  int* kpos_s = reinterpret_cast<int*>(smem + L::KPOS);
  int* qpos_s = reinterpret_cast<int*>(smem + L::QPOS);
  volatile int* tile_s = reinterpret_cast<volatile int*>(smem + L::TILE);
  volatile int* full_s = reinterpret_cast<volatile int*>(smem + L::FULL);
  uint64_t* q_full = reinterpret_cast<uint64_t*>(smem + L::BARS);
  uint64_t* q_empty = q_full + 2;
  uint64_t* k_full = q_empty + 2;
  uint64_t* v_full = k_full + L::STAGES;
  uint64_t* k_empty = v_full + L::STAGES;
  uint64_t* v_empty = k_empty + L::STAGES;

  const WorkItems items{p.B * p.Hq * p.n_qtiles, static_cast<int>(gridDim.x),
                        p.B * p.Hq, p.n_qtiles, p.Hq};
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;

  if (threadIdx.x == 0) {
    for (int i = 0; i < 2; ++i) {
      hopper::mbar_init(&q_full[i], 32);  // every lane of the producer
      hopper::mbar_init(&q_empty[i], WG_CONSUMERS);
    }
    for (int s = 0; s < L::STAGES; ++s) {
      hopper::mbar_init(&k_full[s], 32);  // every lane of the producer
      hopper::mbar_init(&v_full[s], 1);
      hopper::mbar_init(&k_empty[s], WG_CONSUMERS);  // every consumer
      hopper::mbar_init(&v_empty[s], WG_CONSUMERS);
    }
    hopper::fence_barrier_init();
  }
  __syncthreads();

  if (warp < 4) {
    // ---- producer: warp 0 issues every load, warps 1-3 leave ------------
    hopper::regs_dealloc<PRODUCER_REGS>();
    if (warp != 0) return;
    if (lane < (W1 > 0 ? 6 : 3)) {  // the maps that were encoded
      const CUtensorMap* maps = lane % 3 == 0   ? p.q
                                : lane % 3 == 1 ? p.k
                                                : p.v;
      hopper::prefetch_tensormap(&maps[lane / 3]);
    }

    // K rounds carry the tiles and each item's end; V rounds the tiles
    Ring<L::STAGES> kr, vr;
    int n_done = 0;  // items started: Q's buffer and parity
    for (int k = 0;; ++k) {
      const int w = items.get(k, blockIdx.x);
      if (w == -2) break;
      if (w < 0) continue;
      const auto [b, h, q0] = items.decode(w);
      const int hk = h / (p.Hq / p.Hkv);

      // The K/V tiles some query of the item can see are found SCAN tiles
      // at a time: lane l reads positions 32l .. 32l+31 of the chunk in
      // 16-byte loads issued together, so a run of tiles that are skipped
      // costs one load's latency, not one each.  The item's first chunk
      // is scanned, with the query positions read four a lane, before the
      // wait for Q's buffer.
      const int4 qv = load_pos4(p.q_pos, q0 + 4 * lane, p.S);
      int4 kp[8];
#pragma unroll
      for (int v = 0; v < 8; ++v)
        kp[v] = load_pos4(p.k_pos, 32 * lane + 4 * v, p.T);
      // position range of the item's valid query rows
      int qmin = INT_MAX, qmax = INT_MIN;
      const int qx[4] = {qv.x, qv.y, qv.z, qv.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
        if (q0 + 4 * lane + i < p.S) {
          qmin = min(qmin, qx[i]);
          qmax = max(qmax, qx[i]);
        }
      qmin = __reduce_min_sync(0xffffffffu, qmin);
      qmax = __reduce_max_sync(0xffffffffu, qmax);
      const KeyRange at_min(qmin, p.causal, p.window);
      const KeyRange at_max(qmax, p.causal, p.window);
      const KeyRange seen_by_some(at_min.lo, at_max.hi);
      const KeyRange seen_by_all(at_max.lo, at_min.hi);
      uint32_t live_lanes, partial_lanes;
      scan_chunk(kp, seen_by_some, seen_by_all, live_lanes, partial_lanes);

      // Q and its positions into the buffer the item before last used,
      // once the consumers are done with it (the last item's may still be
      // in use); lane 0 loads Q, every lane stores four positions
      const int qb = n_done & 1;
      if (lane == 0) {
        hopper::mbar_wait(&q_empty[qb], ((n_done >> 1) & 1) ^ 1);
        unsigned char* qs = smem + L::Q + qb * L::Q_BYTES;
        hopper::mbar_expect_tx(&q_full[qb], L::Q_BYTES);
        hopper::tma_load_4d(qs, &p.q[0], &q_full[qb], 0, q0, h, b);
        if constexpr (W1 > 0)
          hopper::tma_load_4d(qs + WG_BQ * W0 * 2, &p.q[1], &q_full[qb], W0,
                              q0, h, b);
        // The next item's Q into L2 now: at the change of items every
        // block loads a Q, and from L2 that burst is short.
        int wn = -1;
        for (int kn = k + 1; wn == -1; ++kn) wn = items.get(kn, blockIdx.x);
        if (wn >= 0) {
          const WorkItem nx = items.decode(wn);
          hopper::tma_prefetch_4d(&p.q[0], 0, nx.q0, nx.h, nx.b);
          if constexpr (W1 > 0)
            hopper::tma_prefetch_4d(&p.q[1], W0, nx.q0, nx.h, nx.b);
        }
      }
      __syncwarp();  // lane 0 has seen Q's buffer free
      ++n_done;
      *reinterpret_cast<int4*>(qpos_s + qb * WG_BQ + 4 * lane) = qv;
      hopper::mbar_arrive(&q_full[qb]);  // releases this lane's qpos_s

      for (int c0 = 0;;) {
        for (int u = 0; u < SCAN; ++u) {
          if (!((live_lanes >> (4 * u)) & 0xFu)) continue;  // no stage
          const int t0 = c0 + u * WG_BK;
          // K (with the tile's positions) and V free their buffers apart:
          // consumers are done with K_j before they are with V_j
          const int ks = kr.stage, vs = vr.stage;
          hopper::mbar_wait(&k_empty[ks], kr.phase ^ 1);
          if (lane / 4 == u) {
            int4* dst = reinterpret_cast<int4*>(kpos_s + ks * WG_BK +
                                                32 * (lane % 4));
#pragma unroll
            for (int v = 0; v < 8; ++v) dst[v] = kp[v];
          }
          if (lane == 0) {
            unsigned char* kbuf = smem + L::K + ks * L::KV_BYTES;
            tile_s[ks] = t0;
            full_s[ks] = !((partial_lanes >> (4 * u)) & 0xFu);
            hopper::mbar_arrive_expect_tx(&k_full[ks], L::KV_BYTES);
            hopper::tma_load_4d(kbuf, &p.k[0], &k_full[ks], 0, t0, hk, b);
            if constexpr (W1 > 0)
              hopper::tma_load_4d(kbuf + WG_BK * W0 * 2, &p.k[1],
                                  &k_full[ks], W0, t0, hk, b);
          } else {
            hopper::mbar_arrive(&k_full[ks]);  // releases its kpos_s
          }
          kr.next();
          hopper::mbar_wait(&v_empty[vs], vr.phase ^ 1);
          if (lane == 0) {
            unsigned char* vbuf = smem + L::V + vs * L::KV_BYTES;
            hopper::mbar_arrive_expect_tx(&v_full[vs], L::KV_BYTES);
            hopper::tma_load_4d(vbuf, &p.v[0], &v_full[vs], 0, t0, hk, b);
            if constexpr (W1 > 0)
              hopper::tma_load_4d(vbuf + WG_BK * W0 * 2, &p.v[1],
                                  &v_full[vs], W0, t0, hk, b);
          }
          vr.next();
        }
        c0 += SCAN * WG_BK;
        if (c0 >= p.T) break;
#pragma unroll
        for (int v = 0; v < 8; ++v)
          kp[v] = load_pos4(p.k_pos, c0 + 32 * lane + 4 * v, p.T);
        scan_chunk(kp, seen_by_some, seen_by_all, live_lanes, partial_lanes);
      }
      // the end of the item: a K round that carries no tile
      hopper::mbar_wait(&k_empty[kr.stage], kr.phase ^ 1);
      if (lane == 0) tile_s[kr.stage] = -1;
      hopper::mbar_arrive(&k_full[kr.stage]);
      kr.next();
    }
  } else {
    // ---- consumers: 64 query rows a warpgroup ---------------------------
    hopper::regs_alloc<CONSUMER_REGS>();
    const int cg = warp / 4 - 1;           // consumer group 0 or 1
    const int g = lane / 4, tq = lane % 4;  // accumulator row, column pair
    const int row0 = cg * 64 + (warp % 4) * 16 + g;  // and row0 + 8

    // The two groups take turns at the tensor cores (named barriers 1 and
    // 2): one issues its products while the other runs its softmax.  The
    // second group opens the first turn for the first; both take one turn
    // a tile, so the turns alternate across items too.
    if (cg == 1) named_arrive(1);

    Ring<L::STAGES> kr, vr;
    int n_done = 0;
    for (int k = 0;; ++k) {
      const int w = items.get(k, blockIdx.x);
      if (w == -2) break;
      if (w < 0) continue;
      const auto [b, h, q0] = items.decode(w);
      Acc<D> acc;
      acc.zero();
      float m[2] = {NEG_INF, NEG_INF}, l[2] = {0.f, 0.f};
      float s[WG_BK / 2];
      PFrags pf;
      const int qb = n_done & 1;
      hopper::mbar_wait(&q_full[qb], (n_done >> 1) & 1);
      ++n_done;
      // the positions of this thread's two rows (rows past S are not
      // stored)
      const KeyRange rows[2] = {
          KeyRange(qpos_s[qb * WG_BQ + row0], p.causal, p.window),
          KeyRange(qpos_s[qb * WG_BQ + row0 + 8], p.causal, p.window)};
      // this group's 64 query rows in each head-dim region
      const unsigned char* qa0 = smem + L::Q + qb * L::Q_BYTES;
      const unsigned char* qa1 = qa0 + WG_BQ * W0 * 2 + cg * 64 * W1 * 2;
      qa0 += cg * 64 * W0 * 2;

      // Tile j's products are issued together with tile j-1's P V: S_j =
      // Q K_j^T, then O += P_{j-1} V_{j-1}; the softmax of S_j runs while
      // that P V is in flight, and O is rescaled once it has landed.
      Ring<L::STAGES> pv;  // the V round of tile j-1
      bool any = false;
      hopper::mbar_wait(&k_full[kr.stage], kr.phase);
      if (tile_s[kr.stage] >= 0) {
        // the first tile: S_0 alone
        any = true;
        named_sync(1 + cg);
        hopper::wgmma_fence();
        issue_qk<D>(s, qa0, qa1, smem + L::K + kr.stage * L::KV_BYTES);
        hopper::wgmma_commit();
        named_arrive(2 - cg);
        hopper::wgmma_wait<0>();
        hopper::fence_regs(s);
        float corr[2];  // O is still zero
        softmax_tile(s, full_s[kr.stage], kpos_s + kr.stage * WG_BK, rows,
                     tq, p.scale_log2, m, l, corr);
        hopper::mbar_arrive(&k_empty[kr.stage]);
        pf.pack(s);
        pv = vr;
        vr.next();
        for (;;) {
          kr.next();
          hopper::mbar_wait(&k_full[kr.stage], kr.phase);
          if (tile_s[kr.stage] < 0) break;
          named_sync(1 + cg);
          hopper::wgmma_fence();
          issue_qk<D>(s, qa0, qa1, smem + L::K + kr.stage * L::KV_BYTES);
          hopper::wgmma_commit();
          hopper::mbar_wait(&v_full[pv.stage], pv.phase);
          issue_pv<D>(acc, pf, smem + L::V + pv.stage * L::KV_BYTES);
          hopper::wgmma_commit();
          named_arrive(2 - cg);

          hopper::wgmma_wait<1>();  // S_j has landed; P V may be in flight
          hopper::fence_regs(s);
          softmax_tile(s, full_s[kr.stage], kpos_s + kr.stage * WG_BK,
                       rows, tq, p.scale_log2, m, l, corr);
          hopper::mbar_arrive(&k_empty[kr.stage]);  // K_j, its positions
          hopper::wgmma_wait<0>();
          acc.fence();
          pf.keep();
          hopper::mbar_arrive(&v_empty[pv.stage]);
          acc.scale(corr);
          pf.pack(s);
          pv = vr;
          vr.next();
        }
      }
      // At the item's end: every S is done, so the end's K round goes back
      // to the producer before the last P V.  Q's buffer stages O.
      hopper::mbar_arrive(&k_empty[kr.stage]);
      kr.next();
      if (any) {
        hopper::mbar_wait(&v_full[pv.stage], pv.phase);
        hopper::wgmma_fence();
        issue_pv<D>(acc, pf, smem + L::V + pv.stage * L::KV_BYTES);
        hopper::wgmma_commit();
        hopper::wgmma_wait<0>();
        acc.fence();
        pf.keep();
        hopper::mbar_arrive(&v_empty[pv.stage]);
      }

      // O through Q's buffer (this group's own 64 rows of it) and TMA,
      // which leaves out rows past S
      const int row[2] = {row0, row0 + 8};
      const float inv[2] = {1.f / fmaxf(l[0], 1e-30f),
                            1.f / fmaxf(l[1], 1e-30f)};
      // m is in log2 units, already scaled: back to natural units before
      // the reference's guard; the four lanes of a row hold the same m, l
      if (p.lse != nullptr && tq == 0) {
#pragma unroll
        for (int r = 0; r < 2; ++r)
          if (q0 + row[r] < p.S)
            p.lse[(static_cast<long long>(b) * p.Hq + h) * p.S + q0 +
                  row[r]] = fmaxf(m[r] * LN2, -1e29f) +
                            logf(fmaxf(l[r], 1e-30f));
      }
      unsigned char* qs = smem + L::Q + qb * L::Q_BYTES;
      acc.stage(qs, row, tq, inv);
      hopper::fence_proxy_async();
      named_sync(3 + cg, 128);
      if (threadIdx.x % 128 == 0) {
        hopper::tma_store_4d(&p.o[0], qs + cg * 64 * W0 * 2, 0, q0 + cg * 64,
                             h, b);
        if constexpr (W1 > 0)
          hopper::tma_store_4d(&p.o[1],
                               qs + WG_BQ * W0 * 2 + cg * 64 * W1 * 2, W0,
                               q0 + cg * 64, h, b);
        hopper::bulk_commit();
        hopper::bulk_wait_read();  // before the buffer goes back
      }
      hopper::mbar_arrive(&q_empty[qb]);
    }
    if (threadIdx.x % 128 == 0) hopper::bulk_wait();  // the last O stores
    // the turn the other group left open
    if (cg == 0) named_sync(1);
  }
}

// ===========================================================================
// f32: CUDA cores
// ===========================================================================

constexpr int BQ = 64;    // query rows per block
constexpr int BK = 64;    // key rows per KV tile

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
      any = tile_key_live(kp, p.causal, p.window, qmin, qmax);
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
    if (p.lse != nullptr && cg == 0)  // m and l in natural units
      p.lse[(static_cast<long long>(b) * p.Hq + h) * p.S + q0 + r] =
          fmaxf(m_s[r], -1e29f) + logf(denom);
    float* orow = og + ((static_cast<long long>(b) * p.S + q0 + r) * p.Hq + h) * D;
#pragma unroll
    for (int j = 0; j < DJ; ++j) orow[cg + 16 * j] = acc[i][j] / denom;
  }
}

template <int D>
cudaError_t launch_f32(const Params& p, cudaStream_t stream) {
  constexpr int bytes = Smem<D>::BYTES;
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_f32_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      bytes);
  if (err != cudaSuccess) return err;
  const dim3 grid(p.B * p.Hq, (p.S + BQ - 1) / BQ);
  flash_fwd_f32_kernel<D><<<grid, NT, bytes, stream>>>(p);
  return cudaGetLastError();
}

// Returned when the driver refuses a tensor map (or lacks the encoder).
constexpr int ERR_TENSOR_MAP = -1;

template <int D>
int launch_bf16(const Params& a, cudaStream_t stream) {
  using L = WgSmem<D>;
  TmaParams p{};
  // tensor-map dims are innermost first: (D, rows, heads, batch)
  const long long qdims[4] = {D, a.S, a.Hq, a.B};
  const long long kdims[4] = {D, a.T, a.Hkv, a.B};
  const long long qstr[3] = {a.sqs, a.sqh, a.sqb};
  const long long kstr[3] = {a.sks, a.skh, a.skb};
  const long long vstr[3] = {a.svs, a.svh, a.svb};
  bool ok = hopper::encode_bf16_4d(&p.q[0], a.q, qdims, qstr, L::W0, WG_BQ) &&
            hopper::encode_bf16_4d(&p.k[0], a.k, kdims, kstr, L::W0, WG_BK) &&
            hopper::encode_bf16_4d(&p.v[0], a.v, kdims, vstr, L::W0, WG_BK);
  // out is contiguous (B, S, Hq, D)
  const long long ostr[3] = {static_cast<long long>(a.Hq) * D, D,
                             static_cast<long long>(a.S) * a.Hq * D};
  ok = ok && hopper::encode_bf16_4d(&p.o[0], a.o, qdims, ostr, L::W0, 64);
  if (L::W1 > 0)
    ok = ok &&
         hopper::encode_bf16_4d(&p.q[1], a.q, qdims, qstr, L::W1, WG_BQ) &&
         hopper::encode_bf16_4d(&p.k[1], a.k, kdims, kstr, L::W1, WG_BK) &&
         hopper::encode_bf16_4d(&p.v[1], a.v, kdims, vstr, L::W1, WG_BK) &&
         hopper::encode_bf16_4d(&p.o[1], a.o, qdims, ostr, L::W1, 64);
  if (!ok) return ERR_TENSOR_MAP;
  p.lse = a.lse;
  p.q_pos = a.q_pos;
  p.k_pos = a.k_pos;
  p.B = a.B;
  p.S = a.S;
  p.T = a.T;
  p.Hq = a.Hq;
  p.Hkv = a.Hkv;
  p.window = a.window;
  p.causal = a.causal;
  p.n_qtiles = (a.S + WG_BQ - 1) / WG_BQ;
  p.scale_log2 = a.scale * 1.4426950408889634f;
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_bf16_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      L::BYTES);
  int device = 0, sms = 0;
  if (err == cudaSuccess) err = cudaGetDevice(&device);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return err;
  // one persistent block an SM, or one an item if there are fewer
  const long long n_items = static_cast<long long>(a.B) * a.Hq * p.n_qtiles;
  const int grid = static_cast<int>(n_items < sms ? n_items : sms);
  flash_fwd_bf16_kernel<D><<<grid, WG_THREADS, L::BYTES, stream>>>(p);
  return cudaGetLastError();
}

}  // namespace

// Plain C interface, loaded with ctypes.  Returns 0 when the launch was
// accepted, else a cudaError_t or ERR_TENSOR_MAP (-1); `dtype` is 0 for
// float32, 1 for bfloat16; `lse` is a contiguous f32 (B,Hq,S) or null.
// The caller has checked shapes, strides and dtypes; for bfloat16 it has
// also checked what TMA needs: 16-byte aligned bases and strides of B, S
// and H that are multiples of 8 elements.
extern "C" int flash_fwd(const void* q, const void* k, const void* v,
                         void* o, float* lse, const int* q_pos,
                         const int* k_pos, int B, int S, int T, int Hq,
                         int Hkv, int D, long long sqb,
                         long long sqs, long long sqh, long long skb,
                         long long sks, long long skh, long long svb,
                         long long svs, long long svh, int window,
                         int causal, int dtype, void* stream) {
  Params p;
  p.q = q;
  p.k = k;
  p.v = v;
  p.o = o;
  p.lse = lse;
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
  if (err == ERR_TENSOR_MAP)
    return "cuTensorMapEncodeTiled refused a tensor map of q, k or v "
           "(or the driver has no such entry point)";
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
