#!/usr/bin/env python3
"""Probes of the RWKV6 WKV kernel (rwkv6_wkv) on one NVIDIA GPU.

Run from the root of a checkout, on a machine with the card and nvcc:

    python3 tools/wkv_probe.py variants [--source FILE] [NAME ...]
    python3 tools/wkv_probe.py mma
    python3 tools/wkv_probe.py sync
    python3 tools/wkv_probe.py trace [--source FILE] [NAME]

``variants`` builds copies of ``csrc/wkv.cu`` (or of FILE, a ``wkv.cu``
of another commit) with parts taken out or changed, into
``build/wkv_probe/``, and times each with ``chip_smoke.py``'s wkv timing
phase (rwkv6-7b's prefill, B3 S1024 H64 P64, bf16 r, k, v, f32 w, an
initial state, cold L2, device time), one process a variant, so that
what a part costs shows as the difference from ``base``.  Which variants
exist depends on the source's design (``DESIGNS``); a variant marked
exact also computes the result and is held against the plain version
first (``WKV_TOL`` and the share of y equal to the plain version's).

``mma`` builds a small kernel that issues f64 ``mma.sync`` of each shape
the PTX ISA lists for sm_90 (m8n8k4, m16n8k4, m16n8k8, m16n8k16) from
registers and prints, for each, the f64 tensor-core rate of all SMs with
8 independent accumulators a warp and the latency of one dependent chain
in one warp.

``sync`` times the ways warps and blocks hand work to each other: a
block barrier, a cluster barrier, and mbarrier round trips inside a
block and across a cluster's two blocks.

``trace`` builds a variant with clock64 stamps at the kernel's hand-off
points and prints, for one call at rwkv6-7b's shape with one batch row,
the mean cycles between them in a producer warp and in a chain warp.
"""

from __future__ import annotations

import argparse
import ctypes
import hashlib
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
SOURCE = ROOT / "src" / "repro_torch" / "kernels" / "rwkv6_wkv" / "csrc" \
    / "wkv.cu"
OUT_DIR = ROOT / "build" / "wkv_probe"

# ------------------------------------------------- the chained design
# one block a (b, h, 32 columns), every step of a chunk in order (the
# design before the staged one)
_CH_SENTINEL = "A chunk takes two barriers:"
_CH_DECAYS = """      double pre[H8];  // products of this thread's decays up to row s
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
      if (half) blast[col] = base * pre[H8 - 1];"""
_CH_NODECAYS = """#pragma unroll
      for (int s = 0; s < H8; ++s) {
        const int idx = (half * H8 + s) * PS + col;
        const double rv = pr[cc][s], kv = pk[cc][s];
        rt[idx] = rv * pw[cc][s];
        kt[idx] = kv * pw[cc][s];
        ruk[s] += rv * up[cc] * kv;
      }
      if (half) blast[col] = pw[cc][0];"""
_CH_SCORES_START = "    // Scores, tile (warp / 2, warp % 2) of T x T"
_CH_SCORES_END = "    // y = r~ state (this warp's YPW tiles"
_CH_RSTATE = """#pragma unroll 4
      for (int kk = 0; kk < P; kk += 8) {
        dmma(yacc[yy], rt[(8 * mt + gid) * PS + kk + tig],
             sm[(kk + tig) * SS + 8 * nt + gid]);
        dmma(odd, rt[(8 * mt + gid) * PS + kk + 4 + tig],
             sm[(kk + 4 + tig) * SS + 8 * nt + gid]);
      }"""
_CH_UPDATE = """#pragma unroll
      for (int kk = 0; kk < T; kk += 4)
        dmma(sacc[ss], kt[(kk + tig) * PS + 8 * mt + gid],
             static_cast<double>(vs[(kk + tig) * VS + 8 * nt + gid]));
      const double d = blast[8 * mt + gid];"""
_CH_SCORES_V = """#pragma unroll
      for (int kk = 0; kk < T; kk += 4)
        dmma(yacc[yy], sc[(8 * mt + gid) * SCS + kk + tig],
             static_cast<double>(vs[(kk + tig) * VS + 8 * nt + gid]));"""
_CH_STORE = "      if (s0 + i < p.S) {"
_CH_SYNC2 = """    // The scores are written; the tiles and the state copy are read.
    __syncthreads();"""


def _chained(src: str) -> dict:
    scores = _CH_SCORES_START + src.split(_CH_SCORES_START)[1].split(
        _CH_SCORES_END)[0]
    return {
        "base": [],
        # one multiply by w in place of the prefix products, the shuffle
        # and the division
        "nodecays": [(_CH_DECAYS, _CH_NODECAYS)],
        "noscores": [(scores, ""), (_CH_SCORES_V, "")],
        "nostate": [(_CH_RSTATE, ""),
                    (_CH_UPDATE, "      const double d = 1.0;")],
        # y computed, never stored (a condition the compiler cannot drop)
        "nostores": [(_CH_STORE, "      if (s0 + i < p.S && p.B < 0) {")],
        # one barrier a chunk: results wrong, the timing is what counts
        "onesync": [(_CH_SYNC2, "")],
    }


# -------------------------------------------------- the staged design
# producer warps (inputs, decays, scores) ahead of chain warps (the state
# chain), a ring of chunks between them on mbarriers
_ST_SENTINEL = "Only the state recurrence has to run in order"
_ST_COLS = "constexpr int COLS = 64;"
_ST_RING = "constexpr int RING = 2;"
_ST_LEAD = "constexpr int LEAD = 3;"
_ST_SCORE_WARPS = """      if (warp < 2) {
        const double* kt = so + C::KT;
        const int j0 = 8 * warp;"""
_ST_BONUS = """        double r4[4], r2[2];
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
        r1 += __shfl_xor_sync(FULL, r1, 1);"""
_ST_SLOT_STORES = """          if (active) {
            so[2 * (s8 * PP + col) + half] ="""
_ST_V_STORES = """        if (e < T * QB)
          so[C::VO"""
_ST_BYTES = "static constexpr int BYTES = R * SLOT + L * IN + 8 * (2 * R + L);"
_ST_PROD = "prod *= wd[d][s8];"
_ST_RCP = "double x = __drcp_rn(last);"
_ST_SCORES = """for (int n = 0; n < P / 8; ++n)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const double2 a = ld2(so"""
_ST_RSTATE = """for (int n = 0; n < P / 8; ++n)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const double2 a = ld2(rt"""
_ST_UPDATE = """for (int n = 0; n < P / 8; ++n) {
#pragma unroll
        for (int j = 0; j < 4; ++j)
          dmma(st[n]"""
_ST_STORE = """        if (row < p.S) {
          E* dst"""
_ST_LOADS = "hopper::mbar_arrive_expect_tx(bar, C::IN);"
_ST_READS = """          xw[d][s8] = ok ? iw[t * P + col] : 1.f;
          xr[d][s8] = ok ? to_f32(ir[t * P + col]) : 0.f;
          xk[d][s8] = ok ? to_f32(ik[t * P + col]) : 0.f;"""


def _staged(src: str) -> dict:
    nodecays = [(_ST_PROD, "prod = wd[d][s8];"),
                (_ST_RCP, "double x = last;")]
    noscores = [(_ST_SCORES, _ST_SCORES.replace("n < P / 8", "n < 0"))]
    # the producers' reads of the input slot replaced by constants
    constinputs = [(_ST_READS, _ST_READS.replace("iw[t * P + col]", "0.9f")
                    .replace("to_f32(ir[t * P + col])", "0.5f")
                    .replace("to_f32(ik[t * P + col])", "0.25f"))]
    nostate = [(_ST_RSTATE, _ST_RSTATE.replace("n < P / 8", "n < 0")),
               (_ST_UPDATE, _ST_UPDATE.replace("n < P / 8", "n < 0"))]
    return {
        "base": [],
        # the open choices: half a head a block (384 blocks at rwkv6-7b's
        # shape, each computing all the head's decays and scores) rather
        # than a whole one (192); one block an SM or two; which warps take
        # the scores; the ring's depth; how far ahead inputs load
        "halves": [(_ST_COLS, "constexpr int COLS = 32;")],
        # one block an SM (shared memory padded past half an SM's)
        "oneblock": [(_ST_BYTES, _ST_BYTES.replace(
            "8 * (2 * R + L);", "8 * (2 * R + L) + 120000;"))],
        # the score job on warps 0 and 1 for even chunks, 2 and 3 for odd
        "altscores": [(_ST_SCORE_WARPS, _ST_SCORE_WARPS.replace(
            "if (warp < 2) {", "if ((warp >> 1) == (c & 1)) {").replace(
            "j0 = 8 * warp;", "j0 = 8 * (warp & 1);"))],
        # a ring of three at two blocks an SM: inputs two chunks ahead
        "ring3lead2": [(_ST_RING, "constexpr int RING = 3;"),
                       (_ST_LEAD, "constexpr int LEAD = 2;")],
        "lead2": [(_ST_LEAD, "constexpr int LEAD = 2;")],
        "lead4": [(_ST_LEAD, "constexpr int LEAD = 4;")],
        # parts taken out: results wrong, the timing is what counts
        "nodecays": nodecays,
        "noscores": noscores,
        "nostate": nostate,
        "nostores": [(_ST_STORE, _ST_STORE.replace(
            "row < p.S", "row < p.S && p.B < 0"))],
        "noinputs": [(_ST_LOADS, "hopper::mbar_arrive(bar);\n      return;")],
        # no decays or scores: the chain as fast as its inputs come
        "chainonly": nodecays + noscores,
        # no decays, scores or state: inputs, hand-offs and stores alone
        "empty": nodecays + noscores + nostate,
        # and then, of that skeleton, no bonus sums; no stores of r~, k~
        # and v; no reads of the inputs
        "empty_nobonus": nodecays + noscores + nostate + [
            (_ST_BONUS, "        double r1 = ruk[0];")],
        "empty_nostores": nodecays + noscores + nostate + [
            (_ST_SLOT_STORES, _ST_SLOT_STORES.replace(
                "if (active) {", "if (active && p.B < 0) {")),
            (_ST_V_STORES, _ST_V_STORES.replace(
                "if (e < T * QB)", "if (e < T * QB && p.B < 0)"))],
        "empty_noreads": nodecays + noscores + nostate + constinputs,
    }


# clock64 stamps of block (0, 0, 0), lane 0 of each warp, chunks < 64:
# (anchor, the stamps put before it, the stamps put after it)
_TRACE_POINTS = [
    ("      hopper::mbar_wait(&landed[c % L], (c / L) & 1);", (0,), ()),
    ("      // This thread's inputs and v, read into registers", (1,), ()),
    ("      if (c >= R) hopper::mbar_wait(&empty[s], ((c / R) - 1) & 1);",
     (2,), (3,)),
    ("      // v into the slot, f64 pairs", (4,), ()),
    ("      if (issuer && c + L < nc) issue(c + L);", (5,), (6,)),
    ("      if (lane == 0) hopper::mbar_arrive(&full[s]);", (7,), ()),
    ("""      for (int d = 0; d < C::DI; ++d) {
        const double other""", (8,), ()),
    ("      const bool b3 = lane & 8, b2 = lane & 4, b1 = lane & 2;", (9,),
     ()),
    ("        double r4[4], r2[2];", (10,), ()),
    ("      hopper::mbar_wait(&full[s], (c / R) & 1);", (0,), (1,)),
    ("      // state = (state + k~^T v) * incl_last: m = q", (2,), ()),
    ("      if (lane == 0) arrive_relaxed(&empty[s]);", (3,), (4,)),
]
_TRACE_HEAD = """
__device__ long long wkv_trace[8 * 64 * 16];
#define TR(k) if (blockIdx.x == 0 && blockIdx.y == 0 && blockIdx.z == 0 && \\
                  lane == 0 && warp < 8 && c < 64) \\
    wkv_trace[(warp * 64 + c) * 16 + (k)] = clock64();
"""
_TRACE_TAIL = """
extern "C" int wkv_trace_read(long long* out) {
  return cudaMemcpyFromSymbol(out, wkv_trace, sizeof(wkv_trace));
}
"""


def _trace_source(source: Path) -> Path:
    src = source.read_text()
    if "namespace {" not in src:
        raise SystemExit("wkv.cu has no anonymous namespace to trace")
    src = src.replace("namespace {", _TRACE_HEAD + "namespace {", 1)
    for anchor, before, after in _TRACE_POINTS:
        if anchor not in src:
            raise SystemExit(f"trace: wkv.cu no longer has\n{anchor}")
        pre = "".join(f"      TR({k});\n" for k in before)
        post = "".join(f"\n      TR({k});" for k in after)
        src = src.replace(anchor, pre + anchor + post)
    OUT_DIR.mkdir(parents=True, exist_ok=True)
    digest = hashlib.sha1(src.encode()).hexdigest()[:8]
    path = OUT_DIR / f"wkv_trace_{digest}.cu"
    path.write_text(src + _TRACE_TAIL)
    return path


def _trace(source: Path, name: str) -> None:
    """One call of variant ``name`` at B1 S1024 H64 P64 bf16: the mean
    cycles between stamps of warp 0 (a producer) and warp 4 (a chain
    warp), chunks 4 to 59."""
    sys.path[:0] = [str(ROOT / "src"), str(ROOT)]
    import numpy as np
    import torch

    from repro_torch.kernels.rwkv6_wkv import ops

    ops._SOURCES = (_trace_source(_variant_source(source, name)),)
    print(f"trace of variant {name}", flush=True)
    gen = torch.Generator(device="cuda").manual_seed(1)
    B, S, H, P = 1, 1024, 64, 64
    r, k, v = (torch.randn((B, S, H, P), generator=gen, device="cuda")
               .bfloat16() for _ in range(3))
    w = torch.exp(-torch.exp(torch.randn((B, S, H, P), generator=gen,
                                         device="cuda") * 0.5 - 2))
    u = torch.randn((H, P), generator=gen, device="cuda") * 0.5
    init = torch.randn((B, H, P, P), generator=gen, device="cuda")
    for _ in range(3):
        ops.wkv(r, k, v, w, u, init)
    torch.cuda.synchronize()
    lib = ops._kernel()
    buf = (ctypes.c_longlong * (8 * 64 * 16))()
    if lib.wkv_trace_read(buf):
        raise SystemExit("could not read the trace")
    tr = np.array(buf, dtype=np.int64).reshape(8, 64, 16)
    # stamps in the order a chunk passes them, by warp role
    for warp, order in ((0, (0, 1, 2, 3, 8, 9, 10, 4, 5, 6, 7)),
                        (4, (0, 1, 2, 3, 4))):
        steady = tr[warp, 4:60][:, list(order)]
        deltas = np.diff(steady, axis=1).mean(axis=0)
        period = np.diff(tr[warp, 4:61, 0]).mean()
        print(f"trace warp {warp}: cycles between stamps {list(order)}: "
              f"{np.round(deltas, 1).tolist()}; a chunk every "
              f"{period:.1f} cycles", flush=True)


# name -> (sentinel in the source, patches(src) -> {variant: [(old, new)]},
#          variants that compute the result)
DESIGNS = {
    "chained": (_CH_SENTINEL, _chained, ("base",)),
    "staged": (_ST_SENTINEL, _staged,
                       ("base", "halves", "oneblock", "altscores",
                        "ring3lead2", "lead2", "lead4")),
}


def _design(src: str):
    for name, (sentinel, patches, exact) in DESIGNS.items():
        if sentinel in src:
            return name, patches(src), exact
    raise SystemExit("wkv.cu matches none of the probe's designs "
                     f"({', '.join(DESIGNS)})")


def _variant_source(source: Path, name: str) -> Path:
    src = source.read_text()
    _, patches, _ = _design(src)
    for old, new in patches[name]:
        if old not in src:
            raise SystemExit(f"variant {name}: wkv.cu no longer has the "
                             f"text it patches:\n{old}")
        src = src.replace(old, new)
    OUT_DIR.mkdir(parents=True, exist_ok=True)
    digest = hashlib.sha1(src.encode()).hexdigest()[:8]
    path = OUT_DIR / f"wkv_{name}_{digest}.cu"
    path.write_text(src)
    return path


def _one_variant(source: Path, name: str) -> None:
    sys.path[:0] = [str(ROOT / "src"), str(ROOT)]
    import torch

    import chip_smoke
    from repro_torch.kernels.rwkv6_wkv import ops

    design, _, exact = _design(source.read_text())
    ops._SOURCES = (_variant_source(source, name),)
    print(f"variant {name} of {design} ({source})", flush=True)
    gen = torch.Generator(device="cuda").manual_seed(1)
    if name in exact:
        B, S, H, P = chip_smoke.WKV_PREFILL
        r, k, v = (torch.randn((B, S, H, P), generator=gen, device="cuda")
                   .bfloat16() for _ in range(3))
        w = torch.exp(-torch.exp(torch.randn((B, S, H, P), generator=gen,
                                             device="cuda") * 0.5 - 2))
        u = torch.randn((H, P), generator=gen, device="cuda") * 0.5
        init = torch.randn((B, H, P, P), generator=gen, device="cuda")
        y, state = ops.wkv(r, k, v, w, u, init)
        want_y, want_state = ops.wkv(r.float(), k.float(), v.float(), w, u,
                                     init, impl="ref")
        tol = chip_smoke.WKV_TOL
        same = (y == want_y.to(y.dtype)).float().mean().item()
        ok = (torch.allclose(y.float(), want_y, atol=tol, rtol=tol)
              and torch.allclose(state, want_state, atol=tol, rtol=tol)
              and same >= 0.9999)
        print(f"  held against the plain version: share of y equal "
              f"{same:.6f} {'ok' if ok else 'FAIL'}", flush=True)
        if not ok:
            raise SystemExit(f"variant {name} disagrees with the plain "
                             "version")
    chip_smoke.wkv_timing_phase(torch, ops, gen)


_MMA_SRC = r"""
#include <cuda_runtime.h>
// f64 mma.sync of each sm_90 shape from registers; c[0..NC) accumulates
template <int S> struct Shape;
template <> struct Shape<0> {  // m8n8k4
  static constexpr int NA = 1, NB = 1, NC = 2, FMA = 8 * 8 * 4;
  static __device__ __forceinline__ void mma(double* c, const double* a,
                                             const double* b) {
    asm volatile("mma.sync.aligned.m8n8k4.row.col.f64.f64.f64.f64 "
                 "{%0,%1}, {%2}, {%3}, {%0,%1};"
                 : "+d"(c[0]), "+d"(c[1]) : "d"(a[0]), "d"(b[0]));
  }
};
template <> struct Shape<1> {  // m16n8k4
  static constexpr int NA = 2, NB = 1, NC = 4, FMA = 16 * 8 * 4;
  static __device__ __forceinline__ void mma(double* c, const double* a,
                                             const double* b) {
    asm volatile("mma.sync.aligned.m16n8k4.row.col.f64.f64.f64.f64 "
                 "{%0,%1,%2,%3}, {%4,%5}, {%6}, {%0,%1,%2,%3};"
                 : "+d"(c[0]), "+d"(c[1]), "+d"(c[2]), "+d"(c[3])
                 : "d"(a[0]), "d"(a[1]), "d"(b[0]));
  }
};
template <> struct Shape<2> {  // m16n8k8
  static constexpr int NA = 4, NB = 2, NC = 4, FMA = 16 * 8 * 8;
  static __device__ __forceinline__ void mma(double* c, const double* a,
                                             const double* b) {
    asm volatile("mma.sync.aligned.m16n8k8.row.col.f64.f64.f64.f64 "
                 "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};"
                 : "+d"(c[0]), "+d"(c[1]), "+d"(c[2]), "+d"(c[3])
                 : "d"(a[0]), "d"(a[1]), "d"(a[2]), "d"(a[3]), "d"(b[0]),
                   "d"(b[1]));
  }
};
template <> struct Shape<3> {  // m16n8k16
  static constexpr int NA = 8, NB = 4, NC = 4, FMA = 16 * 8 * 16;
  static __device__ __forceinline__ void mma(double* c, const double* a,
                                             const double* b) {
    asm volatile("mma.sync.aligned.m16n8k16.row.col.f64.f64.f64.f64 "
                 "{%0,%1,%2,%3}, {%4,%5,%6,%7,%8,%9,%10,%11}, "
                 "{%12,%13,%14,%15}, {%0,%1,%2,%3};"
                 : "+d"(c[0]), "+d"(c[1]), "+d"(c[2]), "+d"(c[3])
                 : "d"(a[0]), "d"(a[1]), "d"(a[2]), "d"(a[3]), "d"(a[4]),
                   "d"(a[5]), "d"(a[6]), "d"(a[7]), "d"(b[0]), "d"(b[1]),
                   "d"(b[2]), "d"(b[3]));
  }
};

template <int S, int CH>
__global__ void bench(double* out, int iters) {
  double a[8], b[4], c[CH][4];
  for (int i = 0; i < 8; ++i) a[i] = 1e-3 * (threadIdx.x + i);
  for (int i = 0; i < 4; ++i) b[i] = 1e-3 * (threadIdx.x - i);
  for (int j = 0; j < CH; ++j)
    for (int e = 0; e < 4; ++e) c[j][e] = 0.0;
  for (int it = 0; it < iters; ++it) {
#pragma unroll
    for (int j = 0; j < CH; ++j) Shape<S>::mma(c[j], a, b);
  }
  double s = 0.0;
  for (int j = 0; j < CH; ++j)
    for (int e = 0; e < Shape<S>::NC; ++e) s += c[j][e];
  if (s == 1234.5) out[0] = s;
}

template <int S, int CH>
float run_one(int blocks, int threads, int iters) {
  cudaEvent_t t0, t1;
  cudaEventCreate(&t0);
  cudaEventCreate(&t1);
  bench<S, CH><<<blocks, threads>>>(nullptr, iters);  // warm-up
  cudaEventRecord(t0);
  bench<S, CH><<<blocks, threads>>>(nullptr, iters);
  cudaEventRecord(t1);
  cudaEventSynchronize(t1);
  float ms = 0.f;
  cudaEventElapsedTime(&ms, t0, t1);
  cudaEventDestroy(t0);
  cudaEventDestroy(t1);
  return cudaGetLastError() == cudaSuccess ? ms : -1.f;
}

// chains 1: one dependent chain; 8: eight independent accumulators
extern "C" float mma_bench(int shape, int chains, int blocks, int threads,
                           int iters) {
#define CASE(S) \
  case S: return chains == 1 ? run_one<S, 1>(blocks, threads, iters) \
               : chains == 2 ? run_one<S, 2>(blocks, threads, iters) \
               : chains == 4 ? run_one<S, 4>(blocks, threads, iters) \
                             : run_one<S, 8>(blocks, threads, iters);
  switch (shape) { CASE(0) CASE(1) CASE(2) CASE(3) }
  return -1.f;
}
extern "C" int mma_fma(int shape) {
  switch (shape) {
    case 0: return Shape<0>::FMA;
    case 1: return Shape<1>::FMA;
    case 2: return Shape<2>::FMA;
    case 3: return Shape<3>::FMA;
  }
  return 0;
}
"""


_SYNC_SRC = r"""
#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <cstdint>
#include "common/hopper.cuh"
namespace cg = cooperative_groups;

__device__ __forceinline__ void arrive_at(uint64_t* bar, int rank) {
  uint32_t remote;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n"
               : "=r"(remote) : "r"(hopper::smem_addr(bar)), "r"(rank));
  asm volatile("mbarrier.arrive.release.cluster.shared::cluster.b64 _, [%0];\n"
               :: "r"(remote) : "memory");
}
__device__ __forceinline__ void wait_cluster(uint64_t* bar, uint32_t parity) {
  uint32_t done = 0;
  while (!done) {
    asm volatile("{\n.reg .pred p;\n"
                 "mbarrier.try_wait.parity.acquire.cluster.shared::cta.b64 p, [%1], %2;\n"
                 "selp.u32 %0, 1, 0, p;\n}\n"
                 : "=r"(done) : "r"(hopper::smem_addr(bar)), "r"(parity) : "memory");
  }
}

// mode 0: __syncthreads; 1: cluster.sync (2 blocks); 2: mbarrier ping-pong
// between warps 0 and 1 of a block; 3: the same between warp 0 of the two
// blocks of a cluster; 4: as 3 with 16 stores of 8 bytes a lane into the
// other block's shared memory before each arrive
__global__ void sync_bench(int mode, int iters, double* sink) {
  __shared__ uint64_t bar[2];
  __shared__ double buf[32 * 16];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (threadIdx.x == 0) {
    hopper::mbar_init(&bar[0], 1);
    hopper::mbar_init(&bar[1], 1);
    hopper::fence_barrier_init();
  }
  if (mode >= 1) cg::this_cluster().sync(); else __syncthreads();
  const int rank = mode >= 1 ? cg::this_cluster().block_rank() : 0;
  double* peer = mode >= 1 ? cg::this_cluster().map_shared_rank(buf, rank ^ 1) : buf;
  for (int it = 0; it < iters; ++it) {
    if (mode == 0) {
      __syncthreads();
    } else if (mode == 1) {
      cg::this_cluster().sync();
    } else if (mode == 2) {
      if (warp == 0) {
        if (lane == 0) hopper::mbar_arrive(&bar[0]);
        hopper::mbar_wait(&bar[1], it & 1);
      } else if (warp == 1) {
        hopper::mbar_wait(&bar[0], it & 1);
        if (lane == 0) hopper::mbar_arrive(&bar[1]);
      }
    } else if (warp == 0) {
      if (rank == 0) {
        if (mode == 4)
          for (int j = 0; j < 16; ++j) peer[lane * 16 + j] = it + j;
        __syncwarp();
        if (lane == 0) arrive_at(&bar[0], 1);
        wait_cluster(&bar[1], it & 1);
      } else {
        wait_cluster(&bar[0], it & 1);
        if (mode == 4)
          for (int j = 0; j < 16; ++j) peer[lane * 16 + j] = it - j;
        __syncwarp();
        if (lane == 0) arrive_at(&bar[1], 0);
      }
    }
  }
  if (mode >= 1) cg::this_cluster().sync();
  if (buf[lane] == 1234.5) sink[0] = buf[lane];
}

extern "C" float sync_run(int mode, int iters) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(mode >= 1 ? 2 : 1);
  cfg.blockDim = dim3(128);
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = 2;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = mode >= 1 ? 1 : 0;
  cudaEvent_t t0, t1;
  cudaEventCreate(&t0);
  cudaEventCreate(&t1);
  cudaLaunchKernelEx(&cfg, sync_bench, mode, iters, (double*)nullptr);
  cudaEventRecord(t0);
  cudaLaunchKernelEx(&cfg, sync_bench, mode, iters, (double*)nullptr);
  cudaEventRecord(t1);
  cudaEventSynchronize(t1);
  float ms = 0.f;
  cudaEventElapsedTime(&ms, t0, t1);
  return cudaGetLastError() == cudaSuccess ? ms : -1.f;
}
"""


def _sync() -> None:
    sys.path.insert(0, str(ROOT / "src"))
    import torch

    from repro_torch.kernels import _build

    OUT_DIR.mkdir(parents=True, exist_ok=True)
    src = OUT_DIR / "sync_bench.cu"
    src.write_text(_SYNC_SRC)
    lib_path = OUT_DIR / "sync_bench.so"
    proc = subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-I",
                           str(_build.KERNELS_DIR), "-o", str(lib_path),
                           str(src)], capture_output=True, text=True)
    if proc.returncode:
        print(proc.stdout + proc.stderr)
        raise SystemExit("the sync bench did not build")
    lib = ctypes.CDLL(str(lib_path))
    lib.sync_run.restype = ctypes.c_float
    torch.cuda.init()
    iters = 10000
    for mode, label in enumerate((
            "__syncthreads, one block of 4 warps",
            "cluster.sync, 2 blocks",
            "mbarrier round trip between 2 warps of a block",
            "mbarrier round trip between 2 blocks of a cluster "
            "(release / acquire at cluster scope)",
            "the same after 16 stores of 8 bytes a lane into the other "
            "block")):
        ms = lib.sync_run(mode, iters)
        print(f"sync {label}: {ms * 1e6 / iters:.1f} ns each", flush=True)


def _mma() -> None:
    sys.path.insert(0, str(ROOT / "src"))
    import torch

    from repro_torch.kernels import _build

    OUT_DIR.mkdir(parents=True, exist_ok=True)
    src = OUT_DIR / "mma_bench.cu"
    src.write_text(_MMA_SRC)
    lib_path = OUT_DIR / "mma_bench.so"
    proc = subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-o",
                           str(lib_path), str(src)], capture_output=True,
                          text=True)
    print(proc.stdout + proc.stderr)
    if proc.returncode:
        raise SystemExit("the f64 mma bench did not build")
    lib = ctypes.CDLL(str(lib_path))
    lib.mma_bench.restype = ctypes.c_float
    torch.cuda.init()
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    for shape, label in enumerate(("m8n8k4", "m16n8k4", "m16n8k8",
                                   "m16n8k16")):
        fma = lib.mma_fma(shape)
        iters = 2 ** 16 // (fma // 256)
        warps = sms * 4 * 4
        ms = lib.mma_bench(shape, 8, sms * 4, 128, iters)
        rate = 2 * fma * 8 * iters * warps / (ms * 1e-3) / 1e12
        lat = lib.mma_bench(shape, 1, 1, 32, iters)
        print(f"f64 mma.sync {label}: {rate:.2f} TFLOP/s over {sms} SMs "
              f"(8 accumulators a warp, 16 warps an SM); one dependent "
              f"chain in one warp {lat * 1e6 / iters:.1f} ns an mma",
              flush=True)
    # m16n8k4 with 1, 2 or 4 warps on each of an SM's four schedulers and
    # 2, 4 or 8 independent accumulators a warp
    fma = lib.mma_fma(1)
    iters = 2 ** 16 // (fma // 256)
    for per_sched in (1, 2, 4):
        rates = []
        for chains in (2, 4, 8):
            ms = lib.mma_bench(1, chains, sms, 128 * per_sched, iters)
            flop = 2 * fma * chains * iters * sms * 4 * per_sched
            rates.append("did not launch" if ms <= 0 else
                         f"{flop / (ms * 1e-3) / 1e12:.2f}")
        print(f"f64 mma.sync m16n8k4, {per_sched} warp(s) a scheduler: "
              + ", ".join(rates)
              + " TFLOP/s with 2, 4, 8 accumulators a warp", flush=True)


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    sub = parser.add_subparsers(dest="cmd", required=True)
    var = sub.add_parser("variants")
    var.add_argument("--source", type=Path, default=SOURCE)
    var.add_argument("names", nargs="*", help="variants of the source's "
                     "design (default: all)")
    one = sub.add_parser("_one")
    one.add_argument("--source", type=Path, default=SOURCE)
    one.add_argument("name")
    sub.add_parser("mma")
    sub.add_parser("sync")
    trace = sub.add_parser("trace")
    trace.add_argument("--source", type=Path, default=SOURCE)
    trace.add_argument("name", nargs="?", default="base")
    args = parser.parse_args(argv)
    if args.cmd == "_one":
        _one_variant(args.source.resolve(), args.name)
    elif args.cmd == "mma":
        _mma()
    elif args.cmd == "sync":
        _sync()
    elif args.cmd == "trace":
        _trace(args.source.resolve(), args.name)
    else:
        source = args.source.resolve()
        _, patches, _ = _design(source.read_text())
        unknown = set(args.names) - set(patches)
        if unknown:
            parser.error(f"unknown variants {sorted(unknown)}; choose from "
                         f"{sorted(patches)}")
        for name in args.names or patches:
            proc = subprocess.run([sys.executable, __file__, "_one",
                                   "--source", str(source), name], cwd=ROOT)
            if proc.returncode:
                return proc.returncode
    return 0


if __name__ == "__main__":
    sys.exit(main())
