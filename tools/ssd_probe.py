#!/usr/bin/env python3
"""Probes of the Mamba2 SSD scan kernel (mamba2_ssd) on one NVIDIA GPU.

Run from the root of a checkout, on a machine with the card and nvcc:

    python3 tools/ssd_probe.py variants [--source FILE] [NAME ...]

``variants`` builds copies of ``csrc/ssd.cu`` (or of FILE, an ``ssd.cu``
of another commit) with parts taken out or changed, into
``build/ssd_probe/``, and times each with ``chip_smoke.py``'s ssd timing
phase (zamba2-2.7b's prefill, B3 S1024 H80 P64 N64, bf16 x, B, C and y,
f32 a, zero initial state, cold L2, device time; B1 alone beside it), one
process a variant, so that what a part costs shows as the difference from
``base``.  Which variants exist depends on the source's design
(``DESIGNS``); a variant marked exact also computes the result and is
held against the plain version first (``SSD_TOL``'s bf16 rule).
"""

from __future__ import annotations

import argparse
import hashlib
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
SOURCE = ROOT / "src" / "repro_torch" / "kernels" / "mamba2_ssd" / "csrc" \
    / "ssd.cu"
OUT_DIR = ROOT / "build" / "ssd_probe"

# ------------------------------------------------- the chained design
# one block a (b, h, 32 columns of P), every step of a chunk in order
# between two block barriers (the design before the staged one)
_CH_SENTINEL = "Not done yet (later work): wgmma, TMA"
_CH_DECAYS = """  float incl = v[0] + v[1];
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
  e_s[2 * lane + 1] = expf(c1);"""
# the decays as loaded, no scan and no exp
_CH_NODECAYS = """  cum_s[2 * lane] = v[0];
  cum_s[2 * lane + 1] = v[1];
  w_s[2 * lane] = 1.f;
  w_s[2 * lane + 1] = 1.f;
  e_s[2 * lane] = 1.f;
  e_s[2 * lane + 1] = 1.f;"""
_CH_MASK = "sc[j][e] = col <= i ? sc[j][e] * expf(ci[e >> 1] - cum_s[col])"
_CH_SCORES_START = "    // -- M = L o (C B^T): key tiles up to the diagonal"
_CH_OFF_START = "    // -- y += exp(cum) o (C state^T), the state as hi + lo"
_CH_OFF = """#pragma unroll
      for (int kk = 0; kk < KN; ++kk) {
        mma_bf16(yoff[j], cf[kk], ld_u32(sh + kk * 16),
                 ld_u32(sh + kk * 16 + 8));
        mma_bf16(yoff[j], cf[kk], ld_u32(sl + kk * 16),
                 ld_u32(sl + kk * 16 + 8));
      }"""
_CH_UPDATE_START = \
    "    // -- state = exp(cum_last) state + (X o w)^T B, X o w as hi + lo"
_CH_UPDATE_END = \
    "    // Every warp is done with this chunk's buffers, decays and state copy."
_CH_WRITE_STATE = "    write_state();\n  }\n  cp_async_wait<0>();"
_CH_LO = ["        mma_bf16(yacc[j], alo, bv[0], bv[1]);\n",
          "        mma_bf16(yacc[j + 1], alo, bv[2], bv[3]);\n",
          """        mma_bf16(yoff[j], cf[kk], ld_u32(sl + kk * 16),
                 ld_u32(sl + kk * 16 + 8));\n""",
          "        mma_bf16(st[t], alo, bv[0], bv[1]);\n"]
_CH_STORE = "      if (s >= p.S) continue;"


def _chained(src: str) -> dict:
    scores = _CH_SCORES_START + src.split(_CH_SCORES_START)[1].split(
        _CH_OFF_START)[0]
    update = _CH_UPDATE_START + src.split(_CH_UPDATE_START)[1].split(
        _CH_UPDATE_END)[0]
    nodecays = [(_CH_DECAYS, _CH_NODECAYS),
                (_CH_MASK, "sc[j][e] = col <= i ? sc[j][e]")]
    noscores = [(scores, """    float yacc[NP][4];
#pragma unroll
    for (int j = 0; j < NP; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) yacc[j][e] = 0.f;

""")]
    nooff = [(_CH_OFF, "")]
    noupdate = [(update, ""), (_CH_WRITE_STATE, "  }\n  cp_async_wait<0>();")]
    return {
        "base": [],
        "nodecays": nodecays,
        "noscores": noscores,
        "nooff": nooff,
        "noupdate": noupdate,
        # every product of a hi + lo pair with hi alone (not exact: what
        # the pairs cost, their splits included)
        "hionly": [(lo, "") for lo in _CH_LO],
        # y computed, never stored (a condition the compiler cannot drop)
        "nostores": [(_CH_STORE, "      if (s >= p.S || p.B > 0) continue;")],
        # loads, barriers and the stores of y (zeros) alone
        "empty": nodecays[:1] + noscores + nooff + noupdate,
    }


# -------------------------------------------------- the staged design
# the chain warps (state recurrence) a ring of state slots ahead of the
# output warps (scores, y), inputs by TMA, mbarriers between them
_ST_SENTINEL = "The chain runs up to RING chunks ahead of the output warps"
_ST_CHAIN_EXP = """      const float dec = exp2_approx(total * LOG2E);
      const float w0 = exp2_approx((total - c0) * LOG2E);
      const float w1 = exp2_approx((total - c1) * LOG2E);"""
_ST_MASK_EXP = ["exp2_approx((ci[e] - cj.x) * LOG2E)",
                "exp2_approx((ci[e] - cj.y) * LOG2E)"]
_ST_ROW_EXP = """      const float e0 = exp2_approx(ci[0] * LOG2E);
      const float e1 = exp2_approx(ci[1] * LOG2E);"""
_ST_OFF = """#pragma unroll
      for (int part = 0; part < 2; ++part)
#pragma unroll
        for (int r = 0; r < NR; ++r)
#pragma unroll
          for (int k = 0; k < KS; ++k)
            hopper::wgmma_ss<PB, 0, 0>(
                y, hopper::smem_desc(cs + r * C::RB + k * 32, SW),
                hopper::smem_desc(
                    slot + (part * NR + r) * C::STILE + k * 32, SW),
                part || r || k);"""
_ST_SCORES = """#pragma unroll
      for (int r = 0; r < NR; ++r)
#pragma unroll
        for (int k = 0; k < KS; ++k)
          hopper::wgmma_ss<Q, 0, 0>(
              s, hopper::smem_desc(cs + r * C::RB + k * 32, SW),
              hopper::smem_desc(bs + r * C::RB + k * 32, SW), r || k);"""
_ST_YDIAG = ["        hopper::wgmma_rs_tb<PB>(y, mhi[kk], d, 1);\n",
             "        hopper::wgmma_rs_tb<PB>(y, mlo[kk], d, 1);\n"]
_ST_KEEP_M = "      keep(mhi);\n      keep(mlo);\n"
_ST_UPDATE = ["          hopper::wgmma_rs_tb<NSW>(st[r], ahi[kk], d, 1);\n",
              "          hopper::wgmma_rs_tb<NSW>(st[r], alo[kk], d, 1);\n"]
_ST_KEEP_A = "      keep(ahi);\n      keep(alo);\n"
_ST_STORE = "        hopper::tma_store_4d(&p.ymap, ys, p0, c * Q, h, b);\n"
_ST_ALOAD = \
    "      if (c + 2 < nc) load_decays(ag, p.sas, p.S, c + 2, lane, vn);"
_ST_SLOT = """      if (live) {
#pragma unroll
        for (int r = 0; r < NR; ++r)
#pragma unroll
          for (int j = 0; j < NSW / 8; ++j)
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              const uint32_t off"""
_ST_LOADS = """    hopper::mbar_arrive_expect_tx(bar, C::IN);
    hopper::tma_load_4d(in, &p.xmap, bar, p0, c * Q, h, b);
#pragma unroll
    for (int r = 0; r < NR; ++r) {"""
# after the first turn of the input slots, B and C (or X) not loaded again
_ST_NOBC = """    hopper::mbar_arrive_expect_tx(bar, c < NIN ? C::IN : C::XB);
    hopper::tma_load_4d(in, &p.xmap, bar, p0, c * Q, h, b);
#pragma unroll
    for (int r = 0; r < (c < NIN ? NR : 0); ++r) {"""
_ST_NOX = """    hopper::mbar_arrive_expect_tx(bar, c < NIN ? C::IN : C::IN - C::XB);
    if (c < NIN) hopper::tma_load_4d(in, &p.xmap, bar, p0, c * Q, h, b);
#pragma unroll
    for (int r = 0; r < NR; ++r) {"""
_ST_RING = "constexpr int RING = 1;"
_ST_SLACK = "constexpr int SLACK = 1024;"
_ST_NIN = "constexpr int NIN = 3;"
_ST_PB = "const int pb = P % 64 == 0 ? 64 : P % 32 == 0 ? 32 : 16;"
_ST_BYTES = \
    "static constexpr int BYTES = BARS + 8 * (2 * NIN + 2 * RING) + SLACK;"
# more slots overflow shared memory at N 128, which the timing never runs
_ST_FITS = ('  static_assert(BYTES <= 232448, "shared memory of one block");\n',
            "")


def _staged(src: str) -> dict:
    nodecays = [(_ST_CHAIN_EXP, "      const float dec = 1.f, w0 = 1.f, "
                                "w1 = 1.f;"),
                (_ST_ROW_EXP, "      const float e0 = 1.f, e1 = 1.f;")] + [
        (m, "1.f") for m in _ST_MASK_EXP]
    # no S = C B^T, no M (its decays and splits) and no M X
    noscores = [(_ST_SCORES, ""), (_ST_KEEP_M, "")] + [
        (line, "") for line in _ST_YDIAG]
    nooff = [(_ST_OFF, """#pragma unroll
      for (int i = 0; i < PB / 2; ++i) y[i] = 0.f;""")]
    # no state-update products (the loads and splits of X o w stay)
    noupdate = [(_ST_KEEP_A, "")] + [(line, "") for line in _ST_UPDATE]
    return {
        "base": [],
        # the open choices: half a head a block (480 blocks at zamba2's
        # shape, each computing all the head's decays and scores) rather
        # than a whole one (240); four input slots (one block an SM);
        # three state slots and four input slots; one block an SM with the
        # base's slots (shared memory padded past half an SM's)
        "halves": [(_ST_PB, "const int pb = P % 32 == 0 ? 32 : 16;")],
        "in4": [(_ST_NIN, "constexpr int NIN = 4;"), _ST_FITS],
        "ring3in4": [(_ST_RING, "constexpr int RING = 3;"),
                     (_ST_NIN, "constexpr int NIN = 4;"), _ST_FITS],
        "oneblock": [(_ST_BYTES, _ST_BYTES.replace("+ SLACK;",
                                                   "+ SLACK + 120000;")),
                     _ST_FITS],
        # parts taken out: results wrong, the timing is what counts
        "nodecays": nodecays,
        "noscores": noscores,
        "nooff": nooff,
        "noupdate": noupdate,
        # every product of a hi + lo pair with hi alone
        "hionly": [(_ST_UPDATE[1], ""), (_ST_YDIAG[1], ""),
                   (_ST_OFF, _ST_OFF.replace("part < 2", "part < 1"))],
        # y computed and staged, never stored
        "nostores": [(_ST_STORE, "")],
        # the chain's decays of chunks after the first not loaded
        "noaload": [(_ST_ALOAD, "      vn[0] = vn[1] = -0.01f;")],
        # the state not written to its slot (the hand-off stays)
        "noslot": [(_ST_SLOT, _ST_SLOT.replace("if (live) {",
                                               "if (live && p.S < 0) {"))],
        # two state slots (the chain up to two chunks ahead); four input
        # slots, at two blocks an SM only if the base is taken as aligned
        "ring2": [(_ST_RING, "constexpr int RING = 2;")],
        "in4noslack": [(_ST_NIN, "constexpr int NIN = 4;"),
                       (_ST_SLACK, "constexpr int SLACK = 0;"), _ST_FITS],
        # B and C, or X, loaded in the first turn of the input slots only
        "nobc": [(_ST_LOADS, _ST_NOBC)],
        "nox": [(_ST_LOADS, _ST_NOX)],
        # loads, hand-offs and stores alone
        "empty": nodecays + noscores + nooff + noupdate,
        "empty_nobc": nodecays + noscores + nooff + noupdate + [
            (_ST_LOADS, _ST_NOBC)],
    }


# name -> (sentinel in the source, patches(src) -> {variant: [(old, new)]},
#          variants that compute the result)
DESIGNS = {
    "chained": (_CH_SENTINEL, _chained, ("base",)),
    "staged": (_ST_SENTINEL, _staged,
               ("base", "halves", "in4", "ring3in4", "oneblock", "ring2",
                "in4noslack")),
}


def _design(src: str):
    for name, (sentinel, patches, exact) in DESIGNS.items():
        if sentinel in src:
            return name, patches(src), exact
    raise SystemExit("ssd.cu matches none of the probe's designs "
                     f"({', '.join(DESIGNS)})")


def _variant_source(source: Path, name: str) -> Path:
    src = source.read_text()
    _, patches, _ = _design(src)
    for old, new in patches[name]:
        if old not in src:
            raise SystemExit(f"variant {name}: ssd.cu no longer has the "
                             f"text it patches:\n{old}")
        src = src.replace(old, new)
    OUT_DIR.mkdir(parents=True, exist_ok=True)
    digest = hashlib.sha1(src.encode()).hexdigest()[:8]
    path = OUT_DIR / f"ssd_{name}_{digest}.cu"
    path.write_text(src)
    return path


def _one_variant(source: Path, name: str) -> None:
    sys.path[:0] = [str(ROOT / "src"), str(ROOT)]
    import torch

    import chip_smoke
    from repro_torch.kernels.mamba2_ssd import ops

    design, _, exact = _design(source.read_text())
    ops._SOURCES = (_variant_source(source, name),)
    print(f"variant {name} of {design} ({source})", flush=True)
    gen = torch.Generator(device="cuda").manual_seed(1)
    if name in exact:
        B, S, H, P, N = chip_smoke.SSD_PREFILL

        def rnd(shape, scale):
            return torch.randn(shape, generator=gen, device="cuda") * scale

        xdt = rnd((B, S, H, P), 0.5).bfloat16()
        a = -rnd((B, S, H), 0.1).abs()
        Bm, Cm = (rnd((B, S, N), 0.5).bfloat16() for _ in range(2))
        y, state = ops.ssd(xdt, a, Bm, Cm)
        want_y, want_state = ops.ssd(xdt, a, Bm, Cm, impl="ref")
        tol = chip_smoke.SSD_TOL["torch.bfloat16"]
        errs = [(got.float() - want.float()).abs().max().item()
                / want.float().abs().max().item()
                for got, want in ((y, want_y), (state, want_state))]
        ok = max(errs) <= tol
        print(f"  held against the plain version: max error normalised by "
              f"max |want|, y {errs[0]:.2e}, state {errs[1]:.2e} (tol "
              f"{tol:g}) {'ok' if ok else 'FAIL'}", flush=True)
        if not ok:
            raise SystemExit(f"variant {name} disagrees with the plain "
                             "version")
    chip_smoke.ssd_timing_phase(torch, ops, gen)


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
    args = parser.parse_args(argv)
    source = args.source.resolve()
    if args.cmd == "_one":
        _one_variant(source, args.name)
        return 0
    _, patches, _ = _design(source.read_text())
    unknown = set(args.names) - set(patches)
    if unknown:
        parser.error(f"unknown variants {sorted(unknown)}; choose from "
                     f"{sorted(patches)}")
    failed = []
    for name in args.names or patches:
        proc = subprocess.run([sys.executable, __file__, "_one", "--source",
                               str(source), name], cwd=ROOT)
        if proc.returncode:
            failed.append(name)
    if failed:
        print(f"variants that failed: {failed}", flush=True)
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
