#!/usr/bin/env python3
"""Probes of the grouped expert matmul (gmm) on one NVIDIA GPU.

Run from the root of a checkout, on a machine with the card and nvcc:

    python3 tools/gmm_probe.py variants [NAME ...]
    python3 tools/gmm_probe.py host [--src DIR]

``variants`` builds copies of ``csrc/gmm.cu`` with parts of the wide
(prefill) kernel taken out and times each with ``chip_smoke.py``'s gmm
timing phase (granite-moe's wi and wo products at its prefill and decode
shapes, cold L2, device time), one process a variant, so that what a
part costs shows as the difference from ``base``:
- ``base``: the source as it is (its results are checked);
- ``noproducts``: no wgmma: the loads and the stores alone;
- ``nostores``: no epilogue: the loads and the products alone;
- ``halfweights``: half of each tile's weight boxes loaded (the stores
  kept): what halving the weights' traffic would buy.
Only ``base`` computes the product; the others' times alone matter.

``host`` prints the host time a call of ``grouped_matmul`` from the tree
under DIR (default ``src``; a parent commit unpacked elsewhere may be
given) at granite's decode and prefill shapes, with the card running
behind, and of the wrapper's parts where the tree has them.
"""

from __future__ import annotations

import argparse
import hashlib
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
SOURCE = ROOT / "src" / "repro_torch" / "kernels" / "moe_gmm" / "csrc" \
    / "gmm.cu"
OUT_DIR = ROOT / "build" / "gmm_probe"

_EPILOGUE_START = "    // out: rounded once, staged as four swizzled"
_EPILOGUE_END = "  if (leader) hopper::bulk_wait();"
_PRODUCTS = '''        hopper::wgmma_ss<WD_BN, 0, 1>(
            acc, hopper::smem_desc(buf + cg * BOX + kk * 32, 128),
            hopper::smem_desc_mn128(buf + 2 * BOX + kk * 16 * 128, BOX),
            kt > 0 || kk > 0);'''
_W_BYTES = "(int(w.valid[0]) + int(w.valid[1])) * BOX + w.nw * BOX;"
_W_LOOP = "        for (int a = 0; a < w.nw; ++a)\n" \
    "          hopper::tma_load_4d(buf + (2 + a)"


def _patches(src: str) -> dict:
    epilogue = _EPILOGUE_START + src.split(_EPILOGUE_START)[1].split(
        _EPILOGUE_END)[0]
    return {
        "base": [],
        "noproducts": [(_PRODUCTS, "        ;")],
        # the epilogue ends with the item loop's brace, which stays
        "nostores": [(epilogue, "  }\n")],
        "halfweights": [
            (_W_BYTES, _W_BYTES.replace("w.nw * BOX", "(w.nw / 2) * BOX")),
            (_W_LOOP, _W_LOOP.replace("a < w.nw", "a < w.nw / 2"))],
    }


VARIANTS = ("base", "noproducts", "nostores", "halfweights")


def _variant_source(name: str) -> Path:
    src = SOURCE.read_text()
    for old, new in _patches(src)[name]:
        if old not in src:
            raise SystemExit(f"variant {name}: gmm.cu no longer has the "
                             f"text it patches:\n{old}")
        src = src.replace(old, new)
    OUT_DIR.mkdir(parents=True, exist_ok=True)
    digest = hashlib.sha1(src.encode()).hexdigest()[:8]
    path = OUT_DIR / f"gmm_{name}_{digest}.cu"
    path.write_text(src)
    return path


def _one_variant(name: str) -> None:
    sys.path[:0] = [str(ROOT / "src"), str(ROOT)]
    import torch

    import chip_smoke
    from repro_torch.kernels.moe_gmm import ops

    ops._SOURCES = (_variant_source(name),)
    print(f"variant {name}", flush=True)
    if name == "base":
        gen = torch.Generator(device="cuda").manual_seed(1)
        for B, C in ((3, 8), (3, 320)):
            for D, F in ((1024, 512), (512, 1024)):
                x = torch.randn((B, 32, C, D), generator=gen,
                                device="cuda").bfloat16()
                w = (torch.randn((32, D, F), generator=gen, device="cuda")
                     * D ** -0.5).bfloat16()
                got = ops.grouped_matmul(x, w).float()
                want = ops.grouped_matmul(x, w, impl="ref").float()
                err = ((got - want).abs().max() / want.abs().max()).item()
                if err > chip_smoke.GMM_TOL["torch.bfloat16"]:
                    raise SystemExit(f"base variant disagrees: {err}")
    chip_smoke.gmm_timing_phase(
        torch, ops, torch.Generator(device="cuda").manual_seed(0))


def _host(src_dir: str) -> None:
    sys.path.insert(0, str(Path(src_dir).resolve()))
    import torch

    from repro_torch.kernels.moe_gmm import ops

    def per_call_us(fn, calls=20, reps=25):
        fn()
        times = []
        for _ in range(reps):
            torch.cuda.synchronize()
            t = time.perf_counter()
            for _ in range(calls):
                fn()
            times.append((time.perf_counter() - t) * 1e6 / calls)
        torch.cuda.synchronize()
        return statistics.median(times)

    for label, C in (("decode", 8), ("prefill", 320)):
        x = torch.randn((3, 32, C, 1024), device="cuda").bfloat16()
        w = torch.randn((32, 1024, 512), device="cuda").bfloat16()
        parts = {"grouped_matmul": lambda: ops.grouped_matmul(x, w),
                 "_check": lambda: ops._check(x, w),
                 "torch.empty": lambda: torch.empty(
                     (3, 32, C, 512), dtype=x.dtype, device=x.device)}
        if hasattr(ops, "_tma_operand"):
            lib = ops._kernel()
            parts["_tma_operand(x)"] = lambda: ops._tma_operand(x)
            parts["_weight_operand"] = lambda: ops._weight_operand(lib, w)
        for name, fn in parts.items():
            print(f"host {src_dir} {label} C{C} {name}: "
                  f"{per_call_us(fn):.2f} us a call", flush=True)


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    sub = parser.add_subparsers(dest="cmd", required=True)
    var = sub.add_parser("variants")
    var.add_argument("names", nargs="*", help=f"of {', '.join(VARIANTS)} "
                     "(default: all)")
    one = sub.add_parser("_one")
    one.add_argument("name", choices=VARIANTS)
    host = sub.add_parser("host")
    host.add_argument("--src", default="src")
    args = parser.parse_args(argv)
    if args.cmd == "_one":
        _one_variant(args.name)
    elif args.cmd == "host":
        _host(args.src)
    else:
        unknown = set(args.names) - set(VARIANTS)
        if unknown:
            parser.error(f"unknown variants {sorted(unknown)}; choose from "
                         f"{VARIANTS}")
        for name in args.names or VARIANTS:
            proc = subprocess.run([sys.executable, __file__, "_one", name],
                                  cwd=ROOT)
            if proc.returncode:
                return proc.returncode
    return 0


if __name__ == "__main__":
    sys.exit(main())
