"""Measure ``StepCostModel``'s constants on the card:
``python -m repro_torch.serving.calibrate [--device cuda|cpu] [--smoke]``.

* The prefill: for each n in ``STREAMS``, largest first, prefill n random
  prompts of ``PROMPT`` tokens into bf16 qwen3-0.6b caches of ``MAX_LEN``
  positions (``models.prefill``: the flash kernel once a layer a prefill
  on the card) ``PREFILL_REPS`` times, each timed on the host clock
  between synchronises, and keep the last caches: every n's caches stay
  resident together.  The least wall of each n is fitted by least squares
  against its n x ``PROMPT`` tokens: the slope is the prefill charge a
  token, the launcher's ``--prefill-ms-per-tok`` default.
* The decode step: ``WARM`` steps at each n, then ``ROUNDS`` rounds, each
  timing ``TIMED`` ``decode_step`` calls at every n in turn (host clock,
  each step ended by a synchronise).  A round's median is its step at
  that n; the step is the least of its rounds' medians.  The step is host
  bound and the host is shared, so a slow spell from outside the process
  lifts every n of one round: interleaving keeps it out of the slope, and
  the least round keeps it out of the intercept.  That wall is fitted by
  least squares against n: the intercept is ``t_fixed_ms``, the slope
  ``t_tok_ms``.  Wall, not busy, time: the step a user waits for.
* The host link: a pinned host-to-device copy of ``H2D_BYTES``, median of
  ``H2D_REPS`` on CUDA events; ``thrash_coef`` derives from it
  (``engine``'s module docstring).

Each line printed is one measurement; the last is one JSON object with
all of them, the flash launches of the prefills and the card.  Run it in
a fresh process.  ``--smoke`` takes the reduced config and few streams
(for the CPU tests); ``--device cpu`` runs the plain versions, times host
work, not a card's, and measures no copy.
"""

from __future__ import annotations

import argparse
import json
import statistics
import time
from typing import Dict

import numpy as np
import torch

from .. import resolve_device
from ..configs import get_config, get_smoke_config
from ..kernels.flash_attention import ops as flash_ops
from ..models import decode_step, init_params, prefill
from .engine import CALIBRATION_ARCH as ARCH
from .engine import CALIBRATION_STREAMS as STREAMS

PROMPT, MAX_LEN = 640, 1024
PREFILL_REPS = 2
WARM, ROUNDS, TIMED = 3, 6, 10
H2D_BYTES, H2D_REPS = 1 << 30, 5


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize()


@torch.no_grad()
def decode_walls(cfg, device, streams, prompt: int, max_len: int,
                 seed: int = 0) -> Dict:
    """The prefill walls and the decode-step walls at each active stream
    count (module docstring), the peak memory (on the card) and the flash
    launches of the prefills."""
    params = init_params(cfg, torch.Generator(device=device).manual_seed(
        seed), device)
    rng = np.random.default_rng(seed)
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats()
    caches, toks, prefill_ms, launches = {}, {}, {}, 0
    for n in sorted(streams, reverse=True):
        tokens = torch.as_tensor(rng.integers(
            0, cfg.vocab_size, (n, prompt)).astype(np.int32), device=device)
        walls = []
        for _ in range(PREFILL_REPS):
            logits = caches[n] = None          # free the last rep's first
            before = flash_ops.launches
            _sync(device)
            t = time.perf_counter()
            logits, caches[n] = prefill(cfg, params, {"tokens": tokens},
                                        max_len=max_len)
            _sync(device)
            walls.append((time.perf_counter() - t) * 1e3)
            launches += flash_ops.launches - before
        prefill_ms[n] = min(walls)
        print(f"prefill of {n:>3} x {prompt} tokens: wall "
              f"{prefill_ms[n]:.3f} ms (least of {PREFILL_REPS})")
        toks[n] = logits[:, -1].argmax(-1)[:, None].to(torch.int32)
        del logits, tokens

    def steps(n, count):
        out = []
        for _ in range(count):
            _sync(device)
            t = time.perf_counter()
            logits, caches[n] = decode_step(cfg, params, caches[n], toks[n])
            _sync(device)
            out.append((time.perf_counter() - t) * 1e3)
        if not bool(torch.isfinite(logits).all()):
            raise RuntimeError(f"non-finite decode logits at {n} streams")
        return out

    for n in streams:
        steps(n, WARM)
    rounds = {n: [] for n in streams}
    every = {n: [] for n in streams}
    for _ in range(ROUNDS):
        for n in streams:
            got = steps(n, TIMED)
            rounds[n].append(statistics.median(got))
            every[n] += got
    walls = {n: min(rounds[n]) for n in streams}
    for n in streams:
        print(f"decode step at {n:>3} streams: wall {walls[n]:.3f} ms "
              f"(least of {ROUNDS} round medians of {TIMED}; rounds "
              f"{min(rounds[n]):.3f}..{max(rounds[n]):.3f}, all steps "
              f"median {statistics.median(every[n]):.3f} min "
              f"{min(every[n]):.3f} max {max(every[n]):.3f})")
    peak = (torch.cuda.max_memory_allocated() / 1e9
            if device.type == "cuda" else None)
    print(f"peak memory with every n's caches resident: "
          f"{f'{peak:.2f} GB' if peak is not None else 'n/a'}")
    return {"walls_ms": walls, "round_medians_ms": rounds,
            "prefill_ms": prefill_ms, "peak_gb": peak,
            "prefills": PREFILL_REPS * len(streams),
            "flash_launches": launches}


def fit(walls: Dict[int, float]) -> Dict[str, float]:
    """Least-squares line through (n, wall): intercept, slope and R^2."""
    x = np.array(sorted(walls), dtype=np.float64)
    y = np.array([walls[n] for n in sorted(walls)])
    slope, intercept = np.polyfit(x, y, 1)
    resid = y - (intercept + slope * x)
    r2 = 1.0 - float(resid @ resid) / float(((y - y.mean()) ** 2).sum())
    return {"t_fixed_ms": float(intercept), "t_tok_ms": float(slope),
            "r2": r2}


def h2d_rate(nbytes: int = H2D_BYTES, reps: int = H2D_REPS) -> float:
    """Pinned host-to-device copy rate in bytes/s: ``nbytes`` copied
    ``reps`` times on CUDA events after one warm copy; the median."""
    host = torch.empty(nbytes, dtype=torch.uint8, pin_memory=True)
    dev = torch.empty(nbytes, dtype=torch.uint8, device="cuda")
    dev.copy_(host, non_blocking=True)
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        dev.copy_(host, non_blocking=True)
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / 1e3)
    return nbytes / statistics.median(times)


def main(argv=None) -> Dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None,
                    help="cuda (default) or cpu; cuda raises if absent")
    ap.add_argument("--smoke", action="store_true",
                    help="reduced config, streams 1, 2, 4, prompt 16")
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    if args.smoke:
        cfg, streams, prompt, max_len = (get_smoke_config(ARCH), (1, 2, 4),
                                         16, 32)
    else:
        cfg, streams, prompt, max_len = (get_config(ARCH), STREAMS, PROMPT,
                                         MAX_LEN)
    out = decode_walls(cfg, device, streams, prompt, max_len)
    out.update(fit(out["walls_ms"]))
    print(f"fit over {tuple(streams)} streams: t_fixed_ms "
          f"{out['t_fixed_ms']:.4f}, t_tok_ms {out['t_tok_ms']:.6f}, R^2 "
          f"{out['r2']:.4f}")
    pre = fit({n * prompt: ms for n, ms in out["prefill_ms"].items()})
    out["prefill_ms_per_tok"], out["prefill_r2"] = pre["t_tok_ms"], pre["r2"]
    print(f"prefill fit over {tuple(n * prompt for n in streams)} tokens: "
          f"{pre['t_fixed_ms']:.4f} ms + {pre['t_tok_ms']:.6f} ms a token, "
          f"R^2 {pre['r2']:.4f}")
    out["h2d_bytes_per_s"] = None
    if device.type == "cuda":
        out["h2d_bytes_per_s"] = h2d_rate()
        print(f"pinned host-to-device copy ({H2D_BYTES} B, median of "
              f"{H2D_REPS}): {out['h2d_bytes_per_s'] / 1e9:.3f} GB/s")
        out["device"] = torch.cuda.get_device_name(0)
    else:
        out["device"] = "cpu"
    out["arch"], out["streams"], out["prompt"], out["max_len"] = (
        cfg.name, list(streams), prompt, max_len)
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    main()
