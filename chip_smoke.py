#!/usr/bin/env python3
"""Smoke run of the PyTorch port (``src/repro_torch``) on one NVIDIA GPU.

Run from the root of a checkout:  ``python3 chip_smoke.py``

It builds the port's CUDA kernels from the checkout's sources and then:

1. prints the card (``nvidia-smi`` name and power limit) and the build time;
2. holds the flash-attention kernel against its plain PyTorch version on
   the card: the reference kernel tests' sweep in f32 and bf16, causal,
   windowed and non-causal, plus GQA, ragged lengths, ring-buffer
   positions with unwritten (-1) slots, strided views and the serving
   prefill shape;
3. times the kernel, the plain version and PyTorch's
   ``scaled_dot_product_attention`` (a yardstick only; the port never
   calls it) at the serving prefill shape, beside the card's bound;
4. serves full-width qwen3-0.6b (28 layers, random weights from seed 0)
   under GCR admission: 8 streams on 3 slots, prompt 1024, 16 generated
   tokens each, and checks the flash launch count, the admission counts,
   finite logits, and the first wave's prefill logits against the same
   wave with plain attention; then profiles one prefill wave and a few
   decode steps (device busy time, idle share, the heaviest kernels);
5. prints one JSON line describing every kernel of the path, then, as
   the last line, ``{"ok": true, "device": {...}}``.

Any failure exits non-zero.  Without CUDA, or outside a checkout, it
exits non-zero before doing anything.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"

# Published dense peaks of one H100 SXM (NVIDIA data sheet), for the bound.
PEAK_FLOPS = {"torch.bfloat16": 989e12, "torch.float32": 67e12}
PEAK_BYTES_PER_S = 3.35e12

# (B, S, T, H, D) of the reference kernel tests' flash sweep
SWEEP = [(2, 512, 512, 4, 64), (1, 1024, 1024, 2, 128),
         (2, 256, 1024, 4, 64), (1, 512, 512, 3, 128)]
MODES = [(True, 0), (True, 128), (False, 0)]      # (causal, window)
# f32: summation order only; bf16: one rounding of the output (the
# reference kernel tests' tolerances, as atol = rtol)
TOL = {"torch.float32": 5e-5, "torch.bfloat16": 2e-2}

# the serving run: one GCR engine, more streams than slots
N_STREAMS, N_SLOTS, PROMPT_LEN, GEN_LEN = 8, 3, 1024, 16
# prefill logits, flash kernel vs plain attention, both in bf16: the two
# round attention outputs to bf16 in different places, and 28 layers carry
# those one-ulp differences to the logits.  Allowed: 5% of the largest
# logit (about 13 bf16 ulps at that scale).
LOGIT_RTOL = 0.05


class SmokeFailure(RuntimeError):
    pass


def check(ok: bool, msg: str) -> None:
    if not ok:
        raise SmokeFailure(msg)


def card_line() -> str:
    proc = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    check(proc.returncode == 0, f"nvidia-smi failed: {proc.stderr}")
    return proc.stdout.strip().splitlines()[0]


def time_ms(torch, fn, iters: int = 10, reps: int = 5) -> float:
    """Median over ``reps`` of the mean time of ``iters`` back-to-back
    calls, on CUDA events, after one warm-up call."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / iters)
    return statistics.median(times)


def kernel_phase(torch, fa, gen):
    """Every case: kernel vs plain on the same inputs.  Returns the max
    abs error at the serving prefill shape."""
    def rnd(shape, dtype):
        return torch.randn(shape, generator=gen, device="cuda", dtype=dtype)

    def compare(name, dtype, got, want):
        err = (got.float() - want.float()).abs().max().item()
        tol = TOL[str(dtype)]
        ok = torch.allclose(got.float(), want.float(), atol=tol, rtol=tol)
        print(f"  {name:<58} max_abs_err={err:.3e} atol=rtol={tol:g} "
              f"{'ok' if ok else 'FAIL'}")
        check(ok, f"flash kernel disagrees with plain: {name}")
        return err

    def positional(name, dtype, q, k, v, q_pos, k_pos, window, causal):
        got = fa.flash_attention_fwd(q, k, v, q_pos, k_pos, window=window,
                                     causal=causal)
        want = fa.flash_attention_fwd(q, k, v, q_pos, k_pos, window=window,
                                      causal=causal, impl="ref")
        return compare(name, dtype, got, want)

    def arange(n, off=0):
        return torch.arange(off, off + n, dtype=torch.int32, device="cuda")

    print("kernel phase: flash_attention_fwd vs attention_ref on the card")
    for dtype in (torch.float32, torch.bfloat16):
        short = str(dtype).replace("torch.", "")
        for (B, S, T, H, D) in SWEEP:
            q = rnd((B, S, H, D), dtype)
            k, v = rnd((B, T, H, D), dtype), rnd((B, T, H, D), dtype)
            for causal, window in MODES:
                got = fa.flash_attention(q, k, v, causal=causal,
                                         window=window)
                want = fa.flash_attention(q, k, v, causal=causal,
                                          window=window, impl="ref")
                compare(f"sweep B{B} S{S} T{T} H{H} D{D} {short} "
                        f"causal={causal} window={window}", dtype, got, want)

        # GQA (qwen3's 16/8 heads), ragged lengths, the reduced head dim
        for (B, S, Hq, Hkv, D, window) in [(2, 256, 16, 8, 128, 0),
                                           (2, 12, 4, 2, 64, 0),
                                           (1, 1000, 4, 2, 128, 0),
                                           (1, 1000, 4, 2, 128, 100),
                                           (3, 12, 4, 2, 16, 0)]:
            q = rnd((B, S, Hq, D), dtype)
            k, v = rnd((B, S, Hkv, D), dtype), rnd((B, S, Hkv, D), dtype)
            positional(f"gqa/ragged B{B} S=T={S} Hq{Hq} Hkv{Hkv} D{D} "
                       f"window={window} {short}", dtype, q, k, v,
                       arange(S), arange(S), window, True)

        # ring-buffer positions: shuffled slots, some never written (-1)
        T, S = 320, 128
        k_pos = torch.randperm(T, generator=gen, device="cuda").to(
            torch.int32)
        k_pos[torch.randperm(T, generator=gen, device="cuda")[:40]] = -1
        q = rnd((2, S, 8, 128), dtype)
        k, v = rnd((2, T, 4, 128), dtype), rnd((2, T, 4, 128), dtype)
        for window in (0, 64):
            positional(f"ring k_pos with -1 slots, window={window} {short}",
                       dtype, q, k, v, arange(S, T - S), k_pos, window, True)

        # strided views: q, k, v sliced out of one fused projection
        qkv = rnd((2, 384, 16 + 8 + 8, 128), dtype)
        q, k, v = qkv[:, :, :16], qkv[:, :, 16:24], qkv[:, :, 24:]
        positional(f"strided q/k/v views of a fused qkv {short}", dtype,
                   q, k, v, arange(384), arange(384), 0, True)

    B, S, Hq, Hkv, D = 3, PROMPT_LEN, 16, 8, 128
    q = rnd((B, S, Hq, D), torch.bfloat16)
    k = rnd((B, S, Hkv, D), torch.bfloat16)
    v = rnd((B, S, Hkv, D), torch.bfloat16)
    err = positional(f"serving prefill B{B} S=T={S} Hq{Hq} Hkv{Hkv} D{D} "
                     "bfloat16", torch.bfloat16, q, k, v, arange(S),
                     arange(S), 0, True)
    return err, (q, k, v, arange(S), arange(S))


def timing_phase(torch, fa, inputs):
    q, k, v, q_pos, k_pos = inputs
    B, S, Hq, D = q.shape
    T = k.shape[1]
    sdpa = torch.nn.functional.scaled_dot_product_attention
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
    ms = time_ms(torch, lambda: fa.flash_attention_fwd(q, k, v, q_pos,
                                                       k_pos))
    plain_ms = time_ms(torch, lambda: fa.flash_attention_fwd(
        q, k, v, q_pos, k_pos, impl="ref"), iters=3)
    library_ms = time_ms(torch, lambda: sdpa(qt, kt, vt, is_causal=True,
                                             enable_gqa=True))

    # bound: the pairs this run's positions leave visible, each costing a
    # QK^T and a PV product (2 FLOP per multiply-add); each input byte
    # read once and the output written once
    visible = (k_pos[None, :] <= q_pos[:, None]) & (k_pos >= 0)[None, :]
    flops = 4 * B * Hq * int(visible.sum().item()) * D
    nbytes = (2 * q.numel() + k.numel() + v.numel()) * q.element_size() \
        + 4 * (S + T)
    t_ops = flops / PEAK_FLOPS[str(q.dtype)] * 1e3
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    bound_ms = max(t_ops, t_bytes)
    bound_by = "operations" if t_ops >= t_bytes else "bytes"
    print(f"timing at the serving prefill shape B{B} S=T={S} Hq{Hq} "
          f"Hkv{k.shape[2]} D{D} {q.dtype} causal (median of 5):")
    print(f"  flash kernel {ms:.4f} ms | plain {plain_ms:.4f} ms | "
          f"sdpa (yardstick) {library_ms:.4f} ms | bound {bound_ms:.4f} ms "
          f"({bound_by}: {flops / 1e9:.2f} GFLOP, {nbytes / 1e6:.2f} MB)")
    return {"ms": ms, "plain_ms": plain_ms, "library_ms": library_ms,
            "bound_ms": bound_ms, "bound_by": bound_by}


def serve_phase(torch, np, fa, gen):
    from repro_torch.configs import get_config
    from repro_torch.models import init_params, prefill
    from repro_torch.serving.engine import TorchServeEngine

    cfg = get_config("qwen3-0.6b")
    check((cfg.n_layers, cfg.d_model, cfg.n_heads, cfg.n_kv_heads,
           cfg.head_dim, cfg.vocab_size, cfg.dtype)
          == (28, 1024, 16, 8, 128, 151936, "bfloat16"),
          f"unexpected qwen3-0.6b config {cfg}")
    t0 = time.perf_counter()
    params = init_params(cfg, torch.Generator(device="cuda").manual_seed(0),
                         "cuda")
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in params.parameters())
    print(f"serve phase: {cfg.name} {n_params / 1e6:.1f}M params "
          f"initialised in {time.perf_counter() - t0:.2f} s")

    max_len = PROMPT_LEN + GEN_LEN
    eng = TorchServeEngine(cfg, params, n_slots=N_SLOTS, max_len=max_len,
                           admission_kind="gcr", device="cuda")
    prompts = np.random.default_rng(0).integers(
        0, cfg.vocab_size, (N_STREAMS, PROMPT_LEN)).astype(np.int32)

    prefill_ms, decode_ms, finite, first = [], [], [], {}
    run_prefill, run_decode = eng._prefill, eng._decode

    def timed_prefill(p, batch):
        torch.cuda.synchronize()
        t = time.perf_counter()
        logits, cache = run_prefill(p, batch)
        torch.cuda.synchronize()
        prefill_ms.append((time.perf_counter() - t) * 1e3)
        finite.append(torch.isfinite(logits).all())
        if not first:
            first["tokens"] = batch["tokens"].clone()
            first["logits"] = logits.clone()
        return logits, cache

    def timed_decode(p, cache, tok):
        torch.cuda.synchronize()
        t = time.perf_counter()
        logits, cache = run_decode(p, cache, tok)
        torch.cuda.synchronize()
        decode_ms.append((time.perf_counter() - t) * 1e3)
        finite.append(torch.isfinite(logits).all())
        return logits, cache

    eng._prefill, eng._decode = timed_prefill, timed_decode
    fa.launches = 0                       # count the main path alone
    t0 = time.perf_counter()
    out = eng.generate(prompts, GEN_LEN)
    torch.cuda.synchronize()
    wall_s = time.perf_counter() - t0
    launches = fa.launches

    waves = len(prefill_ms)
    adm = eng.admission
    print(f"  waves={waves} flash launches={launches} "
          f"(want {cfg.n_layers} x {waves}) stat_fast={adm.stat_fast} "
          f"stat_parked={adm.stat_parked}")
    check(waves == 3, f"expected 3 prefill waves, got {waves}")
    check(launches == cfg.n_layers * waves,
          f"flash launches {launches} != {cfg.n_layers} x {waves}")
    check((adm.stat_fast, adm.stat_parked) == (8, 2),
          f"admission counts {adm.stat_fast}/{adm.stat_parked} != 8/2")
    check(bool(torch.stack(finite).all()), "non-finite logits")
    check(out.shape == (N_STREAMS, GEN_LEN)
          and out.min() >= 0 and out.max() < cfg.vocab_padded,
          f"bad generated tokens: shape {out.shape}")

    with torch.no_grad():
        ref_logits, _ = prefill(cfg, params, {"tokens": first["tokens"]},
                                max_len, impl="ref")
    got, want = first["logits"].float(), ref_logits.float()
    err = (got - want).abs().max().item()
    scale = want.abs().max().item()
    agree = int((got.argmax(-1) == want.argmax(-1)).sum().item())
    print(f"  first-wave prefill logits, flash vs plain attention: "
          f"max_abs_err={err:.4e} tol={LOGIT_RTOL * scale:.4e} "
          f"(max |logit| {scale:.3f}); greedy tokens agree "
          f"{agree}/{got.shape[0]}")
    check(err <= LOGIT_RTOL * scale, "prefill logits disagree")

    tokens = N_STREAMS * GEN_LEN
    print(f"  prefill ms per wave: {[round(t, 3) for t in prefill_ms]}")
    print(f"  decode ms per step: median {statistics.median(decode_ms):.3f} "
          f"over {len(decode_ms)} steps")
    print(f"  generated {tokens} tokens in {wall_s:.3f} s: "
          f"{tokens / wall_s:.1f} tokens/s (re-prefill per wave included)")
    print(f"  stream 0 tokens: {out[0].tolist()}")
    wave = {"tokens": first["tokens"]}
    profile_phase(torch, lambda: run_prefill(params, wave),
                  lambda c, t: run_decode(params, c, t))
    return launches


def profile_phase(torch, do_prefill, do_decode, n_decode: int = 8):
    """Where the time goes: one prefill wave and ``n_decode`` decode steps,
    each run once on the host clock and once more under torch.profiler.
    Device busy time is the sum of the profiled kernels' durations (one
    stream, so they do not overlap); the idle share is the rest of the
    unprofiled wall time (the profiler slows the host, not the card)."""
    from torch.profiler import ProfilerActivity, profile

    logits, cache = do_prefill()                       # warm
    tok = logits[:, -1].argmax(-1)[:, None].to(torch.int32)

    def decode_steps():
        nonlocal cache
        for _ in range(n_decode):
            _, cache = do_decode(cache, tok)

    for name, work, n in (("prefill wave", do_prefill, 1),
                          ("decode", decode_steps, n_decode)):
        torch.cuda.synchronize()
        t = time.perf_counter()
        work()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t) * 1e3 / n
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            work()
            torch.cuda.synchronize()
        kernels = [e for e in prof.events()
                   if e.device_type == torch.autograd.DeviceType.CUDA]
        busy_ms = sum(e.time_range.elapsed_us() for e in kernels) / 1e3 / n
        per = " per step" if n > 1 else ""
        if busy_ms == 0:
            print(f"profile {name}: wall {wall_ms:.3f} ms{per}; the "
                  "profiler saw no device time: busy and idle share not "
                  "measured")
            continue
        print(f"profile {name}: wall {wall_ms:.3f} ms{per}, device busy "
              f"{busy_ms:.3f} ms{per}, idle share "
              f"{max(0.0, 1 - busy_ms / wall_ms):.3f}, "
              f"{len(kernels) // n} kernels{per}")
        by_name = {}
        for e in kernels:
            by_name[e.name] = by_name.get(e.name, 0.0) \
                + e.time_range.elapsed_us() / 1e3 / n
        for kname, ms in sorted(by_name.items(), key=lambda kv: -kv[1])[:6]:
            print(f"    {ms:9.3f} ms{per} {ms / busy_ms:6.1%}  {kname[:90]}")


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on a GPU",
              file=sys.stderr)
        return 2
    if not (SRC / "repro_torch" / "__init__.py").exists():
        print(f"chip_smoke: {SRC / 'repro_torch'} not found; run from the "
              "root of a checkout", file=sys.stderr)
        return 2
    sys.path.insert(0, str(SRC))
    import numpy as np

    from repro_torch.kernels import _build
    from repro_torch.kernels.flash_attention import ops as fa

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    print(card_line())
    name = torch.cuda.get_device_name(0)
    print(f"device: {name} x{torch.cuda.device_count()} torch "
          f"{torch.__version__} cuda {torch.version.cuda}")
    t0 = time.perf_counter()
    fa.build()
    print(f"build: flash_fwd in {time.perf_counter() - t0:.2f} s")
    log = _build.library_path("flash_fwd", fa._SOURCES).with_suffix(".log")
    if log.exists():
        print(log.read_text().strip())

    gen = torch.Generator(device="cuda").manual_seed(0)
    max_abs_err, inputs = kernel_phase(torch, fa, gen)
    torch.cuda.synchronize()
    times = timing_phase(torch, fa, inputs)
    del inputs
    launches = serve_phase(torch, np, fa, gen)

    print(card_line())
    print(json.dumps({"kernels": [{
        "name": "flash_attention_fwd",
        "route": "cuda",
        "source": "src/repro_torch/kernels/flash_attention/csrc/flash_fwd.cu",
        "replaces": "src/repro/kernels/flash_attention/kernel.py:78",
        "launches": launches,
        "max_abs_err": max_abs_err,
        **times,
    }]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
