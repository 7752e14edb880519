"""One run of one cell: set-up, the measured window, the traced job
(``--trace 1``), the correctness check, and the result line.

The system under test is ``repro_torch.serving.engine.TorchServeEngine``
with GCR admission, serving bf16 weights that ``weights`` made on the
card from the seed.  A job is one ``generate`` call over a traffic mix's
prompts; jobs run back to back from the window's start, and the window
ends with the first job that ends at or after ``--seconds``.  A cell
whose end-to-end rate is ``device_tokens_per_s`` (the window's output
tokens over the seconds in which an operation ran on the card) runs
each job of its window under a profiler of the card alone; that cell's
``tokens_per_s`` is read in its traced run, whose window is profiled
not at all.

Everything about the model's architecture comes from the module that
the configuration's ``reference`` key names (``spec.reference``; its
contract is in ``spec``'s docstring): the widths (``spec``), the check
of the port's configuration (``check_program``), the float32 reference
and its control (``Weights``, ``logits``) and ``mfu``'s FLOPs
(``model_flops``).  This module names no architecture.
"""

from __future__ import annotations

import dataclasses
import gc
import json
import subprocess
import sys
from types import SimpleNamespace

import numpy as np
import torch

from . import spec as S
from . import timing, traffic, weights

BANNED = ("jax", "jaxlib", "flax", "repro")
WARMUP_STEPS = 4          # decode steps after the warm-up's prefill


class BenchError(RuntimeError):
    pass


def program_config(ref, cfg_file: dict, spec: dict, smoke: bool):
    """The port's configuration of the file's ``program_arch`` cut to the
    benchmark's depth, checked by the reference module ``ref``
    (``check_program``) against the benchmark's widths."""
    from repro_torch import configs

    arch = cfg_file["program_arch"]
    cfg = (configs.get_smoke_config if smoke else configs.get_config)(arch)
    cfg = dataclasses.replace(cfg, n_layers=spec["n_layers"])
    bad = ref.check_program(spec, cfg)
    if bad:
        raise BenchError(f"{arch}: the port's config differs from the "
                         f"benchmark's (benchmark, port): {bad}")
    return cfg


def power_limit_w():
    try:
        proc = subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit",
             "--format=csv,noheader,nounits"], capture_output=True,
            text=True, timeout=30)
        return float(proc.stdout.split()[0])
    except (OSError, ValueError, IndexError, subprocess.TimeoutExpired):
        return None


def _load_reader(name: str):
    """``metrics/<name>.py``'s ``read``; for a quantity split by cell
    (``decode_step_ms.chat``), the reader of the part before the dot."""
    path = S.BENCH_DIR / "metrics" / f"{name}.py"
    if not path.exists():
        path = path.with_name(f"{name.split('.')[0]}.py")
    return S.load_module(path).read


def run_job(eng, prompts, gen_len, device, busy):
    """One ``generate`` call; where ``busy`` is a list, under a profiler
    of the card's operations alone, with the seconds in which an
    operation ran on the card appended to it.  A profile a job, so that
    none outgrows the profiler's buffers."""
    if busy is None:
        return eng.generate(prompts, gen_len)
    trace = timing.DeviceTrace()
    with trace.profile(device, host=False) as prof:
        out = eng.generate(prompts, gen_len)
        timing.sync(device)
    trace.read(prof)
    busy.append(trace.busy_s)
    return out


class Recorders:
    """Records, around one job, each flash call's shapes and each expert
    product's rows that hold a token and experts held, by wrapping the
    kernels' names wherever a loaded ``repro_torch.models`` module binds
    them (the port's own counters are not read).  A name the program no
    longer binds is left alone, and the metric that reads it stays
    silent."""

    NAMES = ("flash_attention_fwd", "grouped_matmul", "_dispatch")

    def __init__(self) -> None:
        import repro_torch.models  # noqa: F401  (loads the model modules)

        self.bound = [(mod, n, vars(mod)[n])
                      for m, mod in sorted(sys.modules.items())
                      if m == "repro_torch.models"
                      or m.startswith("repro_torch.models.")
                      for n in self.NAMES if callable(vars(mod).get(n))]
        self.flash, self.dispatches, self.gmm = [], [], []

    def _flash(self, flash):
        def rec_flash(q, k, v, q_pos, k_pos, *, window=0, causal=True,
                      **kw):
            B, S_, Hq, D = q.shape
            self.flash.append((B, S_, k.shape[1], Hq, k.shape[2], D,
                               v.shape[-1], window, causal,
                               q.element_size()))
            return flash(q, k, v, q_pos, k_pos, window=window,
                         causal=causal, **kw)
        return rec_flash

    def _dispatch(self, dispatch):
        def rec_dispatch(*args):
            out = dispatch(*args)
            # (expert_in, gates, combine index, logits, probs, expert_idx,
            # admitted); anything else is not read
            known = (isinstance(out, tuple) and len(out) == 7
                     and out[6].dtype == torch.bool
                     and out[5].shape == out[6].shape)
            self.dispatches.append(out[5:7] if known else None)
            return out
        return rec_dispatch

    def _grouped_matmul(self, gmm):
        def rec_gmm(x, w, **kw):
            self.gmm.append((len(self.dispatches) - 1, w.shape[1],
                             w.shape[2], x.element_size()))
            return gmm(x, w, **kw)
        return rec_gmm

    def __enter__(self):
        wrap = {"flash_attention_fwd": self._flash,
                "grouped_matmul": self._grouped_matmul,
                "_dispatch": self._dispatch}
        for mod, n, fn in self.bound:
            setattr(mod, n, wrap[n](fn))
        return self

    def __exit__(self, *exc):
        for mod, n, fn in self.bound:
            setattr(mod, n, fn)
        return False

    def gmm_calls(self) -> list:
        """(rows holding a token, experts held, D, F, itemsize) a call;
        none where a call's routing was not recorded."""
        if any(d is None for d in self.dispatches) or \
                any(i < 0 for i, *_ in self.gmm):
            return []
        held = [(int(admitted.sum()), int(torch.unique(experts[admitted])
                                          .numel()))
                for experts, admitted in self.dispatches]
        return [held[i] + (D, F, size) for i, D, F, size in self.gmm]


def run_cell(ns, *, device: torch.device, t_start: float,
             smoke: bool = False) -> dict:
    """Runs the cell ``ns.workload`` once; returns the result line's
    object.  ``smoke`` takes the files' CPU-rehearsal sizes."""
    from repro_torch.kernels.flash_attention import ops as flash_ops
    from repro_torch.kernels.moe_gmm import ops as gmm_ops
    from repro_torch.serving.engine import TorchServeEngine

    bench = S.benchmark()
    cell = S.workload(bench, ns.workload)
    cfg_file = S.sized(S.config_file(bench, cell["config"]), smoke)
    mix = S.sized(S.traffic(cell["traffic"]), smoke)
    chk = S.check(ns.workload)
    ref = S.reference(cfg_file)
    spec = ref.spec(cfg_file)
    cfg = program_config(ref, cfg_file, spec, smoke)
    wanted = S.metrics_for(bench, ns.workload, bool(ns.trace))
    cuda = device.type == "cuda"
    power = power_limit_w() if cuda else None
    vocab, seed = spec["vocab_size"], ns.seed
    slots, gen_len = mix["slots"], mix["gen_len"]

    # --- set-up: weights, engine, warm-up of every shape the mix uses ---
    t_w = timing.now()
    W = weights.make(cfg, seed, device)
    params = weights.to_program(cfg, W)
    t_w = timing.synced_now(device) - t_w

    def engine():
        return TorchServeEngine(cfg, params, n_slots=slots,
                                max_len=mix["prompt_len"] + gen_len,
                                admission_kind="gcr", device=device)

    # a cell whose end-to-end rate is the card's profiles each job of the
    # window (``run_job``), and its warm-up, which starts the profiler
    busy = [] if any(m["name"] == "device_tokens_per_s"
                     for m in wanted) else None
    t_warm = timing.now()
    run_job(engine(), traffic.warmup_prompts(mix, vocab, seed), WARMUP_STEPS,
            device, None if busy is None else [])
    t_warm = timing.synced_now(device) - t_warm
    eng = engine()
    spans = timing.Spans(device)
    if ns.trace and hasattr(eng, "_prefill") and hasattr(eng, "_decode"):
        eng._prefill = spans.wrap("prefill", eng._prefill,
                                  lambda p, b: tuple(b["tokens"].shape))
        eng._decode = spans.wrap("decode", eng._decode,
                                 lambda p, c, t: (t.shape[0], c["pos"]))
    if cuda:
        torch.cuda.reset_peak_memory_stats(device)
    launches0 = (flash_ops.launches, gmm_ops.launches)
    t0 = timing.synced_now(device)
    setup_s = t0 - t_start

    # --- the window: whole jobs, back to back ---
    jobs = []
    while True:
        prompts = traffic.job_prompts(mix, vocab, seed, len(jobs))
        jobs.append((prompts, run_job(eng, prompts, gen_len, device, busy)))
        t1 = timing.synced_now(device)
        if t1 - t0 >= ns.seconds:
            break
    window_s = t1 - t0
    window_peak = torch.cuda.max_memory_allocated(device) if cuda else 0
    launches = {"flash": flash_ops.launches - launches0[0],
                "gmm": gmm_ops.launches - launches0[1]}
    admission = {k: getattr(getattr(eng, "admission", None), k, None)
                 for k in ("stat_fast", "stat_parked")}

    # --- the traced job, after the window, whose times it leaves alone ---
    trace = rec = None
    if ns.trace:
        eng = engine()
        trace = timing.DeviceTrace()
        with Recorders() as rec, trace.profile(device) as prof:
            with torch.profiler.record_function(trace.label):
                eng.generate(traffic.job_prompts(mix, vocab, seed,
                                                 len(jobs)), gen_len)
                timing.sync(device)
        t_read = timing.now()
        trace.read(prof)
        t_read = timing.now() - t_read
    memory_peak = torch.cuda.max_memory_allocated(device) if cuda else 0

    # --- the program's state freed; the check against the reference ---
    del eng, params
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    t_ref = timing.now()
    numbers, attempted, failed = check_outputs(ref, spec, W, mix, jobs,
                                               chk, seed, device)
    t_ref = timing.synced_now(device) - t_ref
    limits = chk["limits"]
    checks = {k: {"value": numbers[k], "limit": limits[k]} for k in limits}
    correct = failed == 0 and all(c["value"] <= c["limit"]
                                  for c in checks.values())

    tokens = len(jobs) * mix["streams"] * gen_len
    info = {"jobs": len(jobs), "window_s": window_s, "tokens": tokens,
            "admission": admission, "launches": launches,
            "numbers": numbers, "busy_s": busy, "weights_s": t_w,
            "warmup_s": t_warm, "reference_s": t_ref}
    if ns.trace:
        record = SimpleNamespace(
            spec=spec, model_flops=ref.model_flops, spans=spans.items,
            window_s=window_s, tokens=tokens,
            window_peak_bytes=window_peak, trace=trace,
            flash_calls=rec.flash, gmm_calls=rec.gmm_calls())
        values = {m["name"]: _load_reader(m["name"])(record)
                  for m in wanted}
        info["trace_events"] = (len(trace.device_ops), len(trace.host_ops))
        info["trace_read_s"] = t_read
    else:
        values = {"setup_s": setup_s, "tokens_per_s": tokens / window_s}
        if busy and sum(busy) > 0:
            values["device_tokens_per_s"] = tokens / sum(busy)
    metrics = {m["name"]: {"value": values[m["name"]], "unit": m["unit"]}
               for m in wanted if values.get(m["name"]) is not None}

    dev = {"platform": "gpu" if cuda else device.type,
           "kind": torch.cuda.get_device_name(device) if cuda else "cpu",
           "count": 1, "memory_peak_bytes": memory_peak,
           "power_limit_w": power}
    result = {"correct": correct, "attempted": attempted, "failed": failed,
              "metrics": metrics, "device": dev}
    if trace is not None:
        dev["busy_s"], dev["window_s"] = trace.busy_s, trace.wall_s
        result["breakdown"] = {"device_ops": trace.top_device_ops(),
                               "idle_gaps": trace.idle_gaps()}
    result["checks"] = checks
    print("info " + json.dumps(info), flush=True)
    return result


def check_outputs(ref, spec, W, mix, jobs, chk, seed, device):
    """The served tokens of a sample of the window's streams, drawn from
    the seed, judged by the float32 reference over each prompt and its
    served tokens.  Returns ({number: value}, streams attempted, streams
    failed)."""
    vocab = spec["vocab_size"]
    attempted, failed = len(jobs) * mix["streams"], 0
    for _, out in jobs:
        if out.shape != (mix["streams"], mix["gen_len"]):
            failed += mix["streams"]
        else:
            failed += int(((out < 0) | (out >= vocab)).any(axis=1).sum())
    seqs, served = sampled(mix, jobs, chk, seed)
    logits = reference_logits(ref, spec, W, mix, seqs, device)
    return gap_numbers(logits, served), attempted, failed


def sampled(mix, jobs, chk, seed):
    """(sequences (N, prompt_len + gen_len - 1), served tokens (N,
    gen_len)) of the sampled streams, as int64 arrays."""
    picks = traffic.sample(seed, len(jobs), mix["streams"],
                           chk["sample_streams"])
    served = np.stack([jobs[j][1][s] for j, s in picks]).astype(np.int64)
    seqs = np.stack([np.concatenate([jobs[j][0][s], jobs[j][1][s][:-1]])
                     for j, s in picks]).astype(np.int64)
    return seqs, served


def reference_logits(ref, spec, W, mix, seqs, device, fp8: bool = False):
    """The reference module ``ref``'s logits (N, gen_len, vocab) at the
    positions whose tokens were served; with ``fp8``, the control's."""
    P, G = mix["prompt_len"], mix["gen_len"]
    return ref.logits(spec, ref.Weights(W, fp8=fp8),
                          torch.as_tensor(seqs, device=device),
                          [P] + [1] * (G - 1), list(range(P - 1, P + G - 1)))


def gap_numbers(ref: torch.Tensor, tokens) -> dict:
    """A token's gap is how far its reference logit lies below the
    reference's best at its position.  ``gap_max`` is the widest over the
    tokens, ``gap_mean`` their mean; ``mismatch`` the share of tokens
    that are not the reference's first."""
    tok = torch.as_tensor(tokens).to(ref.device).clamp(0, ref.shape[-1] - 1)
    best = ref.max(-1)
    gaps = best.values - ref.gather(-1, tok[..., None])[..., 0]
    return {"gap_max": float(gaps.max()), "gap_mean": float(gaps.mean()),
            "mismatch": float((best.indices != tok).float().mean()),
            "tokens_compared": int(gaps.numel())}


def banned_modules() -> list:
    return sorted(m for m in sys.modules if m.split(".")[0] in BANNED)
