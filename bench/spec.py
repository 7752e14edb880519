"""The benchmark's data: ``BENCHMARK.json`` at the root of the checkout
and the files it names under ``bench/``, found by name.

A configuration is ``configs/<name>.json``: the model as it is run, in
the published ``config.json``'s key names, with its source, what was
changed from it, what was assumed, the deployment it stands for, the
program's name for it and sizes for the CPU rehearsal (``smoke``).  A
traffic mix is ``traffic/<name>.json``.  The correctness check of a
cell, its sample and limits, is ``checks/<workload>.json``.  A per-layer
metric is ``metrics/<name>.py``.  Adding a cell, a configuration or a
metric adds files and entries only.
"""

from __future__ import annotations

import json
from pathlib import Path

BENCH_DIR = Path(__file__).resolve().parent
ROOT = BENCH_DIR.parent


def _load(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def benchmark() -> dict:
    return _load(ROOT / "BENCHMARK.json")


def workload(bench: dict, name: str) -> dict:
    for cell in bench["workloads"]:
        if cell["name"] == name:
            return cell
    raise KeyError(f"no workload {name!r} in BENCHMARK.json; have "
                   f"{[c['name'] for c in bench['workloads']]}")


def config_file(bench: dict, name: str) -> dict:
    for cfg in bench["configs"]:
        if cfg["name"] == name:
            return _load(ROOT / cfg["file"])
    raise KeyError(f"no configuration {name!r} in BENCHMARK.json")


def traffic(name: str) -> dict:
    return _load(BENCH_DIR / "traffic" / f"{name}.json")


def check(workload_name: str) -> dict:
    return _load(BENCH_DIR / "checks" / f"{workload_name}.json")


def metrics_for(bench: dict, workload_name: str, trace: bool) -> list:
    """The metrics a run of this cell reports: the end-to-end ones with
    ``--trace 0``, the per-layer ones with ``--trace 1``, each where its
    ``workloads`` list (if any) names the cell."""
    group = bench["per_layer"] if trace else bench["end_to_end"]
    return [m for m in group
            if workload_name in m.get("workloads", [workload_name])]


def sized(entry: dict, smoke: bool) -> dict:
    """A configuration or traffic file's values, with its ``smoke``
    sizes laid over them for the CPU rehearsal."""
    out = {k: v for k, v in entry.items() if k != "smoke"}
    if smoke:
        out.update(entry.get("smoke", {}))
    return out


def model_spec(cfg: dict) -> dict:
    """The widths the benchmark's own code (the reference, the FLOP and
    byte counts) works from, read from a configuration's published keys."""
    d, heads = cfg["hidden_size"], cfg["num_attention_heads"]
    experts = cfg.get("num_local_experts", 0)
    return {
        "n_layers": cfg["num_hidden_layers"],
        "d_model": d,
        "n_heads": heads,
        "n_kv_heads": cfg["num_key_value_heads"],
        "head_dim": cfg.get("head_dim") or d // heads,
        "d_ff": 0 if experts else cfg["intermediate_size"],
        "n_experts": experts,
        "top_k": cfg.get("num_experts_per_tok", 0),
        "expert_d_ff": cfg["intermediate_size"] if experts else 0,
        "capacity_factor": cfg.get("moe_capacity_factor", 0.0),
        "vocab_size": cfg["vocab_size"],
        "window": cfg.get("sliding_window") or 0,
        "rope_theta": float(cfg["rope_theta"]),
        "norm_eps": float(cfg["rms_norm_eps"]),
        "dtype": cfg["torch_dtype"],
    }
