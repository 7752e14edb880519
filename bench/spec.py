"""The benchmark's data: ``BENCHMARK.json`` at the root of the checkout
and the files it names under ``bench/``, found by name.

A configuration is ``configs/<name>.json``: the model as it is run, in
the published ``config.json``'s key names, with its source, what was
changed from it, what was assumed, the deployment it stands for, the
program's name for it (``program_arch``), sizes for the CPU rehearsal
(``smoke``) and its ``reference``: the path, from the checkout's root, of
the Python file that carries everything about the architecture that the
benchmark needs.  The harness and ``control.py`` load that file by path
(``reference``) and ask it, never a fixed module, for

- ``spec(cfg_file) -> dict``: the widths the benchmark works from, read
  from the file's published keys, with at least ``n_layers`` and
  ``vocab_size``;
- ``check_program(spec, cfg) -> dict``: the port's ``ModelConfig``
  against those widths, block kinds included; {name: (benchmark, port)}
  of every mismatch, empty where there is none;
- ``Weights(weights, fp8=False)`` and ``logits(spec, W, tokens, groups,
  at)``: the float32 reference over the benchmark's weight tensors seen
  through ``Weights``, and with ``fp8`` the control, through the same
  function;
- ``model_flops(spec, B, S, start)``: ``mfu``'s yardstick.

The weights' laws follow from each leaf's shape alone (``weights``).

A reference imports nothing of the port.  A traffic mix is
``traffic/<name>.json``.  The correctness check of a cell, its sample and
limits, is ``checks/<workload>.json``.  A per-layer metric is
``metrics/<name>.py``; a quantity split by the
end-to-end metric its cells report (``decode_step_ms.chat``) reads with
the reader of the part before the first dot.  Adding a cell, a configuration or a metric adds
files and entries only.
"""

from __future__ import annotations

import importlib.util
import json
import sys
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


def load_module(path: Path):
    """The Python file at ``path`` as a module of its own, found by path
    (a metric's reader, a configuration's reference)."""
    name = f"bench_file_{path.stem.replace('-', '_')}_{len(sys.modules)}"
    mod_spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(mod_spec)
    sys.modules[name] = mod
    mod_spec.loader.exec_module(mod)
    return mod


def reference(cfg_file: dict):
    """The module that a configuration's ``reference`` key names."""
    return load_module(ROOT / cfg_file["reference"])


def traffic(name: str) -> dict:
    return _load(BENCH_DIR / "traffic" / f"{name}.json")


def check(workload_name: str) -> dict:
    return _load(BENCH_DIR / "checks" / f"{workload_name}.json")


def metrics_for(bench: dict, workload_name: str, trace: bool) -> list:
    """The metrics a run of this cell reports: with ``--trace 0`` the
    end-to-end ones whose ``workloads`` list (if any) names the cell;
    with ``--trace 1`` the per-layer ones whose list names it or, where a
    metric has no list, whose ``moves`` is one of the cell's end-to-end
    metrics."""
    def listed(m):
        return workload_name in m.get("workloads", [workload_name])

    e2e = [m for m in bench["end_to_end"] if listed(m)]
    if not trace:
        return e2e
    moved = {m["name"] for m in e2e}
    return [m for m in bench["per_layer"]
            if (listed(m) if "workloads" in m else m["moves"] in moved)]


def sized(entry: dict, smoke: bool) -> dict:
    """A configuration or traffic file's values, with its ``smoke``
    sizes laid over them for the CPU rehearsal."""
    out = {k: v for k, v in entry.items() if k != "smoke"}
    if smoke:
        out.update(entry.get("smoke", {}))
    return out


def model_spec(cfg: dict) -> dict:
    """The widths the benchmark's own code (the reference, the FLOP and
    byte counts) works from, read from the published keys of a
    configuration in Mixtral's key names: ``decoder``'s ``spec``."""
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
