"""A rehearsal of ``bench/run.py`` on the CPU at the files' smoke sizes,
each in a fresh process, skipping only the look for a card: every cell
of ``BENCHMARK.json`` runs its window and its check, and its last line
holds the contract's keys with ``checks`` last; a traced run reports the
cell's per-layer metrics that a CPU run can read.  Then the ways a run
must fail: no card, no program beside the benchmark, a JAX module
loaded."""

import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

from bench import spec

ROOT = Path(__file__).resolve().parents[2]
BENCHMARK = json.loads((ROOT / "BENCHMARK.json").read_text())
CELLS = [c["name"] for c in BENCHMARK["workloads"]]

DRIVER = r"""
import sys
sys.path[:0] = [sys.argv[1] + "/bench", sys.argv[1] + "/src"]
exec(sys.argv[2])
import run
sys.exit(run.main(sys.argv[3:], device="cpu", smoke=True))
"""


def rehearse(workload, seed=2**31 + 7, trace=0, plant="", cwd=ROOT):
    """Runs one smoke run in a fresh process with ``plant`` executed
    first; returns (exit code, last stdout line as an object or None,
    stderr)."""
    args = ["--workload", workload, "--seed", str(seed), "--seconds",
            "0.2", "--trace", str(trace)]
    env = dict(os.environ, PYTHONPATH="")
    proc = subprocess.run([sys.executable, "-c", DRIVER, str(cwd), plant,
                           *args], cwd=cwd, env=env, capture_output=True,
                          text=True, timeout=240)
    lines = proc.stdout.strip().splitlines()
    last = json.loads(lines[-1]) if lines and lines[-1].startswith("{") \
        else None
    return proc.returncode, last, proc.stderr


@pytest.mark.parametrize("workload", CELLS)
def test_rehearsal_prints_the_contract_line(workload):
    rc, last, err = rehearse(workload)
    assert rc == 0, err
    assert list(last) == ["correct", "attempted", "failed", "metrics",
                          "device", "checks"]
    assert last["correct"] is True and last["failed"] == 0
    assert last["attempted"] > 0
    # the CPU has no device trace: a rate read from it is silent
    want = {m["name"] for m in spec.metrics_for(BENCHMARK, workload, False)
            if m["source"] != "device_trace"}
    assert set(last["metrics"]) == want
    for m in last["metrics"].values():
        assert m["value"] > 0 and m["unit"]
    assert {"platform", "kind", "count", "memory_peak_bytes"} <= \
        set(last["device"])
    tail = err.strip().splitlines()[-len(last["checks"]):]
    for line, (name, c) in zip(tail, last["checks"].items()):
        assert line == f"check {name} {c['value']!r} limit {c['limit']!r}"


def test_traced_rehearsal_reports_the_per_layer_metrics():
    workload = "mixtral-8x7b-16L.chat"
    rc, last, err = rehearse(workload, trace=1)
    assert rc == 0, err
    assert list(last)[-2:] == ["breakdown", "checks"]
    named = {m["name"] for m in spec.metrics_for(BENCHMARK, workload, True)}
    # the CPU has no device trace: the readers of device time are silent
    silent = {"flash_roofline", "gmm_roofline", "device_idle", "peak_mem_gb"}
    assert set(last["metrics"]) == {n for n in named
                                    if n.split(".")[0] not in silent}
    assert {"busy_s", "window_s"} <= set(last["device"])


def test_run_without_a_card_prints_no_result():
    proc = subprocess.run(
        [sys.executable, "bench/run.py", "--workload", CELLS[0], "--seed",
         "1", "--seconds", "1", "--trace", "0"], cwd=ROOT,
        capture_output=True, text=True, timeout=120,
        env=dict(os.environ, PYTHONPATH=""))
    assert proc.returncode != 0 and proc.stdout == ""


def test_benchmark_alone_without_the_program_fails(tmp_path):
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(ROOT / "bench", tmp_path / "bench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    rc, last, err = rehearse(CELLS[0], cwd=tmp_path)
    assert rc != 0 and last is None
    assert "repro_torch" in err


def test_a_loaded_jax_module_fails_the_run():
    plant = "import types; sys.modules['jax'] = types.ModuleType('jax')"
    rc, last, err = rehearse(CELLS[0], plant=plant)
    assert rc != 0 and last is None
    assert "jax" in err
