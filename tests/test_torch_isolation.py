"""The port stands alone: no ``jax``, no ``repro``, no silent CPU.

Every module of ``repro_torch`` and ``chip_smoke.py`` must import in a
process where ``jax`` and ``repro`` / ``repro.*`` cannot be imported (the
GPU machine has no JAX); and an entry point given no device must raise
when CUDA is absent rather than run on the CPU.
"""

import os
import shutil
import subprocess
import sys
from pathlib import Path

import pytest
import torch

REPO = Path(__file__).resolve().parent.parent

_BLOCKED_SCRIPT = r"""
import importlib, pkgutil, sys

class _Block:
    def find_spec(self, name, path=None, target=None):
        top = name.split(".")[0]
        if top in ("jax", "jaxlib", "repro"):
            raise ImportError(f"{name} blocked: the port must not import it")
        return None

sys.meta_path.insert(0, _Block())

import repro_torch
names = [m.name for m in pkgutil.walk_packages(repro_torch.__path__,
                                               "repro_torch.")]
for name in names:
    importlib.import_module(name)
sys.path.insert(0, sys.argv[1])
import chip_smoke
assert callable(chip_smoke.main)
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "repro"))
assert not bad, bad
print(" ".join(names))
"""


def _env():
    env = dict(os.environ)
    env["PYTHONPATH"] = str(REPO / "src") + (
        os.pathsep + env["PYTHONPATH"] if env.get("PYTHONPATH") else "")
    return env


def test_port_and_chip_smoke_import_with_jax_and_repro_blocked():
    proc = subprocess.run([sys.executable, "-c", _BLOCKED_SCRIPT, str(REPO)],
                          cwd=REPO, env=_env(), capture_output=True,
                          text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    names = proc.stdout.split()
    assert len(names) >= 50                     # every module was imported
    for name in ("repro_torch.models.moe", "repro_torch.kernels.moe_gmm",
                 "repro_torch.kernels.moe_gmm.ops",
                 "repro_torch.kernels.moe_gmm.ref",
                 "repro_torch.configs.granite_moe_1b_a400m",
                 "repro_torch.configs.mixtral_8x7b",
                 "repro_torch.models.mamba2",
                 "repro_torch.kernels.mamba2_ssd",
                 "repro_torch.kernels.mamba2_ssd.ops",
                 "repro_torch.kernels.mamba2_ssd.ref",
                 "repro_torch.configs.zamba2_2_7b",
                 "repro_torch.core.atomics", "repro_torch.core.waiting",
                 "repro_torch.core.locks", "repro_torch.core.gcr",
                 "repro_torch.optim", "repro_torch.optim.adamw",
                 "repro_torch.optim.schedules",
                 "repro_torch.data", "repro_torch.data.pipeline",
                 "repro_torch.checkpoint",
                 "repro_torch.checkpoint.manager", "repro_torch.steps",
                 "repro_torch.launch.train", "repro_torch.launch.dryrun",
                 "repro_torch.launch.cost_analysis",
                 "repro_torch.core.gcr_numa", "repro_torch.core.simulator",
                 "repro_torch.core.topology", "repro_torch.runtime",
                 "repro_torch.runtime.fault_tolerance",
                 "repro_torch.examples", "repro_torch.examples.serve_gcr",
                 "repro_torch.examples.train_100m",
                 *(f"repro_torch.examples.{m}" for m in (
                     "quickstart", "cluster_demo", "trace_demo",
                     "lock_bench")),
                 *(f"repro_torch.lint.{m}" for m in (
                     "cli", "contract", "findings", "impact", "pickle_lint",
                     "rules", "runner", "surface")),
                 "repro_torch.lint", "repro_torch.cluster",
                 *(f"repro_torch.cluster.{m}" for m in (
                     "controller", "faults", "fleet", "invariants", "obs",
                     "router", "signals", "telemetry", "topology",
                     "workload"))):
        assert name in names, name


_LINT_BLOCKED_SCRIPT = r"""
import runpy, sys

class _Block:
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in ("torch", "numpy", "jax", "jaxlib", "repro"):
            raise ImportError(f"{name} blocked: the linter is stdlib only")
        return None

sys.meta_path.insert(0, _Block())
sys.argv = ["repro_torch.lint", "--explain", "R101"]
runpy.run_module("repro_torch.lint", run_name="__main__", alter_sys=True)
"""


def test_lint_explain_runs_with_torch_numpy_jax_and_repro_blocked():
    """``python -m repro_torch.lint --explain R101`` on an interpreter that
    can import none of ``torch``, ``numpy``, ``jax`` or ``repro``."""
    proc = subprocess.run([sys.executable, "-c", _LINT_BLOCKED_SCRIPT],
                          cwd=REPO, env=_env(), capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.startswith("R101  (enforces DESIGN.md 3)")


def _no_cuda():
    if torch.cuda.is_available():
        pytest.skip("checks the behaviour without a CUDA device")


def test_entry_points_without_device_raise_when_cuda_is_absent():
    _no_cuda()
    from repro_torch import resolve_device
    from repro_torch.configs import get_smoke_config
    from repro_torch.launch import serve, train
    from repro_torch.models import Transformer, init_cache, init_params
    from repro_torch.serving.engine import TorchServeEngine
    from repro_torch.steps import init_train_state

    assert resolve_device("cpu") == torch.device("cpu")
    for arch in ("qwen3-0.6b", "granite-moe-1b-a400m", "zamba2-2.7b"):
        cfg = get_smoke_config(arch)
        for call in (lambda: resolve_device(),
                     lambda: init_cache(cfg, 1, 8),
                     lambda: Transformer(cfg),
                     lambda: init_params(cfg, torch.Generator()),
                     lambda: TorchServeEngine(cfg, None, 3, 32),
                     lambda: serve.main(["--arch", arch]),
                     lambda: init_train_state(cfg, torch.Generator()),
                     lambda: train.main(["--arch", arch, "--smoke"])):
            with pytest.raises(RuntimeError, match="CUDA"):
                call()


def test_chip_smoke_fails_without_cuda_or_outside_a_checkout(tmp_path):
    """Exits non-zero and prints no result line: here because there is no
    card, and alone in a directory because the port is missing."""
    _no_cuda()
    lone = tmp_path / "chip_smoke.py"
    shutil.copy(REPO / "chip_smoke.py", lone)
    for script, cwd in ((REPO / "chip_smoke.py", REPO), (lone, tmp_path)):
        proc = subprocess.run([sys.executable, str(script)], cwd=cwd,
                              capture_output=True, text=True, timeout=300)
        assert proc.returncode != 0
        assert '"ok"' not in proc.stdout
