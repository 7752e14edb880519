"""The port's fault-tolerance runtime and the two examples built on it.

``repro_torch.runtime`` is the reference's framework-free code, copied:
``HeartbeatMonitor``, ``StragglerMitigator`` and ``plan_elastic_mesh``
must give the reference's answers on the same inputs.  The examples run
on the CPU here (``--device cpu``) and must raise without ``--device``
where there is no card; on the card ``chip_smoke.py`` runs
``train_100m`` at full size.
"""

import dataclasses
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import repro.runtime as ref_rt
import repro_torch.runtime as port_rt

REPO = Path(__file__).resolve().parent.parent


def test_heartbeat_monitor_equals_reference():
    def drive(rt):
        t = [0.0]
        mon = rt.HeartbeatMonitor(list(range(6)), timeout_s=10,
                                  clock=lambda: t[0])
        rng = np.random.default_rng(4)
        plans = []
        for step in range(40):
            t[0] += float(rng.uniform(0.5, 4.0))
            for w in list(mon.last_seen):
                if rng.random() < (0.2 if w in (2, 5) else 0.9):
                    mon.beat(w)
            plans.append(dataclasses.asdict(mon.plan(latest_ckpt_step=step)))
        return plans, sorted(mon.last_seen)

    got = drive(port_rt)
    assert got == drive(ref_rt)
    assert any(p["action"] == "restart_from_checkpoint" for p in got[0])


def test_straggler_mitigator_equals_reference():
    def drive(rt):
        mit = rt.StragglerMitigator(list(range(8)), spares=[90, 91, 92],
                                    threshold=1.4, patience=2, ewma=0.3)
        rng = np.random.default_rng(5)
        swaps = []
        for _ in range(60):
            times = {w: float(rng.uniform(0.9, 1.1)) * (3.0 if w % 3 == 1
                                                        else 1.0)
                     for w in range(8)}
            swaps.append(mit.observe(times))
        return swaps, mit.active, mit.spares, mit.demoted, mit.strikes

    got = drive(port_rt)
    assert got == drive(ref_rt)
    assert got[3] and not got[2]          # stragglers demoted, spares used


def test_elastic_mesh_plan_equals_reference():
    for chips in (16, 17, 100, 240, 256, 511, 512):
        for mp in (1, 4, 8, 16):
            got = port_rt.plan_elastic_mesh(chips, model_parallel=mp)
            assert dataclasses.asdict(got) == dataclasses.asdict(
                ref_rt.plan_elastic_mesh(chips, model_parallel=mp))
            assert got.mesh_shape == (chips // mp, mp)
    with pytest.raises(ValueError):
        port_rt.plan_elastic_mesh(8, model_parallel=16)


def _run_example(name, *args, tmp):
    env = dict(os.environ)
    env["PYTHONPATH"] = str(REPO / "src") + (
        os.pathsep + env["PYTHONPATH"] if env.get("PYTHONPATH") else "")
    env["TMPDIR"] = str(tmp)
    proc = subprocess.run(
        [sys.executable, "-m", f"repro_torch.examples.{name}", *args],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    return proc.stdout


def test_train_100m_small_on_cpu_resumes_and_learns(tmp_path):
    out = _run_example("train_100m", "--small", "--device", "cpu",
                       "--steps", "8", "--ckpt-dir", str(tmp_path / "ckpt"),
                       tmp=tmp_path)
    steps = [line.split() for line in out.splitlines()
             if line.startswith("step ")]
    assert [int(s[1]) for s in steps] == list(range(1, 9))
    # the CPU runs the plain attention: no kernel launch, no device peak
    assert all(s[8] == "n/a" and s[s.index("flash") + 1] == "0"
               for s in steps)
    assert "resumed at next_batch 4" in out
    assert out.index("simulated failure at step 4") < \
        out.index("resumed at next_batch 4") < out.index("step    5")
    done = [line for line in out.splitlines() if line.startswith("done:")]
    assert len(done) == 1
    before, after = (float(x) for x in
                     done[0].split("held batch ")[1].split(";")[0]
                     .split(" -> "))
    assert after < before
    assert sorted(p.name for p in (tmp_path / "ckpt").iterdir()
                  if p.name.startswith("step_"))


def test_serve_gcr_on_cpu(tmp_path):
    out = _run_example("serve_gcr", "--device", "cpu", tmp=tmp_path)
    assert "fast admits: 8, parked: 2" in out
    rows = [line.split() for line in out.splitlines()
            if line.strip()[:1].isdigit()]
    assert [int(r[0]) for r in rows] == [256, 1024, 4096]
    tok = {int(r[0]): [float(x.replace(",", "")) for x in r[1:]]
           for r in rows}
    for n in (1024, 4096):                   # none < gcr, none < gcr_pod
        assert tok[n][0] < tok[n][1] and tok[n][0] < tok[n][2]


def test_examples_and_sim_launcher_without_device(capsys):
    """No ``--device`` means the card: without one the examples and the
    launcher's real-model mode raise; its virtual-time modes need none."""
    if torch.cuda.is_available():
        pytest.skip("checks the behaviour without a CUDA device")
    from repro_torch.examples import serve_gcr, train_100m
    from repro_torch.launch import serve

    for call in (lambda: serve_gcr.main([]),
                 lambda: train_100m.main(["--small", "--steps", "2"]),
                 lambda: serve.main([])):
        with pytest.raises(RuntimeError, match="CUDA"):
            call()
    serve.main(["--cluster", "--duration-ms", "500"])
    assert capsys.readouterr().out.startswith("router=gcr_aware")
