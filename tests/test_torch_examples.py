"""The port's ``quickstart``, ``cluster_demo``, ``trace_demo`` and
``lock_bench`` examples against the reference's ``examples/``.

Under the reference's constants (``patch_ref_constants``) and with the
reference's settings patched into the port's module-level values, each
virtual-time example prints the reference's lines exactly (the output
directory aside) and writes byte-equal trace files.  Under the port's own
H100 defaults each runs to its end with every claim of the reference's
docstring and every ``assert`` holding.  Each example runs once a side,
in module-scoped fixtures.
"""

import contextlib
import dataclasses
import importlib.util
import io
import re
import sys
from pathlib import Path

import pytest
from test_torch_sim_serving import patch_ref_constants

from repro_torch.examples import (cluster_demo, lock_bench, quickstart,
                                  trace_demo)
from repro_torch.serving.engine import PREFILL_MS_PER_TOK, StepCostModel

REPO = Path(__file__).resolve().parent.parent

# the reference examples' virtual-time settings and prefill charge, under
# the port's names (``examples/cluster_demo.py``, ``trace_demo.py``)
REF_SETTINGS = {
    "quickstart": {},
    "cluster_demo": {
        "WINDOW_MS": 4_000.0, "MAX_MS": 120_000.0,
        "STALENESS_MS": (0.0, 120.0, 500.0), "JITTER_MS": 20.0,
        "DIURNAL_MS": 16_000.0, "COOLDOWN_IN_MS": 800.0,
        "LEAD_MS": 4_000.0, "THINK_MS": 1_500.0, "PREFILL_MS": 0.05,
    },
    "trace_demo": {
        "WINDOW_MS": 250.0, "MAX_MS": 60_000.0,
        "SMOKE": (2, 32, 2_000.0), "FULL": (4, 32, 4_000.0),
        "STALENESS_MS": 60.0, "JITTER_MS": 5.0,
        "HEALTH_STALE_MS": 150.0, "HEDGE_DELAY_MS": 500.0,
    },
}
ARGS = {"quickstart": [], "cluster_demo": [],
        "trace_demo": ["--smoke", "--out", "OUT"]}
# imported here, before any test patches the constants their module-level
# settings derive from
PORT = {"quickstart": quickstart, "cluster_demo": cluster_demo,
        "trace_demo": trace_demo}
TAGS = ("blind", "gcr_aware", "faulted")
STREAMS = ("flight", "spans", "trace", "windows")


def _load_reference(name):
    spec = importlib.util.spec_from_file_location(
        f"_ref_example_{name}", REPO / "examples" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _reference_main(name):
    """The reference example's ``__main__`` body (``quickstart`` runs its
    two demos there and has no ``main``)."""
    mod = _load_reference(name)
    if name == "quickstart":
        return lambda: (mod.lock_demo(), mod.serving_demo())
    return mod.main


def _run(name, main, out_dir, mp, pass_argv):
    """stdout of ``main`` with ``OUT`` standing for ``out_dir``, and the
    bytes of every file it wrote there."""
    argv = [str(out_dir) if a == "OUT" else a for a in ARGS[name]]
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        if pass_argv:
            mp.setattr(sys, "argv", [name] + argv)
            main()
        elif argv:
            main(argv)
        else:
            main()
    files = {p.name: p.read_bytes() for p in sorted(out_dir.glob("*"))}
    return buf.getvalue().replace(str(out_dir), "OUT"), files


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    out = {}
    with pytest.MonkeyPatch.context() as mp:
        for name in ARGS:
            out[name] = _run(name, _reference_main(name),
                             tmp_path_factory.mktemp(f"ref_{name}"), mp,
                             pass_argv=True)
    return out


@pytest.fixture(scope="module")
def port_on_reference(tmp_path_factory):
    out = {}
    with pytest.MonkeyPatch.context() as mp:
        patch_ref_constants(mp)
        for name, settings in REF_SETTINGS.items():
            mod = PORT[name]
            for key, value in settings.items():
                mp.setattr(mod, key, value)
            out[name] = _run(name, mod.main,
                             tmp_path_factory.mktemp(f"port_ref_{name}"), mp,
                             pass_argv=False)
    return out


@pytest.fixture(scope="module")
def port_on_h100(tmp_path_factory):
    out = {}
    with pytest.MonkeyPatch.context() as mp:
        for name in ARGS:
            out[name] = _run(name, PORT[name].main,
                             tmp_path_factory.mktemp(f"port_h100_{name}"),
                             mp, pass_argv=False)
    return out


@pytest.mark.parametrize("name", list(ARGS))
def test_example_prints_the_reference_lines(name, reference,
                                            port_on_reference):
    want_out, want_files = reference[name]
    got_out, got_files = port_on_reference[name]
    assert got_out == want_out
    assert sorted(got_files) == sorted(want_files)
    for fname, data in want_files.items():
        assert got_files[fname] == data, fname
    if name == "trace_demo":
        assert sorted(want_files) == sorted(f"{tag}.{s}{ext}" for tag in TAGS
                                            for s, ext in zip(STREAMS, (
                                                ".jsonl", ".jsonl", ".json",
                                                ".csv")))


@pytest.mark.parametrize("name", ["cluster_demo", "trace_demo"])
def test_virtual_times_are_the_references_in_h100_steps(name):
    """Every setting that differs is the reference's times ``STEPS``, the
    H100 step of a full active set at the demo's limit over the
    reference's, rounded; the limits and fleet sizes are the
    reference's."""
    mod = PORT[name]
    ref = _load_reference(name)
    ref_step = 3.0 + 0.02 * mod.LIMIT
    assert mod.STEPS == round(StepCostModel().step_ms(mod.LIMIT, 0, 0.0)
                              / ref_step) == 12
    for key, value in REF_SETTINGS[name].items():
        if key == "PREFILL_MS":
            assert mod.PREFILL_MS == PREFILL_MS_PER_TOK
        elif isinstance(value, tuple) and name == "trace_demo":
            n_replicas, limit, window = value
            assert getattr(mod, key) == (n_replicas, limit,
                                         window * mod.STEPS)
        elif isinstance(value, tuple):
            assert getattr(mod, key) == tuple(v * mod.STEPS for v in value)
        else:
            assert getattr(mod, key) == value * mod.STEPS, key
    if name == "cluster_demo":
        assert (ref.N_REPLICAS, ref.LIMIT, ref.N_PODS) == (
            mod.N_REPLICAS, mod.LIMIT, mod.N_PODS)
        assert dataclasses.astuple(ref.SPEC) == dataclasses.astuple(mod.SPEC)
    else:
        assert ref.WINDOW_MS == REF_SETTINGS[name]["WINDOW_MS"]


def _fields(line):
    return dict(f.split("=", 1) for f in line.split() if "=" in f)


def _num(text):
    return float(text.replace(",", "").rstrip("%").removesuffix("ms"))


def test_quickstart_claims_hold_on_h100(port_on_h100):
    out = port_on_h100["quickstart"][0].splitlines()
    locks = {int(r.split()[0]): [float(x) for x in r.split()[1:]]
             for r in out[2:5]}
    # GCR survives oversubscription where the bare spin lock collapses
    assert locks[80][1] > 10 * locks[80][0]
    assert "GCR-wrapped pthread lock acquired and released: OK" in out
    rows = {line.split()[0].split("=")[1]: _fields(line)
            for line in out if line.strip().startswith("admission=")}
    assert set(rows) == {"none", "gcr", "gcr_pod"}
    # the serving-level collapse without admission, and GCR's escape
    assert rows["none"]["done"] == "0"
    for kind in ("gcr", "gcr_pod"):
        assert rows[kind]["done"] == "2048"
        assert _num(rows[kind]["tok/s"]) > 10 * _num(rows["none"]["tok/s"])


def test_cluster_demo_claims_hold_on_h100(port_on_h100):
    out = port_on_h100["cluster_demo"][0].splitlines()
    table = {tuple(line.split()[:2]): line.split()[2:]
             for line in out[3:9]}
    blind = _num(table[("round_robin", "none")][1])
    aware = _num(table[("gcr_aware", "gcr")][1])
    # restricting and steering which streams circulate holds goodput
    # where blind routing over unrestricted replicas collapses
    assert aware > 10 * blind
    scale = {line.split(":")[0].strip(): _fields(line) for line in out
             if line.strip().startswith(("queue-depth:", "slo-predict:"))}
    # the predictive controller scales out, back in, and migrates KV
    sc = scale["slo-predict"]
    assert int(sc["out"]) > 0 and int(sc["in"]) > 0
    assert int(sc["migrated"]) > 0
    chat = {line.split()[0]: line.split()[1:] for line in out[-3:]}
    # sticky routing lands turns where their prefix is cached
    assert _num(chat["affinity"][2]) > _num(chat["gcr_aware"][2])


def test_trace_demo_claims_hold_on_h100(port_on_h100):
    out, files = port_on_h100["trace_demo"]
    onsets = re.findall(r"^  onset: (.*)$", out, flags=re.M)
    # blind collapses, the restricted fleet holds (the example asserts
    # both; this reads them from its lines)
    assert onsets[0].startswith("window ")
    assert onsets[1].startswith("none")
    assert "collapse onset found for the blind fleet only" in out
    assert len(files) == len(TAGS) * len(STREAMS)
    flight = files["faulted.flight.jsonl"].decode()
    spans = files["faulted.spans.jsonl"].decode()
    for event in ('"eject"', '"restore"'):
        assert event in flight
    for event in ('"hedge"', '"cancel"'):
        assert event in spans


def test_lock_bench_runs_every_row():
    names = []
    for name, lock in lock_bench.rows():
        kops, unfair = lock_bench.bench(lock, 4, duration_s=0.05)
        assert kops > 0, name
        assert 0.5 <= unfair <= 1.0, name
        names.append(name)
    assert names == ["pthread", "ttas", "mcs_spin", "gcr(pthread)",
                     "gcr(ttas)", "gcr_numa(pthread)"]
