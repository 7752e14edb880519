"""Which metrics a cell reports, and where each is read from: the
``workloads`` lists and ``moves`` of ``BENCHMARK.json`` (``spec.
metrics_for``), the readers found by name (a quantity split by cell reads
with its base name's reader), and the card's busy time of a profile that
carries no label of its own."""

from types import SimpleNamespace

import pytest
import torch

from bench import harness, spec, timing
from bench.tests.test_bench_run import BENCHMARK, CELLS

TOY = {
    "end_to_end": [
        {"name": "rate", "workloads": ["a", "b"]},
        {"name": "setup_s"},
        {"name": "card_rate", "workloads": ["c"]},
    ],
    "per_layer": [
        {"name": "step_ms", "moves": "rate"},
        {"name": "step_ms.c", "moves": "card_rate", "workloads": ["c"]},
        {"name": "roofline", "moves": "rate", "workloads": ["b"]},
    ],
}


@pytest.mark.parametrize("cell,trace,want", [
    ("a", False, ["rate", "setup_s"]),
    ("c", False, ["setup_s", "card_rate"]),
    ("a", True, ["step_ms"]),
    ("b", True, ["step_ms", "roofline"]),
    ("c", True, ["step_ms.c"]),
])
def test_metrics_for_follows_the_lists_then_moves(cell, trace, want):
    assert [m["name"] for m in spec.metrics_for(TOY, cell, trace)] == want


@pytest.mark.parametrize("workload", CELLS)
def test_each_cell_reports_what_its_per_layer_metrics_move(workload):
    e2e = {m["name"] for m in spec.metrics_for(BENCHMARK, workload, False)}
    assert "setup_s" in e2e and len(e2e) >= 2
    per_layer = spec.metrics_for(BENCHMARK, workload, True)
    assert per_layer
    for m in per_layer:
        assert m["moves"] in e2e, m["name"]
        assert callable(harness._load_reader(m["name"]))


def test_a_split_metric_reads_with_its_base_reader():
    run = SimpleNamespace(spans=[("decode", 0.07, (32, 600)),
                                 ("prefill", 0.6, (32, 512)),
                                 ("decode", 0.09, (32, 601))],
                          tokens=4096, window_s=8.0)
    assert harness._load_reader("decode_step_ms.chat")(run) == \
        pytest.approx(80.0)
    assert harness._load_reader("tokens_per_s.chat")(run) == 512.0


def _event(name, start, dur, cuda):
    kind = torch.autograd.DeviceType.CUDA if cuda else \
        torch.autograd.DeviceType.CPU
    return SimpleNamespace(name=lambda: name, start_ns=lambda: start,
                           duration_ns=lambda: dur, device_type=lambda: kind)


def test_a_profile_without_a_label_spans_its_device_operations():
    events = [_event("cudaLaunchKernel", 0, 5, False),
              _event("gemm", 100, 50, True), _event("add", 120, 60, True),
              _event("copy", 400, 100, True)]
    prof = SimpleNamespace(profiler=SimpleNamespace(
        kineto_results=SimpleNamespace(events=lambda: events)))
    trace = timing.DeviceTrace()
    trace.read(prof)
    assert (trace.start_ns, trace.end_ns) == (100, 500)
    assert trace.busy_s == pytest.approx(180e-9)
    assert trace.wall_s == pytest.approx(400e-9)


def test_only_the_card_rate_cell_profiles_its_window():
    profiled = [c for c in CELLS
                if "device_tokens_per_s" in
                {m["name"] for m in spec.metrics_for(BENCHMARK, c, False)}]
    assert profiled == ["mixtral-8x7b-16L.chat"]
