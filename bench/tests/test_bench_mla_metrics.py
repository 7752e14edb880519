"""The two latent-attention metrics on a synthetic traced job, with
answers worked by hand, and silent where there is nothing to read: no
``mla.decode`` span (the other cells' models) or a program that records
no device times (an older port)."""

from types import SimpleNamespace

import pytest

from bench import harness, program_spans as P, work
from repro_torch.runtime import trace

SPEC = {"n_heads": 16, "kv_lora_rank": 512, "qk_rope_head_dim": 64}
DECODE_SPANS = [(100, 200, P.DECODE), (300, 400, P.DECODE),
                (120, 130, "repro_torch.model.mla.decode")]


def _run(host_ops=DECODE_SPANS):
    return SimpleNamespace(spec=SPEC, trace=SimpleNamespace(
        host_ops=sorted(host_ops)))


@pytest.fixture
def program(monkeypatch):
    """The port's trace module answering with the given device times and
    counters."""
    def answer(times, counts):
        monkeypatch.setattr(trace, "device_times", lambda: times)
        monkeypatch.setattr(trace, "counters", lambda: counts)
    return answer


def test_decode_ms_is_the_spans_device_time_a_step(program):
    # 3 spans of 1, 2 and 3 ms in 2 decode steps: 3 ms a step
    program({"repro_torch.model.mla.decode": [0.001, 0.002, 0.003]}, {})
    assert harness._load_reader("mla_decode_ms")(_run()) == \
        pytest.approx(3.0)


def test_roofline_is_the_latent_bytes_bound_over_the_spans(program):
    """4 slots x 32,768 rows x 27 layers = 3,538,944 rows: 576 x 2 bytes
    each, 4,076,863,488 bytes, 1.216974 ms at 3.35 TB/s; 16 x (512 + 64 +
    512) x 2 FLOP each, 123,211,874,304 FLOP, 0.124582 ms at 989
    TFLOP/s: the bytes bound it.  Over 6 ms of spans: 20.2829%."""
    rows = 4 * 32_768 * 27
    program({"repro_torch.model.mla.decode": [0.001, 0.002, 0.003]},
            {"mla.latent_rows": rows})
    assert rows * 576 * 2 == 4_076_863_488
    assert rows * 16 * 1088 * 2 == 123_211_874_304
    assert work.bound_s(123_211_874_304, 4_076_863_488) == \
        pytest.approx(4_076_863_488 / 3.35e12)
    got = harness._load_reader("mla_decode_roofline")(_run())
    assert got == pytest.approx(100 * 4_076_863_488 / 3.35e12 / 0.006)
    assert got == pytest.approx(20.2829, abs=1e-4)


@pytest.mark.parametrize("times,counts", [
    ({}, {"moe.rows": 8}),                       # no mla.decode span
    ({"repro_torch.model.mla.decode": []}, {}),  # none ran
])
def test_silent_without_latent_attention(program, times, counts):
    program(times, counts)
    for name in ("mla_decode_ms", "mla_decode_roofline"):
        assert harness._load_reader(name)(_run()) is None


def test_silent_where_the_program_records_no_device_times(monkeypatch):
    monkeypatch.delattr(trace, "device_times")
    monkeypatch.setattr(trace, "counters",
                        lambda: {"mla.latent_rows": 1000})
    for name in ("mla_decode_ms", "mla_decode_roofline"):
        assert harness._load_reader(name)(_run()) is None


def test_roofline_silent_without_the_counter(program):
    program({"repro_torch.model.mla.decode": [0.001]}, {})
    assert harness._load_reader("mla_decode_ms")(_run()) == \
        pytest.approx(0.5)
    assert harness._load_reader("mla_decode_roofline")(_run()) is None


def test_decode_ms_silent_without_decode_steps(program):
    program({"repro_torch.model.mla.decode": [0.001]}, {})
    assert harness._load_reader("mla_decode_ms")(
        _run([(1, 2, "repro_torch.engine.prefill")])) is None
