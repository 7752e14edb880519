"""The serving path's spans and counters (``repro_torch.runtime.trace``)
and the MoE aux computed only for training, on the CPU at smoke sizes.

Under ``torch.profiler`` one ``TorchServeEngine.generate`` records one
``repro_torch.engine.generate`` span, a prefill span a wave, a decode
span a step and an ``admission.admit`` instant a stream, all as host
operations (not user annotations, which the profiler mirrors onto the
card's timeline); with no profiler it opens no range, moves no counter
and tests the profiler's flag once a site.  The MoE's counters equal a
hand count of ``_dispatch``'s admitted pairs; serving returns the same
logits and caches whether the aux is computed or not, and training's aux
is the layer mean of each layer's."""

import functools

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from repro_torch.configs import get_smoke_config
from repro_torch.models import (decode_step, forward_train, init_params,
                                prefill)
from repro_torch.models import moe as moe_mod
from repro_torch.models import transformer as T
from repro_torch.runtime import trace
from repro_torch.serving.engine import TorchServeEngine

N_STREAMS, N_SLOTS, PROMPT, GEN = 5, 2, 8, 3
WAVES = 3                      # 2 + 2 + 1 streams


@functools.lru_cache(maxsize=None)
def _model(arch):
    cfg = get_smoke_config(arch)
    return cfg, init_params(cfg, torch.Generator().manual_seed(0), "cpu")


def _prompts(cfg, n=N_STREAMS, seed=0):
    return np.random.default_rng(seed).integers(
        0, cfg.vocab_size, (n, PROMPT)).astype(np.int32)


def _generate(arch, profiled):
    cfg, params = _model(arch)
    eng = TorchServeEngine(cfg, params, n_slots=N_SLOTS,
                           max_len=PROMPT + GEN, device="cpu")
    if not profiled:
        return eng.generate(_prompts(cfg), GEN), None
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        out = eng.generate(_prompts(cfg), GEN)
    return out, prof.profiler.kineto_results.events()


@pytest.fixture(scope="module")
def traced():
    plain, _ = _generate("internlm2-20b", profiled=False)
    out, events = _generate("internlm2-20b", profiled=True)
    return plain, out, [e for e in events
                        if e.name().startswith("repro_torch.")]


def _ranges(events, name):
    return [(e.start_ns(), e.start_ns() + e.duration_ns()) for e in events
            if e.name() == name]


def test_generate_records_one_span_a_call_wave_step_and_stream(traced):
    _, _, events = traced
    (g0, g1), = _ranges(events, "repro_torch.engine.generate")
    steps = {name: _ranges(events, f"repro_torch.{name}")
             for name in ("engine.prefill", "engine.decode",
                          "admission.admit")}
    assert len(steps["engine.prefill"]) == WAVES
    assert len(steps["engine.decode"]) == WAVES * GEN
    assert len(steps["admission.admit"]) == N_STREAMS
    for ranges in steps.values():
        assert all(g0 <= s <= e <= g1 for s, e in ranges)
    # the first wave's streams are admitted before its prefill, the rest
    # after a wave's decode steps
    first = min(s for s, _ in steps["engine.prefill"])
    admits = sorted(s for s, _ in steps["admission.admit"])
    assert admits[N_SLOTS - 1] <= first < admits[N_SLOTS]


def test_model_spans_nest_in_the_engine_steps(traced):
    _, _, events = traced
    cfg, _ = _model("internlm2-20b")
    steps = (_ranges(events, "repro_torch.engine.prefill")
             + _ranges(events, "repro_torch.engine.decode"))
    for name in ("model.attn", "model.mlp"):
        spans = _ranges(events, f"repro_torch.{name}")
        assert len(spans) == len(steps) * cfg.n_layers
        assert all(any(a <= s <= e <= b for a, b in steps)
                   for s, e in spans)


def test_spans_are_host_operations_not_user_annotations(traced):
    _, _, events = traced
    assert events
    for e in events:
        assert not e.is_user_annotation(), e.name()
        assert e.device_type() == torch.autograd.DeviceType.CPU


def test_served_tokens_equal_with_and_without_the_profiler(traced):
    plain, out, _ = traced
    np.testing.assert_array_equal(out, plain)


class _CountingFlag:
    """Stands in for ``torch.autograd.profiler``: counts each read of the
    flag, which stays off."""

    def __init__(self):
        self.reads = 0

    @property
    def _is_profiler_enabled(self):
        self.reads += 1
        return False


@pytest.mark.parametrize("arch", ["internlm2-20b", "mixtral-8x7b"])
def test_no_profiler_opens_no_range_and_tests_the_flag_once_a_site(
        arch, monkeypatch):
    opened = []
    monkeypatch.setattr(trace, "_RecordFunctionFast",
                        lambda name: opened.append(name))
    trace.reset()
    trace._counts["moe.rows"] = [7]
    flag = _CountingFlag()
    monkeypatch.setattr(trace, "_profiler", flag)
    cfg, _ = _model(arch)
    _generate(arch, profiled=False)
    assert opened == []
    assert trace.counters() == {"moe.rows": 7}
    # a site a generate call (its reset and its span), a stream (admit),
    # a wave (prefill) and a step (decode); in each step a layer's two
    # spans and, for an MoE layer, its two counts
    calls = WAVES * (1 + GEN)
    per_layer = 2 + (2 if cfg.n_experts else 0)
    assert flag.reads == (2 + N_STREAMS + calls
                          + calls * cfg.n_layers * per_layer)
    trace.reset()


def _record_dispatch(monkeypatch):
    """Wraps the model's ``_dispatch``: (rows handed to the experts,
    admitted pairs) a call."""
    seen = []
    real = moe_mod._dispatch

    def recording(*args):
        out = real(*args)
        B, E, C, _ = out[0].shape
        seen.append((B * E * C, int(out[6].sum())))
        return out

    monkeypatch.setattr(moe_mod, "_dispatch", recording)
    return seen


def test_moe_counters_equal_a_hand_count_of_the_admitted_pairs(monkeypatch):
    cfg, params = _model("mixtral-8x7b")
    seen = _record_dispatch(monkeypatch)
    tokens = torch.from_numpy(_prompts(cfg, n=3)).long()
    with profile(activities=[ProfilerActivity.CPU]):
        trace.reset()
        logits, cache = prefill(cfg, params, {"tokens": tokens},
                                max_len=PROMPT + 2)
        got = trace.counters()
    assert len(seen) == cfg.n_layers
    want = [sum(col) for col in zip(*seen)]
    assert [got["moe.rows"], got["moe.rows_with_token"]] == want
    assert 0 < want[1] < want[0]

    seen.clear()
    tok = logits[:, -1].argmax(-1)[:, None]
    with profile(activities=[ProfilerActivity.CPU]):
        trace.reset()
        decode_step(cfg, params, cache, tok)
        got = trace.counters()
    want = [sum(col) for col in zip(*seen)]
    B, E = 3, cfg.n_experts
    assert want == [cfg.n_layers * B * E * 8,
                    cfg.n_layers * B * cfg.n_experts_active]
    assert [got["moe.rows"], got["moe.rows_with_token"]] == want
    trace.reset()


def test_counters_sum_ints_and_tensors_and_reset():
    trace.reset()
    trace._counts["a"] = [3, torch.tensor([True, False, True]), 4]
    trace._counts["b"] = [torch.ones(2, 2, dtype=torch.bool)]
    assert trace.counters() == {"a": 9, "b": 4}
    trace.reset()
    assert trace.counters() == {}


@pytest.mark.parametrize("arch", ["internlm2-20b", "mixtral-8x7b"])
def test_serving_steps_equal_those_with_the_aux_computed(arch,
                                                         monkeypatch):
    """prefill and decode_step skip the aux; their logits and caches
    equal, bit for bit, those of the stack computing it."""
    cfg, params = _model(arch)
    tokens = torch.from_numpy(_prompts(cfg, n=3)).long()

    def run():
        logits, cache = prefill(cfg, params, {"tokens": tokens},
                                max_len=PROMPT + 2)
        step, cache = decode_step(cfg, params, cache,
                                  logits[:, -1].argmax(-1)[:, None])
        return logits, step, cache

    without = run()
    monkeypatch.setattr(T, "_stack",
                        functools.partial(T._stack, with_aux=True))
    with_aux = run()
    for a, b in zip(without[:2], with_aux[:2]):
        assert torch.equal(a, b)
    for la, lb in zip(without[2]["layers"], with_aux[2]["layers"]):
        for key in la:
            assert torch.equal(la[key], lb[key])


def test_forward_train_aux_is_the_layer_mean_of_each_layers(monkeypatch):
    cfg, params = _model("mixtral-8x7b")
    layer_aux = []
    real = moe_mod.moe_mlp

    def recording(*args, **kw):
        out, aux = real(*args, **kw)
        layer_aux.append(aux)
        return out, aux

    monkeypatch.setattr(moe_mod, "moe_mlp", recording)
    rng = np.random.default_rng(3)
    batch = {k: torch.from_numpy(rng.integers(0, cfg.vocab_size, (2, 16)))
             for k in ("tokens", "targets")}
    _, metrics = forward_train(cfg, params, batch, remat=False)
    assert len(layer_aux) == cfg.n_layers
    for key in ("moe_lb_loss", "moe_z_loss", "moe_drop_frac"):
        want = torch.stack([a[key] for a in layer_aux]).mean()
        assert torch.equal(metrics[key], want), key
