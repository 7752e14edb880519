"""The port's virtual-time serving engine against the reference's.

``repro_torch.serving.engine``'s ``SimServeEngine``, ``StepCostModel``,
``PrefixCache``, ``Request``, ``ServeResult`` and ``percentile`` are the
reference's pure-Python code, so under the reference's cost constants the
two packages must give *equal* results, float for float: the same
arithmetic runs in the same order.  The port's own defaults are the H100's
(``engine``'s module docstring); the tests below also hold their
derivation and that the collapse, and GCR's escape from it, survive them.
"""

import dataclasses
import functools
import inspect
import re

import numpy as np
import pytest

import repro.launch.serve as ref_serve
import repro.serving.engine as ref_engine
import repro_torch.launch.serve as port_serve
import repro_torch.serving.engine as port_engine
from repro_torch.config import H100
from repro_torch.configs.qwen3_0_6b import CONFIG as QWEN3

REF_COST = dataclasses.asdict(ref_engine.StepCostModel())


def port_cost(**over):
    """The port's StepCostModel holding the reference's constants."""
    return port_engine.StepCostModel(**{**REF_COST, **over})


# the reference launcher's ``--prefill-ms-per-tok`` default
REF_PREFILL_MS_PER_TOK = 0.05


def patch_ref_constants(mp):
    """Every bare ``StepCostModel()`` in the port builds the reference's
    constants (the engine's default cost, the launcher's cluster mode, the
    fleet's ``knee_cost`` and ``est_capacity_rps``), and so do the port's
    other H100 defaults: ``SLO``'s two objectives, the fleet's
    ``MigrationCost()`` and the launcher's prefill charge.  ``mp`` is a
    ``pytest.MonkeyPatch``."""
    import repro.cluster.controller as ref_controller
    import repro.cluster.telemetry as ref_telemetry
    import repro_torch.cluster.controller as port_controller
    import repro_torch.cluster.fleet as port_fleet
    import repro_torch.cluster.telemetry as port_telemetry

    factory = functools.partial(port_engine.StepCostModel, **REF_COST)
    mp.setattr(port_engine, "StepCostModel", factory)
    mp.setattr(port_fleet, "StepCostModel", factory)
    mp.setattr(port_telemetry, "PER_TOKEN_MS",
               ref_telemetry.SLO().per_token_ms)
    mp.setattr(port_telemetry, "TTFT_MS", ref_telemetry.SLO().ttft_ms)
    mp.setattr(port_fleet, "MigrationCost", functools.partial(
        port_controller.MigrationCost,
        **dataclasses.asdict(ref_controller.MigrationCost())))
    mp.setattr(port_serve, "PREFILL_MS_PER_TOK", REF_PREFILL_MS_PER_TOK)


@pytest.fixture
def ref_constants(monkeypatch):
    """The port under the reference's constants (``patch_ref_constants``)
    for one test."""
    patch_ref_constants(monkeypatch)


def sweep_requests(mod, n, seed, prefixes=False):
    """The launcher's sweep generator; with ``prefixes`` every request
    also shares one of 97 prefix groups over half its prompt."""
    rng = np.random.default_rng(seed)
    reqs = []
    for i in range(n):
        prompt = int(rng.integers(256, 1024))
        gen = int(rng.integers(64, 256))
        arrive = float(rng.uniform(0, 500))
        extra = (dict(session_id=i % 97, prefix_id=i % 97,
                      prefix_len=prompt // 2) if prefixes else {})
        reqs.append(mod.Request(rid=i, prompt_len=prompt, gen_len=gen,
                                pod=i % 2, arrive_ms=arrive, **extra))
    return reqs


def run_engine(mod, cost, kind, n, leap, cache):
    adm = mod.make_admission(kind, 384, n_pods=2)
    pc = mod.PrefixCache(50_000) if cache else None
    eng = mod.SimServeEngine(adm, cost, prefix_cache=pc,
                             leap_stepping=leap)
    res = eng.run(sweep_requests(mod, n, seed=n, prefixes=cache),
                  max_ms=600_000)
    trace = [(r.rid, r.generated, r.done_ms, r.first_token_ms,
              r.prefix_hit_tokens)
             for r in sorted(eng.requests.values(), key=lambda r: r.rid)]
    counters = (eng.tokens_out, eng.peak_active, eng.peak_parked,
                adm.num_parked,
                (pc.tokens, pc.hit_tokens, pc.query_tokens,
                 pc.evicted_tokens, len(pc)) if pc else None)
    return dataclasses.asdict(res), trace, counters


@pytest.mark.parametrize("cache", [False, True], ids=["nocache", "cache"])
@pytest.mark.parametrize("leap", [True, False], ids=["leap", "step"])
@pytest.mark.parametrize("n", [256, 1024])
@pytest.mark.parametrize("kind", ["none", "gcr", "gcr_pod"])
def test_sim_engine_run_equals_reference(kind, n, leap, cache):
    over = dict(t_prefill_ms_per_tok=0.05) if cache else {}
    ref = run_engine(ref_engine,
                     ref_engine.StepCostModel(**{**REF_COST, **over}),
                     kind, n, leap, cache)
    got = run_engine(port_engine, port_cost(**over), kind, n, leap, cache)
    assert got[0] == ref[0]             # every ServeResult field
    assert got[1] == ref[1]             # every request's stamps
    assert got[2] == ref[2]
    assert ref[0]["completed"] > 0


def test_externally_clocked_steps_equal_reference():
    """``submit`` / ``step`` / ``step_leap`` / ``leap_submit`` driven by an
    outside clock (as the fleet drives them), arrivals landing inside
    banked leap chains."""
    def drive(mod, cost):
        eng = mod.SimServeEngine(mod.make_admission("gcr", 48), cost)
        reqs = sweep_requests(mod, 200, seed=5)
        reqs.sort(key=lambda r: (r.arrive_ms, r.rid))
        now, log, i = 0.0, [], 0
        while i < len(reqs) or eng.has_work:
            if eng.has_work:
                end, done, k = eng.step_leap(now)
                log.append((now, end, k, [r.rid for r in done]))
                while i < len(reqs) and reqs[i].arrive_ms < end:
                    if eng._leap is not None:
                        log.append(eng.leap_submit(reqs[i],
                                                   reqs[i].arrive_ms))
                    else:
                        log.append(eng.submit(reqs[i]))
                    i += 1
                now = end
            else:
                now = max(now, reqs[i].arrive_ms)
                log.append(eng.submit(reqs[i]))
                i += 1
        return log, eng.tokens_out, eng.occupancy()

    ref = drive(ref_engine, ref_engine.StepCostModel(**REF_COST))
    assert drive(port_engine, port_cost()) == ref
    steps = [entry for entry in ref[0] if isinstance(entry, tuple)
             and len(entry) == 4]
    assert max(k for _, _, k, _ in steps) > 1          # chains banked
    assert any(len(entry) == 3 for entry in ref[0]
               if isinstance(entry, tuple))            # leap_submit ran


def test_percentile_and_prefix_cache_equal_reference():
    rng = np.random.default_rng(3)
    vals = sorted(rng.random(101).tolist())
    for q in (0.0, 0.01, 0.5, 0.9, 0.99, 1.0):
        assert port_engine.percentile(vals, q) == \
            ref_engine.percentile(vals, q)
    assert port_engine.percentile([], 0.5) == 0.0
    caches = [mod.PrefixCache(5_000) for mod in (ref_engine, port_engine)]
    for _ in range(400):
        pid, toks = int(rng.integers(0, 40)), int(rng.integers(0, 900))
        op = rng.random()
        outs = []
        for pc in caches:
            if op < 0.5:
                outs.append(pc.lookup(pid, toks))
            elif op < 0.98:
                outs.append(pc.insert(pid, toks))
            else:
                outs.append(pc.clear())
        assert outs[0] == outs[1]
    a, b = caches
    assert (a.tokens, a.hit_tokens, a.query_tokens, a.evicted_tokens,
            list(a._entries.items())) == \
        (b.tokens, b.hit_tokens, b.query_tokens, b.evicted_tokens,
         list(b._entries.items()))
    with pytest.raises(ValueError):
        port_engine.PrefixCache(0)


@pytest.mark.parametrize("kind", ["none", "gcr", "gcr_pod"])
def test_fleet_sweep_stdout_equals_reference(kind, capsys, monkeypatch,
                                             ref_constants):
    monkeypatch.setattr("sys.argv", ["serve", "--fleet-sweep",
                                     "--admission", kind])
    ref_serve.main()
    want = capsys.readouterr().out
    port_serve.main(["--fleet-sweep", "--admission", kind])
    assert capsys.readouterr().out == want
    assert len(want.splitlines()) == 4


# -- the port's own (H100) defaults --------------------------------------


def test_kv_bytes_per_tok_is_qwen3_bf16_k_and_v():
    want = 2 * QWEN3.n_layers * QWEN3.n_kv_heads * QWEN3.d_head * 2
    assert want == 114_688
    assert port_engine.StepCostModel().kv_bytes_per_tok == want


def test_cost_defaults_derive_from_the_h100_spec():
    cost = port_engine.StepCostModel()
    assert cost.hbm_budget == 0.6 * H100.hbm_bytes == 48e9
    assert cost.t_xpod_ms == 256 * 114_688 / H100.network_bw * 1e3
    assert cost.t_xpod_ms == pytest.approx(0.5872, abs=1e-4)
    # thrash at load 2 and 256 streams == one budget out and back in
    thrash = cost.thrash_coef * (2.0 - 1.0) ** 2 * 256
    assert thrash == pytest.approx(
        2 * cost.hbm_budget / port_engine.H2D_BYTES_PER_S * 1e3, rel=1e-12)
    assert cost.t_prefill_ms_per_tok == 0.0
    assert cost.t_fixed_ms == port_engine.T_FIXED_MS > 0
    assert cost.t_tok_ms == port_engine.T_TOK_MS > 0
    # the reference's functional form, unchanged
    assert [f.name for f in dataclasses.fields(port_engine.StepCostModel)] \
        == [f.name for f in dataclasses.fields(ref_engine.StepCostModel)]
    assert inspect.getsource(port_engine.StepCostModel.step_ms) == \
        inspect.getsource(ref_engine.StepCostModel.step_ms)


def test_engine_names_no_tpu():
    src = inspect.getsource(port_engine)
    assert not re.search(r"TPU|v5e|v5p|\bICI\b", src)
    assert "H100" in port_engine.__doc__
    assert "H100" in port_engine.StepCostModel.__doc__


def test_h100_fleet_sweep_shows_collapse_and_gcr_avoids_it(capsys):
    tok_s = {}
    for kind in ("none", "gcr"):
        port_serve.main(["--fleet-sweep", "--admission", kind])
        rows = [line.split() for line in
                capsys.readouterr().out.splitlines()[1:]]
        tok_s[kind] = {int(r[0]): float(r[1].replace(",", ""))
                       for r in rows}
    for n in (1024, 4096):
        assert tok_s["gcr"][n] > tok_s["none"][n]
    # none collapses past its peak; gcr keeps climbing to its plateau
    assert tok_s["none"][4096] < 0.1 * tok_s["none"][256]
    assert tok_s["gcr"][4096] >= tok_s["gcr"][1024]


def test_calibrate_fits_a_line_and_runs_on_the_cpu(capsys):
    from repro_torch.serving import calibrate

    got = calibrate.fit({1: 40.5, 8: 42.25, 32: 48.25, 256: 104.25})
    assert got["t_fixed_ms"] == pytest.approx(40.25, abs=1e-9)
    assert got["t_tok_ms"] == pytest.approx(0.25, abs=1e-12)
    assert got["r2"] == pytest.approx(1.0, abs=1e-12)
    out = calibrate.main(["--smoke", "--device", "cpu"])
    assert sorted(out["walls_ms"]) == [1, 2, 4]
    assert out["flash_launches"] == 0          # the plain version ran
    assert out["prefills"] == 3 * calibrate.PREFILL_REPS
    assert sorted(out["prefill_ms"]) == [1, 2, 4]
    assert out["prefill_ms_per_tok"] == calibrate.fit(
        {n * 16: ms for n, ms in out["prefill_ms"].items()})["t_tok_ms"]
    # the step is the least of its rounds' medians
    assert all(out["walls_ms"][n] == min(out["round_medians_ms"][n])
               and len(out["round_medians_ms"][n]) == calibrate.ROUNDS
               for n in (1, 2, 4))
    assert out["h2d_bytes_per_s"] is None and out["device"] == "cpu"
    assert capsys.readouterr().out.splitlines()[-1].startswith("{")
    assert calibrate.STREAMS == port_engine.CALIBRATION_STREAMS \
        == (1, 8, 32, 64, 128, 256)
    assert calibrate.ARCH == port_engine.CALIBRATION_ARCH == QWEN3.name
    assert (calibrate.PROMPT, calibrate.MAX_LEN) == (640, 1024)
