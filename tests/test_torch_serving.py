"""The port's serving engine and admission against the reference's.

``TorchServeEngine`` must reproduce ``JaxServeEngine`` step for step (its
quirks included) on the ``examples/serve_gcr.py`` setting, in f32 so that
greedy tokens are not split by bf16 near-ties; the port's own copies of
the GCR admission classes must behave line for line like ``repro.core``'s
on a seeded offer / release / tick sequence.
"""

import dataclasses

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import torch  # noqa: E402

from repro.configs import get_smoke_config as jget_smoke  # noqa: E402
from repro.models import init_params as jinit_params  # noqa: E402
from repro.serving.engine import JaxServeEngine  # noqa: E402
from repro.serving.engine import make_admission as jmake_admission  # noqa: E402
from repro_torch.configs import get_smoke_config  # noqa: E402
from repro_torch.convert import params_from_numpy  # noqa: E402
from repro_torch.serving.engine import (TorchServeEngine,  # noqa: E402
                                        make_admission)


@pytest.mark.parametrize("kind,stats", [("gcr", (8, 2)),
                                        ("gcr_pod", (8, 2)),
                                        ("none", None)])
def test_generate_matches_jax_engine(kind, stats):
    jcfg = dataclasses.replace(jget_smoke("qwen3-0.6b"), dtype="float32")
    cfg = dataclasses.replace(get_smoke_config("qwen3-0.6b"),
                              dtype="float32")
    jparams = jinit_params(jcfg, jax.random.key(0))
    params = params_from_numpy(
        jax.tree.map(lambda a: np.asarray(a, np.float32), jparams), cfg,
        "cpu")
    prompts = np.random.default_rng(0).integers(
        0, cfg.vocab_size, (8, 12)).astype(np.int32)

    jeng = JaxServeEngine(jcfg, jparams, n_slots=3, max_len=32,
                          admission_kind=kind)
    eng = TorchServeEngine(cfg, params, n_slots=3, max_len=32,
                           admission_kind=kind, device="cpu")
    want = jeng.generate(prompts, gen_len=6)
    got = eng.generate(prompts, gen_len=6)
    assert got.dtype == want.dtype and got.shape == (8, 6)
    np.testing.assert_array_equal(got, want)
    if stats is not None:
        assert (eng.admission.stat_fast, eng.admission.stat_parked) == stats
        assert (jeng.admission.stat_fast,
                jeng.admission.stat_parked) == stats


def _state(adm):
    queues = getattr(adm, "pod_queues", None) or [getattr(adm, "queue", [])]
    return (sorted(adm.active), [[s.stream_id for s in q] for q in queues],
            adm.num_active, adm.num_parked,
            {k: getattr(adm, k) for k in ("stat_fast", "stat_parked",
                                          "stat_promotions",
                                          "stat_demotions",
                                          "stat_rotations", "preferred",
                                          "completions", "step",
                                          "last_demoted")
             if hasattr(adm, k)})


@pytest.mark.parametrize("kind", ["gcr", "gcr_pod", "none"])
def test_admission_matches_reference(kind):
    """Seeded offer / release / tick / cancel sequence: every return
    value and the whole visible state agree after every call."""
    rng = np.random.default_rng(7)
    ref = jmake_admission(kind, 4, n_pods=3, promote_every=5)
    port = make_admission(kind, 4, n_pods=3, promote_every=5)
    live, next_id = [], 0
    for _ in range(400):
        op = rng.integers(0, 10)
        if op < 5 or not live:
            pod = int(rng.integers(0, 3))
            got = port.offer(next_id, pod)
            assert got == ref.offer(next_id, pod)
            live.append(next_id)
            next_id += 1
        elif op < 8:
            sid = live.pop(int(rng.integers(0, len(live))))
            assert port.release(sid) == ref.release(sid)
        elif op < 9 or kind == "none":
            port.tick()
            ref.tick()
        else:
            sid = live[int(rng.integers(0, len(live)))]
            port.cancel(sid)
            ref.cancel(sid)
        assert _state(port) == _state(ref)
    if kind == "gcr_pod":
        assert port.active_pod_mix() == ref.active_pod_mix()
    port.drain()
    ref.drain()
    assert _state(port) == _state(ref)


def test_engine_refuses_params_on_another_device():
    cfg = get_smoke_config("qwen3-0.6b")
    params = params_from_numpy(
        jax.tree.map(lambda a: np.asarray(a, np.float32),
                     jinit_params(jget_smoke("qwen3-0.6b"),
                                  jax.random.key(0))), cfg, "cpu")
    with pytest.raises(ValueError, match="params are on"):
        TorchServeEngine(cfg, params, 3, 32, device="meta")
    assert params.embed.dtype == torch.bfloat16
