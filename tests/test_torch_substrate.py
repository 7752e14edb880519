"""The trainer's substrate in the port against the reference's, on the CPU.

* the port's copies of the lock zoo and GCR (``repro_torch.core``) pass
  the reference's own lock cases (``tests/test_locks.py``): mutual
  exclusion bare and under ``gcr_wrap``, progress under saturation,
  adaptive disabling, work conservation;
* the data pipeline gives the reference's batches for the same
  ``(seed, i)`` and restores at ``next_batch``;
* a checkpoint either package writes restores in the other, with equal
  values and dtypes (bf16 params, f32 moments, int32 count);
* ``launch/train.py``'s save, stop and resume gives a straight run's losses
  (exactly: the same arithmetic in one process), and without ``--device``
  and without a card it raises.
"""

import sys
import threading
import time

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from repro.checkpoint import CheckpointManager as JCheckpointManager  # noqa: E402
from repro.configs import get_smoke_config as jget_smoke  # noqa: E402
from repro.data import PrefetchPipeline as JPrefetchPipeline  # noqa: E402
from repro.data import SyntheticTokens as JSyntheticTokens  # noqa: E402
from repro.models import init_params as jinit_params  # noqa: E402
from repro.optim import adamw_init as jadamw_init  # noqa: E402
from repro_torch.checkpoint import CheckpointManager  # noqa: E402
from repro_torch.configs import get_smoke_config  # noqa: E402
from repro_torch.convert import (load_numpy_,  # noqa: E402
                                 opt_state_from_numpy, opt_state_to_tree,
                                 params_from_numpy, params_to_tree)
from repro_torch.core import GCR, LOCKS, gcr_wrap, make_lock  # noqa: E402
from repro_torch.data import PrefetchPipeline, SyntheticTokens  # noqa: E402
from repro_torch.launch import train  # noqa: E402
from repro_torch.models import Transformer  # noqa: E402

ARCH = "qwen3-0.6b"
JOIN_S = 60


def _run_threads(work, n):
    ts = [threading.Thread(target=work) for _ in range(n)]
    for t in ts:
        t.start()
    for t in ts:
        t.join(timeout=JOIN_S)
    assert not any(t.is_alive() for t in ts)


def hammer(lock, n_threads=6, iters=200):
    """The reference test's hammer, with a short switch interval so that
    threads interleave inside the critical section if the lock lets them."""
    counter = [0]
    in_cs = [0]
    max_in_cs = [0]

    def work():
        for _ in range(iters):
            lock.acquire()
            try:
                in_cs[0] += 1
                max_in_cs[0] = max(max_in_cs[0], in_cs[0])
                c = counter[0]
                counter[0] = c + 1
                in_cs[0] -= 1
            finally:
                lock.release()

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        _run_threads(work, n_threads)
    finally:
        sys.setswitchinterval(interval)
    return counter[0], max_in_cs[0]


# ---------------------------------------------------------------------------
# Locks and GCR
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", sorted(LOCKS))
def test_mutual_exclusion_base_locks(name):
    total, max_in = hammer(make_lock(name))
    assert total == 6 * 200
    assert max_in == 1


@pytest.mark.parametrize("name", ["ttas", "mcs_spin", "mcs_stp", "pthread",
                                  "ticket", "clh"])
def test_mutual_exclusion_gcr(name):
    lock = gcr_wrap(make_lock(name), promote_threshold=64)
    assert isinstance(lock, GCR)
    total, max_in = hammer(lock)
    assert total == 6 * 200
    assert max_in == 1


def test_gcr_progress_under_saturation():
    """Starvation-freedom: every thread completes with a tiny active
    threshold and a critical section long enough to saturate the lock."""
    lock = gcr_wrap(make_lock("ttas"), enter_threshold=1, join_threshold=0,
                    promote_threshold=8)
    counter = [0]

    def work():
        for _ in range(30):
            lock.acquire()
            try:
                counter[0] += 1
                time.sleep(0.0005)   # hold the lock: forces saturation
            finally:
                lock.release()

    _run_threads(work, 6)
    assert counter[0] == 6 * 30
    assert lock.stat_slow_path > 0   # restriction actually engaged


def test_gcr_adaptive_stays_off_uncontended():
    lock = gcr_wrap(make_lock("pthread"), adaptive=True)
    for _ in range(100):
        lock.acquire()
        lock.release()
    assert not lock._enabled
    assert lock.stat_slow_path == 0


def test_gcr_work_conserving():
    """When actives drain, a passive thread gets in without promotion."""
    lock = gcr_wrap(make_lock("pthread"), enter_threshold=0,
                    join_threshold=0, promote_threshold=10**9)
    done = []

    def enter(tag):
        lock.acquire()
        done.append(tag)
        lock.release()

    t1 = threading.Thread(target=enter, args=("a",))
    t2 = threading.Thread(target=enter, args=("b",))
    t1.start()
    t1.join(timeout=JOIN_S)
    t2.start()
    t2.join(timeout=JOIN_S)
    assert not t1.is_alive() and not t2.is_alive()
    assert sorted(done) == ["a", "b"]


# ---------------------------------------------------------------------------
# Data pipeline
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("seed", [0, 7])
def test_synthetic_batches_match_reference(seed):
    src = SyntheticTokens(get_smoke_config(ARCH), 32, 4, seed=seed)
    jsrc = JSyntheticTokens(jget_smoke(ARCH), 32, 4, seed=seed)
    for i in (0, 1, 5, 123):
        got, want = src.global_batch_at(i), jsrc.global_batch_at(i)
        assert sorted(got) == sorted(want) == ["targets", "tokens"]
        for key in want:
            assert got[key].dtype == want[key].dtype == np.int32
            np.testing.assert_array_equal(got[key], want[key])
        np.testing.assert_array_equal(src.host_shard(i, 1, 2)["tokens"],
                                      jsrc.host_shard(i, 1, 2)["tokens"])


def _take(pipe, n):
    out = []
    try:
        for i, batch in pipe:
            out.append((i, batch))
            if len(out) == n:
                break
    finally:
        pipe.stop()
    return out


@pytest.mark.parametrize("use_gcr", [True, False])
def test_prefetch_restores_at_next_batch(use_gcr):
    """Workers claim indices under the (GCR-wrapped) lock and may finish
    out of order; the pipeline delivers in order from ``next_batch``, the
    batches the reference's pipeline delivers."""
    cfg, jcfg = get_smoke_config(ARCH), jget_smoke(ARCH)
    src = SyntheticTokens(cfg, 16, 2, seed=3)
    pipe = PrefetchPipeline.restore(src, 5, depth=3, workers=3,
                                    use_gcr=use_gcr)
    assert isinstance(pipe.lock, GCR) == use_gcr
    got = _take(pipe, 6)
    want = _take(JPrefetchPipeline.restore(JSyntheticTokens(jcfg, 16, 2, 3),
                                           5, depth=3, workers=3), 6)
    assert [i for i, _ in got] == [i for i, _ in want] == list(range(5, 11))
    for (_, g), (_, w) in zip(got, want):
        np.testing.assert_array_equal(g["tokens"], w["tokens"])
        np.testing.assert_array_equal(g["targets"], w["targets"])
    assert pipe.snapshot() >= 11


# ---------------------------------------------------------------------------
# Checkpoints across packages
# ---------------------------------------------------------------------------


def _jax_state(seed):
    """A reference train state with nonzero moments: bf16 params, f32 m
    and v, int32 count."""
    jparams = jinit_params(jget_smoke(ARCH), jax.random.key(seed))
    jopt = jadamw_init(jparams)
    rng = np.random.default_rng(seed)
    jopt["m"] = jax.tree.map(lambda a: jnp.asarray(
        rng.standard_normal(a.shape), jnp.float32), jopt["m"])
    jopt["v"] = jax.tree.map(lambda a: jnp.asarray(
        rng.random(a.shape), jnp.float32), jopt["v"])
    jopt["count"] = jnp.int32(7)
    return jparams, jopt


def _assert_same(got, want):
    assert jax.tree.structure(got) == jax.tree.structure(want)
    for g, w in zip(jax.tree.leaves(got), jax.tree.leaves(want)):
        np.testing.assert_array_equal(np.asarray(g, np.float32),
                                      np.asarray(w, np.float32))


def test_reference_checkpoint_restores_in_port(tmp_path):
    jparams, jopt = _jax_state(0)
    jmgr = JCheckpointManager(str(tmp_path), keep=2, async_save=False)
    jmgr.save(7, {"params": jparams, "opt": jopt}, extra={"next_batch": 7})

    mgr = CheckpointManager(str(tmp_path))
    assert mgr.latest_step() == 7
    step, state, extra = mgr.restore()
    assert (step, extra) == (7, {"next_batch": 7})
    params = Transformer(get_smoke_config(ARCH), "cpu")
    load_numpy_(params, state["params"])
    assert params.embed.dtype == torch.bfloat16
    opt = opt_state_from_numpy(state["opt"], params)
    assert opt["count"].dtype == torch.int32 and int(opt["count"]) == 7
    _assert_same(
        jax.tree.map(lambda t: t.float().numpy(), params_to_tree(params)),
        jparams)
    got_opt = opt_state_to_tree(opt, params)
    for part in ("m", "v"):
        _assert_same(jax.tree.map(lambda t: t.numpy(), got_opt[part]),
                     jopt[part])


def test_port_checkpoint_restores_in_reference(tmp_path):
    jparams, jopt = _jax_state(1)
    params = params_from_numpy(
        jax.tree.map(lambda a: np.asarray(a, np.float32), jparams),
        get_smoke_config(ARCH), "cpu")
    opt = opt_state_from_numpy(
        jax.tree.map(lambda a: np.asarray(a), jopt), params)
    mgr = CheckpointManager(str(tmp_path), keep=2, async_save=True)
    mgr.save(3, {"params": params_to_tree(params),
                 "opt": opt_state_to_tree(opt, params)},
             extra={"next_batch": 3})
    mgr.wait()

    step, state, extra = JCheckpointManager(str(tmp_path)).restore()
    assert (step, extra) == (3, {"next_batch": 3})
    assert jax.tree.map(lambda a: str(a.dtype), state) == {
        "params": jax.tree.map(lambda a: "bfloat16", jparams),
        "opt": {"m": jax.tree.map(lambda a: "float32", jopt["m"]),
                "v": jax.tree.map(lambda a: "float32", jopt["v"]),
                "count": "int32"}}
    _assert_same(state["params"], jparams)
    _assert_same(state["opt"], jopt)


def test_checkpoint_retention_and_atomic_publish(tmp_path):
    """Older checkpoints go after a save, beyond ``keep``; no temp
    directory is left behind."""
    mgr = CheckpointManager(str(tmp_path), keep=2)
    for step in (1, 2, 3):
        mgr.save(step, {"x": torch.full((3,), float(step))},
                 extra={"next_batch": step})
    mgr.wait()
    assert sorted(p.name for p in tmp_path.iterdir()) == [
        "step_0000000002", "step_0000000003"]
    step, state, _ = mgr.restore()
    assert step == 3 and state["x"].tolist() == [3.0, 3.0, 3.0]
    assert mgr.restore(2)[1]["x"].tolist() == [2.0, 2.0, 2.0]


def test_save_copies_before_the_tensors_change(tmp_path):
    """The trainer updates its tensors in place right after a save: what
    is written is what they held when ``save`` was called."""
    t = torch.zeros(1000)
    mgr = CheckpointManager(str(tmp_path), async_save=True)
    mgr.save(1, {"t": t})
    t.fill_(5.0)
    mgr.wait()
    assert not mgr.restore()[1]["t"].any()


# ---------------------------------------------------------------------------
# The launcher
# ---------------------------------------------------------------------------


class _Stop(Exception):
    pass


def _save_stop_resume(tmp_path, monkeypatch, arch):
    """``--smoke --device cpu --steps 4 --ckpt-every 2``: straight, then
    the same run stopped as step 2 begins (its checkpoint at 2 started)
    and resumed, which starts at next_batch 2 and gives the straight
    run's losses for steps 2 and 3."""
    args = ["--arch", arch, "--smoke", "--device", "cpu", "--steps", "4",
            "--ckpt-every", "2", "--batch", "2", "--seq", "32"]
    straight = train.main(args + ["--ckpt-dir", str(tmp_path / "straight")])
    assert len(straight) == 4 and all(np.isfinite(straight))

    real = train.make_train_step

    def stopping(*a, **kw):
        fn = real(*a, **kw)

        def step(params, opt, batch, i):
            if i == 2:
                raise _Stop
            return fn(params, opt, batch, i)
        return step

    run = str(tmp_path / "run")
    monkeypatch.setattr(train, "make_train_step", stopping)
    with pytest.raises(_Stop):
        train.main(args + ["--ckpt-dir", run])
    monkeypatch.setattr(train, "make_train_step", real)
    assert CheckpointManager(run).latest_step() == 2
    assert CheckpointManager(run).restore()[2] == {"next_batch": 2}

    resumed = train.main(args + ["--ckpt-dir", run])
    assert resumed == straight[2:]
    assert CheckpointManager(run).latest_step() == 4


def test_launcher_save_stop_resume_gives_straight_losses(tmp_path,
                                                         monkeypatch):
    """The dense arch through ``_save_stop_resume``."""
    _save_stop_resume(tmp_path, monkeypatch, ARCH)


@pytest.mark.parametrize("arch", ["granite-moe-1b-a400m", "zamba2-2.7b",
                                  "rwkv6-7b"])
def test_launcher_trains_and_resumes_every_kind(tmp_path, monkeypatch,
                                                arch):
    """The MoE, Mamba2 and RWKV6 smoke configs through the same save,
    stop and resume (``_save_stop_resume``)."""
    _save_stop_resume(tmp_path, monkeypatch, arch)


def test_launcher_without_device_raises_when_cuda_is_absent(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("checks the behaviour without a CUDA device")
    with pytest.raises(RuntimeError, match="CUDA"):
        train.main(["--arch", ARCH, "--smoke", "--ckpt-dir", str(tmp_path)])
