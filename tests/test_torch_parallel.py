"""The port's multi-device layer across gloo ranks on the CPU.

Each test spawns its ranks as processes (``torch.multiprocessing``, the
spawn method) that meet through a ``FileStore`` in ``tmp_path`` (no
network).  Every spawn has its own timeout, so a hung collective fails
the test instead of running into the suite's limit.

The sharded train step is held against the port's single-device step
(which ``tests/test_torch_train.py`` holds against
``jax.value_and_grad(forward_train)``): each step starts both from the
same state (the single-device parameters and AdamW state, loaded into
the sharded ones between steps) and the same batch, and after it the
loss, every gathered parameter and both AdamW moments agree to 1e-5 in
f32, relative L2 a leaf.  Each step starts from the same state because a
step's f32 rounding depends on the layout: with tensor parallelism the
gradients differ from one device's by about 1e-6 of a leaf (3e-7 with
data parallelism alone, as for another order of the batch), and AdamW's
first update, about lr * sign(g) for every weight, carries such
differences on to about 1e-5 of the next step's moments.
"""

from __future__ import annotations

import dataclasses
import json
import traceback
from pathlib import Path

import numpy as np
import pytest
import torch
import torch.multiprocessing as mp

ROOT = Path(__file__).resolve().parents[1]
SPAWN_TIMEOUT = 120.0
TOL = 1e-5


def _worker(rank, world, store, fn, args, out):
    import torch.distributed as dist
    torch.set_num_threads(1)     # the ranks share the host's cores
    try:
        dist.init_process_group("gloo", store=dist.FileStore(store, world),
                                rank=rank, world_size=world)
        result = fn(rank, world, *args)
        dist.barrier()
        if rank == 0:
            Path(out).write_text(json.dumps(result))
    except BaseException:
        Path(f"{out}.err{rank}").write_text(traceback.format_exc())
        raise
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def spawn(tmp_path, world, fn, *args, timeout=SPAWN_TIMEOUT):
    """Run ``fn(rank, world, *args)`` on ``world`` gloo ranks; returns rank
    0's JSON result.  Fails on a rank's error or on the timeout."""
    ctx = mp.get_context("spawn")
    store = str(tmp_path / f"store_{fn.__name__}")
    out = str(tmp_path / f"out_{fn.__name__}.json")
    for f in Path(tmp_path).glob(f"out_{fn.__name__}.json*"):
        f.unlink()
    procs = [ctx.Process(target=_worker,
                         args=(r, world, store, fn, args, out))
             for r in range(world)]
    for p in procs:
        p.start()
    for p in procs:
        p.join(timeout)
    hung = [p for p in procs if p.is_alive()]
    for p in hung:
        p.kill()
        p.join()
    errs = sorted(Path(tmp_path).glob(f"out_{fn.__name__}.json.err*"))
    if errs:
        pytest.fail("\n".join(e.read_text() for e in errs))
    assert not hung, f"{len(hung)} rank(s) still running after {timeout} s"
    assert all(p.exitcode == 0 for p in procs), [p.exitcode for p in procs]
    return json.loads(Path(out).read_text())


# ---------------------------------------------------------------------------
# Rank functions (module level: the spawned ranks import them)
# ---------------------------------------------------------------------------


def _smoke(arch, **overrides):
    from repro_torch.configs import get_smoke_config
    return dataclasses.replace(get_smoke_config(arch),
                               **{"dtype": "float32", **overrides})


def _batch(cfg, B, S, seed=1):
    rng = np.random.default_rng(seed)
    batch = {"tokens": torch.from_numpy(
                 rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int64)),
             "targets": torch.from_numpy(
                 rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int64))}
    if cfg.frontend == "audio_stub":
        batch["frames"] = torch.from_numpy(rng.standard_normal(
            (B, S // cfg.enc_seq_divisor, cfg.frontend_dim)
        ).astype(np.float32))
    return batch


def _max_rel(a, b) -> float:
    """The worst leaf's relative L2 difference of two numpy trees (the
    measure of ``tests/test_torch_train.py``)."""
    from repro_torch.parallel.sharding import _flatten
    fa, fb = _flatten(a), _flatten(b)
    assert fa.keys() == fb.keys()
    worst = 0.0
    for k in fa:
        got, want = (np.asarray(fa[k], np.float64),
                     np.asarray(fb[k], np.float64))
        den = max(float(np.linalg.norm(want)), 1e-30)
        worst = max(worst, float(np.linalg.norm(got - want)) / den)
    return worst


RWKV_MUS = ("mu_r", "mu_k", "mu_v", "mu_w", "mu_g", "mu_ck", "mu_cr")


@torch.no_grad()
def _perturb_rwkv(params):
    """The RWKV6 parameters that the init sets to constants, drawn as
    ``tests/test_torch_train.py`` draws them: at the init's constants the
    smoke model's f32 gradients are ill-conditioned (its own f32 and f64
    gradients differ by 4.3e-4 of a leaf's largest value)."""
    rng = np.random.default_rng(0)
    for blk in params.layers:
        p = blk.rwkv
        for name in RWKV_MUS:
            w = getattr(p, name)
            w.copy_(torch.from_numpy(rng.uniform(0.0, 1.0, w.shape)))
        p.bonus_u.copy_(torch.from_numpy(rng.normal(0.0, 0.5,
                                                    p.bonus_u.shape)))
        p.decay_w0.copy_(torch.from_numpy(rng.uniform(-6, -1,
                                                      p.decay_w0.shape)))
        p.ln_x_w.copy_(torch.from_numpy(1.0 + rng.normal(0.0, 0.1,
                                                         p.ln_x_w.shape)))


def _rank_train(rank, world, mesh_shape, arch, overrides, steps,
                microbatches=1, fsdp_min_elems=None):
    """``steps`` sharded steps against as many single-device steps from a
    copy of the same weights, on one batch.  ``fsdp_min_elems`` lowers
    the rules' FSDP threshold (2^20 elements, which no smoke leaf
    reaches)."""
    import copy

    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor import Replicate

    from repro_torch.config import OptimizerConfig
    from repro_torch.convert import (load_numpy_, opt_state_from_numpy,
                                     opt_state_to_numpy, params_to_numpy)
    from repro_torch.parallel import ShardingRules
    from repro_torch.steps import init_train_state, make_train_step

    cfg = _smoke(arch, **overrides)
    mesh = init_device_mesh("cpu", tuple(mesh_shape),
                            mesh_dim_names=("data", "model"))
    params, opt = init_train_state(cfg, torch.Generator().manual_seed(0),
                                   "cpu")
    if cfg.block_pattern[0] == "rwkv6":
        _perturb_rwkv(params)
    ref_params, ref_opt = copy.deepcopy(params), copy.deepcopy(opt)
    rules = ShardingRules(cfg, mesh)
    if fsdp_min_elems is not None:
        rules.fsdp_min_elems = fsdp_min_elems
    rules.distribute_params(params)
    opt = rules.distribute_opt(opt, params)
    opt_cfg = OptimizerConfig(lr=1e-3, warmup_steps=1, total_steps=100)
    step = make_train_step(cfg, opt_cfg, rules, microbatches=microbatches)
    ref_step = make_train_step(cfg, opt_cfg, microbatches=microbatches)
    batch = _batch(cfg, 8, 32)
    data = mesh.mesh_dim_names.index("data")
    out = {"losses": [], "ref_losses": [], "loss": 0.0, "params": 0.0,
           "moments": 0.0,
           "dp_split_params": sum(p.placements[data] != Replicate()
                                  for p in params.parameters())}
    for i in range(steps):
        params, opt, m = step(params, opt, batch, i)
        ref_params, ref_opt, rm = ref_step(ref_params, ref_opt, batch, i)
        out["losses"].append(float(m["loss"]))
        out["ref_losses"].append(float(rm["loss"]))
        want_p = params_to_numpy(ref_params)
        want_o = opt_state_to_numpy(ref_opt, ref_params)
        got_o = opt_state_to_numpy(opt, params)
        out["loss"] = max(out["loss"], abs(out["losses"][-1]
                                           - out["ref_losses"][-1])
                          / abs(out["ref_losses"][-1]))
        out["params"] = max(out["params"],
                            _max_rel(params_to_numpy(params), want_p))
        out["moments"] = max(out["moments"], _max_rel(
            {"m": got_o["m"], "v": got_o["v"]},
            {"m": want_o["m"], "v": want_o["v"]}))
        out["count"] = int(got_o["count"])
        # the next step starts from the single-device state
        load_numpy_(params, want_p)
        opt = rules.distribute_opt(opt_state_from_numpy(want_o, ref_params),
                                   params)
    return out


def _check(out, steps, moments_tol=TOL):
    assert out["loss"] < TOL, out
    assert out["params"] < TOL, out
    assert out["moments"] < moments_tol, out
    assert out["count"] == steps
    assert all(np.isfinite(out["losses"]))


# ---------------------------------------------------------------------------
# The sharded train step against the single-device step
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("mesh_shape", [(2, 2), (1, 4)])
def test_qwen3_sharded_step_matches_single_device(tmp_path, mesh_shape):
    """(2, 2): DP x TP; (1, 4): TP 4 over 4 q heads, where the 2 kv heads
    do not divide the axis (each rank reads the one kv head of its q
    head)."""
    out = spawn(tmp_path, 4, _rank_train, mesh_shape, "qwen3-0.6b", {}, 2)
    _check(out, 2)


def test_qwen3_fsdp_sharded_step_matches_single_device(tmp_path):
    """FSDP at (2, 2) with the threshold lowered to 1024 elements: every
    layer's large leaf split over data on its first free dim, gathered by
    each unit inside its recomputed region, its gradient reduce-scattered
    back."""
    out = spawn(tmp_path, 4, _rank_train, (2, 2), "qwen3-0.6b", {}, 2, 1,
                1 << 10)
    _check(out, 2)
    assert out["dp_split_params"] > 0


def test_qwen3_sharded_loss_drops_on_one_batch(tmp_path):
    """The claim of the reference's sharded test, on the port: four steps
    on one batch at (2, 2), the loss falls."""
    out = spawn(tmp_path, 4, _rank_train, (2, 2), "qwen3-0.6b", {}, 4)
    _check(out, 4)
    assert out["losses"][-1] < out["losses"][0], out["losses"]


def test_microbatched_sharded_step_matches_single_device(tmp_path):
    """Two microbatches, each split over dp, against two on one device."""
    out = spawn(tmp_path, 4, _rank_train, (2, 2), "qwen3-0.6b", {}, 1, 2)
    _check(out, 1)
