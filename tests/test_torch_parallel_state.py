"""The port's hierarchical gradient sync, checkpoints across meshes and
the sharded launcher, across gloo ranks on the CPU (the harness of
``tests/test_torch_parallel.py``)."""

from __future__ import annotations

import json
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import torch

from test_torch_parallel import ROOT, SPAWN_TIMEOUT, _batch, _smoke, spawn


# ---------------------------------------------------------------------------
# Hierarchical gradient sync
# ---------------------------------------------------------------------------


def _sync_grads(seed):
    rng = np.random.default_rng(seed)
    return {"w": (rng.standard_normal((8, 6)) * 2).astype(np.float32),
            "b": rng.standard_normal(3).astype(np.float32),
            "k": {"x": rng.standard_normal((4, 2, 2)).astype(np.float32)}}


def _rank_sync(rank, world, per_rank):
    from torch.distributed.device_mesh import init_device_mesh

    from repro_torch.parallel.collectives import hierarchical_grad_sync
    from repro_torch.parallel.sharding import _flatten
    mesh = init_device_mesh("cpu", (2, 2, 1),
                            mesh_dim_names=("pod", "data", "model"))
    grads = _sync_grads(rank if per_rank else 0)
    tgrads = {k: ({kk: torch.from_numpy(vv) for kk, vv in v.items()}
                  if isinstance(v, dict) else torch.from_numpy(v))
              for k, v in grads.items()}
    out = {}
    for compress in (False, True):
        res = hierarchical_grad_sync(tgrads, mesh, compress=compress)
        out[str(compress)] = {k: v.tolist()
                              for k, v in _flatten(res).items()}
    gathered = [None] * world
    import torch.distributed as dist
    dist.all_gather_object(gathered, out)
    return gathered


_JAX_SYNC = textwrap.dedent("""
    import os
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    import json
    import jax
    import numpy as np
    from repro.parallel.collectives import hierarchical_grad_sync
    rng = np.random.default_rng(0)
    grads = {"w": (rng.standard_normal((8, 6)) * 2).astype(np.float32),
             "b": rng.standard_normal(3).astype(np.float32),
             "k": {"x": rng.standard_normal((4, 2, 2)).astype(np.float32)}}
    mesh = jax.make_mesh((2, 2, 1), ("pod", "data", "model"))
    out = {}
    for compress in (False, True):
        with mesh:
            res = jax.jit(lambda g: hierarchical_grad_sync(
                g, mesh, compress=compress))(grads)
        out[str(compress)] = {"w": np.asarray(res["w"]).tolist(),
                              "b": np.asarray(res["b"]).tolist(),
                              "k.x": np.asarray(res["k"]["x"]).tolist()}
    print(json.dumps(out))
""")


def test_hierarchical_grad_sync_matches_reference(tmp_path):
    """(pod=2, data=2, model=1), the same grads on every rank: the port
    against the reference's own function (4 host devices in a
    subprocess), with and without int8."""
    proc = subprocess.run(
        [sys.executable, "-c", _JAX_SYNC], capture_output=True, text=True,
        timeout=SPAWN_TIMEOUT, cwd=ROOT,
        env={"PYTHONPATH": str(ROOT / "src"), "PATH": "/usr/bin:/bin",
             "JAX_PLATFORMS": "cpu", "HOME": str(tmp_path)})
    assert proc.returncode == 0, proc.stderr[-3000:]
    want = json.loads(proc.stdout.strip().splitlines()[-1])
    got = spawn(tmp_path, 4, _rank_sync, False)
    for rank_out in got:
        for compress in ("False", "True"):
            for k, v in want[compress].items():
                np.testing.assert_allclose(np.array(rank_out[compress][k]),
                                           np.array(v), rtol=1e-6, atol=0)


def _numpy_sync(per_rank, compress):
    """The reference's formula in numpy: rank r = (pod r // 2, data r % 2);
    a leaf whose leading dim 2 divides is summed over data in f32, each
    pod's data-shard quantized alone (with compress) and the int8 values
    summed in int32 over pods times the mean scale; others summed in
    f32 over all."""
    from repro_torch.parallel.sharding import _flatten
    flat = [_flatten(g) for g in per_rank]
    out = {}
    for k in flat[0]:
        pods = [flat[0][k] + flat[1][k], flat[2][k] + flat[3][k]]
        if flat[0][k].shape[0] % 2 or not compress:
            out[k] = pods[0] + pods[1]
            continue
        shards = []
        for half in np.split(np.arange(flat[0][k].shape[0]), 2):
            qs, scales = [], []
            for pod in pods:
                x = pod[half].astype(np.float32)
                scale = np.float32(max(np.abs(x).max(), 1e-12) / 127.0)
                qs.append(np.clip(np.round(x / scale), -127, 127
                                  ).astype(np.int32))
                scales.append(scale)
            shards.append(((qs[0] + qs[1]).astype(np.float32)
                           * np.float32((scales[0] + scales[1]) / 2.0)))
        out[k] = np.concatenate(shards)
    return out


def test_hierarchical_grad_sync_with_different_grads(tmp_path):
    """Each rank's own grads, against the numpy restatement."""
    got = spawn(tmp_path, 4, _rank_sync, True)
    per_rank = [_sync_grads(r) for r in range(4)]
    for compress in (False, True):
        want = _numpy_sync(per_rank, compress)
        for rank_out in got:
            for k, v in want.items():
                np.testing.assert_allclose(np.array(rank_out[str(compress)][k]),
                                           v, rtol=1e-6, atol=1e-6)


# ---------------------------------------------------------------------------
# Checkpoints across meshes, and the launcher
# ---------------------------------------------------------------------------


def _rank_save(rank, world, mesh_shape, ckpt_dir):
    """One sharded step at ``mesh_shape`` (so the moments are not zero),
    then a checkpoint of params and AdamW state."""
    from torch.distributed.device_mesh import init_device_mesh

    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.config import OptimizerConfig
    from repro_torch.convert import opt_state_to_tree, params_to_tree
    from repro_torch.parallel import ShardingRules
    from repro_torch.steps import init_train_state, make_train_step

    cfg = _smoke("qwen3-0.6b", dtype="bfloat16")
    mesh = init_device_mesh("cpu", tuple(mesh_shape),
                            mesh_dim_names=("data", "model"))
    params, opt = init_train_state(cfg, torch.Generator().manual_seed(0),
                                   "cpu")
    rules = ShardingRules(cfg, mesh)
    rules.distribute_params(params)
    opt = rules.distribute_opt(opt, params)
    step = make_train_step(cfg, OptimizerConfig(lr=1e-3), rules)
    params, opt, _ = step(params, opt, _batch(cfg, 8, 32), 0)
    mgr = CheckpointManager(ckpt_dir, keep=2, async_save=False)
    mgr.save(1, {"params": params_to_tree(params),
                 "opt": opt_state_to_tree(opt, params)},
             extra={"next_batch": 1})
    return {"written": sorted(os.listdir(ckpt_dir))}


def _rank_restore(rank, world, mesh_shape, ckpt_dir):
    """Restore onto ``mesh_shape`` through ``restore(shardings=)``; returns
    the gathered state, bf16 widened to f32, as lists."""
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor import DTensor

    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.convert import (load_numpy_, opt_state_from_numpy,
                                     opt_state_to_numpy, params_to_numpy)
    from repro_torch.models.transformer import Transformer
    from repro_torch.optim import adamw_init
    from repro_torch.parallel import ShardingRules
    from repro_torch.parallel.sharding import _flatten

    cfg = _smoke("qwen3-0.6b", dtype="bfloat16")
    mesh = init_device_mesh("cpu", tuple(mesh_shape),
                            mesh_dim_names=("data", "model"))
    rules = ShardingRules(cfg, mesh)
    params = Transformer(cfg, "cpu")      # every leaf comes from the restore
    rules.distribute_params(params)
    opt = rules.distribute_opt(adamw_init(params), params)
    mgr = CheckpointManager(ckpt_dir, keep=2, async_save=False)
    step, state, extra = mgr.restore(shardings={
        "params": rules.param_shardings(params),
        "opt": rules.opt_shardings(params)})
    load_numpy_(params, state["params"])
    opt = opt_state_from_numpy(state["opt"], params)
    placed = all(isinstance(p, DTensor) and list(p.placements) == pl
                 for (n, p), pl in zip(params.named_parameters(),
                                       rules.param_placements(params).values()))
    placed &= all(list(opt["m"][n].placements) == pl for n, pl in
                  rules.opt_placements(params).items())
    flat = _flatten({"params": params_to_numpy(params),
                     "opt": opt_state_to_numpy(opt, params)})
    return {"step": step, "extra": extra, "placed": placed,
            "state": {k: np.asarray(v).tolist() for k, v in flat.items()}}


def test_checkpoint_restores_across_meshes_bit_equal(tmp_path):
    """Saved at (2, 2) after a sharded bf16 step; restored at (1, 4)
    through ``restore(shardings=)`` and in one process with no group:
    every leaf bit-equal to what was saved, each placed as the new mesh's
    rules say (the counterpart of
    ``tests/test_substrate.py::test_checkpoint_elastic_restore_resharded``)."""
    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.convert import (load_numpy_, opt_state_from_numpy,
                                     opt_state_to_numpy, params_to_numpy)
    from repro_torch.models.transformer import Transformer
    from repro_torch.parallel.sharding import _flatten

    ckpt = str(tmp_path / "ckpt")
    spawn(tmp_path, 4, _rank_save, (2, 2), ckpt)
    saved = np.load(Path(ckpt) / "step_0000000001" / "arrays.npz")
    want = {k.replace("__", "."): saved[k] for k in saved.files}
    got = spawn(tmp_path, 4, _rank_restore, (1, 4), ckpt)
    assert got["step"] == 1 and got["extra"] == {"next_batch": 1}
    assert got["placed"]
    assert want.keys() == got["state"].keys()
    for k, v in want.items():
        np.testing.assert_array_equal(np.asarray(got["state"][k], v.dtype),
                                      v, err_msg=k)
    # one device, no process group
    cfg = _smoke("qwen3-0.6b", dtype="bfloat16")
    step, state, _ = CheckpointManager(ckpt).restore()
    params = load_numpy_(Transformer(cfg, "cpu"), state["params"])
    opt = opt_state_from_numpy(state["opt"], params)
    flat = _flatten({"params": params_to_numpy(params),
                     "opt": opt_state_to_numpy(opt, params)})
    for k, v in want.items():
        np.testing.assert_array_equal(flat[k], v, err_msg=k)
    assert not any(np.all(v == 0) for k, v in want.items()
                   if k.startswith("opt.m."))


def _rank_launch(rank, world, ckpt_dir):
    """The launcher three times on one dir: 4 steps (saves at 2 and 4);
    again (resumes at 4, takes no step); with step 4 removed (resumes at
    2, takes steps 2 and 3)."""
    import shutil

    import torch.distributed as dist

    from repro_torch.launch import train
    argv = ["--arch", "qwen3-0.6b", "--smoke", "--device", "cpu",
            "--model-parallel", "2", "--steps", "4", "--ckpt-every", "2",
            "--batch", "4", "--seq", "32", "--ckpt-dir", ckpt_dir]
    first = train.main(argv)
    second = train.main(argv)
    dist.barrier()
    if rank == 0:
        shutil.rmtree(Path(ckpt_dir) / "step_0000000004")
    dist.barrier()
    third = train.main(argv)
    return {"first": first, "second": second, "third": third,
            "ckpts": sorted(os.listdir(ckpt_dir))}


def test_launcher_resumes_under_four_ranks(tmp_path):
    """``launch/train.py`` under 4 gloo ranks at --model-parallel 2 (mesh
    (2, 2)): the second run resumes at next_batch 4 and only re-saves; the
    third, from the step-2 checkpoint, repeats steps 2 and 3 exactly."""
    out = spawn(tmp_path, 4, _rank_launch, str(tmp_path / "ckpt"))
    assert len(out["first"]) == 4 and np.all(np.isfinite(out["first"]))
    assert out["second"] == []
    assert out["third"] == out["first"][2:]
    assert out["ckpts"] == ["step_0000000002", "step_0000000004"]
