"""End-to-end driver: train the reference's "~100M-param" qwen3-family
model (12 layers, 32k vocab: 255.9M by ``param_count``) with the full
production stack on one device (the card by default):

  sharded train step (ShardingRules on a one-rank host mesh) -> AdamW +
  cosine -> GCR-locked prefetch pipeline -> async atomic checkpoints ->
  kill/restore demo (fault tolerance) -> straggler monitor fed with
  per-step timings.

The port of ``examples/train_100m.py``.  Run:

    PYTHONPATH=src python -m repro_torch.examples.train_100m --steps 60
    (full 100M config; --small --device cpu for a seconds-long demo)

The training losses are of different random batches, so the closing
check holds one batch no step trains on (the one after the last step's)
and requires its loss to fall between the first step and the end.
Every step prints its loss, its wall time (ended by a synchronise on the
card), the peak device memory of the step (``n/a`` on the CPU) and the
flash kernel's launches in it (0 on the CPU, where the plain version
runs).  Weights come from a seeded ``torch.Generator``.
"""

import argparse
import dataclasses
import os
import shutil
import tempfile
import time

import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor
from torch.distributed.tensor.experimental import implicit_replication

from ..checkpoint import CheckpointManager
from ..config import OptimizerConfig
from ..configs import get_config
from ..convert import (load_numpy_, opt_state_from_numpy, opt_state_to_tree,
                       params_to_tree)
from ..data import PrefetchPipeline, SyntheticTokens
from ..kernels.flash_attention import ops as flash_ops
from ..launch.mesh import make_host_mesh
from ..launch.train import init_distributed
from ..models import forward_train
from ..parallel import ShardingRules
from ..runtime import StragglerMitigator
from ..steps import init_train_state, make_train_step

# the full run's batch x sequence: the flash kernel's B and S on this path
FULL_BATCH = (8, 512)


def build(arch_cfg, steps: int, device):
    mesh = make_host_mesh(model=1)
    rules = ShardingRules(arch_cfg, mesh)
    params, opt = init_train_state(
        arch_cfg, torch.Generator(device=device).manual_seed(0), device)
    rules.distribute_params(params)
    opt = rules.distribute_opt(opt, params)
    # the reference warms up over 20 of its 60 steps: a third of the run
    opt_cfg = OptimizerConfig(lr=3e-4, warmup_steps=max(1, steps // 3),
                              total_steps=steps)
    step = make_train_step(arch_cfg, opt_cfg, rules)
    return params, opt, step, rules


@torch.no_grad()
def held_loss(cfg, params, rules, batch, device) -> float:
    """The loss of ``batch`` under ``params``, no update."""
    batch = {k: torch.from_numpy(v).to(device) for k, v in batch.items()}
    with implicit_replication():
        loss, _ = forward_train(cfg, params, rules.shard_batch(batch),
                                sc=rules.constrain)
    return float(loss.full_tensor() if isinstance(loss, DTensor) else loss)


def timed_step(step, params, opt, batch, i, device):
    """One step: returns (params, opt, loss, wall ms, peak GB or None,
    flash launches)."""
    batch = {k: torch.from_numpy(v).to(device) for k, v in batch.items()}
    cuda = device.type == "cuda"
    if cuda:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    before = flash_ops.launches
    t0 = time.perf_counter()
    params, opt, metrics = step(params, opt, batch, i)
    loss = float(metrics["loss"])      # waits for the step
    if cuda:
        torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) * 1e3
    peak = torch.cuda.max_memory_allocated() / 1e9 if cuda else None
    return params, opt, loss, wall, peak, flash_ops.launches - before


def report(i, loss, wall, peak, flash, tag="") -> None:
    mem = f"{peak:.2f} GB" if peak is not None else "n/a"
    print(f"step {i + 1:4d} loss {loss:.4f} wall {wall:.1f} ms peak {mem} "
          f"flash {flash}{tag}")


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=60)
    ap.add_argument("--small", action="store_true",
                    help="tiny config (CI-speed demo)")
    ap.add_argument("--ckpt-dir", default=os.path.join(
        tempfile.gettempdir(), "repro_torch_train100m"))
    ap.add_argument("--device", default=None,
                    help="cuda (default) or cpu; cuda raises if absent")
    args = ap.parse_args(argv)

    device = init_distributed(args.device)
    base = get_config("qwen3-0.6b")
    if args.small:
        cfg = dataclasses.replace(base, n_layers=2, d_model=128, n_heads=4,
                                  n_kv_heads=2, d_ff=256, d_head=32,
                                  vocab_size=2048)
        B, S = 8, 64
    else:
        # the reference's "~100M" shape: 12 layers of the qwen3-0.6b shape
        # and a 32k vocab, which param_count puts at 255.9M
        cfg = dataclasses.replace(base, n_layers=12, vocab_size=32768)
        B, S = FULL_BATCH

    n_params = cfg.param_count()
    print(f"model: {cfg.name}-derived, {n_params/1e6:.1f}M params; "
          f"batch {B}x{S} on {device} ({dist.get_world_size()} rank)")

    shutil.rmtree(args.ckpt_dir, ignore_errors=True)
    mgr = CheckpointManager(args.ckpt_dir, keep=2, async_save=True)
    src = SyntheticTokens(cfg, seq_len=S, global_batch=B, seed=0)
    pipe = PrefetchPipeline(src, depth=4, workers=2, use_gcr=True)
    params, opt, step, rules = build(cfg, args.steps, device)
    straggler = StragglerMitigator(list(range(4)), spares=[99])
    held = src.global_batch_at(args.steps)
    held_before = held_loss(cfg, params, rules, held, device)

    half = args.steps // 2
    losses = []
    try:
        for i, batch in iter(pipe):
            if i >= half:
                break
            params, opt, loss, wall, peak, flash = timed_step(
                step, params, opt, batch, i, device)
            losses.append(loss)
            dt = wall / 1e3
            straggler.observe({w: dt * (1 + 0.05 * w) for w in range(4)})
            report(i, loss, wall, peak, flash)
    finally:
        pipe.stop()
    mgr.save(half, {"params": params_to_tree(params),
                    "opt": opt_state_to_tree(opt, params)},
             extra={"next_batch": half})
    mgr.wait()
    print(f"-- simulated failure at step {half}: restoring from "
          f"checkpoint and resuming --")

    # fresh process would do exactly this:
    del params, opt
    params2, opt2, step, rules = build(cfg, args.steps, device)
    _, state, extra = mgr.restore(shardings={
        "params": rules.param_shardings(params2),
        "opt": rules.opt_shardings(params2)})
    load_numpy_(params2, state["params"])
    opt2 = opt_state_from_numpy(state["opt"], params2)
    del state
    print(f"resumed at next_batch {extra['next_batch']}")
    pipe2 = PrefetchPipeline.restore(src, extra["next_batch"], workers=2)
    try:
        for i, batch in iter(pipe2):
            if i >= args.steps:
                break
            params2, opt2, loss, wall, peak, flash = timed_step(
                step, params2, opt2, batch, i, device)
            losses.append(loss)
            report(i, loss, wall, peak, flash, " (resumed)")
    finally:
        pipe2.stop()

    held_after = held_loss(cfg, params2, rules, held, device)
    if not held_after < held_before:
        raise RuntimeError(f"loss did not improve: held batch "
                           f"{held_before:.4f} -> {held_after:.4f}")
    print(f"done: loss {losses[0]:.4f} -> {losses[-1]:.4f}, held batch "
          f"{held_before:.4f} -> {held_after:.4f}; "
          f"straggler demotions: {straggler.demoted}")
    dist.destroy_process_group()


if __name__ == "__main__":
    main()
