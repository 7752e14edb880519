"""Training launcher: ``python -m repro_torch.launch.train --arch <id>
[--smoke] [--device cuda|cpu] [...]``.

The reference launcher's loop: a GCR-locked prefetch pipeline feeds the
sharded train step (AdamW, each block recomputed in the backward pass,
optional microbatching), the loss is printed every 10 steps, async atomic
checkpoints are written every ``--ckpt-every`` steps and at the end, and
a run resumes from the newest checkpoint in ``--ckpt-dir`` at its
``next_batch``, placed on the current mesh (which may differ from the one
that wrote it).  Without ``--device`` it runs on CUDA and raises where
there is none.

The process group comes from ``torchrun``'s environment (``WORLD_SIZE``,
``RANK``, ``LOCAL_RANK``, ``MASTER_ADDR``, ``MASTER_PORT``): NCCL with one
card a rank (``cuda:LOCAL_RANK``), gloo with ``--device cpu``.  Without
that environment the launcher starts a group of one process (an
in-memory store, no network): the counterpart of the
reference's ``jax.distributed.initialize`` under ``TPU_WORKER_ID``.  The
mesh is ``make_host_mesh(--model-parallel)`` over every rank, or the
(16, 16) production mesh with ``--production-mesh``; ``ShardingRules``
place the parameters and (ZeRO-1) moments as the reference does.  Every
rank draws the same weights and reads the same global batch; only rank 0
prints and writes checkpoints.

    torchrun --nproc-per-node=<cards> -m repro_torch.launch.train \
        --arch qwen3-0.6b --model-parallel 2

``--arch`` takes all ten archs: dense (qwen3-0.6b, qwen3-8b,
deepseek-7b, internlm2-20b), MoE with GCR-MoE admission
(granite-moe-1b-a400m, mixtral-8x7b), Mamba2 with a shared attention
block (zamba2-2.7b), RWKV6 (rwkv6-7b), the encoder-decoder whisper-base
(the pipeline's f32 frames feed its encoder) and internvl2-2b (the
pipeline's f32 patches come before the tokens; ``--seq`` counts them).
"""

from __future__ import annotations

import argparse
import os
import tempfile
import time
from typing import List, Optional, Sequence

import torch
import torch.distributed as dist

from .. import resolve_device
from ..checkpoint import CheckpointManager
from ..config import OptimizerConfig
from ..configs import PORTED, get_config, get_smoke_config
from ..convert import (load_numpy_, opt_state_from_numpy, opt_state_to_tree,
                       params_to_tree)
from ..data import PrefetchPipeline, SyntheticTokens
from ..parallel import ShardingRules
from ..steps import init_train_state, make_train_step
from .mesh import make_host_mesh, make_production_mesh


def init_distributed(device_arg: Optional[str]) -> torch.device:
    """Start the process group (module docstring) unless one is started;
    returns this rank's device."""
    device = resolve_device(device_arg)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", int(os.environ.get("LOCAL_RANK", 0)))
    if device.type == "cuda":
        torch.cuda.set_device(device)
    if dist.is_initialized():
        return device
    backend = "nccl" if device.type == "cuda" else "gloo"
    if "WORLD_SIZE" in os.environ:
        dist.init_process_group(backend, device_id=(
            device if device.type == "cuda" else None))
    else:
        dist.init_process_group(backend, store=dist.HashStore(), rank=0,
                                world_size=1)
    return device


def main(argv: Optional[Sequence[str]] = None) -> List[float]:
    """Runs the loop; returns the loss of each step this run took, in
    order."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True, choices=sorted(PORTED))
    ap.add_argument("--smoke", action="store_true",
                    help="use the reduced config (CPU-friendly)")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--model-parallel", type=int, default=1)
    ap.add_argument("--production-mesh", action="store_true",
                    help="use the 16x16 production mesh (256 ranks)")
    ap.add_argument("--ckpt-dir", default="")
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="cuda (default) or cpu; cuda raises if absent")
    args = ap.parse_args(argv)

    device = init_distributed(args.device)
    main_rank = dist.get_rank() == 0
    say = print if main_rank else (lambda *a, **k: None)
    cfg = get_smoke_config(args.arch) if args.smoke else get_config(args.arch)

    mesh = (make_production_mesh() if args.production_mesh
            else make_host_mesh(model=args.model_parallel))
    rules = ShardingRules(cfg, mesh)
    params, opt = init_train_state(
        cfg, torch.Generator(device=device).manual_seed(args.seed), device)
    n_params = sum(p.numel() for p in params.parameters())
    rules.distribute_params(params)
    opt = rules.distribute_opt(opt, params)
    say(f"arch={cfg.name} params={n_params / 1e6:.1f}M device={device} "
        f"mesh={rules.mesh_shape} ranks={dist.get_world_size()}")

    opt_cfg = OptimizerConfig(lr=args.lr, warmup_steps=max(args.steps // 10, 1),
                              total_steps=args.steps)
    step_fn = make_train_step(cfg, opt_cfg, rules,
                              microbatches=args.microbatches)

    ckpt_dir = args.ckpt_dir or os.path.join(tempfile.gettempdir(),
                                             f"repro_torch_{cfg.name}")
    mgr = CheckpointManager(ckpt_dir, keep=2, async_save=True)
    start = 0
    if mgr.latest_step() is not None:
        step, state, extra = mgr.restore(shardings={
            "params": rules.param_shardings(params),
            "opt": rules.opt_shardings(params)})
        load_numpy_(params, state["params"])
        opt = opt_state_from_numpy(state["opt"], params)
        start = int(extra.get("next_batch", step))
        say(f"resumed from step {step} at next_batch {start}")

    def train_state():
        return {"params": params_to_tree(params),
                "opt": opt_state_to_tree(opt, params)}

    src = SyntheticTokens(cfg, seq_len=args.seq, global_batch=args.batch,
                          seed=args.seed)
    pipe = PrefetchPipeline(src, depth=4, workers=2, start_at=start,
                            use_gcr=True)
    losses = []
    t0 = time.perf_counter()
    tokens_done = 0
    try:
        for i, batch in iter(pipe):
            if i >= args.steps:
                break
            batch = {k: torch.from_numpy(v).to(device)
                     for k, v in batch.items()}
            params, opt, metrics = step_fn(params, opt, batch, i)
            losses.append(metrics["loss"])
            tokens_done += args.batch * args.seq
            if (i + 1) % 10 == 0:
                dt = time.perf_counter() - t0
                say(f"step {i+1:5d} loss {float(metrics['loss']):.4f} "
                      f"lr {float(metrics['lr']):.2e} "
                      f"{tokens_done/dt:,.0f} tok/s")
            if (i + 1) % args.ckpt_every == 0:
                mgr.save(i + 1, train_state(), extra={"next_batch": i + 1})
    finally:
        pipe.stop()
        mgr.wait()   # a stopped run still publishes the save it started
    mgr.save(args.steps, train_state(), extra={"next_batch": args.steps})
    mgr.wait()
    say(f"done; checkpoints in {ckpt_dir}")
    return [float(loss) for loss in losses]


if __name__ == "__main__":
    main()
