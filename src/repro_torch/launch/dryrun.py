"""Multi-pod dry run: trace every (architecture x input-shape) cell on the
production meshes, on meta tensors, and extract the roofline inputs: the
port of ``repro.launch.dryrun``.

Run as ``python -m repro_torch.launch.dryrun`` on any host: no card, no
network.  It starts the ``fake`` process group (rank 0 of 256, or of 512
with ``--multi-pod``), builds the (16, 16) or (2, 16, 16) mesh over it
(``launch.mesh.make_production_mesh``, device type ``cpu``), places meta
params, optimizer state, batch and caches by ``ShardingRules`` and runs
one train, prefill or decode step through ``steps`` with the kernels on
(``impl="auto"``): a meta tensor reaches each kernel op's shape function,
so the program traced is the one the card runs.  Collectives on the fake
group move nothing; the counter (``launch.cost_analysis.CostCounter``)
reads what rank 0 computes, moves and holds.

Per cell it writes ``experiments/dryrun_torch/<mesh>/<arch>__<shape>.json``
with the reference's record fields, the XLA-specific ones renamed:
``hlo_flops`` -> ``flops``, ``hlo_bytes`` -> ``bytes``, ``compile_s`` ->
``trace_s``; there is no ``xla_cost_analysis``.  It adds
``collectives_by_dim`` (each mesh dim's, or ``world``'s, collectives),
``links`` (``nvlink`` or ``network`` a dim), ``kernels`` (each kernel op's
calls, FLOPs and bytes), ``hardware`` and ``fits`` (peak <= the card's
80 GB).  The roofline terms are against ``config.H100``: FLOPs over the
bf16 peak, bytes over HBM's rate, and each collective's bytes over NVLink
where its group fits in one 8-GPU node, else over the network link.

Usage:
  python -m repro_torch.launch.dryrun --arch qwen3-0.6b --shape train_4k
  python -m repro_torch.launch.dryrun --all [--multi-pod] [--skip-existing]
"""

from __future__ import annotations

import argparse
import json
import logging
import time
import traceback
from pathlib import Path
from typing import Optional

import torch
import torch.distributed as dist

from ..config import H100, SHAPES, ModelConfig, OptimizerConfig, cells_for
from ..configs import ARCHS, get_config
from ..parallel import ShardingRules
from ..steps import (batch_shapes, decode_state_shapes, make_decode_step,
                     make_prefill, make_train_step, train_state_shapes)
from .cost_analysis import CostCounter
from .mesh import make_production_mesh

OUT_DIR = Path(__file__).resolve().parents[3] / "experiments" / "dryrun_torch"

# Per-cell perf overrides, the reference's (its EXPERIMENTS.md section
# Perf): mixtral train exceeds HBM at 1 microbatch; 4-way gradient
# accumulation divides the activation working set, accumulated in bf16.
PERF_OVERRIDES = {
    ("mixtral-8x7b", "train_4k"): {"microbatches": 4,
                                   "accum_dtype": "bfloat16"},
}


def start_fake_group(multi_pod: bool) -> None:
    """Rank 0 of a ``fake`` group of 256 (512 with ``multi_pod``) ranks, if
    no group is started."""
    if not dist.is_initialized():
        # importing it registers the backend
        from torch.testing._internal.distributed.fake_pg import FakeStore
        dist.init_process_group("fake", store=FakeStore(), rank=0,
                                world_size=512 if multi_pod else 256)


def mesh_tag(multi_pod: bool) -> str:
    return "2x16x16" if multi_pod else "16x16"


def run_cell(arch: str, shape_name: str, multi_pod: bool, out_dir: Path,
             cfg: Optional[ModelConfig] = None) -> dict:
    """One cell: trace its step under the counter and write its record.
    ``cfg`` replaces the arch's config (the tests' smoke widths); the fake
    group must be started with the mesh's world size."""
    cfg = cfg or get_config(arch)
    shape = SHAPES[shape_name]
    start_fake_group(multi_pod)
    mesh = make_production_mesh(multi_pod=multi_pod)
    chips = mesh.size()
    rules = ShardingRules(cfg, mesh, shape)
    t0 = time.time()

    params, opt = train_state_shapes(cfg)
    # the global batch, as the launcher hands it to the step, which splits
    # it (over microbatches, then over dp)
    batch = batch_shapes(cfg, shape)
    if shape.kind == "train":
        params.requires_grad_(True)
        rules.distribute_params(params)
        opt = rules.distribute_opt(opt, params)
        over = PERF_OVERRIDES.get((arch, shape_name), {})
        step_fn = make_train_step(
            cfg, OptimizerConfig(), rules,
            microbatches=over.get("microbatches", 1),
            accum_dtype=getattr(torch, over.get("accum_dtype", "float32")))
        args = (params, opt, batch, 0)
    elif shape.kind == "prefill":
        del opt
        rules.distribute_params(params)
        step_fn = make_prefill(cfg, max_len=shape.seq_len, rules=rules)
        args = (params, batch)
    else:  # decode
        del opt
        rules.distribute_params(params)
        caches = rules.place_cache(decode_state_shapes(cfg, shape), "meta")
        step_fn = make_decode_step(cfg, rules)
        args = (params, caches, batch["tokens"])

    counter = CostCounter(mesh)
    counter.add_arguments(*args)
    with counter:
        out = step_fn(*args)
    mem = counter.memory()
    del out, args

    # Per-device quantities (rank 0's program)
    flops = float(counter.flops)
    hbm = float(counter.bytes)
    coll_total = float(counter.collective_bytes)

    # MODEL_FLOPS: 6 N D for train, 2 N D for inference forward (global)
    n_active = cfg.active_param_count()
    if shape.kind == "train":
        tokens = shape.global_batch * shape.seq_len
        model_flops = 6.0 * n_active * tokens
    elif shape.kind == "prefill":
        tokens = shape.global_batch * shape.seq_len
        model_flops = 2.0 * n_active * tokens
    else:
        tokens = shape.global_batch  # one token per sequence
        model_flops = 2.0 * n_active * tokens

    terms = {
        "compute_s": flops / H100.peak_flops,
        "memory_s": hbm / H100.hbm_bw,
        "collective_s": counter.collective_seconds(),
    }
    dominant = max(terms, key=terms.get)

    rec = {
        "arch": arch,
        "shape": shape_name,
        "kind": shape.kind,
        "mesh": mesh_tag(multi_pod),
        "chips": chips,
        "hardware": H100.name,
        "trace_s": round(time.time() - t0, 1),
        "memory": mem,
        "fits": mem["peak_bytes"] <= H100.hbm_bytes,
        "flops": flops,
        "bytes": hbm,
        "collectives": counter.collectives,
        "collectives_by_dim": counter.by_dim,
        "links": {k: counter.links[k] for k in counter.by_dim
                  if k in counter.links},
        "collective_bytes": coll_total,
        "kernels": counter.kernels,
        "model_flops": model_flops,
        "model_flops_per_chip": model_flops / chips,
        "useful_flops_ratio": (model_flops / chips) / flops if flops else None,
        "roofline": terms,
        "dominant": dominant,
        "params": cfg.param_count(),
        "active_params": n_active,
    }

    out_dir.mkdir(parents=True, exist_ok=True)
    path = out_dir / f"{arch}__{shape_name}.json"
    path.write_text(json.dumps(rec, indent=1))
    return rec


def all_cells():
    for arch in ARCHS:
        cfg = get_config(arch)
        for shape in cells_for(cfg):
            yield arch, shape.name


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch")
    ap.add_argument("--shape")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--skip-existing", action="store_true")
    ap.add_argument("--out-dir", type=Path, default=OUT_DIR,
                    help="records go to OUT_DIR/<mesh>/ (default "
                         "experiments/dryrun_torch)")
    args = ap.parse_args(argv)
    if not args.all and not (args.arch and args.shape):
        ap.error("give --arch and --shape, or --all")
    # DTensor warns once for every sequential two-dim reduction it plans
    logging.getLogger("torch.distributed.tensor._redistribute").setLevel(
        logging.ERROR)

    tag = mesh_tag(args.multi_pod)
    out_dir = args.out_dir / tag
    start_fake_group(args.multi_pod)

    cells = (list(all_cells()) if args.all
             else [(args.arch, args.shape)])
    failures = []
    for arch, shape in cells:
        path = out_dir / f"{arch}__{shape}.json"
        if args.skip_existing and path.exists():
            print(f"skip {arch}/{shape} (exists)")
            continue
        try:
            rec = run_cell(arch, shape, args.multi_pod, out_dir)
            t = rec["roofline"]
            print(f"OK  {arch:22s} {shape:12s} mesh={tag} "
                  f"trace={rec['trace_s']:7.1f}s "
                  f"peak/dev={rec['memory']['peak_bytes'] / 1e9:7.2f}GB "
                  f"fits={rec['fits']!s:5s} "
                  f"comp={t['compute_s']:.3e}s mem={t['memory_s']:.3e}s "
                  f"coll={t['collective_s']:.3e}s dom={rec['dominant']}",
                  flush=True)
        except Exception as e:  # noqa: BLE001 - report and continue
            failures.append((arch, shape, repr(e)))
            print(f"FAIL {arch}/{shape}: {e}", flush=True)
            traceback.print_exc()
    if failures:
        print(f"\n{len(failures)} failures:")
        for f in failures:
            print("  ", f)
        raise SystemExit(1)
    print("\nall cells traced")


if __name__ == "__main__":
    main()
