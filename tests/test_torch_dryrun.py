"""The port's dry run (``repro_torch.launch.dryrun``) against the
reference's, on the CPU.

* The cell rules and the analytic counts (``layer_kinds``,
  ``subquadratic``, ``param_count``, ``active_param_count``,
  ``cells_for``) equal the reference's for all ten archs: exactly.
* The dry-run specs (``batch_shapes``, ``decode_state_shapes``,
  ``train_state_shapes``) equal the reference's ``ShapeDtypeStruct``s
  leaf for leaf, shape and dtype, for every arch and cell, the port's
  leaves laid out as ``convert`` lays them out: exactly.
* Each kernel op on meta tensors gives its plain version's output shapes
  and dtypes (exactly), and its ``work()`` equals the counts PERF.md
  prints for the timed shapes (to the printed 0.01 GFLOP and 0.01 MB).
* The fake-group parts run in subprocesses, all at once (one a mesh,
  and one each for the (2, 16, 16) train cells of zamba2 and rwkv6):
  the counter reads local work (a sharded matmul's FLOPs, an
  all-gather's and an all-to-all's bytes, exactly), the uneven head
  split that raised in a
  plain reshape runs, and ``run_cell`` at smoke width writes a full
  record for each kind (attn, moe, mamba2, rwkv6, whisper) in train,
  prefill and decode on (16, 16) and (2, 16, 16), ``model_flops``
  equal to the reference's formula (exactly); full-width qwen3-0.6b
  ``train_4k`` on (16, 16) reads its per-device FLOPs within 5% of a
  hand count.
* The bf16 accumulation override (4 microbatches, gradients summed in
  bf16) against the reference's, after one step: loss and every
  parameter within 8 bf16 ulps at the value's scale, the tolerance of
  tests/test_torch_bf16.py; and, with f32 weights, each leaf's first
  moment within a relative L2 error of 2^-11, which the same step with
  the gradients summed in f32 misses on every leaf.
"""

import dataclasses
import json
import math
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from repro import steps as jsteps  # noqa: E402
from repro.config import SHAPES as JSHAPES  # noqa: E402
from repro.config import OptimizerConfig as JOptimizerConfig  # noqa: E402
from repro.config import cells_for as jcells_for  # noqa: E402
from repro.configs import get_config as jget_config  # noqa: E402
from repro.configs import get_smoke_config as jget_smoke  # noqa: E402
from repro.models import init_params as jinit_params  # noqa: E402
from repro.optim import adamw_init as jadamw_init  # noqa: E402
from repro_torch import steps  # noqa: E402
from repro_torch.config import SHAPES, OptimizerConfig, cells_for  # noqa: E402
from repro_torch.configs import ARCHS, get_config, get_smoke_config  # noqa: E402
from repro_torch.convert import (opt_state_to_numpy,  # noqa: E402
                                 opt_state_to_tree, params_from_numpy,
                                 params_to_numpy, params_to_tree)
from repro_torch.kernels.flash_attention import ops as fa  # noqa: E402
from repro_torch.kernels.mamba2_ssd import ops as sd  # noqa: E402
from repro_torch.kernels.moe_gmm import ops as gm  # noqa: E402
from repro_torch.kernels.rwkv6_wkv import ops as wk  # noqa: E402
from repro_torch.optim import adamw_init  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
CELLS = [(arch, s.name) for arch in ARCHS for s in cells_for(get_config(arch))]


# ---------------------------------------------------------------------------
# Config functions and shape functions
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", ARCHS)
def test_config_functions_match_reference(arch):
    cfg, ref = get_config(arch), jget_config(arch)
    assert cfg.layer_kinds() == ref.layer_kinds()
    assert cfg.subquadratic == ref.subquadratic
    assert cfg.param_count() == ref.param_count()
    assert cfg.active_param_count() == ref.active_param_count()
    assert ([dataclasses.asdict(s) for s in cells_for(cfg)]
            == [dataclasses.asdict(s) for s in jcells_for(ref)])


def test_the_cells_are_the_references_33():
    assert len(CELLS) == 33
    assert CELLS == [(a, s.name) for a in ARCHS
                     for s in jcells_for(jget_config(a))]


def _flat(tree, prefix=""):
    out = {}
    for key, val in tree.items():
        if isinstance(val, dict):
            out.update(_flat(val, f"{prefix}{key}."))
        else:
            out[f"{prefix}{key}"] = val
    return out


def _sig(leaf):
    """(shape, dtype name) of a meta tensor, a ShapeDtypeStruct or the
    port's integer cache position."""
    if isinstance(leaf, int):
        return ((), "int32")
    dtype = str(leaf.dtype).replace("torch.", "")
    return tuple(leaf.shape), dtype


def _ref_sigs(tree):
    return {k: _sig(v) for k, v in _flat(jax.tree.map(
        lambda s: s, tree, is_leaf=lambda x: isinstance(
            x, jax.ShapeDtypeStruct))).items()}


def _stack_cache(cache):
    """The port's cache (one dict a layer) in the reference's stacked
    layout, as (shape, dtype)."""
    def stack(items):
        return {k: stack([it[k] for it in items]) if isinstance(v, dict)
                else ((len(items),) + tuple(v.shape),
                      str(v.dtype).replace("torch.", ""))
                for k, v in items[0].items()}
    out = {"pos": _sig(cache["pos"])}
    for part in ("layers", "shared", "cross"):
        if part in cache:
            out[part] = stack(cache[part])
    return _flat(out)


@pytest.mark.parametrize("arch,shape", CELLS)
def test_shape_functions_match_reference(arch, shape):
    cfg, ref = get_config(arch), jget_config(arch)
    batch = steps.batch_shapes(cfg, SHAPES[shape])
    assert all(t.device.type == "meta" for t in batch.values())
    assert ({k: _sig(v) for k, v in batch.items()}
            == _ref_sigs(jsteps.batch_shapes(ref, JSHAPES[shape])))
    if SHAPES[shape].kind == "decode":
        got = _stack_cache(steps.decode_state_shapes(cfg, SHAPES[shape]))
        want = _ref_sigs(jsteps.decode_state_shapes(ref, JSHAPES[shape]))
        assert got == want
        return
    params, opt = steps.train_state_shapes(cfg)
    jparams, jopt = jsteps.train_state_shapes(ref)
    assert ({k: _sig(v) for k, v in _flat(params_to_tree(params)).items()}
            == _ref_sigs(jparams))
    assert ({k: _sig(v) for k, v in _flat(opt_state_to_tree(opt, params))
             .items()} == _ref_sigs(jopt))
    assert all(p.device.type == "meta" for p in params.parameters())


# ---------------------------------------------------------------------------
# Kernel ops on meta tensors, and their work counts
# ---------------------------------------------------------------------------


def _kernel_case(name, device):
    g = torch.Generator().manual_seed(0)

    def t(*shape, dtype=torch.bfloat16):
        x = torch.randn(shape, generator=g).to(dtype)
        return x.to(device)

    if name == "flash":
        q, k = t(2, 64, 4, 32), t(2, 64, 2, 32)
        pos = torch.arange(64, dtype=torch.int32).to(device)
        return fa.flash_attention_fwd(q, k, k, pos, pos, return_lse=True)
    if name == "gmm":
        return (gm.grouped_matmul(t(2, 4, 8, 16), t(4, 16, 24)),)
    if name == "ssd":
        a = -t(2, 64, 3, dtype=torch.float32).abs()
        return sd.ssd(t(2, 64, 3, 16), a, t(2, 64, 16), t(2, 64, 16),
                      t(2, 3, 16, 16, dtype=torch.float32))
    w = torch.sigmoid(t(2, 32, 2, 16, dtype=torch.float32))
    return wk.wkv(t(2, 32, 2, 16), t(2, 32, 2, 16), t(2, 32, 2, 16), w,
                  t(2, 16, dtype=torch.float32),
                  t(2, 2, 16, 16, dtype=torch.float32))


@pytest.mark.parametrize("name", ["flash", "gmm", "ssd", "wkv"])
def test_kernel_op_on_meta_gives_the_plain_versions_outputs(name):
    plain = _kernel_case(name, "cpu")
    meta = _kernel_case(name, "meta")
    assert [(tuple(o.shape), o.dtype) for o in meta] == [
        (tuple(o.shape), o.dtype) for o in plain]
    assert all(o.device.type == "meta" for o in meta)


@pytest.mark.parametrize("name", ["flash_fwd", "gmm", "ssd", "wkv"])
def test_kernel_operator_passes_opcheck_on_meta(name):
    """Schema, fake implementation and autograd registration of each
    kernel operator (``torch.library.opcheck``; the card runs it on CUDA
    tensors in chip_smoke.py)."""
    bf, f32 = torch.bfloat16, torch.float32

    def t(*shape, dtype=bf):
        return torch.empty(shape, dtype=dtype, device="meta")

    pos = torch.empty(128, dtype=torch.int32, device="meta")
    args = {"flash_fwd": (t(2, 128, 4, 64), t(2, 128, 2, 64),
                          t(2, 128, 2, 64), pos, pos, 0, True, True),
            "gmm": (t(2, 4, 64, 64), t(4, 64, 64)),
            "ssd": (t(2, 128, 2, 64), t(2, 128, 2, dtype=f32),
                    t(2, 128, 64), t(2, 128, 64), None),
            "wkv": (t(2, 64, 2, 64), t(2, 64, 2, 64), t(2, 64, 2, 64),
                    t(2, 64, 2, 64, dtype=f32), t(2, 64, dtype=f32),
                    t(2, 2, 64, 64, dtype=f32))}[name]
    result = torch.library.opcheck(
        getattr(torch.ops.repro_torch, name).default, args)
    assert set(result.values()) == {"SUCCESS"}, result


# (work, GFLOP, MB) as PERF.md section 6 prints them for the timed shapes
WORK = [
    ("flash qwen3 D128", lambda: fa.work(3, 1024, 1024, 16, 8, 128),
     12.90, 37.76),
    ("flash granite D64", lambda: fa.work(3, 1024, 1024, 16, 8, 64),
     6.45, 18.88),
    ("flash zamba2 D80", lambda: fa.work(3, 1024, 1024, 32, 32, 80),
     16.12, 62.92),
    ("flash whisper encoder", lambda: fa.work(3, 512, 512, 8, 8, 64,
                                              causal=False), 1.61, 6.30),
    ("flash whisper cross", lambda: fa.work(3, 1024, 512, 8, 8, 64,
                                            causal=False), 3.22, 9.44),
    ("gmm prefill", lambda: gm.work(3, 32, 320, 1024, 512), 32.21, 127.93),
    ("gmm decode", lambda: gm.work(3, 32, 8, 1024, 512), 0.81, 35.91),
    ("ssd zamba2", lambda: sd.work(3, 1024, 80, 64, 64), 20.13, 68.62),
    ("wkv rwkv6", lambda: wk.work(3, 1024, 64, 64, init_state=True),
     4.03, 157.30),
]


@pytest.mark.parametrize("label,fn,gflop,mb", WORK,
                         ids=[w[0] for w in WORK])
def test_work_equals_the_timed_counts(label, fn, gflop, mb):
    flops, nbytes = fn()
    assert round(flops / 1e9, 2) == gflop
    assert round(nbytes / 1e6, 2) == mb


def test_flash_visible_pairs_count_the_bottom_right_mask():
    """Against the mask itself (positions as the model builds them)."""
    for S, T, window, causal in ((64, 64, 0, True), (32, 64, 0, True),
                                 (64, 64, 16, True), (48, 32, 0, False),
                                 (40, 64, 8, True)):
        q_pos = torch.arange(S) + T - S
        k_pos = torch.arange(T)
        mask = torch.ones(S, T, dtype=torch.bool)
        if causal:
            mask &= k_pos[None] <= q_pos[:, None]
            if window:
                mask &= (q_pos[:, None] - k_pos[None]) < window
        assert fa.visible_pairs(S, T, window, causal) == int(mask.sum())


# ---------------------------------------------------------------------------
# The fake process group: counter, uneven heads, run_cell
# ---------------------------------------------------------------------------

_FAKE = textwrap.dedent("""
    import json, logging, sys
    from pathlib import Path
    import torch
    logging.getLogger("torch.distributed.tensor._redistribute").setLevel(
        logging.ERROR)
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor
    from repro_torch.configs import get_smoke_config
    from repro_torch.launch import dryrun
    from repro_torch.launch.cost_analysis import CostCounter
    from repro_torch.launch.mesh import make_production_mesh
    from repro_torch.models.layers import merge_heads, split_heads

    multi, out_dir = sys.argv[1] == "1", Path(sys.argv[2])
    jobs = sys.argv[3].split(",")
    dryrun.start_fake_group(multi)
    mesh = make_production_mesh(multi_pod=multi)
    out = {"cells": {}}

    if "counter" in jobs:
        # a sharded matmul and a redistribute, counted locally
        a = distribute_tensor(torch.empty(4096, 1024, device="meta"), mesh,
                              [Shard(0), Replicate()], src_data_rank=None)
        b = distribute_tensor(torch.empty(1024, 4096, device="meta"), mesh,
                              [Replicate(), Shard(1)], src_data_rank=None)
        with CostCounter(mesh) as c:
            a @ b
        out["matmul"] = [c.flops, c.collectives]
        with CostCounter(mesh) as c:
            a.redistribute(mesh, [Replicate(), Replicate()])
        out["gather"] = [c.flops, c.collectives, c.by_dim]
        with CostCounter(mesh) as c:
            a.redistribute(mesh, [Shard(1), Replicate()])
        out["alltoall"] = [c.flops, c.collectives, c.by_dim]

    if "heads" in jobs:
        # 8 heads of 16 split over model (16): DTensor cannot reshape it
        x = distribute_tensor(torch.empty(4, 64, 128, device="meta"), mesh,
                              [Replicate()] * (mesh.ndim - 1) + [Shard(2)],
                              src_data_rank=None)
        try:
            x.reshape(4, 64, 8, 16)
            out["plain_reshape"] = "ran"
        except RuntimeError as e:
            out["plain_reshape"] = str(e)[:200]
        y = split_heads(x, 4, 64, 8, 16)
        out["split_heads"] = [list(y.shape),
                              [type(p).__name__ for p in y.placements]]
        # the backward of a flattening of heads: the gradient comes back
        # split over model, where the heads do not divide it
        h = distribute_tensor(torch.empty(4, 64, 8, 16, device="meta"), mesh,
                              [Replicate()] * mesh.ndim, src_data_rank=None)
        h.requires_grad_(True)
        w = distribute_tensor(torch.empty(4, 64, 128, device="meta"), mesh,
                              [Replicate()] * (mesh.ndim - 1) + [Shard(2)],
                              src_data_rank=None)
        for name, flat in (("reshape", lambda t: t.reshape(4, 64, 128)),
                           ("merge_heads",
                            lambda t: merge_heads(t, 4, 64, 128))):
            try:
                (flat(h) * w).sum().backward()
                out[name + "_backward"] = list(h.grad.shape)
            except RuntimeError as e:
                out[name + "_backward"] = str(e)[:200]
            h.grad = None

    for job in jobs:
        if "/" not in job:
            continue
        arch, shape = job.split("/")
        try:
            rec = dryrun.run_cell(arch, shape, multi, out_dir,
                                  cfg=get_smoke_config(arch))
            out["cells"][job] = rec
        except Exception as e:
            out["cells"][job] = {"error": repr(e)[:500]}
    if "full" in jobs:
        out["full"] = dryrun.run_cell("qwen3-0.6b", "train_4k", False,
                                      out_dir)
    print(json.dumps(out))
""")

KINDS = {"qwen3-0.6b": "flash_fwd", "granite-moe-1b-a400m": "gmm",
         "zamba2-2.7b": "ssd", "rwkv6-7b": "wkv", "whisper-base": "flash_fwd"}
STEPS = ("train_4k", "prefill_32k", "decode_32k")
# DTensor plans the redistributions of a (2, 16, 16) train step for a
# minute (qwen3's, whose plans the other attention kinds then reuse) to
# three (zamba2's and rwkv6's) on this CPU: those two run in processes of
# their own, beside the rest
_SLOW = ("zamba2-2.7b/train_4k", "rwkv6-7b/train_4k")
_JOBS = [
    ("0", ["counter", "heads", "full"]
     + [f"{a}/{s}" for a in KINDS for s in STEPS]),
    ("1", ["heads"] + [f"{a}/{s}" for a in KINDS for s in STEPS
                       if f"{a}/{s}" not in _SLOW]),
] + [("1", [job]) for job in _SLOW]
SMOKE_CELLS = [(m, a, s) for m in ("16x16", "2x16x16") for a in KINDS
               for s in STEPS]


@pytest.fixture(scope="module")
def fake_runs(tmp_path_factory):
    """The jobs in subprocesses under the fake group, all at once, each
    returning its results as the last line of its output; merged by
    mesh."""
    env = {"PYTHONPATH": str(ROOT / "src"), "PATH": os.environ["PATH"],
           "HOME": str(tmp_path_factory.mktemp("home"))}
    procs = []
    for multi, jobs in _JOBS:
        out = tmp_path_factory.mktemp(f"dryrun{multi}")
        procs.append((multi, subprocess.Popen(
            [sys.executable, "-c", _FAKE, multi, str(out), ",".join(jobs)],
            cwd=ROOT, env=env, stdout=subprocess.PIPE,
            stderr=subprocess.PIPE, text=True)))
    results = {"16x16": {"cells": {}}, "2x16x16": {"cells": {}}}
    for multi, proc in procs:
        stdout, stderr = proc.communicate(timeout=900)
        assert proc.returncode == 0, stderr[-4000:]
        got = json.loads(stdout.strip().splitlines()[-1])
        into = results["2x16x16" if multi == "1" else "16x16"]
        into["cells"].update(got.pop("cells"))
        into.update(got)
    return results


def test_counter_reads_local_flops_and_collectives(fake_runs):
    """(4096, 1024) [Shard(0), Replicate()] @ (1024, 4096) [Replicate(),
    Shard(1)] on (16, 16): each rank multiplies 256 rows by 256 columns
    and moves nothing; Shard(0) -> Replicate() over data is one
    all-gather of the whole f32 tensor on data; Shard(0) -> Shard(1) over
    data is one all-to-all of the local (256, 1024) f32 shard on data
    (which DTensor runs as an all-gather and a chunk on a cpu mesh)."""
    run = fake_runs["16x16"]
    flops, colls = run["matmul"]
    assert flops == 2 * 256 * 1024 * 256 and colls == {}
    flops, colls, by_dim = run["gather"]
    want = {"all-gather": {"count": 1, "bytes": 4096 * 1024 * 4}}
    assert flops == 0 and colls == want and by_dim == {"data": want}
    flops, colls, by_dim = run["alltoall"]
    want = {"all-to-all": {"count": 1, "bytes": 256 * 1024 * 4}}
    assert flops == 0 and colls == want and by_dim == {"data": want}


@pytest.mark.parametrize("mesh", ["16x16", "2x16x16"])
def test_uneven_head_split_raised_in_a_plain_reshape_and_runs(fake_runs,
                                                              mesh):
    """The fault the sharded zamba2 and rwkv6 steps hit (the width divides
    the model axis, the heads do not): DTensor refuses the plain reshape;
    ``split_heads`` gathers the width first, as the reference replicates a
    dim that does not divide."""
    run = fake_runs[mesh]
    assert "Cannot unflatten unevenly sharded tensor" in run["plain_reshape"]
    shape, placements = run["split_heads"]
    assert shape == [4, 64, 8, 16]
    assert placements == ["Replicate"] * len(placements)
    assert "Cannot unflatten" in run["reshape_backward"]
    assert run["merge_heads_backward"] == [4, 64, 8, 16]


FIELDS = ("arch", "shape", "kind", "mesh", "chips", "hardware", "trace_s",
          "memory", "fits", "flops", "bytes", "collectives",
          "collectives_by_dim", "links", "collective_bytes", "kernels",
          "model_flops", "model_flops_per_chip", "useful_flops_ratio",
          "roofline", "dominant", "params", "active_params")


@pytest.mark.parametrize("mesh,arch,shape", SMOKE_CELLS)
def test_run_cell_at_smoke_width(fake_runs, mesh, arch, shape):
    rec = fake_runs[mesh]["cells"][f"{arch}/{shape}"]
    assert "error" not in rec, rec
    assert tuple(rec) == FIELDS
    spec, ref = JSHAPES[shape], jget_smoke(arch)
    tokens = spec.global_batch * (1 if spec.kind == "decode"
                                  else spec.seq_len)
    factor = 6.0 if spec.kind == "train" else 2.0
    assert rec["model_flops"] == factor * ref.active_param_count() * tokens
    assert rec["chips"] == (512 if mesh == "2x16x16" else 256)
    assert rec["params"] == ref.param_count()
    mem = rec["memory"]
    assert 0 < mem["argument_bytes"] <= mem["peak_bytes"]
    assert mem["temp_bytes"] == mem["peak_bytes"] - mem["argument_bytes"]
    assert rec["fits"] and rec["flops"] > 0 and rec["bytes"] > 0
    assert rec["dominant"] == max(rec["roofline"], key=rec["roofline"].get)
    assert set(rec["links"]) == set(rec["collectives_by_dim"])
    if spec.kind != "decode":        # decode runs no kernel
        assert rec["kernels"][KINDS[arch]]["count"] > 0


def test_full_width_qwen3_train_flops_against_a_hand_count(fake_runs):
    """qwen3-0.6b train_4k on (16, 16): d_model 1024 / 16 < 128, so the
    rules fold the model axis into dp: each rank trains one sequence of
    4096 tokens with all 28 layers.  Per token and layer, the projections
    cost 2 (d Hq D + 2 d Hkv D + Hq D d) (attention) + 2 * 3 d F (MLP)
    FLOP a pass: forward, its recomputation (which stops before the MLP's
    last product, whose output the backward does not read) and the
    backward (twice the forward).  The LM head 2 d V a token four times
    (forward, the chunked loss's recomputation, two backward products).
    Flash: its forward twice (``work``), the plain backward five products
    over all S x T pairs a layer."""
    rec = fake_runs["16x16"]["full"]
    d, Hq, Hkv, D, F, V, L, S = 1024, 16, 8, 128, 3072, 151936, 28, 4096
    attn = 2 * (d * Hq * D + 2 * d * Hkv * D + Hq * D * d)
    mlp = 2 * 3 * d * F
    layers = (4 * attn + 4 * mlp - mlp // 3) * S * L
    head = 4 * 2 * d * V * S
    flash = 2 * L * fa.work(1, S, S, Hq, Hkv, D)[0]
    flash_bwd = 5 * 2 * Hq * S * S * D * L
    hand = layers + head + flash + flash_bwd
    assert abs(rec["flops"] - hand) <= 0.05 * hand
    assert rec["kernels"]["flash_fwd"]["count"] == 2 * L
    assert rec["fits"]


# ---------------------------------------------------------------------------
# The reference's one perf override: bf16 gradient accumulation
# ---------------------------------------------------------------------------


def _ulp_tol(want: np.ndarray) -> float:
    e = math.floor(math.log2(max(float(np.abs(want).max()), 1e-30)))
    return 8 * 2.0 ** (e - 7)


# A leaf's first moment against the reference's, as a relative L2 error:
# 2^-11, an eighth of bf16's relative spacing (2^-8).  With f32 weights the
# port's and the reference's microbatch gradients agree to ~1e-6, so what
# is left is how the four of them were summed: the same bf16 roundings
# (smoke qwen3: at most 1.4e-4 a leaf) or not (summed in f32: at least
# 2.2e-3 a leaf).
_SUM_TOL = 2.0 ** -11


def _one_step(dtype, accum_dtypes):
    """One train step of smoke qwen3 with weights in ``dtype``, 4
    microbatches of 2 sequences: the reference's with its gradients summed
    in bf16 (``PERF_OVERRIDES[("mixtral-8x7b", "train_4k")]``), and the
    port's with each of ``accum_dtypes``, from the reference's weights on
    the same batch.  Returns ``(reference, {accum_dtype: port})``, each
    ``(loss, params, first moments)`` as numpy."""
    jcfg = dataclasses.replace(jget_smoke("qwen3-0.6b"), dtype=dtype)
    cfg = dataclasses.replace(get_smoke_config("qwen3-0.6b"), dtype=dtype)
    kw = dict(lr=1e-3, warmup_steps=1, total_steps=10)
    jstep = jax.jit(jsteps.make_train_step(
        jcfg, JOptimizerConfig(**kw), microbatches=4,
        accum_dtype=jnp.bfloat16))
    jparams = jinit_params(jcfg, jax.random.key(3))
    start = jax.tree.map(lambda a: np.asarray(a, np.float32), jparams)
    rng = np.random.default_rng(7)
    toks = rng.integers(0, cfg.vocab_size, (8, 65)).astype(np.int32)
    batch = {"tokens": toks[:, :-1], "targets": toks[:, 1:]}
    jparams, jopt, jmetrics = jstep(
        jparams, jadamw_init(jparams),
        {k: jnp.asarray(v) for k, v in batch.items()}, jnp.int32(0))

    def f32(tree):
        return _flat(jax.tree.map(lambda a: np.asarray(a, np.float32), tree))

    ref = (float(jmetrics["loss"]), f32(jparams), f32(jopt["m"]))
    ports = {}
    for accum in accum_dtypes:
        step = steps.make_train_step(cfg, OptimizerConfig(**kw),
                                     microbatches=4, accum_dtype=accum)
        params = params_from_numpy(start, cfg, "cpu").requires_grad_(True)
        params, opt, metrics = step(params, adamw_init(params),
                                    {k: torch.from_numpy(v)
                                     for k, v in batch.items()}, 0)
        ports[accum] = (float(metrics["loss"]),
                        _flat(params_to_numpy(params)),
                        _flat(opt_state_to_numpy(opt, params)["m"]))
    return ref, ports


@pytest.fixture(scope="module")
def f32_weight_steps():
    return _one_step("float32", (torch.bfloat16, torch.float32))


def _sum_errors(ref, port):
    """Each leaf's first moment against the reference's: relative L2."""
    want, got = ref[2], port[2]
    assert got.keys() == want.keys()
    return {k: float(np.linalg.norm(got[k] - want[k])
                     / np.linalg.norm(want[k])) for k in want}


def test_bf16_accumulation_matches_reference(f32_weight_steps):
    """The override at the reference's setting (bf16 weights): loss and
    every parameter after one step within 8 bf16 ulps at the value's
    scale, the tolerance of tests/test_torch_bf16.py.  A first AdamW step
    is about lr * sign(g), so the parameters barely see how the gradients
    were summed: the sum itself is held through the first moments
    ((1 - b1) * clip * g) with f32 weights, each leaf within ``_SUM_TOL``
    of the reference's (relative L2)."""
    ref, ports = _one_step("bfloat16", (torch.bfloat16,))
    loss, params, _ = ports[torch.bfloat16]
    assert abs(loss - ref[0]) <= _ulp_tol(np.float32(ref[0]))
    assert params.keys() == ref[1].keys()
    bad = {k: float(np.abs(params[k] - want).max())
           for k, want in ref[1].items()
           if not np.abs(params[k] - want).max() <= _ulp_tol(want)}
    assert not bad, bad
    ref, ports = f32_weight_steps
    errors = _sum_errors(ref, ports[torch.bfloat16])
    assert max(errors.values()) <= _SUM_TOL, errors


def test_f32_accumulation_misses_the_bf16_sum(f32_weight_steps):
    """The control: the same step with the gradients summed in f32 misses
    the reference's bf16 sum by more than ``_SUM_TOL`` on every leaf, so
    the check above sees the accumulation dtype."""
    ref, ports = f32_weight_steps
    errors = _sum_errors(ref, ports[torch.float32])
    assert min(errors.values()) > _SUM_TOL, errors
