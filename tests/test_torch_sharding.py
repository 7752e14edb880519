"""The port's sharding rules, compression and meshes against the
reference's, in one process (no ranks).

The rules need no devices: as in ``tests/test_sharding.py`` a shape-only
stand-in mesh drives both packages' ``ShardingRules``, and the port's
specs must equal the reference's entry for entry.  The port keeps one
module per layer, so its per-layer leaves move the reference's stacked
layer entry to another dim; each rank must still hold the same number of
elements of every reference leaf as a reference device.
"""

from __future__ import annotations

import subprocess
import sys
import textwrap
from pathlib import Path

import jax
import numpy as np
import pytest

from repro.config import SHAPES
from repro.configs import ARCHS, get_config
from repro.models import transformer as RT
from repro.parallel.sharding import ShardingRules as RefRules

from repro_torch import config as PC
from repro_torch.configs import get_config as port_config
from repro_torch.models import transformer as PT
from repro_torch.optim import compression as PCOMP
from repro_torch.parallel import ShardingRules
from repro_torch.parallel.sharding import _flatten

ROOT = Path(__file__).resolve().parents[1]


class _FakeMesh:
    """Shape-only stand-in so spec generation needs no real devices."""

    def __init__(self, shape):
        self.shape = dict(shape)
        self.axis_names = tuple(shape)


MESHES = {
    "pod1": {"data": 16, "model": 16},
    "pod2": {"pod": 2, "data": 16, "model": 16},
    "host42": {"data": 4, "model": 2},
}


def _ref_flat(tree):
    """A reference pytree of PartitionSpecs -> {'a.b.c': tuple}."""
    leaves = jax.tree_util.tree_flatten_with_path(
        tree, is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))[0]
    return {".".join(str(getattr(k, "key", k)) for k in path): tuple(spec)
            for path, spec in leaves}


def _both(arch, mesh, **kw):
    return (RefRules(get_config(arch), _FakeMesh(MESHES[mesh]), **kw),
            ShardingRules(port_config(arch), _FakeMesh(MESHES[mesh]), **kw))


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("mesh", ["pod1", "pod2", "host42"])
def test_param_and_opt_specs_match_reference(arch, mesh):
    """param_specs with FSDP on and off, and opt_specs (ZeRO-1), on the
    reference's tree names and stacked shapes."""
    rshapes = RT.param_shapes(get_config(arch))
    pshapes = PT.param_shapes(port_config(arch))
    for fsdp in (True, False):
        ref, port = _both(arch, mesh, fsdp=fsdp)
        want = _ref_flat(ref.param_specs(rshapes))
        got = _flatten(port.param_specs(pshapes))
        assert got == want, fsdp
        want = _ref_flat(ref.opt_specs(rshapes))
        got = _flatten(port.opt_specs(pshapes))
        assert got == want, fsdp


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("mesh", ["pod1", "pod2", "host42"])
def test_batch_specs_and_train_fold_match_reference(arch, mesh):
    """batch_specs at three batch sizes (dividing dp, not dividing, one),
    and the dp-only fold of ``shape=SHAPES["train_4k"]`` (params, moments
    and batches)."""
    ref, port = _both(arch, mesh)
    for B in (256, 6, 1):
        batch = {"tokens": jax.ShapeDtypeStruct((B, 64), np.int32),
                 "targets": jax.ShapeDtypeStruct((B, 64), np.int32)}
        assert (_flatten(port.batch_specs({k: v.shape for k, v in
                                           batch.items()}))
                == _ref_flat(ref.batch_specs(batch)))
    shape = SHAPES["train_4k"]
    ref = RefRules(get_config(arch), _FakeMesh(MESHES[mesh]), shape=shape)
    port = ShardingRules(port_config(arch), _FakeMesh(MESHES[mesh]),
                         shape=PC.SHAPES["train_4k"])
    assert (port.dp, port.tp, port.dp_size, port.tp_size) == (
        ref.dp, ref.tp, ref.dp_size, ref.tp_size)
    rshapes = RT.param_shapes(get_config(arch))
    pshapes = PT.param_shapes(port_config(arch))
    assert (_flatten(port.opt_specs(pshapes))
            == _ref_flat(ref.opt_specs(rshapes)))
    batch = {"tokens": jax.ShapeDtypeStruct((shape.global_batch, 64),
                                            np.int32)}
    assert (_flatten(port.batch_specs({"tokens": (shape.global_batch, 64)}))
            == _ref_flat(ref.batch_specs(batch)))


@pytest.mark.parametrize("arch", ["internlm2-20b", "rwkv6-7b",
                                  "mixtral-8x7b", "zamba2-2.7b"])
@pytest.mark.parametrize("mesh", ["pod1", "pod2"])
def test_cache_specs_match_reference(arch, mesh):
    """cache_specs at decode_32k and at long_500k (batch 1: the sequence
    also on dp)."""
    for name in ("decode_32k", "long_500k"):
        shape = SHAPES[name]
        ref, port = _both(arch, mesh)
        cfg = get_config(arch)
        enc = shape.seq_len // cfg.enc_seq_divisor if cfg.is_encdec else 0
        rc = RT.cache_shapes(cfg, shape.global_batch, shape.seq_len, enc)
        pc = PT.cache_shapes(port_config(arch), shape.global_batch,
                             shape.seq_len, enc)
        assert (_flatten(port.cache_specs(pc, shape.global_batch))
                == _ref_flat(ref.cache_specs(rc, shape.global_batch)))


def _elems(shape, spec, mesh_shape):
    n = int(np.prod(shape)) if len(shape) else 1
    for entry in spec:
        for a in (entry if isinstance(entry, tuple) else (entry,)):
            if a is not None:
                n //= mesh_shape[a]
    return n


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("mesh", ["pod1", "pod2", "host42"])
def test_rank_holds_reference_bytes_of_each_leaf(arch, mesh):
    """Each rank holds as many elements of every reference leaf (params,
    and moments under ZeRO-1) as a reference device: the stacked layer
    entry the port moves to a per-layer dim keeps the count.  Also checks
    every port placement divides its dim."""
    ref, port = _both(arch, mesh)
    rshapes = RT.param_shapes(get_config(arch))
    module = PT.Transformer(port_config(arch), "meta")
    shapes = {n: tuple(p.shape) for n, p in module.named_parameters()}
    for zero1 in (False, True):
        want = _ref_flat(ref.opt_specs(rshapes, zero1=zero1))
        rflat = {k: tuple(v.shape) for k, v in _ref_flat_shapes(rshapes)}
        got: dict = {}
        for name, spec in port.leaf_specs(module, zero1=zero1).items():
            for d, entry in enumerate(spec):
                for a in (entry if isinstance(entry, tuple) else (entry,)):
                    if a is not None:
                        assert shapes[name][d] % MESHES[mesh][a] == 0
            parts = name.split(".")
            key = (".".join(parts[:1] + parts[2:])
                   if parts[0] in ("layers", "enc_layers") else name)
            got[key] = got.get(key, 0) + _elems(shapes[name], spec,
                                                MESHES[mesh])
        for key, spec in want.items():
            assert got[key] == _elems(rflat[key], spec, MESHES[mesh]), key


def _ref_flat_shapes(tree):
    leaves = jax.tree_util.tree_flatten_with_path(tree)[0]
    return [(".".join(str(k.key) for k in path), leaf)
            for path, leaf in leaves]


def test_host_mesh_takes_the_fsdp_branch():
    """On (data=4, model=2), qwen3-0.6b's 28 layers divide dp: its large
    stacked leaves get FSDP on the layer dim in the reference, and on a
    per-layer dim in the port."""
    ref, port = _both("qwen3-0.6b", "host42")
    want = _ref_flat(ref.param_specs(RT.param_shapes(
        get_config("qwen3-0.6b"))))
    assert want["layers.mlp.wi_gate"] == ("data", None, "model")
    module = PT.Transformer(port_config("qwen3-0.6b"), "meta")
    got = port.leaf_specs(module)
    assert got["layers.0.mlp.wi_gate"] == ("data", "model")
    assert got["layers.0.attn.q_norm"] == (None,)


# ---------------------------------------------------------------------------
# Compression
# ---------------------------------------------------------------------------


def _grads(seed):
    rng = np.random.default_rng(seed)
    return {"w": (rng.standard_normal((64, 32)) * 3).astype(np.float32),
            "b": rng.standard_normal(17).astype(np.float32),
            "nested": {"z": np.zeros((4, 4), np.float32),
                       "t": (rng.standard_normal((5, 3)) * 1e-3
                             ).astype(np.float32)}}


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_compression_matches_reference(seed):
    """quantize_int8: int8 bit-equal, scale to 1e-7 relative; dequantize
    the same product; and the error-feedback chain over three steps."""
    import torch

    from repro.optim import compression as RCOMP
    g = _grads(seed)
    for x in (g["w"], g["b"], g["nested"]["z"], g["nested"]["t"]):
        q, s = PCOMP.quantize_int8(torch.from_numpy(x))
        rq, rs = RCOMP.quantize_int8(jax.numpy.asarray(x))
        assert q.dtype == torch.int8
        np.testing.assert_array_equal(q.numpy(), np.asarray(rq))
        np.testing.assert_allclose(float(s), float(rs), rtol=1e-7, atol=0)
        np.testing.assert_allclose(
            PCOMP.dequantize_int8(q, s).numpy(),
            np.asarray(RCOMP.dequantize_int8(rq, rs)), rtol=1e-7, atol=0)
    tg = PCOMP._map(torch.from_numpy, g)
    err, rerr = PCOMP.init_error_feedback(tg), RCOMP.init_error_feedback(g)
    for _ in range(3):
        qt, err = PCOMP.compress_with_feedback(tg, err)
        rqt, rerr = RCOMP.compress_with_feedback(g, rerr)
        deq, rdeq = PCOMP.decompress(qt), RCOMP.decompress(rqt)
        for k, v in _flatten(deq).items():
            np.testing.assert_allclose(v.numpy(), np.asarray(
                _flatten(rdeq)[k]), rtol=1e-6, atol=1e-7)
        for k, v in _flatten(err).items():
            np.testing.assert_allclose(v.numpy(), np.asarray(
                _flatten(rerr)[k]), rtol=1e-5, atol=1e-7)


def test_error_feedback_identity():
    """corrected = dequant + new_error exactly (the reference's property
    of ``tests/test_properties.py``), for the port."""
    import torch
    g = PCOMP._map(torch.from_numpy, _grads(3))
    err = PCOMP._map(lambda x: torch.full_like(x, 0.01), g)
    qt, new_err = PCOMP.compress_with_feedback(g, err)
    deq = PCOMP.decompress(qt)
    for k, v in _flatten(g).items():
        corrected = v.float() + _flatten(err)[k]
        torch.testing.assert_close(_flatten(deq)[k] + _flatten(new_err)[k],
                                   corrected, rtol=1e-6, atol=1e-6)


# ---------------------------------------------------------------------------
# Meshes
# ---------------------------------------------------------------------------

_FAKE_MESH = textwrap.dedent("""
    import json
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore
    from repro_torch.launch.mesh import make_production_mesh
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=512)
    out = {}
    for multi in (False, True):
        m = make_production_mesh(multi_pod=multi)
        out[str(multi)] = [list(m.shape), list(m.mesh_dim_names),
                           m.device_type]
    print(json.dumps(out))
""")


def test_production_mesh_under_the_fake_group():
    """make_production_mesh builds (16, 16) and (2, 16, 16) with the
    reference's axis names over a fake group of 512 ranks, in a
    subprocess (no devices, no network)."""
    import json
    proc = subprocess.run([sys.executable, "-c", _FAKE_MESH],
                          capture_output=True, text=True, timeout=120,
                          cwd=ROOT, env={"PYTHONPATH": str(ROOT / "src"),
                                         "PATH": "/usr/bin:/bin"})
    assert proc.returncode == 0, proc.stderr[-3000:]
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    assert out["False"] == [[16, 16], ["data", "model"], "cpu"]
    assert out["True"] == [[2, 16, 16], ["pod", "data", "model"], "cpu"]
