"""The port's prefill and decode under sharding rules across gloo ranks
on the CPU, against the port's single-device steps (the harness of
``tests/test_torch_parallel.py``)."""

from __future__ import annotations

import pytest

from test_torch_parallel import TOL, spawn


def _rank_serve(rank, world, mesh_shape, archs):
    """make_prefill and two make_decode_step steps under rules (caches
    placed by the cache specs: batch on data, the ring buffers' sequence
    on model) against the same on one device; the largest logit
    difference over the largest logit, per arch."""
    import copy

    import torch
    from torch.distributed.device_mesh import init_device_mesh

    from repro_torch.models import transformer as T
    from repro_torch.parallel import ShardingRules
    from repro_torch.steps import make_decode_step, make_prefill
    from test_torch_parallel import _batch, _smoke

    mesh = init_device_mesh("cpu", tuple(mesh_shape),
                            mesh_dim_names=("data", "model"))
    out = {}
    for arch in archs:
        cfg = _smoke(arch)
        params = T.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
        ref = copy.deepcopy(params)
        rules = ShardingRules(cfg, mesh)
        rules.distribute_params(params)
        batch = _batch(cfg, 4, 32)
        batch.pop("targets")
        logits, cache = make_prefill(cfg, 40, rules)(params, batch)
        want, ref_cache = make_prefill(cfg, 40)(ref, batch)
        errs = [float((logits.full_tensor() - want).abs().max()
                      / want.abs().max())]
        decode, ref_decode = make_decode_step(cfg, rules), make_decode_step(cfg)
        for _ in range(2):
            tok = want[:, -1].argmax(-1)[:, None]
            logits, cache = decode(params, cache, tok)
            want, ref_cache = ref_decode(ref, ref_cache, tok)
            errs.append(float((logits.full_tensor() - want).abs().max()
                              / want.abs().max()))
        out[arch] = errs
    return out


@pytest.mark.parametrize("mesh_shape,arch", [
    ((2, 2), "qwen3-0.6b"), ((2, 2), "granite-moe-1b-a400m"),
    ((2, 2), "zamba2-2.7b"), ((2, 2), "rwkv6-7b"),
    ((2, 2), "whisper-base"), ((1, 4), "qwen3-0.6b")])
def test_sharded_prefill_and_decode_match_single_device(tmp_path, mesh_shape,
                                                        arch):
    """Prefill and decode through the step builders under rules, every
    kind: the KV ring buffers split along the sequence (each rank writes
    its own slots; decode reduces the softmax across the ranks), the SSM
    and WKV states by heads; logits within 1e-5 of the largest."""
    out = spawn(tmp_path, 4, _rank_serve, mesh_shape, (arch,))
    for arch, errs in out.items():
        assert max(errs) < TOL, (arch, errs)
