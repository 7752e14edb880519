"""DeepSeek-V2-Lite's reference (the module its configuration's
``reference`` key names) against the port, on the CPU at the
configuration's smoke size, as ``test_bench_reference`` holds the
others: both in float32 on the same weights, the port serving prompts
through ``TorchServeEngine`` (prefill through the expanded latent
attention, then decode through the latent cache in the absorbed form),
the reference computing each prompt and its served tokens at once in the
expanded form.  Every logit the engine produced agrees with the
reference's at the same position to 1e-4 of the largest (the order of
float32 sums only), with and without tokens dropped at the experts'
capacity.  Each fault planted in the port's configuration (the gates
renormalised, the shared experts left out, YaRN off) breaks that
agreement."""

import dataclasses
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from bench import weights
from bench.tests.test_bench_reference import TOL, _served, _setup
from bench.tests.test_bench_run import ROOT

CONFIG = "deepseek-v2-lite"
PROMPT, GEN = 40, 6


def _compare(cfg, W, ref, spec, mix, program_cfg=None):
    """(served logits, reference logits) of one job, normalised by the
    reference's largest; the engine serves ``program_cfg`` (``cfg``
    where not given) over the weights of ``cfg``."""
    prompts, out, got = _served(program_cfg or cfg, W, mix)
    seqs = np.concatenate([prompts, out[:, :-1]], axis=1).astype(np.int64)
    want = ref.logits(spec, ref.Weights(W), torch.as_tensor(seqs),
                      [PROMPT] + [1] * (GEN - 1),
                      list(range(PROMPT - 1, PROMPT + GEN - 1)))
    scale = want.abs().max()
    return got / scale, want / scale


@pytest.mark.parametrize("change", [{}, {"moe_capacity_factor": 0.5}],
                         ids=["published", "capacity_drops"])
def test_reference_matches_port_in_f32(change):
    ref, spec, cfg, W, mix = _setup(CONFIG, PROMPT, GEN, 4, 2, **change)
    got, want = _compare(cfg, W, ref, spec, mix)
    torch.testing.assert_close(got, want, atol=TOL, rtol=0)


def test_tokens_are_dropped_in_the_capacity_case():
    ref, spec, cfg, W, mix = _setup(CONFIG, PROMPT, GEN, 4, 2,
                                    moe_capacity_factor=0.5)
    x = torch.randn(PROMPT, spec["n_experts"],
                    generator=torch.Generator().manual_seed(0))
    experts = torch.topk(x, spec["top_k"], dim=-1).indices
    keep = ref.admitted(experts, [PROMPT], spec)
    # capacity max(8, ceil8(int(40 * 3 * 0.5 / 8))) = 8 of 15 claims an
    # expert on average
    assert not keep.all()
    for e in range(spec["n_experts"]):
        assert int(((experts == e) & keep).sum()) == min(
            8, int((experts == e).sum()))


@pytest.mark.parametrize("fault", [
    {"moe_renormalize": True},          # gates renormalised to sum 1
    {"moe_shared_experts": 0},          # shared experts left out
    {"yarn_factor": 0.0},               # plain rope, no YaRN scale
], ids=["renormalised", "no_shared", "no_yarn"])
def test_planted_fault_fails_the_comparison(fault):
    ref, spec, cfg, W, mix = _setup(CONFIG, PROMPT, GEN, 4, 2)
    got, want = _compare(cfg, W, ref, spec, mix,
                         dataclasses.replace(cfg, **fault))
    assert (got - want).abs().max() > 100 * TOL


def test_smoke_weights_hold_the_dense_layer_outside_layers():
    """``bench/weights.py`` groups ``layers.<i>.*`` over i; the leading
    dense layer is a module of its own, so every index of ``layers``
    holds the same leaves."""
    _, spec, cfg, W, _ = _setup(CONFIG, PROMPT, GEN, 4, 2)
    assert W["dense_layers.0.mlp.wi_gate"].shape == (64, spec["d_ff"])
    assert W["layers"]["moe.wi_gate"].shape == (
        spec["n_layers"] - 1, spec["n_experts"], 64, spec["expert_d_ff"])
    assert W["layers"]["moe.shared_wo"].shape == (
        spec["n_layers"] - 1, 2 * spec["expert_d_ff"], 64)
    model = weights.to_program(cfg, W)
    assert model.dense_layers[0].mlp.wi_gate.data_ptr() == \
        W["dense_layers.0.mlp.wi_gate"].data_ptr()


_LOAD_BLOCKED = r"""
import json, sys
blocked = {"jax", "jaxlib", "flax", "repro", "repro_torch"}

class Block:
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in blocked:
            raise ImportError(f"{name} blocked")
        return None

sys.meta_path.insert(0, Block())
sys.path[:0] = [sys.argv[1]]
from bench import spec as S
bench = S.benchmark()
for cfg in bench["configs"]:
    ref = S.reference(S.config_file(bench, cfg["name"]))
    assert callable(ref.logits) and callable(ref.check_program), cfg
assert not [m for m in sys.modules if m.split(".")[0] in blocked]
print(json.dumps(sorted(S.config_file(bench, c["name"])["reference"]
                        for c in bench["configs"])))
"""


def test_every_configurations_reference_loads_with_the_port_blocked():
    """Each configuration's reference, loaded by path as the harness
    loads it (``spec.reference``), with ``repro_torch``, the JAX package
    and JAX blocked: the check of ``test_bench_isolation``, which walks
    the ``bench.reference`` package, for references that live in a
    directory of their own under ``bench/reference/``."""
    proc = subprocess.run([sys.executable, "-c", _LOAD_BLOCKED, str(ROOT)],
                          cwd=ROOT, env=dict(os.environ, PYTHONPATH=""),
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert "bench/reference/mla/deepseek_v2.py" in json.loads(proc.stdout)
