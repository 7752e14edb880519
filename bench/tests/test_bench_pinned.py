"""What the cells read, pinned to the values of the harness before each
configuration named its own reference module: the widths, the port's
configuration as checked, ``mfu``'s FLOPs at the prefill and decode
shapes of each configuration under each traffic mix it has been run
with, and, at the configurations' smoke sizes on the CPU,
the weights drawn from a seed and the reference's logits and its
control's, bit for bit (SHA-256 of the bytes)."""

import hashlib

import pytest
import torch

from bench import spec as S
from bench import weights
from bench.harness import program_config

SPECS = {
    "internlm2-20b": {
        "n_layers": 48, "d_model": 6144, "n_heads": 48, "n_kv_heads": 8,
        "head_dim": 128, "d_ff": 16384, "n_experts": 0, "top_k": 0,
        "expert_d_ff": 0, "capacity_factor": 0.0, "vocab_size": 92544,
        "window": 0, "rope_theta": 10000.0, "norm_eps": 1e-05,
        "dtype": "bfloat16"},
    "mixtral-8x7b-16L": {
        "n_layers": 16, "d_model": 4096, "n_heads": 32, "n_kv_heads": 8,
        "head_dim": 128, "d_ff": 0, "n_experts": 8, "top_k": 2,
        "expert_d_ff": 14336, "capacity_factor": 1.25, "vocab_size": 32000,
        "window": 4096, "rope_theta": 10000.0, "norm_eps": 1e-05,
        "dtype": "bfloat16"},
}
_COMMON = {"head_dim": 128, "rope_theta": 10000.0, "norm_eps": 1e-05, "dtype": "bfloat16",
           "qk_norm": False, "frontend": "none"}
# the port's ModelConfig fields that the check compares, as checked
PROGRAM = {
    "internlm2-20b": dict(
        _COMMON, n_layers=48, d_model=6144, n_heads=48, n_kv_heads=8,
        vocab_size=92544, sliding_window=0, d_ff=16384,
        block_pattern=("attn",)),
    "mixtral-8x7b-16L": dict(
        _COMMON, n_layers=16, d_model=4096, n_heads=32, n_kv_heads=8,
        vocab_size=32000, sliding_window=4096, n_experts=8,
        n_experts_active=2, moe_d_ff=14336, moe_capacity_factor=1.25,
        block_pattern=("moe",)),
}
# model_flops at (slots, prompt_len, 0), (slots, 1, prompt_len) and
# (slots, 1, prompt_len + gen_len - 2): the prefill, the first and the
# last decode step
FLOPS = {
    ("internlm2-20b", "rag"): (1306248238596096, 347335557120,
                               347467677696),
    ("mixtral-8x7b-16L", "rag"): (431049309945856, 111627206656,
                                  111627206656),
    ("mixtral-8x7b-16L", "chat"): (207835413610496, 416452444160,
                                   416972537856),
}
# smoke size: the weights of seed 2**31 + 5, and the reference's and the
# control's logits over 3 rows of a 12-token prompt and 3 served tokens
SMOKE = {
    "internlm2-20b": ("66d2db1539a0fb1a", "72824826e1f7940c",
                      "eec6752f8dd30890"),
    "mixtral-8x7b-16L": ("26a318ad2af45519", "59bcfbf9eac3eca6",
                         "8036c42cc085c2b6"),
}
SEED, P, G = 2**31 + 5, 12, 4


def _digest(tensors) -> str:
    h = hashlib.sha256()
    for t in tensors:
        h.update(t.detach().contiguous().reshape(-1).view(torch.uint8)
                 .numpy().tobytes())
    return h.hexdigest()[:16]


def weights_digest(W: dict) -> str:
    flat = dict(W["layers"], **{k: v for k, v in W.items()
                                if k != "layers"})
    return _digest(flat[k] for k in sorted(flat))


def smoke_tokens(vocab: int) -> torch.Tensor:
    return torch.randint(0, vocab, (3, P + G - 1),
                         generator=torch.Generator().manual_seed(3))


def _config(name, smoke=False):
    cfg_file = S.sized(S.config_file(S.benchmark(), name), smoke)
    ref = S.reference(cfg_file)
    return cfg_file, ref, ref.spec(cfg_file)


@pytest.mark.parametrize("config_name", sorted(SPECS))
def test_spec_and_checked_program_are_pinned(config_name):
    cfg_file, ref, spec = _config(config_name)
    assert spec == SPECS[config_name]
    cfg = program_config(ref, cfg_file, spec, smoke=False)
    assert {f: getattr(cfg, f) for f in PROGRAM[config_name]} == \
        PROGRAM[config_name]


@pytest.mark.parametrize("config_name,traffic", sorted(FLOPS))
def test_model_flops_at_the_cell_shapes_are_pinned(config_name, traffic):
    _, ref, spec = _config(config_name)
    mix = S.traffic(traffic)
    B, P_, G_ = mix["slots"], mix["prompt_len"], mix["gen_len"]
    got = (ref.model_flops(spec, B, P_, 0),
           ref.model_flops(spec, B, 1, P_),
           ref.model_flops(spec, B, 1, P_ + G_ - 2))
    assert got == FLOPS[config_name, traffic]


@pytest.mark.parametrize("config_name", sorted(SMOKE))
def test_smoke_weights_and_reference_logits_are_pinned(config_name):
    cfg_file, ref, spec = _config(config_name, smoke=True)
    cfg = program_config(ref, cfg_file, spec, smoke=True)
    W = weights.make(cfg, SEED, torch.device("cpu"))
    tokens = smoke_tokens(spec["vocab_size"])
    got = [weights_digest(W)]
    for fp8 in (False, True):
        got.append(_digest([ref.logits(
            spec, ref.Weights(W, fp8=fp8), tokens, [P] + [1] * (G - 1),
            list(range(P - 1, P + G - 1)))]))
    assert tuple(got) == SMOKE[config_name]
