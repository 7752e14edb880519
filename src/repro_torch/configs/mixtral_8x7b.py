"""mixtral-8x7b [moe]: 8 experts top-2, sliding-window attention
[arXiv:2401.04088].  32L d_model=4096 32H(kv=8) expert d_ff=14336
vocab=32000, window=4096."""

import dataclasses

from ..config import ModelConfig

CONFIG = ModelConfig(
    name="mixtral-8x7b",
    family="moe",
    n_layers=32,
    d_model=4096,
    n_heads=32,
    n_kv_heads=8,
    d_ff=14336,
    vocab_size=32000,
    block_pattern=("moe",),
    sliding_window=4096,
    n_experts=8,
    n_experts_active=2,
    moe_d_ff=14336,
    gcr_moe=True,
)

SMOKE = dataclasses.replace(
    CONFIG, n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, d_ff=128,
    vocab_size=512, sliding_window=32, n_experts=4, n_experts_active=2,
    moe_d_ff=128)
