"""granite-moe-1b-a400m [moe]: 32 experts top-8
[hf:ibm-granite/granite-3.0-1b-a400m-base].
24L d_model=1024 16H(kv=8) expert d_ff=512 vocab=49155."""

import dataclasses

from ..config import ModelConfig

CONFIG = ModelConfig(
    name="granite-moe-1b-a400m",
    family="moe",
    n_layers=24,
    d_model=1024,
    n_heads=16,
    n_kv_heads=8,
    d_ff=512,
    vocab_size=49155,
    block_pattern=("moe",),
    n_experts=32,
    n_experts_active=8,
    moe_d_ff=512,
    gcr_moe=True,
)

SMOKE = dataclasses.replace(
    CONFIG, n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, d_ff=64,
    vocab_size=512, n_experts=8, n_experts_active=2, moe_d_ff=64)
