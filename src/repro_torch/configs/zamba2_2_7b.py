"""zamba2-2.7b [hybrid]: Mamba2 backbone + shared attention block applied
every 6 layers [arXiv:2411.15242].  54L d_model=2560 32H(kv=32) d_ff=10240
vocab=32000, ssm_state=64."""

import dataclasses

from ..config import ModelConfig

CONFIG = ModelConfig(
    name="zamba2-2.7b",
    family="hybrid",
    n_layers=54,
    d_model=2560,
    n_heads=32,
    n_kv_heads=32,
    d_ff=10240,
    vocab_size=32000,
    block_pattern=("mamba2",),
    ssm_state=64,
    ssm_expand=2,
    ssm_head_dim=64,
    ssm_conv=4,
    shared_attn_every=6,
)

SMOKE = dataclasses.replace(
    CONFIG, n_layers=6, d_model=64, n_heads=4, n_kv_heads=4, d_ff=128,
    vocab_size=512, ssm_state=16, ssm_head_dim=16, shared_attn_every=3)
