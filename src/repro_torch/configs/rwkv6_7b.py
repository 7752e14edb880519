"""rwkv6-7b [ssm]: Finch - data-dependent decay [arXiv:2404.05892].
32L d_model=4096 (attn-free) d_ff=14336 vocab=65536."""

import dataclasses

from ..config import ModelConfig

CONFIG = ModelConfig(
    name="rwkv6-7b",
    family="ssm",
    n_layers=32,
    d_model=4096,
    n_heads=0,
    n_kv_heads=0,
    d_ff=14336,
    vocab_size=65536,
    block_pattern=("rwkv6",),
    rwkv_head_dim=64,
)

SMOKE = dataclasses.replace(
    CONFIG, n_layers=4, d_model=64, d_ff=128, vocab_size=512,
    rwkv_head_dim=16)
