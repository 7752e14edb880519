"""qwen3-8b [dense]: qk_norm, GQA [hf:Qwen/Qwen3-8B].
36L d_model=4096 32H(kv=8) d_ff=12288 vocab=151936; head_dim=128."""

import dataclasses

from ..config import ModelConfig

CONFIG = ModelConfig(
    name="qwen3-8b",
    family="dense",
    n_layers=36,
    d_model=4096,
    n_heads=32,
    n_kv_heads=8,
    d_ff=12288,
    vocab_size=151936,
    block_pattern=("attn",),
    d_head=128,
    qk_norm=True,
    rope_theta=1e6,
)

SMOKE = dataclasses.replace(
    CONFIG, n_layers=4, d_model=64, n_heads=4, n_kv_heads=2, d_ff=128,
    vocab_size=512, d_head=16)
