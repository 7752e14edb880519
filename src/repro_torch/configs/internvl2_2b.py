"""internvl2-2b [vlm]: InternViT + InternLM2 backbone [arXiv:2404.16821].
24L d_model=2048 16H(kv=8) d_ff=8192 vocab=92553.

Assignment rule: the ViT frontend is a STUB - ``input_specs()`` provides
precomputed patch embeddings (InternViT-300M width 1024); a linear
projection (the MLP connector) maps them into the LM stream."""

import dataclasses

from ..config import ModelConfig

CONFIG = ModelConfig(
    name="internvl2-2b",
    family="vlm",
    n_layers=24,
    d_model=2048,
    n_heads=16,
    n_kv_heads=8,
    d_ff=8192,
    vocab_size=92553,
    block_pattern=("attn",),
    frontend="vision_stub",
    frontend_dim=1024,
    n_patches=256,
)

SMOKE = dataclasses.replace(
    CONFIG, n_layers=4, d_model=64, n_heads=4, n_kv_heads=2, d_ff=128,
    vocab_size=512, frontend_dim=32, n_patches=8)
