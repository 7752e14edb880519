"""deepseek-7b [dense]: llama-arch, MHA (kv=32) [arXiv:2401.02954].
30L d_model=4096 32H(kv=32) d_ff=11008 vocab=102400."""

import dataclasses

from ..config import ModelConfig

CONFIG = ModelConfig(
    name="deepseek-7b",
    family="dense",
    n_layers=30,
    d_model=4096,
    n_heads=32,
    n_kv_heads=32,
    d_ff=11008,
    vocab_size=102400,
    block_pattern=("attn",),
)

SMOKE = dataclasses.replace(
    CONFIG, n_layers=4, d_model=64, n_heads=4, n_kv_heads=4, d_ff=128,
    vocab_size=512)
