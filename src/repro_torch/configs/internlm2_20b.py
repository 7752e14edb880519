"""internlm2-20b [dense]: GQA [arXiv:2403.17297].
48L d_model=6144 48H(kv=8) d_ff=16384 vocab=92544."""

import dataclasses

from ..config import ModelConfig

CONFIG = ModelConfig(
    name="internlm2-20b",
    family="dense",
    n_layers=48,
    d_model=6144,
    n_heads=48,
    n_kv_heads=8,
    d_ff=16384,
    vocab_size=92544,
    block_pattern=("attn",),
)

SMOKE = dataclasses.replace(
    CONFIG, n_layers=4, d_model=64, n_heads=4, n_kv_heads=2, d_ff=128,
    vocab_size=512)
