"""whisper-base [audio]: encoder-decoder [arXiv:2212.04356].
6L(enc)+6L(dec) d_model=512 8H(kv=8) d_ff=2048 vocab=51865.

Assignment rule: the conv frontend is a STUB - ``input_specs()`` provides
precomputed frame embeddings (80-dim mel features); a linear projection
stands in for the conv stem.  enc_len = seq_len // 2 (the stem's stride-2)."""

import dataclasses

from ..config import ModelConfig

CONFIG = ModelConfig(
    name="whisper-base",
    family="encdec",
    n_layers=6,
    d_model=512,
    n_heads=8,
    n_kv_heads=8,
    d_ff=2048,
    vocab_size=51865,
    block_pattern=("attn",),
    n_enc_layers=6,
    enc_seq_divisor=2,
    frontend="audio_stub",
    frontend_dim=80,
)

SMOKE = dataclasses.replace(
    CONFIG, n_layers=2, n_enc_layers=2, d_model=64, n_heads=4, n_kv_heads=4,
    d_ff=128, vocab_size=512, frontend_dim=16)
