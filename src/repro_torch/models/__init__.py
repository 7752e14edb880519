"""PyTorch model code: the dense GQA decoder (``attn`` block kind)."""

from .transformer import (Transformer, decode_step, forward_logits,
                          init_cache, init_params, prefill)

__all__ = [
    "Transformer",
    "decode_step",
    "forward_logits",
    "init_cache",
    "init_params",
    "prefill",
]
