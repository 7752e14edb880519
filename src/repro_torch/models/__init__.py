"""PyTorch model code: GQA decoders with a dense MLP (``attn`` block kind)
or a mixture of experts (``moe``)."""

from .moe import MoE, moe_mlp
from .transformer import (Transformer, decode_step, forward_logits,
                          init_cache, init_params, prefill)

__all__ = [
    "MoE",
    "Transformer",
    "decode_step",
    "forward_logits",
    "init_cache",
    "init_params",
    "moe_mlp",
    "prefill",
]
