"""PyTorch model code: GQA decoders with a dense MLP (``attn`` block kind)
or a mixture of experts (``moe``), and Mamba2 stacks (``mamba2``) with
zamba2's shared attention block."""

from .mamba2 import Mamba2, mamba2_decode_step, mamba2_forward
from .moe import MoE, moe_mlp
from .transformer import (Transformer, decode_step, forward_logits,
                          init_cache, init_params, prefill)

__all__ = [
    "Mamba2",
    "MoE",
    "Transformer",
    "decode_step",
    "forward_logits",
    "init_cache",
    "init_params",
    "mamba2_decode_step",
    "mamba2_forward",
    "moe_mlp",
    "prefill",
]
