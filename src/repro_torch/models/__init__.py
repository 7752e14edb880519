"""PyTorch model code: GQA decoders with a dense MLP (``attn`` block kind)
or a mixture of experts (``moe``), Mamba2 stacks (``mamba2``) with
zamba2's shared attention block, RWKV6 stacks (``rwkv6``), whisper's
encoder-decoder (cross-attention in every decoder block) and the audio
and vision frontend stubs."""

from .mamba2 import Mamba2, mamba2_decode_step, mamba2_forward
from .moe import MoE, moe_mlp
from .rwkv6 import (RWKV6, rwkv6_channel_mix, rwkv6_channel_mix_step,
                    rwkv6_time_mix, rwkv6_time_mix_step)
from .transformer import (Transformer, decode_step, forward_logits,
                          forward_train, init_cache, init_params, prefill)

__all__ = [
    "Mamba2",
    "MoE",
    "RWKV6",
    "Transformer",
    "decode_step",
    "forward_logits",
    "forward_train",
    "init_cache",
    "init_params",
    "mamba2_decode_step",
    "mamba2_forward",
    "moe_mlp",
    "prefill",
    "rwkv6_channel_mix",
    "rwkv6_channel_mix_step",
    "rwkv6_time_mix",
    "rwkv6_time_mix_step",
]
