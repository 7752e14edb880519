"""Flash attention: CUDA forward kernel for sm_90a, its plain PyTorch
version, and the autograd op whose backward is plain PyTorch."""

from .ops import FlashAttention, flash_attention, flash_attention_fwd
from .ref import attention_ref, flash_bwd_ref

__all__ = ["FlashAttention", "attention_ref", "flash_attention",
           "flash_attention_fwd", "flash_bwd_ref"]
