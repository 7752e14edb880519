"""Flash attention forward: CUDA kernel for sm_90a + plain PyTorch version."""

from .ops import flash_attention, flash_attention_fwd
from .ref import attention_ref

__all__ = ["attention_ref", "flash_attention", "flash_attention_fwd"]
