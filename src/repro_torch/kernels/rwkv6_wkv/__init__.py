"""RWKV6 WKV recurrence: CUDA kernel for sm_90a + plain PyTorch version."""

from .ops import wkv
from .ref import wkv_ref

__all__ = ["wkv", "wkv_ref"]
