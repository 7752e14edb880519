"""Mamba2 chunked SSD scan: CUDA kernel for sm_90a + plain PyTorch version."""

from .ops import ssd
from .ref import ssd_ref

__all__ = ["ssd", "ssd_ref"]
