"""Grouped expert matmul: CUDA kernel for sm_90a + plain PyTorch version."""

from .ops import grouped_matmul
from .ref import gmm_ref

__all__ = ["gmm_ref", "grouped_matmul"]
