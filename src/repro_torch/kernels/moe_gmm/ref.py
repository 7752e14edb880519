"""Plain PyTorch grouped expert matmul: the gmm kernel's reference and its
path on the CPU.

It computes what ``repro.kernels.moe_gmm.ref.gmm_ref`` computes: the
per-expert products in f32 (in f64 for f64 inputs, which the gradient
checks use), cast once to x's dtype.  It also takes the
model's ``(B,E,C,D)`` expert buffers.
"""

from __future__ import annotations

import torch


def gmm_ref(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x: (E,C,D) or (B,E,C,D); w: (E,D,F) -> (E,C,F) or (B,E,C,F)."""
    acc = torch.promote_types(x.dtype, torch.float32)
    return torch.einsum("...ecd,edf->...ecf", x.to(acc),
                        w.to(acc)).to(x.dtype)
