"""repro_torch: the PyTorch / CUDA port of ``repro`` for NVIDIA Hopper.

The JAX package ``repro`` is the reference; this package keeps its module
and function names so each port has an obvious counterpart.  It imports
nothing from ``repro`` (it keeps its own copies of the framework-free
parts it needs) and never imports ``jax``.

Entry points run on the card unless the caller asks for the CPU.
"""

from __future__ import annotations

from typing import Optional, Union

import torch

__version__ = "0.1.0"


def resolve_device(device: Optional[Union[str, torch.device]] = None
                   ) -> torch.device:
    """``cuda`` by default.  Raises when CUDA is asked for and absent: the
    port never drops silently to the CPU."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA was requested but no CUDA device is available; pass "
            "device='cpu' to run the plain PyTorch path on the CPU")
    return dev
