"""The plain backward of a kernel whose reference trains through a plain
function under ``jax.grad``: run the plain version again on the saved
inputs with grad on, and take its gradients."""

from __future__ import annotations

from typing import Callable, Optional, Sequence, Tuple

import torch


def replay_grads(plain: Callable, saved: Sequence[Optional[torch.Tensor]],
                 needs: Sequence[bool],
                 grad_outputs: Sequence[Optional[torch.Tensor]]
                 ) -> Tuple[Optional[torch.Tensor], ...]:
    """Gradients of ``plain(*saved)``'s outputs, weighted by
    ``grad_outputs`` (None for an output that got none), for each input
    with ``needs`` set; None for the others."""
    inputs = [None if t is None else t.detach().requires_grad_(need)
              for t, need in zip(saved, needs)]
    wanted = [t for t in inputs if t is not None and t.requires_grad]
    with torch.enable_grad():
        outs = plain(*inputs)
    pairs = [(out, g) for out, g in zip(outs, grad_outputs) if g is not None]
    if not wanted or not pairs:
        return (None,) * len(inputs)
    grads = iter(torch.autograd.grad([out for out, _ in pairs], wanted,
                                     [g for _, g in pairs],
                                     allow_unused=True))
    return tuple(next(grads) if t is not None and t.requires_grad else None
                 for t in inputs)
