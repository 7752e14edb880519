"""Int8 gradient compression with error feedback (cross-pod hop): the port
of ``repro.optim.compression``.

Gradients are quantized to int8 with a per-tensor scale before the
cross-pod reduction and the quantization error is fed back into the next
step (error feedback keeps SGD/Adam convergence unbiased in expectation).
The arithmetic is the reference's: the scale is ``max(max|x|, 1e-12) /
127`` in f32, the quotient is rounded half to even (``torch.round``, as
``jnp.round``) and clipped to +-127.  Trees are name-keyed dicts of
tensors (``{name: grad}``), nested dicts included.
"""

from __future__ import annotations

from typing import Any, Mapping, Tuple

import torch


def quantize_int8(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Symmetric per-tensor int8 quantization; returns (q, scale)."""
    x32 = x.float()
    scale = torch.clamp(x32.abs().max(), min=1e-12) / 127.0
    q = torch.clamp(torch.round(x32 / scale), -127, 127).to(torch.int8)
    return q, scale


def dequantize_int8(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.float() * scale


def _map(fn, tree: Mapping) -> dict:
    return {k: _map(fn, v) if isinstance(v, Mapping) else fn(v)
            for k, v in tree.items()}


def init_error_feedback(grads: Mapping) -> dict:
    return _map(lambda g: torch.zeros(g.shape, dtype=torch.float32,
                                      device=g.device), grads)


def compress_with_feedback(grads: Mapping, error_state: Mapping
                           ) -> Tuple[dict, dict]:
    """Returns ((q, scale) tree, new_error_state).

    new_error = (g + error) - dequant(quant(g + error))
    """
    qtree: dict = {}
    etree: dict = {}
    for k, g in grads.items():
        if isinstance(g, Mapping):
            qtree[k], etree[k] = compress_with_feedback(g, error_state[k])
            continue
        corrected = g.float() + error_state[k]
        q, scale = quantize_int8(corrected)
        qtree[k] = (q, scale)
        etree[k] = corrected - dequantize_int8(q, scale)
    return qtree, etree


def decompress(qtree: Mapping) -> dict:
    def one(v: Any):
        if isinstance(v, Mapping):
            return decompress(v)
        return dequantize_int8(*v)
    return {k: one(v) for k, v in qtree.items()}
