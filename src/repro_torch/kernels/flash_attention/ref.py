"""Plain PyTorch attention with materialised scores: the flash kernel's
reference and its path on the CPU.

It computes what ``repro.models.layers._plain_attention`` and
``repro.kernels.flash_attention.ref.attention_ref`` compute, in f32 with
the output in q's dtype, and takes the model's positions and GQA layout.
A row whose keys are all masked gets the uniform average here, as
``jax.nn.softmax`` gives it; the kernel gives zeros for such a row (the
reference flash path's guard).  Causal prefill has no such row.
"""

from __future__ import annotations

import math

import torch

NEG_INF = -1e30


def attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  q_pos: torch.Tensor, k_pos: torch.Tensor, window: int = 0,
                  causal: bool = True) -> torch.Tensor:
    """q: (B,S,Hq,D); k,v: (B,T,Hkv,D); q_pos (S,), k_pos (T,) int.

    Query head h reads kv head h // (Hq // Hkv), the mapping of the
    reference's ``jnp.repeat(k, G, axis=2)``.  Mask: ``k_pos >= 0``; if
    causal also ``k_pos <= q_pos`` and, with a window,
    ``q_pos - k_pos < window``."""
    B, S, Hq, D = q.shape
    Hkv = k.shape[2]
    scale = 1.0 / math.sqrt(D)
    qg = q.float().reshape(B, S, Hkv, Hq // Hkv, D)
    scores = torch.einsum("bshgd,bthd->bhgst", qg, k.float()) * scale
    mask = (k_pos >= 0)[None, :]
    if causal:
        mask = mask & (k_pos[None, :] <= q_pos[:, None])
        if window:
            mask = mask & ((q_pos[:, None] - k_pos[None, :]) < window)
    scores = torch.where(mask, scores, NEG_INF)
    probs = torch.softmax(scores, dim=-1)
    out = torch.einsum("bhgst,bthd->bshgd", probs, v.float())
    return out.reshape(B, S, Hq, D).to(q.dtype)
