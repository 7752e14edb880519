"""Plain PyTorch attention: the flash kernel's reference and its path on
the CPU, forward (``attention_ref``) and backward (``flash_bwd_ref``).

``attention_ref`` computes what ``repro.models.layers._plain_attention``
and ``repro.kernels.flash_attention.ref.attention_ref`` compute, in f32
with the output in q's dtype, and takes the model's positions and GQA
layout.  A row whose keys are all masked gets the uniform average here, as
``jax.nn.softmax`` gives it; the kernel gives zeros for such a row (the
reference flash path's guard).  Causal prefill has no such row.

``flash_bwd_ref`` is the port of the reference's attention gradient,
``repro.models.layers._flash_bwd_impl`` (plain XLA there, so plain
PyTorch here): probabilities recomputed block by block from the saved
log-sum-exp, never the whole (S, T) score matrix.
"""

from __future__ import annotations

import math

import torch

NEG_INF = -1e30
# the reference's chunks (repro.models.layers.Q_CHUNK, KV_CHUNK)
Q_CHUNK = 512
KV_CHUNK = 1024


def _mask(q_pos, k_pos, window: int, causal: bool) -> torch.Tensor:
    """(S, T) bool: the reference's ``_chunk_mask``."""
    mask = (k_pos >= 0)[None, :]
    if causal:
        mask = mask & (k_pos[None, :] <= q_pos[:, None])
        if window:
            mask = mask & ((q_pos[:, None] - k_pos[None, :]) < window)
    return mask


def attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  q_pos: torch.Tensor, k_pos: torch.Tensor, window: int = 0,
                  causal: bool = True, return_lse: bool = False):
    """q: (B,S,Hq,D); k: (B,T,Hkv,D); v: (B,T,Hkv,Dv); q_pos (S,), k_pos
    (T,) int; the output (B,S,Hq,Dv).

    Query head h reads kv head h // (Hq // Hkv), the mapping of the
    reference's ``jnp.repeat(k, G, axis=2)``.  Mask: ``k_pos >= 0``; if
    causal also ``k_pos <= q_pos`` and, with a window,
    ``q_pos - k_pos < window``.

    With ``return_lse`` also returns each row's log-sum-exp of the scaled
    scores, f32 (B,Hq,S), as ``_flash_fwd_impl`` defines it:
    ``max(m, -1e29) + log(max(l, 1e-30))``."""
    B, S, Hq, D = q.shape
    Hkv = k.shape[2]
    scale = 1.0 / math.sqrt(D)
    qg = q.float().reshape(B, S, Hkv, Hq // Hkv, D)
    scores = torch.einsum("bshgd,bthd->bhgst", qg, k.float()) * scale
    scores = torch.where(_mask(q_pos, k_pos, window, causal), scores,
                         NEG_INF)
    probs = torch.softmax(scores, dim=-1)
    out = torch.einsum("bhgst,bthd->bshgd", probs, v.float())
    out = out.reshape(B, S, Hq, v.shape[3]).to(q.dtype)
    if not return_lse:
        return out
    m_safe = scores.amax(dim=-1).clamp(min=-1e29)
    l = torch.exp(scores - m_safe[..., None]).sum(dim=-1)
    lse = m_safe + torch.log(l.clamp(min=1e-30))
    return out, lse.reshape(B, Hq, S)


def flash_bwd_ref(q, k, v, q_pos, k_pos, out, lse, dout, window: int = 0,
                  causal: bool = True):
    """dq, dk, dv of ``out = attention(q, k, v)`` given ``dout``, from the
    saved ``out`` and ``lse`` (B,Hq,S): ``_flash_bwd_impl`` in its blocked
    form, with ``delta = rowsum(dout * out)``.  The reference walks the
    blocks twice (dq by q chunk over kv chunks, dk and dv by kv chunk over
    q chunks); this walks them once and adds each block's share to all
    three, in the same order, so every sum is taken as the reference takes
    it.  Blocks are ``Q_CHUNK`` query rows by ``KV_CHUNK`` keys; the last
    of each may be short (the reference needs S and T to divide).

    GQA as in ``attention_ref``: q is read grouped (B,S,Hkv,G,D), so dk
    and dv come out summed over each group of query heads, the gradient of
    the reference's ``jnp.repeat``.  The casts are the reference's: the
    products take p and ds in q's dtype, sums are f32, and dq, dk, dv go
    back to the inputs' dtypes."""
    B, S, Hq, D = q.shape
    T, Hkv, Dv = k.shape[1], k.shape[2], v.shape[3]
    G = Hq // Hkv
    scale = 1.0 / math.sqrt(D)
    f32 = torch.float32
    qg = q.reshape(B, S, Hkv, G, D)
    dog = dout.reshape(B, S, Hkv, G, Dv)
    lse_g = lse.reshape(B, Hkv, G, S)
    delta = torch.einsum("bshgd,bshgd->bhgs", dog.to(f32),
                         out.reshape(B, S, Hkv, G, Dv).to(f32))
    dq = torch.zeros((B, S, Hkv, G, D), dtype=f32, device=q.device)
    dk = torch.zeros((B, T, Hkv, D), dtype=f32, device=q.device)
    dv = torch.zeros((B, T, Hkv, Dv), dtype=f32, device=q.device)
    for t0 in range(0, T, KV_CHUNK):
        tk = slice(t0, t0 + KV_CHUNK)
        k_blk, v_blk = k[:, tk], v[:, tk]
        for s0 in range(0, S, Q_CHUNK):
            sq = slice(s0, s0 + Q_CHUNK)
            q_blk, do_blk = qg[:, sq], dog[:, sq]
            sc = torch.einsum("bshgd,bthd->bhgst", q_blk, k_blk).to(f32) \
                * scale
            sc = torch.where(_mask(q_pos[sq], k_pos[tk], window, causal), sc,
                             NEG_INF)
            p = torch.exp(sc - lse_g[..., sq, None])      # (B,Hkv,G,s,t)
            dv[:, tk] += torch.einsum("bhgst,bshgd->bthd", p.to(q.dtype),
                                      do_blk).to(f32)
            dp = torch.einsum("bshgd,bthd->bhgst", do_blk, v_blk).to(f32)
            ds = (p * (dp - delta[..., sq, None])).to(q.dtype)
            dq[:, sq] += torch.einsum("bhgst,bthd->bshgd", ds,
                                      k_blk).to(f32) * scale
            dk[:, tk] += torch.einsum("bhgst,bshgd->bthd", ds,
                                      q_blk).to(f32) * scale
    return (dq.reshape(B, S, Hq, D).to(q.dtype), dk.to(k.dtype),
            dv.to(v.dtype))
