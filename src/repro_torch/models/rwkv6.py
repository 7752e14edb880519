"""RWKV6 "Finch" block [arXiv:2404.05892]: the port of
``repro.models.rwkv6``.

Time mixing is a gated linear recurrence with a *data-dependent
per-channel decay* ``w_t`` and a bonus ``u`` for the current token:

    S_t = diag(w_t) S_{t-1} + k_t^T v_t          (state per head: K x V)
    y_t = r_t (diag(u) k_t^T v_t + S_{t-1})

``rwkv6_time_mix`` is the full-sequence (prefill) path: token shift,
lerp mixes, projections, the LoRA decay and the chunked WKV, which goes
through ``ops.wkv``: the Hopper kernel for a CUDA tensor, the plain
version (``ref.wkv_ref``, the reference's ``wkv_chunked``) for a CPU
tensor.  The decode steps are the O(1) recurrence, plain PyTorch in f32
as they are plain XLA in the reference.  Channel mixing is the
squared-ReLU MLP of the RWKV family.

The shift states are the last (normed) block input of the time mix and of
the channel mix, (B, 1, D) in the model's dtype; the WKV state is
(B, H, P, P) f32, ``state[b, h, k_dim, v_dim]``.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from ..kernels.rwkv6_wkv import ops
from ..kernels.rwkv6_wkv.ref import MAX_DECAY_RATE
from .layers import _param, dense_init_, merge_heads, no_sc, split_heads

LORA_DIM = 64


class RWKV6(nn.Module):
    """Parameters of ``repro.models.rwkv6.rwkv6_params``.  ``decay_w0``
    and ``bonus_u`` are f32 whatever the model's dtype, as in the
    reference."""

    def __init__(self, d_model: int, d_ff: int, n_heads: int,
                 head_dim: int, *, device, dtype) -> None:
        super().__init__()
        D, f32 = d_model, torch.float32
        # time mix
        for name in ("mu_r", "mu_k", "mu_v", "mu_w", "mu_g"):
            setattr(self, name, _param((D,), device, dtype))
        for name in ("w_r", "w_k", "w_v", "w_g", "w_o"):
            setattr(self, name, _param((D, D), device, dtype))
        # data-dependent decay (LoRA): w_t = exp(-exp(w0 + tanh(x A) B))
        self.decay_w0 = _param((D,), device, f32)
        self.decay_A = _param((D, LORA_DIM), device, dtype)
        self.decay_B = _param((LORA_DIM, D), device, dtype)
        self.bonus_u = _param((n_heads, head_dim), device, f32)
        self.ln_x_w = _param((D,), device, dtype)   # per-head group norm
        # channel mix
        self.mu_ck = _param((D,), device, dtype)
        self.mu_cr = _param((D,), device, dtype)
        self.c_k = _param((D, d_ff), device, dtype)
        self.c_v = _param((d_ff, D), device, dtype)
        self.c_r = _param((D, D), device, dtype)


@torch.no_grad()
def rwkv6_init_(p: RWKV6, generator: torch.Generator) -> None:
    """The reference's laws: every mix 0.5, projections and the decay LoRA
    N(0, 1/in_dim), ``decay_w0`` -3, ``bonus_u`` 0, the group-norm weight
    1."""
    for name in ("mu_r", "mu_k", "mu_v", "mu_w", "mu_g", "mu_ck", "mu_cr"):
        getattr(p, name).fill_(0.5)
    for w in (p.w_r, p.w_k, p.w_v, p.w_g, p.w_o, p.decay_A, p.decay_B,
              p.c_k, p.c_v, p.c_r):
        dense_init_(w, generator)
    p.decay_w0.fill_(-3.0)
    p.bonus_u.zero_()
    p.ln_x_w.fill_(1.0)


def _token_shift(x: torch.Tensor, prev: Optional[torch.Tensor]
                 ) -> torch.Tensor:
    """The x_{t-1} sequence; prev: (B,1,D) last token of the previous
    segment, or None for zeros."""
    if prev is None:
        prev = torch.zeros_like(x[:, :1])
    return torch.cat([prev, x[:, :-1]], dim=1)


def _lerp(x, xs, mu):
    return x + (xs - x) * mu


def _group_norm_heads(x: torch.Tensor, weight: torch.Tensor, n_heads: int,
                      eps: float = 1e-5) -> torch.Tensor:
    """Per-head LayerNorm (RWKV's ln_x): population variance, in f32."""
    B, S, D = x.shape
    xh = split_heads(x, B, S, n_heads, D // n_heads).float()
    mean = xh.mean(dim=-1, keepdim=True)
    var = xh.var(dim=-1, keepdim=True, unbiased=False)
    y = (xh - mean) * torch.rsqrt(var + eps)
    return (merge_heads(y, B, S, D) * weight.float()).to(x.dtype)


def _decay(p: RWKV6, xw: torch.Tensor) -> torch.Tensor:
    """w = exp(-min(exp(w0 + tanh(xw A) B), MAX_DECAY_RATE)), in f32."""
    dlog = p.decay_w0 + (torch.tanh(xw @ p.decay_A) @ p.decay_B).float()
    return torch.exp(-torch.clamp(torch.exp(dlog), max=MAX_DECAY_RATE))


def rwkv6_time_mix(
    p: RWKV6, x: torch.Tensor, *, n_heads: int, head_dim: int,
    shift_state: Optional[torch.Tensor] = None,
    wkv_state: Optional[torch.Tensor] = None,
    return_state: bool = False,
    impl: str = "auto",
    sc=no_sc,
):
    """x: (B,S,D).  Returns the output and, with ``return_state``, the
    shift state (B,1,D) and the final WKV state.  ``impl="ref"`` sends
    the WKV to the plain version even on the card (for comparing).
    ``sc`` pins r, k, v and w to the heads layout (the kernel splits by
    heads)."""
    B, S, D = x.shape
    xs = _token_shift(x, shift_state)
    xr = _lerp(x, xs, p.mu_r)
    xk = _lerp(x, xs, p.mu_k)
    xv = _lerp(x, xs, p.mu_v)
    xw = _lerp(x, xs, p.mu_w)
    xg = _lerp(x, xs, p.mu_g)

    r = sc(split_heads(xr @ p.w_r, B, S, n_heads, head_dim), "heads")
    k = sc(split_heads(xk @ p.w_k, B, S, n_heads, head_dim), "heads")
    v = sc(split_heads(xv @ p.w_v, B, S, n_heads, head_dim), "heads")
    g = F.silu(xg @ p.w_g)
    w = sc(split_heads(_decay(p, xw), B, S, n_heads, head_dim), "heads")

    y, final_wkv = ops.wkv(r, k, v, w, p.bonus_u, wkv_state, impl=impl)
    y = _group_norm_heads(merge_heads(y, B, S, D).to(x.dtype), p.ln_x_w,
                          n_heads)
    out = (y * g) @ p.w_o
    if return_state:
        # a copy: a view would keep the whole (B, S, D) input alive
        return out, x[:, -1:].clone(), final_wkv
    return out


def rwkv6_channel_mix(
    p: RWKV6, x: torch.Tensor,
    shift_state: Optional[torch.Tensor] = None,
    return_state: bool = False,
):
    xs = _token_shift(x, shift_state)
    xk = _lerp(x, xs, p.mu_ck)
    xr = _lerp(x, xs, p.mu_cr)
    k = torch.square(F.relu(xk @ p.c_k))
    out = torch.sigmoid(xr @ p.c_r) * (k @ p.c_v)
    if return_state:
        return out, x[:, -1:].clone()
    return out


def rwkv6_time_mix_step(p: RWKV6, x: torch.Tensor,
                        shift_state: torch.Tensor, wkv_state: torch.Tensor,
                        *, n_heads: int, head_dim: int):
    """O(1) recurrent step.  x: (B,1,D).  Returns (out, shift state,
    WKV state)."""
    B, _, D = x.shape
    xs = shift_state
    xr = _lerp(x, xs, p.mu_r)
    xk = _lerp(x, xs, p.mu_k)
    xv = _lerp(x, xs, p.mu_v)
    xw = _lerp(x, xs, p.mu_w)
    xg = _lerp(x, xs, p.mu_g)

    f32 = torch.float32
    r = split_heads(xr @ p.w_r, B, n_heads, head_dim).to(f32)
    k = split_heads(xk @ p.w_k, B, n_heads, head_dim).to(f32)
    v = split_heads(xv @ p.w_v, B, n_heads, head_dim).to(f32)
    g = F.silu(xg @ p.w_g)
    w = split_heads(_decay(p, xw), B, n_heads, head_dim)

    state = wkv_state.to(f32)
    kv = k[..., :, None] * v[..., None, :]                  # (B,H,P,P)
    y = torch.einsum("bhp,bhpq->bhq", r * p.bonus_u[None], kv) \
        + torch.einsum("bhp,bhpq->bhq", r, state)
    new_state = state * w[..., None] + kv

    y = merge_heads(y, B, 1, D).to(x.dtype)
    y = _group_norm_heads(y, p.ln_x_w, n_heads)
    out = (y * g) @ p.w_o
    return out, x, new_state.to(wkv_state.dtype)


def rwkv6_channel_mix_step(p: RWKV6, x: torch.Tensor,
                           shift_state: torch.Tensor):
    xs = shift_state
    xk = _lerp(x, xs, p.mu_ck)
    xr = _lerp(x, xs, p.mu_cr)
    k = torch.square(F.relu(xk @ p.c_k))
    out = torch.sigmoid(xr @ p.c_r) * (k @ p.c_v)
    return out, x
