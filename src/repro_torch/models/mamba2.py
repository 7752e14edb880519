"""Mamba2 (SSD, state-space duality) block: the port of
``repro.models.mamba2``.

``mamba2_forward`` is the full-sequence (prefill) path: projections, the
depthwise causal convolutions with their state, and the chunked SSD scan,
which goes through ``ops.ssd``: the Hopper kernel for a CUDA tensor, the
plain version (``ssd_chunked``) for a CPU tensor.  ``mamba2_decode_step``
is the O(1) recurrent update of serving, plain PyTorch in f32 as it is
plain XLA in the reference.

Shapes (per block):
  x        (B, S, d_model)
  d_inner  = expand * d_model;  heads H = d_inner / head_dim (P);  state N.
  in_proj  -> z (d_inner), xin (d_inner), B (N), C (N), dt (H)
  SSM state (B, H, P, N), f32
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..kernels.mamba2_ssd import ops
from ..kernels.mamba2_ssd.ref import CHUNK, ssd_ref
from .layers import (_param, dense_init_, merge_heads, no_sc, rms_norm,
                     split_heads)


class Mamba2(nn.Module):
    """Parameters of ``repro.models.mamba2.mamba2_params``.  ``A_log``,
    ``dt_bias`` and ``D`` are f32 whatever the model's dtype, as in the
    reference."""

    def __init__(self, d_model: int, d_inner: int, n_state: int,
                 n_heads: int, conv_k: int, *, device, dtype) -> None:
        super().__init__()
        f32 = torch.float32
        self.w_z = _param((d_model, d_inner), device, dtype)
        self.w_x = _param((d_model, d_inner), device, dtype)
        self.w_B = _param((d_model, n_state), device, dtype)
        self.w_C = _param((d_model, n_state), device, dtype)
        self.w_dt = _param((d_model, n_heads), device, dtype)
        self.conv_x_w = _param((conv_k, d_inner), device, dtype)
        self.conv_x_b = _param((d_inner,), device, dtype)
        self.conv_B_w = _param((conv_k, n_state), device, dtype)
        self.conv_B_b = _param((n_state,), device, dtype)
        self.conv_C_w = _param((conv_k, n_state), device, dtype)
        self.conv_C_b = _param((n_state,), device, dtype)
        self.A_log = _param((n_heads,), device, f32)      # A = -exp(A_log)
        self.dt_bias = _param((n_heads,), device, f32)
        self.D = _param((n_heads,), device, f32)
        self.norm_w = _param((d_inner,), device, dtype)
        self.out_proj = _param((d_inner, d_model), device, dtype)


@torch.no_grad()
def mamba2_init_(p: Mamba2, generator: torch.Generator) -> None:
    """The reference's laws: projections N(0, 1/in_dim), convolution
    weights N(0, 1) * 0.1 drawn in f32, zero biases, A_log 0, dt_bias -2,
    D and the norm weight 1."""
    for w in (p.w_z, p.w_x, p.w_B, p.w_C, p.w_dt, p.out_proj):
        dense_init_(w, generator)
    for w in (p.conv_x_w, p.conv_B_w, p.conv_C_w):
        w.copy_(torch.randn(w.shape, generator=generator, device=w.device,
                            dtype=torch.float32) * 0.1)
    for b in (p.conv_x_b, p.conv_B_b, p.conv_C_b, p.A_log):
        b.zero_()
    p.dt_bias.fill_(-2.0)
    p.D.fill_(1.0)
    p.norm_w.fill_(1.0)


def _causal_conv(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                 state: Optional[torch.Tensor]
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Depthwise causal conv1d.  x: (B,S,C); w: (K,C); state: (B,K-1,C).

    The K products are summed in x's dtype, left to right, then the bias
    added, as the reference does (``F.conv1d`` would sum in f32 and move
    bf16 results)."""
    K, S = w.shape[0], x.shape[1]
    if state is None:
        state = torch.zeros((x.shape[0], K - 1, x.shape[2]), dtype=x.dtype,
                            device=x.device)
    xp = torch.cat([state, x], dim=1)
    out = xp[:, 0:S] * w[0]
    for i in range(1, K):
        out = out + xp[:, i:i + S] * w[i]
    out = out + b
    # a copy: a view would keep the whole (B, S+K-1, C) input alive
    new_state = xp[:, -(K - 1):].clone() if K > 1 else state
    return F.silu(out), new_state


def _project(p: Mamba2, x: torch.Tensor):
    return (x @ p.w_z, x @ p.w_x, x @ p.w_B, x @ p.w_C, x @ p.w_dt)


def ssd_chunked(xh: torch.Tensor, a: torch.Tensor, Bm: torch.Tensor,
                Cm: torch.Tensor, init_state: Optional[torch.Tensor] = None,
                chunk: int = CHUNK) -> Tuple[torch.Tensor, torch.Tensor]:
    """Chunked SSD, plain PyTorch (``ssd_ref``).  xh: (B,S,H,P) inputs
    premultiplied by dt; a: (B,S,H) log decays; Bm, Cm: (B,S,N).  Returns
    (y (B,S,H,P), final_state (B,H,P,N) f32)."""
    return ssd_ref(xh, a, Bm, Cm, init_state, chunk)


def mamba2_forward(
    p: Mamba2, x: torch.Tensor, *,
    d_inner: int, n_state: int, n_heads: int, head_dim: int,
    eps: float = 1e-5,
    ssm_state: Optional[torch.Tensor] = None,
    conv_state: Optional[Dict[str, torch.Tensor]] = None,
    return_state: bool = False,
    impl: str = "auto",
    sc=no_sc,
):
    """Full-sequence forward (prefill).  ``impl="ref"`` sends the scan to
    the plain version even on the card (for comparing).  ``sc`` pins the
    scan's input to the heads layout (the kernel splits by heads)."""
    B, S, _ = x.shape
    z, xin, Bmat, Cmat, dt = _project(p, x)

    cs = conv_state if conv_state is not None else {}
    xin, cs_x = _causal_conv(xin, p.conv_x_w, p.conv_x_b, cs.get("x"))
    Bmat, cs_B = _causal_conv(Bmat, p.conv_B_w, p.conv_B_b, cs.get("B"))
    Cmat, cs_C = _causal_conv(Cmat, p.conv_C_w, p.conv_C_b, cs.get("C"))
    new_conv_state = {"x": cs_x, "B": cs_B, "C": cs_C}

    dt = F.softplus(dt.float() + p.dt_bias)                    # (B,S,H)
    A = -torch.exp(p.A_log)                                     # (H,)
    a = dt * A                                                  # log decay
    xh = split_heads(xin, B, S, n_heads, head_dim)
    xdt = sc((xh.float() * dt[..., None]).to(x.dtype), "heads")

    y, final_state = ops.ssd(xdt, a, Bmat.to(x.dtype), Cmat.to(x.dtype),
                             ssm_state, impl=impl)
    y = y + xh * p.D[None, None, :, None].to(x.dtype)
    y = merge_heads(y, B, S, d_inner)

    # gated RMSNorm then output projection
    y = rms_norm(y * F.silu(z), p.norm_w, eps)
    out = y @ p.out_proj
    if return_state:
        return out, (final_state, new_conv_state)
    return out


def mamba2_decode_step(
    p: Mamba2, x: torch.Tensor, ssm_state: torch.Tensor,
    conv_state: Dict[str, torch.Tensor], *,
    d_inner: int, n_state: int, n_heads: int, head_dim: int,
    eps: float = 1e-5,
) -> Tuple[torch.Tensor, torch.Tensor, Dict[str, torch.Tensor]]:
    """Single-token recurrent update.  x: (B,1,D); state (B,H,P,N)."""
    B = x.shape[0]
    z, xin, Bmat, Cmat, dt = _project(p, x)

    xin, cs_x = _causal_conv(xin, p.conv_x_w, p.conv_x_b, conv_state["x"])
    Bmat, cs_B = _causal_conv(Bmat, p.conv_B_w, p.conv_B_b, conv_state["B"])
    Cmat, cs_C = _causal_conv(Cmat, p.conv_C_w, p.conv_C_b, conv_state["C"])
    new_conv_state = {"x": cs_x, "B": cs_B, "C": cs_C}

    dt = F.softplus(dt.float() + p.dt_bias)[:, 0]             # (B,H)
    A = -torch.exp(p.A_log)
    decay = torch.exp(dt * A)                                   # (B,H)
    xh = split_heads(xin, B, n_heads, head_dim).float()
    Bv = Bmat[:, 0].float()                                     # (B,N)
    Cv = Cmat[:, 0].float()

    # h' = decay * h + dt * (x outer B);  y = C . h' + D*x
    upd = (dt[..., None] * xh)[..., None] * Bv[:, None, None, :]
    new_state = ssm_state * decay[..., None, None] + upd.to(ssm_state.dtype)
    y = torch.einsum("bhpn,bn->bhp", new_state.float(), Cv)
    y = y + xh * p.D[None, :, None]
    y = merge_heads(y, B, 1, d_inner).to(x.dtype)

    y = rms_norm(y * F.silu(z), p.norm_w, eps)
    return y @ p.out_proj, new_state, new_conv_state
