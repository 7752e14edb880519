"""Mixture-of-experts MLP with GCR-style capacity admission: the port of
``repro.models.moe``.

Expert capacity is the saturated shared resource and tokens are the
contending threads.  Tokens are admitted to an expert's capacity buffer in
priority order; with ``gcr_admission`` and a ``priority_offset`` the
priority origin is rotated (GCR's periodic promotion shuffle), so the same
tail positions are not always the ones dropped.  Dropped (passive) tokens
fall through on the residual path.

Dispatch is grouped per batch row, as in the reference: ranks, capacity
and the scatter/gather are computed for each sequence on its own.  The
reference's ``jax.vmap`` over rows is written out as batched tensor ops.
The three expert products go through ``grouped_matmul``: the Hopper
kernel for a CUDA tensor, the plain version for a CPU tensor.  Routing,
the scatter, the SwiGLU and the combine are plain PyTorch, as they are
plain XLA in the reference.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple, Union

import torch
import torch.nn.functional as F
from torch import nn

from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
from torch.distributed.tensor.experimental import local_map

from ..kernels.moe_gmm.ops import grouped_matmul
from .layers import _param, dense_init_, no_sc


class MoE(nn.Module):
    """Parameters of ``repro.models.moe.moe_params``.  The router is f32
    whatever the model's dtype, as in the reference."""

    def __init__(self, d_model: int, d_ff: int, n_experts: int, *, device,
                 dtype) -> None:
        super().__init__()
        self.router = _param((d_model, n_experts), device, torch.float32)
        self.wi_gate = _param((n_experts, d_model, d_ff), device, dtype)
        self.wi_up = _param((n_experts, d_model, d_ff), device, dtype)
        self.wo = _param((n_experts, d_ff, d_model), device, dtype)


@torch.no_grad()
def moe_init_(p: MoE, generator: torch.Generator) -> None:
    """The reference's laws: every matrix N(0, 1/in_dim)."""
    for w in (p.router, p.wi_gate, p.wi_up, p.wo):
        dense_init_(w, generator)


def _capacity(n_tokens: int, n_experts: int, top_k: int,
              capacity_factor: float) -> int:
    cap = int(n_tokens * top_k * capacity_factor / n_experts)
    return max(8, ((cap + 7) // 8) * 8)   # pad to sublane multiple


def router_topk(router: torch.Tensor, x: torch.Tensor, top_k: int):
    """f32 router logits, probabilities, and the top-k gates (renormalised)
    and experts of every token: (logits, probs, gate_vals, expert_idx)."""
    logits = x.float() @ router                                # (B,S,E)
    probs = torch.softmax(logits, dim=-1)
    gate_vals, expert_idx = torch.topk(probs, top_k, dim=-1)   # (B,S,k)
    gate_vals = gate_vals / gate_vals.sum(-1, keepdim=True).clamp_min(1e-9)
    return logits, probs, gate_vals, expert_idx


def admission_ranks(expert_idx: torch.Tensor, n_experts: int,
                    priority_offset: Optional[Union[int, torch.Tensor]]
                    = None) -> torch.Tensor:
    """expert_idx: (B,S,k) expert choices.  Returns the rank (B,S,k) of
    each (token, slot) among its expert's earlier claimants in its row:
    in token order, or with ``priority_offset`` in the order rotated to
    start at token ``priority_offset % S`` (a cyclic shift, so the "sort"
    by priority is a roll).

    The claims are counted expert-major, (B,E,S*k), so the running count
    is a scan along the contiguous last dim: the reference's
    ``cumsum(one_hot)`` over the token axis is an outer-dim scan, which
    on the card took longer than the expert products."""
    B, S, k = expert_idx.shape
    if priority_offset is not None:
        off = priority_offset % S
        pos = torch.arange(S, device=expert_idx.device)
        order, unsort = (pos + off) % S, (pos - off) % S
        return admission_ranks(expert_idx[:, order], n_experts)[:, unsort]
    flat = expert_idx.reshape(B, 1, S * k)
    experts = torch.arange(n_experts, device=expert_idx.device)[:, None]
    claims = (flat == experts).cumsum(-1, dtype=torch.int32)  # inclusive
    return (claims.gather(1, flat) - 1).reshape(B, S, k)


class _Dispatch(torch.autograd.Function):
    """The expert buffers' rows: token ``src[i]`` of x (B*S, D) for each
    capacity slot i, a zero row where ``src[i]`` is B*S (an unfilled
    slot).  The backward gives each token the sum of its k slots'
    gradients (``slot`` (B*S, k), a dropped one at the discard slot, which
    reads zero): one gather and a sum, where autograd's backward of the
    gather would add every unfilled slot's gradient into the zero row one
    after another."""

    @staticmethod
    def forward(ctx, x, src, slot):
        ctx.save_for_backward(slot)
        return torch.cat([x, x.new_zeros(1, x.shape[1])])[src]

    @staticmethod
    def backward(ctx, grad):
        (slot,) = ctx.saved_tensors
        rows = torch.cat([grad, grad.new_zeros(1, grad.shape[1])])
        return (rows.index_select(0, slot.reshape(-1))
                .view(*slot.shape, -1).sum(1), None, None)


def _dispatch(router: torch.Tensor, x: torch.Tensor, E: int, k: int,
              cap: int, offset):
    """Routing, admission and the scatter into the capacity buffers, per
    batch row: (expert_in (B,E,C,D), gate_vals (B,S,k) zeroed where not
    admitted, the combine's slot index (B,S,k), and for the aux metrics
    the router's logits and probabilities, expert_idx and admitted)."""
    B, S, D = x.shape
    logits, probs, gate_vals, expert_idx = router_topk(router, x, k)
    rank_in_expert = admission_ranks(expert_idx, E, offset)
    admitted = rank_in_expert < cap                            # active set
    gate_vals = gate_vals * admitted                           # passive -> 0

    # --- scatter: each capacity slot (b, e, c) records which token it holds;
    # unfilled slots read a zero row and dropped slots land in one discard
    # slot, the reference's discard row ----------------------------------
    rows = torch.arange(B, device=x.device)[:, None, None]
    flat_c = torch.where(admitted, rank_in_expert, 0)          # (B,S,k)
    slot = torch.where(admitted, (rows * E + expert_idx) * cap + flat_c,
                       B * E * cap)
    token = (rows * S + torch.arange(S, device=x.device)[:, None]
             ).expand(B, S, k)
    src = torch.full((B * E * cap + 1,), B * S, dtype=torch.long,
                     device=x.device)
    src.index_copy_(0, slot.reshape(-1), token.reshape(-1))
    expert_in = _Dispatch.apply(x.reshape(B * S, D), src[:-1],
                                slot.reshape(B * S, k)).view(B, E, cap, D)
    # dropped slots read slot 0 of their expert, under a zero gate, as in
    # the reference
    combine_idx = (rows * E + expert_idx) * cap + flat_c
    return (expert_in, gate_vals, combine_idx, logits, probs, expert_idx,
            admitted)


def _combine(expert_out: torch.Tensor, combine_idx: torch.Tensor,
             gate_vals: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """Gather each (token, slot)'s expert output back and combine in
    ``dtype``; the gather's backward adds the dropped slots' zero
    gradients into slot 0, which leaves it as it is."""
    B, E, cap, D = expert_out.shape
    S, k = combine_idx.shape[1:]
    gathered = expert_out.reshape(B * E * cap, D).index_select(
        0, combine_idx.reshape(-1))
    gathered = gathered.view(B, S, k, D) * gate_vals[..., None].to(dtype)
    return gathered.sum(dim=2)


def moe_mlp(
    p: MoE,
    x: torch.Tensor,                 # (B, S, D)
    *,
    n_experts: int,
    top_k: int,
    capacity_factor: float = 1.25,
    gcr_admission: bool = False,
    priority_offset: Optional[Union[int, torch.Tensor]] = None,
    impl: str = "auto",              # expert products: auto | ref
    sc=no_sc,                        # sharding hook
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Returns (output (B,S,D) in x's dtype, aux metrics incl. the
    load-balance loss), as ``repro.models.moe.moe_mlp``.

    A DTensor ``x`` (under sharding rules) is routed, dispatched and
    combined on each rank's own batch rows (``_sharded_moe``); the expert
    products run on the layout ``sc(..., "moe_buf")`` gives them."""
    B, S, D = x.shape
    E, k = n_experts, top_k
    cap = _capacity(S, E, k, capacity_factor)
    offset = priority_offset if gcr_admission else None
    if isinstance(x, DTensor):
        return _sharded_moe(p, x, E, k, cap, offset, impl, sc)
    (expert_in, gate_vals, combine_idx, logits, probs, expert_idx,
     admitted) = _dispatch(p.router, x, E, k, cap, offset)
    expert_in = sc(expert_in, "moe_buf")

    h = F.silu(grouped_matmul(expert_in, p.wi_gate, impl=impl)) \
        * grouped_matmul(expert_in, p.wi_up, impl=impl)
    expert_out = sc(grouped_matmul(h, p.wo, impl=impl), "moe_buf")
    out = _combine(expert_out, combine_idx, gate_vals, x.dtype)

    # aux: load-balance loss (Switch) + router z-loss + drop fraction
    density = F.one_hot(expert_idx, E).float().mean(dim=(0, 1, 2)) * E
    router_prob = probs.mean(dim=(0, 1)) * E
    aux = {
        "moe_lb_loss": (density * router_prob).mean(),
        "moe_z_loss": torch.logsumexp(logits, dim=-1).square().mean(),
        "moe_drop_frac": 1.0 - admitted.float().mean(),
    }
    return out, aux


def _sharded_moe(p, x, E: int, k: int, cap: int, offset, impl: str, sc):
    """``moe_mlp`` for a DTensor ``x``.  Routing, admission and capacity
    are per batch row, so ``_dispatch`` and ``_combine`` run through
    ``local_map`` on each rank's whole rows (x split only by batch,
    replicated on every other mesh dim); the three expert products take
    the capacity buffers as ``sc`` places them (EP: experts on the model
    axis) and the combine gathers them back.  The aux metrics are means
    over the global batch (DTensor reductions of the rows' values)."""
    mesh = x.device_mesh
    rows = [Shard(0) if pl == Shard(0) else Replicate()
            for pl in x.placements]
    rep = [Replicate()] * mesh.ndim
    # the router's gradient sums over the batch-split dims
    router_grad = [Partial() if pl == Shard(0) else Replicate()
                   for pl in rows]

    def front(xl, rl):
        (expert_in, gate_vals, combine_idx, logits, probs, expert_idx,
         admitted) = _dispatch(rl, xl, E, k, cap, offset)
        return (expert_in, gate_vals, combine_idx, probs,
                torch.logsumexp(logits, dim=-1).square(),
                F.one_hot(expert_idx, E).float(), admitted.float())

    (expert_in, gate_vals, combine_idx, probs, lse2, assign,
     admitted) = local_map(
        front, out_placements=(rows,) * 7, in_placements=(rows, rep),
        in_grad_placements=(rows, router_grad), device_mesh=mesh,
        redistribute_inputs=True)(x, p.router)
    expert_in = sc(expert_in, "moe_buf")
    h = F.silu(grouped_matmul(expert_in, p.wi_gate, impl=impl)) \
        * grouped_matmul(expert_in, p.wi_up, impl=impl)
    expert_out = sc(grouped_matmul(h, p.wo, impl=impl), "moe_buf")
    out = local_map(
        lambda eo, ci, gv: _combine(eo, ci, gv, x.dtype),
        out_placements=rows, in_placements=(rows, rows, rows),
        in_grad_placements=(rows, rows, rows), device_mesh=mesh,
        redistribute_inputs=True)(expert_out, combine_idx, gate_vals)

    density = assign.mean(dim=(0, 1, 2)) * E
    router_prob = probs.mean(dim=(0, 1)) * E
    aux = {
        "moe_lb_loss": (density * router_prob).mean(),
        "moe_z_loss": lse2.mean(),
        "moe_drop_frac": 1.0 - admitted.mean(),
    }
    # the batch means summed over the ranks now (replicated scalars)
    return out, {key: val.redistribute(mesh, rep) for key, val in aux.items()}
