"""AdamW with decoupled weight decay and global-norm clipping: the port of
``repro.optim.adamw``.

Moments are f32 whatever the parameter dtype.  The state mirrors the
parameters by name: ``{"m": {name: f32}, "v": {name: f32}, "count":
int32}``, with the names of ``Module.named_parameters()``
(``convert.opt_state_to_tree`` lays it out as the reference's pytree).
The step counter, the learning rate and the bias corrections are f32
tensors, as the reference computes them, not Python floats.

Unlike the reference, which returns new arrays, the update writes the
parameters and moments in place (it returns the same objects): a second
copy of the optimizer state would double its memory.

Sharded (DTensor) parameters, gradients and moments: the gradient norm
sums each rank's local squares, each divided by the number of ranks that
hold the same shard, and all-reduces the one sum, so the clip equals the
single-device clip.  Each leaf's update runs on the moments' local shards
(ZeRO-1: a moment may be split over dp where its parameter is not); the
gradient and the parameter are cut to that layout locally, and the new
parameter shard is gathered back into the parameter's placement.
"""

from __future__ import annotations

from typing import Dict, Mapping, Tuple, Union

import torch
import torch.distributed as dist
from torch import nn
from torch.distributed.tensor import DTensor, Replicate

from ..config import OptimizerConfig
from .schedules import cosine_schedule

Params = Union[nn.Module, Mapping[str, torch.Tensor]]


def _named(params: Params) -> Dict[str, torch.Tensor]:
    if isinstance(params, nn.Module):
        return dict(params.named_parameters())
    return dict(params)


def adamw_init(params: Params) -> Dict:
    named = _named(params)

    def zeros():
        return {name: torch.zeros(p.shape, dtype=torch.float32,
                                  device=p.device)
                for name, p in named.items()}

    device = next(iter(named.values())).device
    return {"m": zeros(), "v": zeros(),
            "count": torch.zeros((), dtype=torch.int32, device=device)}


def _local_square_sum(x: torch.Tensor) -> torch.Tensor:
    """A DTensor's share of its squared norm: its local sum over the
    number of ranks that hold that shard."""
    copies = 1
    for i, pl in enumerate(x.placements):
        if isinstance(pl, Replicate):
            copies *= x.device_mesh.size(i)
    return x.to_local().float().square().sum() / copies


def global_norm(tree: Mapping[str, torch.Tensor]) -> torch.Tensor:
    """sqrt of the sum of squares of every leaf; for DTensor leaves (placed
    by shards and replicas, no partial sums) one all-reduce of the ranks'
    shares over the default group, a plain tensor on every rank."""
    vals = list(tree.values())
    if not any(isinstance(x, DTensor) for x in vals):
        sums = [x.float().square().sum() for x in vals]
        return torch.sqrt(torch.stack(sums).sum())
    total = torch.stack([_local_square_sum(x) for x in vals]).sum()
    dist.all_reduce(total)
    return torch.sqrt(total)


def _local(x):
    return x.to_local() if isinstance(x, DTensor) else x


@torch.no_grad()
def adamw_update(grads: Mapping[str, torch.Tensor], opt_state: Dict,
                 params: Params, cfg: OptimizerConfig
                 ) -> Tuple[Params, Dict, Dict[str, torch.Tensor]]:
    """Returns (params, opt_state, metrics); ``grads`` maps each parameter
    name to its gradient.  Parameters and moments are updated in place."""
    count_in = opt_state["count"]
    count = _local(count_in) + 1
    lr = cosine_schedule(count, lr=cfg.lr, warmup_steps=cfg.warmup_steps,
                         total_steps=cfg.total_steps)

    gnorm = global_norm(grads)
    clip = (torch.clamp(cfg.grad_clip / torch.clamp(gnorm, min=1e-9),
                        max=1.0) if cfg.grad_clip > 0 else 1.0)

    b1, b2, eps = cfg.b1, cfg.b2, cfg.eps
    c = count.to(torch.float32)
    bc1 = 1.0 - b1 ** c
    bc2 = 1.0 - b2 ** c

    for name, p in _named(params).items():
        m, v = opt_state["m"][name], opt_state["v"][name]
        g, p_m = grads[name], p
        if isinstance(m, DTensor):
            # the moments' layout (ZeRO-1): cut locally, no communication
            g = g.redistribute(m.device_mesh, m.placements)
            p_m = p.redistribute(m.device_mesh, m.placements)
        g, p_l = _local(g).float() * clip, _local(p_m).float()
        m_l, v_l = _local(m), _local(v)
        m_new = b1 * m_l + (1 - b1) * g
        v_new = b2 * v_l + (1 - b2) * torch.square(g)
        step = (m_new / bc1) / (torch.sqrt(v_new / bc2) + eps)
        step = step + cfg.weight_decay * p_l
        new_p = p_l - lr * step
        if isinstance(m, DTensor):
            new_p = DTensor.from_local(
                new_p.to(p.dtype), m.device_mesh, m.placements,
                run_check=False).redistribute(
                    p.device_mesh, p.placements).to_local()
        _local(p).copy_(new_p)
        m_l.copy_(m_new)
        v_l.copy_(v_new)
    opt_state["count"] = (DTensor.from_local(count, count_in.device_mesh,
                                             count_in.placements,
                                             run_check=False)
                          if isinstance(count_in, DTensor) else count)
    return params, opt_state, {"grad_norm": gnorm, "lr": lr}
