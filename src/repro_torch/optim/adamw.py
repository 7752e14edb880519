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
"""

from __future__ import annotations

from typing import Dict, Mapping, Tuple, Union

import torch
from torch import nn

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


def global_norm(tree: Mapping[str, torch.Tensor]) -> torch.Tensor:
    sums = [x.float().square().sum() for x in tree.values()]
    return torch.sqrt(torch.stack(sums).sum())


@torch.no_grad()
def adamw_update(grads: Mapping[str, torch.Tensor], opt_state: Dict,
                 params: Params, cfg: OptimizerConfig
                 ) -> Tuple[Params, Dict, Dict[str, torch.Tensor]]:
    """Returns (params, opt_state, metrics); ``grads`` maps each parameter
    name to its gradient.  Parameters and moments are updated in place."""
    count = opt_state["count"] + 1
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
        g = grads[name].float() * clip
        m_new = b1 * m + (1 - b1) * g
        v_new = b2 * v + (1 - b2) * torch.square(g)
        step = (m_new / bc1) / (torch.sqrt(v_new / bc2) + eps)
        step = step + cfg.weight_decay * p.float()
        p.copy_(p.float() - lr * step)
        m.copy_(m_new)
        v.copy_(v_new)
    opt_state["count"] = count
    return params, opt_state, {"grad_norm": gnorm, "lr": lr}
