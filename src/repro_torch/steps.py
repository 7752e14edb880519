"""Step functions (train / prefill / decode): the port of
``repro.steps``'s step builders, on one device.

``make_train_step`` returns ``train_step(params, opt_state, batch, step)
-> (params, opt_state, metrics)``; the parameters and the optimizer state
are updated in place and returned (``optim.adamw``).  The reference's
sharding hooks, donation and dry-run shape functions belong to the
multi-device slice.
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch

from .config import ModelConfig, OptimizerConfig
from .models import transformer as T
from .optim import adamw_init, adamw_update


def make_train_step(cfg: ModelConfig, opt_cfg: OptimizerConfig,
                    microbatches: int = 1, impl: str = "auto"):
    """Returns train_step(params, opt_state, batch, step) ->
        (params, opt_state, metrics).

    Each layer is recomputed in the backward pass (the reference's
    default ``remat=True``).  With ``cfg.gcr_moe`` the MoE's admission
    order rotates by a stride of 4099 tokens every
    ``gcr_moe_rotate_every`` steps.  ``microbatches > 1`` accumulates gradients
    over batch splits (the batch's leading axis cut into equal consecutive
    parts), in f32, and averages them and the loss over the splits: peak
    activation memory divides by the microbatch count.  ``impl="ref"``
    sends every kernel to its plain version on the card (for
    comparing)."""

    def grads_of(params, batch, step):
        moe_offset = None
        if cfg.gcr_moe:
            # GCR-MoE fairness rotation: priority origin moves every
            # gcr_moe_rotate_every steps (the THRESHOLD-promotion analogue).
            stride = 4099  # prime stride: co-prime with token counts
            moe_offset = (step // cfg.gcr_moe_rotate_every) * stride
        loss, metrics = T.forward_train(cfg, params, batch,
                                        moe_offset=moe_offset, impl=impl)
        named = dict(params.named_parameters())
        grads = torch.autograd.grad(loss, list(named.values()))
        return loss, metrics, dict(zip(named, grads))

    def train_step(params, opt_state, batch, step):
        if microbatches == 1:
            loss, metrics, grads = grads_of(params, batch, step)
        else:
            grads = {name: torch.zeros(p.shape, dtype=torch.float32,
                                       device=p.device)
                     for name, p in params.named_parameters()}
            lsum = torch.zeros((), dtype=torch.float32,
                               device=params.embed.device)
            ms = []
            for j in range(microbatches):
                part = {key: val.reshape((microbatches,
                                          val.shape[0] // microbatches)
                                         + tuple(val.shape[1:]))[j]
                        for key, val in batch.items()}
                loss_j, m_j, g_j = grads_of(params, part, step)
                for name, g in g_j.items():
                    grads[name] = grads[name] + g.float()
                lsum = lsum + loss_j.detach()
                ms.append(m_j)
            grads = {name: g / microbatches for name, g in grads.items()}
            loss = lsum / microbatches
            metrics = {key: torch.stack([m[key].detach() for m in ms]).mean()
                       for key in ms[0]}
            metrics["loss"] = loss
        metrics = {key: val.detach() for key, val in metrics.items()}
        params, opt_state, opt_metrics = adamw_update(grads, opt_state,
                                                      params, opt_cfg)
        return params, opt_state, {**metrics, **opt_metrics}

    return train_step


def make_prefill(cfg: ModelConfig, max_len: int, impl: str = "auto"):
    """prefill_step(params, batch) -> (last-token logits, caches), without
    grad."""

    @torch.no_grad()
    def prefill_step(params, batch):
        return T.prefill(cfg, params, batch, max_len=max_len, impl=impl)

    return prefill_step


def make_decode_step(cfg: ModelConfig):
    """serve_step(params, caches, tokens) -> (logits, caches), without
    grad."""

    @torch.no_grad()
    def serve_step(params, caches, tokens):
        return T.decode_step(cfg, params, caches, tokens)

    return serve_step


def init_train_state(cfg: ModelConfig, generator: torch.Generator,
                     device=None) -> Tuple[T.Transformer, Dict]:
    """Materialized params (grad on) + AdamW state, drawn from
    ``generator`` (which must live on ``device``)."""
    params = T.init_params(cfg, generator, device)
    params.requires_grad_(True)
    return params, adamw_init(params)
