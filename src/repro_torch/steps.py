"""Step functions (train / prefill / decode) and dry-run input specs: the
port of ``repro.steps``.

``make_train_step`` returns ``train_step(params, opt_state, batch, step)
-> (params, opt_state, metrics)``; the parameters and the optimizer state
are updated in place and returned (``optim.adamw``).

With ``rules`` (``parallel.ShardingRules``) each builder passes
``rules.constrain`` to the model as its ``sc`` hook, as the reference
does.  The parameters and moments are then DTensors placed by the rules
(``rules.distribute_params``, ``rules.distribute_opt``); a batch of plain
tensors (the same global batch on every rank) is split over dp by
``batch_specs``; the step runs under DTensor's implicit replication (a
plain tensor made inside the model, such as the positions, counts as
replicated), and the four kernels run on each rank's local shards
(``kernels._sharded``).  The reference's donation has no counterpart
(the train step updates in place).

The dry-run specs (``batch_shapes``, ``decode_state_shapes``,
``train_state_shapes``) are the ``jax.ShapeDtypeStruct`` analogue: shape
and dtype, nothing allocated (meta tensors; the cache's leaves are
``transformer.CacheLeaf``s).  The batch is the reference's dict; the
caches and the train state are in the port's layout (one module or dict
a layer), which ``convert`` maps to the reference's stacked tree
(``transformer.param_shapes``, ``transformer.cache_shapes``).
"""

from __future__ import annotations

import contextlib
from typing import Dict, Optional, Tuple

import torch
from torch.distributed.tensor import DTensor
from torch.distributed.tensor.experimental import implicit_replication

from .config import ModelConfig, OptimizerConfig, ShapeSpec
from .models import transformer as T
from .models.layers import no_sc
from .optim import adamw_init, adamw_update
from .parallel import ShardingRules


def _hook(rules: Optional[ShardingRules]):
    return rules.constrain if rules is not None else no_sc


def _context(rules: Optional[ShardingRules]):
    return (implicit_replication() if rules is not None
            else contextlib.nullcontext())


def _plain(x):
    """A replicated (or partial) DTensor as a plain tensor; others as they
    are."""
    return x.full_tensor() if isinstance(x, DTensor) else x


def _shard(rules: Optional[ShardingRules], batch: Dict) -> Dict:
    return rules.shard_batch(batch) if rules is not None else batch


# ---------------------------------------------------------------------------
# Input specs (meta tensors; no allocation)
# ---------------------------------------------------------------------------


def _meta(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device="meta")


def batch_shapes(cfg: ModelConfig, shape: ShapeSpec) -> Dict[str, torch.Tensor]:
    """Abstract input batch for a cell (the assignment's ``input_specs``)."""
    B = shape.global_batch
    i32, dtype = torch.int32, getattr(torch, cfg.dtype)
    if shape.kind == "decode":
        # one new token (the cache is a separate argument)
        return {"tokens": _meta((B, 1), i32)}
    S = shape.seq_len
    batch = {"tokens": _meta((B, S), i32)}
    if shape.kind == "train":
        batch["targets"] = _meta((B, S), i32)
    if cfg.frontend == "vision_stub":
        # patches replace the leading part of the context window
        for key in list(batch):
            batch[key] = _meta((B, S - cfg.n_patches), i32)
        batch["patches"] = _meta((B, cfg.n_patches, cfg.frontend_dim), dtype)
    if cfg.frontend == "audio_stub":
        batch["frames"] = _meta((B, S // cfg.enc_seq_divisor,
                                 cfg.frontend_dim), dtype)
    return batch


def decode_state_shapes(cfg: ModelConfig, shape: ShapeSpec) -> Dict:
    """Abstract KV/SSM cache for a decode cell (seq_len tokens resident):
    ``transformer.cache_layout``, each leaf a ``CacheLeaf`` (shape,
    dtype), which ``ShardingRules.place_cache`` allocates."""
    enc_len = shape.seq_len // cfg.enc_seq_divisor if cfg.is_encdec else 0
    return T.cache_layout(cfg, shape.global_batch, shape.seq_len, enc_len)


def train_state_shapes(cfg: ModelConfig) -> Tuple[T.Transformer, Dict]:
    """Abstract params (a ``Transformer`` on the meta device) and AdamW
    state."""
    params = T.Transformer(cfg, "meta")
    return params, adamw_init(params)



def make_train_step(cfg: ModelConfig, opt_cfg: OptimizerConfig,
                    rules: Optional[ShardingRules] = None,
                    microbatches: int = 1, impl: str = "auto",
                    accum_dtype: torch.dtype = torch.float32):
    """Returns train_step(params, opt_state, batch, step) ->
        (params, opt_state, metrics).

    Each layer is recomputed in the backward pass (the reference's
    default ``remat=True``).  With ``cfg.gcr_moe`` the MoE's admission
    order rotates by a stride of 4099 tokens every
    ``gcr_moe_rotate_every`` steps.  ``microbatches > 1`` accumulates gradients
    over batch splits (the batch's leading axis cut into equal consecutive
    parts, each then split over dp under ``rules``), in ``accum_dtype``,
    and averages them and the loss over the splits: peak activation memory
    divides by the microbatch count.  Under ``rules`` the gradients are pinned to the
    parameters' placements (the reference's ``_pin``), which sums them
    over dp.  ``impl="ref"`` sends every kernel to its plain version on
    the card (for comparing).  The metrics come back as plain tensors."""
    sc = _hook(rules)

    def _pin(grads, named):
        """Gradients to the parameters' placements."""
        if rules is None:
            return grads
        return {n: (g.redistribute(named[n].device_mesh, named[n].placements)
                    if isinstance(g, DTensor) else g)
                for n, g in grads.items()}

    def grads_of(params, batch, step):
        moe_offset = None
        if cfg.gcr_moe:
            # GCR-MoE fairness rotation: priority origin moves every
            # gcr_moe_rotate_every steps (the THRESHOLD-promotion analogue).
            stride = 4099  # prime stride: co-prime with token counts
            moe_offset = (step // cfg.gcr_moe_rotate_every) * stride
        loss, metrics = T.forward_train(cfg, params, _shard(rules, batch),
                                        moe_offset=moe_offset, impl=impl,
                                        sc=sc)
        named = dict(params.named_parameters())
        grads = torch.autograd.grad(loss, list(named.values()))
        return loss, metrics, _pin(dict(zip(named, grads)), named)

    def train_step(params, opt_state, batch, step):
        with _context(rules):
            if microbatches == 1:
                loss, metrics, grads = grads_of(params, batch, step)
            else:
                grads = {name: torch.zeros_like(p, dtype=accum_dtype)
                         for name, p in params.named_parameters()}
                lsum = torch.zeros((), dtype=torch.float32,
                                   device=params.final_norm.device)
                ms = []
                for j in range(microbatches):
                    part = {key: val.reshape((microbatches,
                                              val.shape[0] // microbatches)
                                             + tuple(val.shape[1:]))[j]
                            for key, val in batch.items()}
                    loss_j, m_j, g_j = grads_of(params, part, step)
                    for name, g in g_j.items():
                        grads[name] = grads[name] + g.to(accum_dtype)
                    lsum = lsum + loss_j.detach()
                    ms.append(m_j)
                grads = {name: g / microbatches for name, g in grads.items()}
                loss = lsum / microbatches
                metrics = {key: torch.stack([m[key].detach()
                                             for m in ms]).mean()
                           for key in ms[0]}
                metrics["loss"] = loss
            metrics = {key: _plain(val.detach())
                       for key, val in metrics.items()}
            params, opt_state, opt_metrics = adamw_update(
                grads, opt_state, params, opt_cfg)
        return params, opt_state, {**metrics, **opt_metrics}

    return train_step


def make_prefill(cfg: ModelConfig, max_len: int,
                 rules: Optional[ShardingRules] = None, impl: str = "auto"):
    """prefill_step(params, batch) -> (last-token logits, caches), without
    grad; under ``rules`` the logits and caches are DTensors."""
    sc = _hook(rules)

    @torch.no_grad()
    def prefill_step(params, batch):
        with _context(rules):
            return T.prefill(cfg, params, _shard(rules, batch),
                             max_len=max_len, impl=impl, sc=sc)

    return prefill_step


def make_decode_step(cfg: ModelConfig,
                     rules: Optional[ShardingRules] = None):
    """serve_step(params, caches, tokens) -> (logits, caches), without
    grad."""
    sc = _hook(rules)

    @torch.no_grad()
    def serve_step(params, caches, tokens):
        with _context(rules):
            if rules is not None:
                tokens = rules.shard_batch({"tokens": tokens})["tokens"]
            return T.decode_step(cfg, params, caches, tokens, sc=sc)

    return serve_step


def init_train_state(cfg: ModelConfig, generator: torch.Generator,
                     device=None) -> Tuple[T.Transformer, Dict]:
    """Materialized params (grad on) + AdamW state, drawn from
    ``generator`` (which must live on ``device``)."""
    params = T.init_params(cfg, generator, device)
    params.requires_grad_(True)
    return params, adamw_init(params)
