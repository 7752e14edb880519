"""Model assembly for the ``attn`` and ``moe`` block kinds: embeddings ->
layer stack -> LM head.  The port of ``repro.models.transformer`` for GQA
decoders with a dense SwiGLU MLP or a mixture of experts.

Two serving modes share the block code, as in the reference:
  prefill : full prompt, caches written (ring buffers);
  decode  : one token against the caches (the serve step);
plus ``forward_logits``, the full-sequence forward without a cache that
the teacher-forcing test holds prefill and decode against.

Parameters live in a ``Transformer`` module whose parameter names follow
the reference's pytree (``layers.<i>.attn.wq`` for the reference's
``params["layers"]["attn"]["wq"][i]``, ``layers.<i>.moe.wi_gate`` for
``params["layers"]["moe"]["wi_gate"][i]``); caches are
``{"pos": int, "layers": [{"k", "v"}, ...]}`` and are updated in place.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch
from torch import nn

from .. import resolve_device
from ..config import ModelConfig
from . import layers as L
from . import moe as MOE


def _torch_dtype(name: str) -> torch.dtype:
    dtype = getattr(torch, name, None)
    if not isinstance(dtype, torch.dtype):
        raise ValueError(f"unknown dtype {name!r}")
    return dtype


def _check_supported(cfg: ModelConfig) -> None:
    if (set(cfg.block_pattern) not in ({"attn"}, {"moe"})
            or cfg.shared_attn_every or cfg.n_enc_layers
            or cfg.frontend != "none"):
        raise NotImplementedError(
            f"{cfg.name}: repro_torch serves attention decoders with a dense "
            "or MoE MLP only so far (Mamba2, RWKV6, encoder-decoder and "
            "frontends are later slices)")


class Block(nn.Module):
    """One layer: ln1, attn, ln2, and ``mlp`` (``attn`` kind) or ``moe``
    (``moe`` kind)."""

    def __init__(self, cfg: ModelConfig, *, device, dtype) -> None:
        super().__init__()
        self.ln1 = L._param((cfg.d_model,), device, dtype)
        self.attn = L.Attention(cfg.d_model, cfg.n_heads, cfg.n_kv_heads,
                                cfg.head_dim, cfg.qk_norm, device=device,
                                dtype=dtype)
        self.ln2 = L._param((cfg.d_model,), device, dtype)
        if cfg.block_pattern[0] == "moe":
            self.moe = MOE.MoE(cfg.d_model, cfg.moe_d_ff, cfg.n_experts,
                               device=device, dtype=dtype)
        else:
            self.mlp = L.MLP(cfg.d_model, cfg.d_ff, device=device,
                             dtype=dtype)


class Transformer(nn.Module):
    """The model's parameters, allocated but not initialised: fill them with
    ``init_params`` or ``convert.params_from_numpy``."""

    def __init__(self, cfg: ModelConfig, device=None,
                 dtype: Optional[torch.dtype] = None) -> None:
        super().__init__()
        _check_supported(cfg)
        device = resolve_device(device)
        dtype = dtype or _torch_dtype(cfg.dtype)
        self.embed = L._param((cfg.vocab_padded, cfg.d_model), device, dtype)
        self.final_norm = L._param((cfg.d_model,), device, dtype)
        self.lm_head = L._param((cfg.d_model, cfg.vocab_padded), device,
                                dtype)
        self.layers = nn.ModuleList(
            Block(cfg, device=device, dtype=dtype)
            for _ in range(cfg.n_layers))


# ---------------------------------------------------------------------------
# Parameter initialization
# ---------------------------------------------------------------------------


@torch.no_grad()
def init_params(cfg: ModelConfig, generator: torch.Generator,
                device=None) -> Transformer:
    """The reference's shapes and laws (``init_params``, ``dense_init``,
    ``embed_init``, ``moe_params``, norms at one; the MoE router in f32),
    drawn from ``generator``, which must live on ``device``.  torch and
    jax.random give different numbers from one seed: to compare with the
    reference, carry its weights over with ``convert.params_from_numpy``."""
    params = Transformer(cfg, device)
    L.embed_init_(params.embed, generator)
    params.final_norm.fill_(1.0)
    L.dense_init_(params.lm_head, generator)
    for blk in params.layers:
        blk.ln1.fill_(1.0)
        blk.ln2.fill_(1.0)
        for w in (blk.attn.wq, blk.attn.wk, blk.attn.wv, blk.attn.wo):
            L.dense_init_(w, generator)
        if hasattr(blk, "moe"):
            MOE.moe_init_(blk.moe, generator)
        else:
            for w in (blk.mlp.wi_gate, blk.mlp.wi_up, blk.mlp.wo):
                L.dense_init_(w, generator)
        if cfg.qk_norm:
            blk.attn.q_norm.fill_(1.0)
            blk.attn.k_norm.fill_(1.0)
    return params


# ---------------------------------------------------------------------------
# Caches
# ---------------------------------------------------------------------------


def init_cache(cfg: ModelConfig, B: int, max_len: int, device=None) -> Dict:
    """Zeroed ring-buffer caches: ``max_len`` slots, or the sliding window
    when that is shorter."""
    _check_supported(cfg)
    device = resolve_device(device)
    dtype = _torch_dtype(cfg.dtype)
    Tc = min(max_len, cfg.sliding_window) if cfg.sliding_window else max_len
    shape = (B, Tc, cfg.n_kv_heads, cfg.head_dim)
    return {"pos": 0,
            "layers": [{"k": torch.zeros(shape, dtype=dtype, device=device),
                        "v": torch.zeros(shape, dtype=dtype, device=device)}
                       for _ in range(cfg.n_layers)]}


# ---------------------------------------------------------------------------
# Blocks and stack
# ---------------------------------------------------------------------------


def _apply_attn_block(cfg: ModelConfig, p: Block, x, positions, cache,
                      cache_pos: int, *, decode: bool, impl: str = "auto",
                      moe_offset=None):
    """attn + mlp/moe block.  Returns (x, cache, aux); aux holds the MoE
    metrics and is empty for a dense block."""
    h = L.rms_norm(x, p.ln1, cfg.norm_eps)
    attn_out, cache = L.multihead_attention(
        p.attn, h, positions, cache, cache_pos,
        n_heads=cfg.n_heads, n_kv=cfg.n_kv_heads, d_head=cfg.head_dim,
        qk_norm=cfg.qk_norm, rope_theta=cfg.rope_theta,
        window=cfg.sliding_window, decode=decode, eps=cfg.norm_eps,
        impl=impl)
    x = x + attn_out
    h2 = L.rms_norm(x, p.ln2, cfg.norm_eps)
    if hasattr(p, "moe"):
        moe_out, aux = MOE.moe_mlp(
            p.moe, h2, n_experts=cfg.n_experts, top_k=cfg.n_experts_active,
            capacity_factor=cfg.moe_capacity_factor,
            gcr_admission=cfg.gcr_moe, priority_offset=moe_offset,
            impl=impl)
        return x + moe_out, cache, aux
    return x + L.mlp(p.mlp, h2), cache, {}


def _stack(cfg: ModelConfig, params: Transformer, x, positions,
           caches: Optional[Dict], cache_pos: int, *, decode: bool,
           impl: str = "auto", moe_offset=None):
    """Run the decoder stack (the reference's layer scan, as a loop).
    Returns (x, caches, aux), aux averaged over layers."""
    auxes = []
    for i, lp in enumerate(params.layers):
        lcache = caches["layers"][i] if caches is not None else None
        x, _, aux = _apply_attn_block(cfg, lp, x, positions, lcache,
                                      cache_pos, decode=decode, impl=impl,
                                      moe_offset=moe_offset)
        auxes.append(aux)
    aux = {k: torch.stack([a[k] for a in auxes]).mean() for k in auxes[0]}
    return x, caches, aux


# ---------------------------------------------------------------------------
# Public entry points
# ---------------------------------------------------------------------------


def _positions(start: int, n: int, device) -> torch.Tensor:
    return torch.arange(start, start + n, dtype=torch.int32, device=device)


def forward_logits(cfg: ModelConfig, params: Transformer,
                   tokens: torch.Tensor, impl: str = "auto") -> torch.Tensor:
    """Full-sequence logits (B, S, V) without a cache."""
    x = params.embed[tokens]
    positions = _positions(0, tokens.shape[1], x.device)
    x, _, _ = _stack(cfg, params, x, positions, None, 0, decode=False,
                     impl=impl)
    return L.rms_norm(x, params.final_norm, cfg.norm_eps) @ params.lm_head


def prefill(cfg: ModelConfig, params: Transformer, batch: Dict,
            max_len: int, impl: str = "auto"):
    """Process the prompt ``batch["tokens"]`` (B, S); returns (last-token
    logits (B, 1, V), populated cache).  ``impl="ref"`` sends prompt
    attention and the expert products to their plain versions even on the
    card (for comparing)."""
    tokens = batch["tokens"]
    x = params.embed[tokens]
    B, S = tokens.shape
    positions = _positions(0, S, x.device)
    caches = init_cache(cfg, B, max_len, x.device)
    x, caches, _ = _stack(cfg, params, x, positions, caches, 0,
                          decode=False, impl=impl)
    caches["pos"] = S
    x = L.rms_norm(x[:, -1:], params.final_norm, cfg.norm_eps)
    return x @ params.lm_head, caches


def decode_step(cfg: ModelConfig, params: Transformer, caches: Dict,
                tokens: torch.Tensor):
    """One serving step: tokens (B, 1) -> (logits (B, 1, V), caches).  The
    caches are updated in place and returned."""
    x = params.embed[tokens]
    pos = caches["pos"]
    positions = _positions(pos, tokens.shape[1], x.device)
    x, caches, _ = _stack(cfg, params, x, positions, caches, pos,
                          decode=True)
    caches["pos"] = pos + tokens.shape[1]
    x = L.rms_norm(x, params.final_norm, cfg.norm_eps)
    return x @ params.lm_head, caches
