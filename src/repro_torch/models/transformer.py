"""Model assembly: embeddings -> layer stack -> LM head.  The port of
``repro.models.transformer`` for four block kinds: ``attn`` (GQA with a
dense SwiGLU MLP), ``moe`` (GQA with a mixture of experts), ``mamba2``
(the SSD block) and ``rwkv6`` (RWKV6 time mix and channel mix), with
zamba2's shared attention block (one parameter set, attention + dense
MLP) applied after every ``shared_attn_every`` layers.

Three modes share the block code, as in the reference:
  train   : ``forward_train``, the full-sequence forward to the loss, each
            layer recomputed in the backward pass;
  prefill : full prompt, caches written (ring buffers / recurrent states);
  decode  : one token against the caches (the serve step);
plus ``forward_logits``, the full-sequence forward without a cache that
the teacher-forcing test holds prefill and decode against.

Parameters live in a ``Transformer`` module whose parameter names follow
the reference's pytree (``layers.<i>.attn.wq`` for the reference's
``params["layers"]["attn"]["wq"][i]``, ``layers.<i>.mamba.w_z`` for
``params["layers"]["mamba"]["w_z"][i]``, ``layers.<i>.rwkv.w_r`` for
``params["layers"]["rwkv"]["w_r"][i]``, ``shared_attn.attn.wq`` for
``params["shared_attn"]["attn"]["wq"]``).  Caches are ``{"pos": int,
"layers": [...], "shared": [...]}``: a layer holds ``{"k", "v"}`` ring
buffers (attention kinds), ``{"ssm", "conv": {"x", "B", "C"}}`` (mamba2)
or ``{"wkv", "tm_shift", "cm_shift"}`` (rwkv6), ``shared`` one ring
buffer per invocation of the shared block.  They are updated in place.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from .. import resolve_device
from ..config import ModelConfig
from . import layers as L
from . import mamba2 as M
from . import moe as MOE
from . import rwkv6 as R


def _torch_dtype(name: str) -> torch.dtype:
    dtype = getattr(torch, name, None)
    if not isinstance(dtype, torch.dtype):
        raise ValueError(f"unknown dtype {name!r}")
    return dtype


def _check_supported(cfg: ModelConfig) -> None:
    if (set(cfg.block_pattern) not in ({"attn"}, {"moe"}, {"mamba2"},
                                       {"rwkv6"})
            or cfg.n_enc_layers or cfg.frontend != "none"):
        raise NotImplementedError(
            f"{cfg.name}: repro_torch runs attention decoders with a dense "
            "or MoE MLP, Mamba2 stacks and RWKV6 stacks only so far "
            "(encoder-decoder and frontends are later slices)")


class Block(nn.Module):
    """One layer of ``kind``: ln1 and ``mamba`` (``mamba2``); ln1, ln2
    and ``rwkv`` (``rwkv6``); or ln1, attn, ln2 and ``mlp`` (``attn``,
    also the shared block) or ``moe`` (``moe``)."""

    def __init__(self, cfg: ModelConfig, kind: str, *, device,
                 dtype) -> None:
        super().__init__()
        self.ln1 = L._param((cfg.d_model,), device, dtype)
        if kind == "rwkv6":
            self.ln2 = L._param((cfg.d_model,), device, dtype)
            self.rwkv = R.RWKV6(cfg.d_model, cfg.d_ff, cfg.rwkv_heads,
                                cfg.rwkv_head_dim, device=device,
                                dtype=dtype)
            return
        if kind == "mamba2":
            self.mamba = M.Mamba2(cfg.d_model, cfg.d_inner, cfg.ssm_state,
                                  cfg.ssm_heads, cfg.ssm_conv, device=device,
                                  dtype=dtype)
            return
        self.attn = L.Attention(cfg.d_model, cfg.n_heads, cfg.n_kv_heads,
                                cfg.head_dim, cfg.qk_norm, device=device,
                                dtype=dtype)
        self.ln2 = L._param((cfg.d_model,), device, dtype)
        if kind == "moe":
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
            Block(cfg, cfg.block_pattern[0], device=device, dtype=dtype)
            for _ in range(cfg.n_layers))
        if cfg.shared_attn_every:
            self.shared_attn = Block(cfg, "attn", device=device, dtype=dtype)


# ---------------------------------------------------------------------------
# Parameter initialization
# ---------------------------------------------------------------------------


@torch.no_grad()
def init_params(cfg: ModelConfig, generator: torch.Generator,
                device=None) -> Transformer:
    """The reference's shapes and laws (``init_params``, ``dense_init``,
    ``embed_init``, ``moe_params``, ``mamba2_params``, ``rwkv6_params``,
    norms at one; the MoE router, Mamba2's A_log, dt_bias and D and
    RWKV6's decay_w0 and bonus_u in f32), drawn from
    ``generator``, which must live on ``device``.  torch and jax.random
    give different numbers from one seed: to compare with the reference,
    carry its weights over with ``convert.params_from_numpy``."""
    params = Transformer(cfg, device)
    L.embed_init_(params.embed, generator)
    params.final_norm.fill_(1.0)
    L.dense_init_(params.lm_head, generator)
    blocks = list(params.layers)
    if cfg.shared_attn_every:
        blocks.append(params.shared_attn)
    for blk in blocks:
        blk.ln1.fill_(1.0)
        if hasattr(blk, "mamba"):
            M.mamba2_init_(blk.mamba, generator)
            continue
        blk.ln2.fill_(1.0)
        if hasattr(blk, "rwkv"):
            R.rwkv6_init_(blk.rwkv, generator)
            continue
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
    """Zeroed caches.  Attention: ring buffers of ``max_len`` slots, or the
    sliding window when that is shorter.  Mamba2: the f32 SSM state and the
    convolutions' last K-1 inputs in the model's dtype.  RWKV6: the f32
    WKV state and the two (B, 1, D) shift states in the model's dtype."""
    _check_supported(cfg)
    device = resolve_device(device)
    dtype = _torch_dtype(cfg.dtype)

    def zeros(*shape, dt=dtype):
        return torch.zeros(shape, dtype=dt, device=device)

    def attn_cache():
        Tc = (min(max_len, cfg.sliding_window) if cfg.sliding_window
              else max_len)
        shape = (B, Tc, cfg.n_kv_heads, cfg.head_dim)
        return {"k": zeros(*shape), "v": zeros(*shape)}

    def mamba_cache():
        kconv = cfg.ssm_conv - 1
        return {"ssm": zeros(B, cfg.ssm_heads, cfg.ssm_head_dim,
                             cfg.ssm_state, dt=torch.float32),
                "conv": {"x": zeros(B, kconv, cfg.d_inner),
                         "B": zeros(B, kconv, cfg.ssm_state),
                         "C": zeros(B, kconv, cfg.ssm_state)}}

    def rwkv_cache():
        P = cfg.rwkv_head_dim
        return {"wkv": zeros(B, cfg.rwkv_heads, P, P, dt=torch.float32),
                "tm_shift": zeros(B, 1, cfg.d_model),
                "cm_shift": zeros(B, 1, cfg.d_model)}

    layer_cache = {"mamba2": mamba_cache, "rwkv6": rwkv_cache}.get(
        cfg.block_pattern[0], attn_cache)
    cache = {"pos": 0,
             "layers": [layer_cache() for _ in range(cfg.n_layers)]}
    if cfg.shared_attn_every:
        cache["shared"] = [attn_cache() for _ in
                           range(cfg.n_layers // cfg.shared_attn_every)]
    return cache


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


def _apply_mamba_block(cfg: ModelConfig, p: Block, x, cache: Optional[Dict],
                       *, decode: bool, impl: str = "auto"):
    """ln1 + Mamba2 block.  Returns x; the cache's states are replaced
    in place."""
    h = L.rms_norm(x, p.ln1, cfg.norm_eps)
    kw = dict(d_inner=cfg.d_inner, n_state=cfg.ssm_state,
              n_heads=cfg.ssm_heads, head_dim=cfg.ssm_head_dim,
              eps=cfg.norm_eps)
    if decode:
        out, cache["ssm"], cache["conv"] = M.mamba2_decode_step(
            p.mamba, h, cache["ssm"], cache["conv"], **kw)
    elif cache is not None:  # prefill: thread states through (f32 state)
        out, (cache["ssm"], cache["conv"]) = M.mamba2_forward(
            p.mamba, h, ssm_state=cache["ssm"], conv_state=cache["conv"],
            return_state=True, impl=impl, **kw)
    else:
        out = M.mamba2_forward(p.mamba, h, impl=impl, **kw)
    return x + out


def _apply_rwkv_block(cfg: ModelConfig, p: Block, x,
                      cache: Optional[Dict], *, decode: bool,
                      impl: str = "auto"):
    """ln1 + time mix, ln2 + channel mix.  Returns x; the cache's states
    (the normed inputs' last token and the f32 WKV state) are replaced in
    place."""
    kw = dict(n_heads=cfg.rwkv_heads, head_dim=cfg.rwkv_head_dim)
    h = L.rms_norm(x, p.ln1, cfg.norm_eps)
    if decode:
        tm_out, cache["tm_shift"], cache["wkv"] = R.rwkv6_time_mix_step(
            p.rwkv, h, cache["tm_shift"], cache["wkv"], **kw)
        x = x + tm_out
        h2 = L.rms_norm(x, p.ln2, cfg.norm_eps)
        cm_out, cache["cm_shift"] = R.rwkv6_channel_mix_step(
            p.rwkv, h2, cache["cm_shift"])
        return x + cm_out
    if cache is not None:  # prefill: thread states through (f32 state)
        tm_out, cache["tm_shift"], cache["wkv"] = R.rwkv6_time_mix(
            p.rwkv, h, shift_state=cache["tm_shift"],
            wkv_state=cache["wkv"], return_state=True, impl=impl, **kw)
        x = x + tm_out
        h2 = L.rms_norm(x, p.ln2, cfg.norm_eps)
        cm_out, cache["cm_shift"] = R.rwkv6_channel_mix(
            p.rwkv, h2, shift_state=cache["cm_shift"], return_state=True)
        return x + cm_out
    x = x + R.rwkv6_time_mix(p.rwkv, h, impl=impl, **kw)
    h2 = L.rms_norm(x, p.ln2, cfg.norm_eps)
    return x + R.rwkv6_channel_mix(p.rwkv, h2)


def _stack(cfg: ModelConfig, params: Transformer, x, positions,
           caches: Optional[Dict], cache_pos: int, *, decode: bool,
           impl: str = "auto", moe_offset=None, remat: bool = False):
    """Run the decoder stack (the reference's layer scan, as a loop), with
    the shared block after layer i when (i + 1) % shared_attn_every == 0,
    on shared cache i // shared_attn_every.  Returns (x, caches, aux), aux
    averaged over layers.  ``remat`` (training, no caches) recomputes each
    unit in the backward pass, the reference's ``jax.checkpoint(unit)``:
    a unit is one layer and, where it follows that layer, the shared
    block."""
    k = cfg.shared_attn_every
    auxes = []
    for i, lp in enumerate(params.layers):
        shared = params.shared_attn if k and (i + 1) % k == 0 else None
        lcache = scache = None
        if caches is not None:
            lcache = caches["layers"][i]
            scache = caches["shared"][i // k] if shared is not None else None
        args = (cfg, lp, shared, x, positions, lcache, scache, cache_pos,
                decode, impl, moe_offset)
        if remat:
            x, aux = checkpoint(_unit, *args, use_reentrant=False)
        else:
            x, aux = _unit(*args)
        if aux:
            auxes.append(aux)
    aux = ({key: torch.stack([a[key] for a in auxes]).mean()
            for key in auxes[0]} if auxes else {})
    return x, caches, aux


def _unit(cfg: ModelConfig, p: Block, shared: Optional[Block], x,
          positions, lcache: Optional[Dict], scache: Optional[Dict],
          cache_pos: int, decode: bool, impl: str, moe_offset):
    """One layer and, where one follows it, the shared block; the caches
    (None without) are updated in place.  Returns (x, aux), aux the MoE
    metrics (empty for the other kinds)."""
    aux = {}
    if hasattr(p, "mamba"):
        x = _apply_mamba_block(cfg, p, x, lcache, decode=decode, impl=impl)
    elif hasattr(p, "rwkv"):
        x = _apply_rwkv_block(cfg, p, x, lcache, decode=decode, impl=impl)
    else:
        x, _, aux = _apply_attn_block(cfg, p, x, positions, lcache,
                                      cache_pos, decode=decode, impl=impl,
                                      moe_offset=moe_offset)
    if shared is not None:
        x, _, _ = _apply_attn_block(cfg, shared, x, positions, scache,
                                    cache_pos, decode=decode, impl=impl)
    return x, aux


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


def forward_train(cfg: ModelConfig, params: Transformer, batch: Dict,
                  remat: bool = True, moe_offset=None, impl: str = "auto"):
    """Full-sequence forward to the loss; returns (loss, metrics).

    ``batch`` holds int ``tokens`` and ``targets`` (B, S).  Embeddings, the
    stack (each layer, with the shared block that follows it, under
    ``torch.utils.checkpoint`` when ``remat``), the final norm, then
    ``chunked_softmax_xent`` over the LM head, plus 0.01 times each
    ``*_loss`` aux of the stack (the MoE's load-balance and z losses,
    averaged over layers).  Every decoder kind trains: the flash, gmm, ssd
    and wkv kernels run their forwards inside autograd ops whose
    backwards are plain PyTorch.  ``moe_offset`` rotates the MoE's
    admission order (GCR-MoE).  ``impl="ref"`` sends every kernel to its
    plain version on the card.  Encoder-decoder and frontend configs
    raise ``NotImplementedError``."""
    _check_supported(cfg)
    tokens = batch["tokens"]
    x = params.embed[tokens]
    positions = _positions(0, tokens.shape[1], x.device)
    x, _, aux = _stack(cfg, params, x, positions, None, 0, decode=False,
                       impl=impl, moe_offset=moe_offset, remat=remat)
    x = L.rms_norm(x, params.final_norm, cfg.norm_eps)
    loss = L.chunked_softmax_xent(x, params.lm_head, batch["targets"], None)
    for key, val in aux.items():
        if key.endswith("_loss"):
            loss = loss + 0.01 * val
    return loss, {"loss": loss, **aux}


def prefill(cfg: ModelConfig, params: Transformer, batch: Dict,
            max_len: int, impl: str = "auto"):
    """Process the prompt ``batch["tokens"]`` (B, S); returns (last-token
    logits (B, 1, V), populated cache).  ``impl="ref"`` sends prompt
    attention, the expert products, the SSD scan and the WKV to their
    plain versions even on the card (for comparing)."""
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
