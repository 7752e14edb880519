"""Model assembly: embeddings -> layer stack -> LM head.  The port of
``repro.models.transformer`` for four block kinds: ``attn`` (GQA with a
dense SwiGLU MLP), ``moe`` (GQA with a mixture of experts), ``mamba2``
(the SSD block) and ``rwkv6`` (RWKV6 time mix and channel mix), with
three structural extensions:

* zamba2: a shared attention block (one parameter set, attention + dense
  MLP) applied after every ``shared_attn_every`` layers;
* whisper: an encoder stack (non-causal attention + MLP blocks over the
  frames' projection, then ``enc_norm``) and cross-attention, after the
  self-attention of every decoder block, over the encoder's output;
* the frontend stubs: ``batch["patches"]`` (``vision_stub``) and
  ``batch["frames"]`` (``audio_stub``) are precomputed embeddings,
  projected by ``frontend_proj`` and prepended to the tokens' embeddings
  (vision) or fed to the encoder (audio).

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
``params["shared_attn"]["attn"]["wq"]``, ``enc_layers.<i>.attn.wq`` for
``params["enc_layers"]["attn"]["wq"][i]``).  Caches are ``{"pos": int,
"layers": [...], "shared": [...], "cross": [...]}``: a layer holds
``{"k", "v"}`` ring buffers (attention kinds), ``{"ssm", "conv": {"x",
"B", "C"}}`` (mamba2) or ``{"wkv", "tm_shift", "cm_shift"}`` (rwkv6),
``shared`` one ring buffer per invocation of the shared block, ``cross``
one static ``{"k", "v"}`` of the encoder's length per decoder layer.
They are updated in place.
"""

from __future__ import annotations

from typing import Dict, NamedTuple, Optional

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
    if set(cfg.block_pattern) not in ({"attn"}, {"moe"}, {"mamba2"},
                                      {"rwkv6"}):
        raise NotImplementedError(
            f"{cfg.name}: repro_torch runs stacks of one block kind (attn, "
            f"moe, mamba2 or rwkv6), not {cfg.block_pattern}")
    if cfg.frontend not in ("none", "audio_stub", "vision_stub"):
        raise NotImplementedError(f"{cfg.name}: unknown frontend "
                                  f"{cfg.frontend!r}")


class Block(nn.Module):
    """One layer of ``kind``: ln1 and ``mamba`` (``mamba2``); ln1, ln2
    and ``rwkv`` (``rwkv6``); or ln1, attn, ln2 and ``mlp`` (``attn``,
    also the shared block and the encoder's layers) or ``moe`` (``moe``).
    With ``cross`` (the decoder blocks of an encoder-decoder) also
    ``ln_cross`` and ``cross``, an attention without QK norm."""

    def __init__(self, cfg: ModelConfig, kind: str, *, device,
                 dtype, cross: bool = False) -> None:
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
        if cross:
            self.ln_cross = L._param((cfg.d_model,), device, dtype)
            self.cross = L.Attention(cfg.d_model, cfg.n_heads,
                                     cfg.n_kv_heads, cfg.head_dim, False,
                                     device=device, dtype=dtype)
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
            Block(cfg, cfg.block_pattern[0], device=device, dtype=dtype,
                  cross=cfg.is_encdec)
            for _ in range(cfg.n_layers))
        if cfg.shared_attn_every:
            self.shared_attn = Block(cfg, "attn", device=device, dtype=dtype)
        if cfg.is_encdec:
            self.enc_layers = nn.ModuleList(
                Block(cfg, "attn", device=device, dtype=dtype)
                for _ in range(cfg.n_enc_layers))
            self.enc_norm = L._param((cfg.d_model,), device, dtype)
        if cfg.frontend != "none":
            self.frontend_proj = L._param((cfg.frontend_dim, cfg.d_model),
                                          device, dtype)


# ---------------------------------------------------------------------------
# Parameter initialization
# ---------------------------------------------------------------------------


@torch.no_grad()
def init_params(cfg: ModelConfig, generator: torch.Generator,
                device=None) -> Transformer:
    """The reference's shapes and laws (``init_params``, ``dense_init``
    for every projection, the frontend's and the cross-attention's
    included, ``embed_init``, ``moe_params``, ``mamba2_params``,
    ``rwkv6_params``, norms at one; the MoE router, Mamba2's A_log,
    dt_bias and D and RWKV6's decay_w0 and bonus_u in f32), drawn from
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
    if cfg.is_encdec:
        blocks.extend(params.enc_layers)
        params.enc_norm.fill_(1.0)
    if cfg.frontend != "none":
        L.dense_init_(params.frontend_proj, generator)
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
        if hasattr(blk, "cross"):
            blk.ln_cross.fill_(1.0)
            for w in (blk.cross.wq, blk.cross.wk, blk.cross.wv,
                      blk.cross.wo):
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


class CacheLeaf(NamedTuple):
    """A cache leaf's shape and dtype (``cache_layout``)."""
    shape: torch.Size
    dtype: torch.dtype


def _cache_tree(cfg: ModelConfig, B: int, max_len: int, enc_len: int,
                leaf) -> Dict:
    """``init_cache``'s structure with ``leaf(shape, dtype)`` as each
    leaf."""
    _check_supported(cfg)
    dtype = _torch_dtype(cfg.dtype)

    def zeros(*shape, dt=dtype):
        return leaf(torch.Size(shape), dt)

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
    if cfg.is_encdec:
        shape = (B, enc_len, cfg.n_kv_heads, cfg.head_dim)
        cache["cross"] = [{"k": zeros(*shape), "v": zeros(*shape)}
                          for _ in range(cfg.n_layers)]
    return cache


def init_cache(cfg: ModelConfig, B: int, max_len: int, device=None,
               enc_len: int = 0) -> Dict:
    """Zeroed caches.  Attention: ring buffers of ``max_len`` slots, or the
    sliding window when that is shorter.  Mamba2: the f32 SSM state and the
    convolutions' last K-1 inputs in the model's dtype.  RWKV6: the f32
    WKV state and the two (B, 1, D) shift states in the model's dtype.
    Encoder-decoder: also each decoder layer's cross-attention K/V of
    ``enc_len`` slots, which prefill fills and decode only reads."""
    _check_supported(cfg)
    device = resolve_device(device)
    return _cache_tree(cfg, B, max_len, enc_len,
                       lambda shape, dt: torch.zeros(shape, dtype=dt,
                                                     device=device))


def cache_layout(cfg: ModelConfig, B: int, max_len: int,
                 enc_len: int = 0) -> Dict:
    """``init_cache``'s structure with a ``CacheLeaf`` (shape, dtype) as
    each leaf: nothing allocated, not even on the meta device."""
    return _cache_tree(cfg, B, max_len, enc_len, CacheLeaf)


# ---------------------------------------------------------------------------
# Blocks and stack
# ---------------------------------------------------------------------------


def _residual(sc, x, out):
    """``x + out`` pinned to the residual's layout (the reference's
    ``sc(x + out, "residual")``), ``out`` pinned first: a DTensor add
    that moved ``out`` itself would hand its backward a gradient in a
    layout the branch never had."""
    return sc(x + sc(out, "residual"), "residual")


def _apply_attn_block(cfg: ModelConfig, p: Block, x, positions, cache,
                      cache_pos: int, *, decode: bool, impl: str = "auto",
                      moe_offset=None, causal: bool = True, cross_src=None,
                      cross_cache: Optional[Dict] = None, sc=L.no_sc):
    """attn (+ cross) + mlp/moe block.  Returns (x, cache, aux); aux holds
    the MoE metrics and is empty for a dense block.  A block with
    ``cross`` attends over ``cross_src`` (the encoder's output; prefill
    writes its K/V into ``cross_cache``) or, in decode, over
    ``cross_cache`` alone."""
    h = sc(L.rms_norm(x, p.ln1, cfg.norm_eps), "block_in")
    attn_out, cache = L.multihead_attention(
        p.attn, h, positions, cache, cache_pos,
        n_heads=cfg.n_heads, n_kv=cfg.n_kv_heads, d_head=cfg.head_dim,
        qk_norm=cfg.qk_norm, rope_theta=cfg.rope_theta,
        window=cfg.sliding_window, causal=causal, decode=decode,
        eps=cfg.norm_eps, impl=impl, sc=sc)
    x = _residual(sc, x, attn_out)
    if hasattr(p, "cross"):
        hc = sc(L.rms_norm(x, p.ln_cross, cfg.norm_eps), "block_in")
        cross_out, _ = L.multihead_attention(
            p.cross, hc, positions, cross_cache, cache_pos,
            n_heads=cfg.n_heads, n_kv=cfg.n_kv_heads, d_head=cfg.head_dim,
            causal=False, decode=decode, kv_src=cross_src, is_cross=True,
            eps=cfg.norm_eps, impl=impl, sc=sc)
        x = _residual(sc, x, cross_out)
    h2 = sc(L.rms_norm(x, p.ln2, cfg.norm_eps), "block_in")
    if hasattr(p, "moe"):
        moe_out, aux = MOE.moe_mlp(
            p.moe, h2, n_experts=cfg.n_experts, top_k=cfg.n_experts_active,
            capacity_factor=cfg.moe_capacity_factor,
            gcr_admission=cfg.gcr_moe, priority_offset=moe_offset,
            impl=impl, sc=sc)
        return _residual(sc, x, moe_out), cache, aux
    return _residual(sc, x, L.mlp(p.mlp, h2)), cache, {}


def _apply_mamba_block(cfg: ModelConfig, p: Block, x, cache: Optional[Dict],
                       *, decode: bool, impl: str = "auto", sc=L.no_sc):
    """ln1 + Mamba2 block.  Returns x; the cache's states are replaced
    in place."""
    h = sc(L.rms_norm(x, p.ln1, cfg.norm_eps), "block_in")
    kw = dict(d_inner=cfg.d_inner, n_state=cfg.ssm_state,
              n_heads=cfg.ssm_heads, head_dim=cfg.ssm_head_dim,
              eps=cfg.norm_eps)
    if decode:
        out, cache["ssm"], cache["conv"] = M.mamba2_decode_step(
            p.mamba, h, cache["ssm"], cache["conv"], **kw)
    elif cache is not None:  # prefill: thread states through (f32 state)
        out, (cache["ssm"], cache["conv"]) = M.mamba2_forward(
            p.mamba, h, ssm_state=cache["ssm"], conv_state=cache["conv"],
            return_state=True, impl=impl, sc=sc, **kw)
    else:
        out = M.mamba2_forward(p.mamba, h, impl=impl, sc=sc, **kw)
    return _residual(sc, x, out)


def _apply_rwkv_block(cfg: ModelConfig, p: Block, x,
                      cache: Optional[Dict], *, decode: bool,
                      impl: str = "auto", sc=L.no_sc):
    """ln1 + time mix, ln2 + channel mix.  Returns x; the cache's states
    (the normed inputs' last token and the f32 WKV state) are replaced in
    place."""
    kw = dict(n_heads=cfg.rwkv_heads, head_dim=cfg.rwkv_head_dim)
    h = sc(L.rms_norm(x, p.ln1, cfg.norm_eps), "block_in")
    if decode:
        tm_out, cache["tm_shift"], cache["wkv"] = R.rwkv6_time_mix_step(
            p.rwkv, h, cache["tm_shift"], cache["wkv"], **kw)
        x = _residual(sc, x, tm_out)
        h2 = sc(L.rms_norm(x, p.ln2, cfg.norm_eps), "block_in")
        cm_out, cache["cm_shift"] = R.rwkv6_channel_mix_step(
            p.rwkv, h2, cache["cm_shift"])
        return _residual(sc, x, cm_out)
    if cache is not None:  # prefill: thread states through (f32 state)
        tm_out, cache["tm_shift"], cache["wkv"] = R.rwkv6_time_mix(
            p.rwkv, h, shift_state=cache["tm_shift"],
            wkv_state=cache["wkv"], return_state=True, impl=impl, sc=sc,
            **kw)
        x = _residual(sc, x, tm_out)
        h2 = sc(L.rms_norm(x, p.ln2, cfg.norm_eps), "block_in")
        cm_out, cache["cm_shift"] = R.rwkv6_channel_mix(
            p.rwkv, h2, shift_state=cache["cm_shift"], return_state=True)
        return _residual(sc, x, cm_out)
    x = _residual(sc, x, R.rwkv6_time_mix(p.rwkv, h, impl=impl, sc=sc,
                                          **kw))
    h2 = sc(L.rms_norm(x, p.ln2, cfg.norm_eps), "block_in")
    return _residual(sc, x, R.rwkv6_channel_mix(p.rwkv, h2))


def _stack(cfg: ModelConfig, params: Transformer, x, positions,
           caches: Optional[Dict], cache_pos: int, *, decode: bool,
           impl: str = "auto", moe_offset=None, remat: bool = False,
           cross_src=None, sc=L.no_sc):
    """Run the decoder stack (the reference's layer scan, as a loop), with
    the shared block after layer i when (i + 1) % shared_attn_every == 0,
    on shared cache i // shared_attn_every, and layer i's cross-attention
    over ``cross_src`` and cross cache i.  Returns (x, caches, aux), aux
    averaged over layers.  ``remat`` (training, no caches) recomputes each
    unit in the backward pass, the reference's ``jax.checkpoint(unit)``:
    a unit is one layer and, where it follows that layer, the shared
    block.  ``cross_src`` goes to the checkpoint as an input of the unit,
    so the recomputation reads it as the forward did and its gradient
    flows back to the encoder.  ``sc`` is the sharding hook: each unit
    gathers its parameters through it (``sc(p, "params")``) inside the
    recomputed region."""
    k = cfg.shared_attn_every
    auxes = []
    for i, lp in enumerate(params.layers):
        shared = params.shared_attn if k and (i + 1) % k == 0 else None
        lcache = scache = lcross = None
        if caches is not None:
            lcache = caches["layers"][i]
            scache = caches["shared"][i // k] if shared is not None else None
            lcross = caches["cross"][i] if cfg.is_encdec else None
        args = (cfg, lp, shared, x, positions, lcache, scache, cache_pos,
                decode, impl, moe_offset, cross_src, lcross, sc)
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
          cache_pos: int, decode: bool, impl: str, moe_offset,
          cross_src=None, lcross: Optional[Dict] = None, sc=L.no_sc):
    """One layer and, where one follows it, the shared block; the caches
    (None without) are updated in place.  Returns (x, aux), aux the MoE
    metrics (empty for the other kinds)."""
    aux = {}
    p = sc(p, "params")
    if hasattr(p, "mamba"):
        x = _apply_mamba_block(cfg, p, x, lcache, decode=decode, impl=impl,
                               sc=sc)
    elif hasattr(p, "rwkv"):
        x = _apply_rwkv_block(cfg, p, x, lcache, decode=decode, impl=impl,
                              sc=sc)
    else:
        x, _, aux = _apply_attn_block(cfg, p, x, positions, lcache,
                                      cache_pos, decode=decode, impl=impl,
                                      moe_offset=moe_offset,
                                      cross_src=cross_src, cross_cache=lcross,
                                      sc=sc)
    if shared is not None:
        x, _, _ = _apply_attn_block(cfg, sc(shared, "params"), x, positions,
                                    scache, cache_pos, decode=decode,
                                    impl=impl, sc=sc)
    return x, aux


# ---------------------------------------------------------------------------
# Encoder (whisper) and frontends
# ---------------------------------------------------------------------------


def _project(stub: torch.Tensor, w: torch.Tensor,
             dtype: torch.dtype) -> torch.Tensor:
    """A frontend stub's projection ``stub @ w``, taken in the promoted
    dtype (as jnp promotes f32 @ bf16 to f32; torch's ``@`` refuses the
    pair) and cast to ``dtype``, the model's."""
    dt = torch.promote_types(stub.dtype, w.dtype)
    return (stub.to(dt) @ w.to(dt)).to(dtype)


def _encode(cfg: ModelConfig, params: Transformer, batch: Dict,
            remat: bool, impl: str = "auto",
            sc=L.no_sc) -> Optional[torch.Tensor]:
    """``batch["frames"]`` (B, T_enc, frontend_dim), precomputed embeddings
    (the stub) -> the encoder's output (B, T_enc, d_model); None for a
    model without an encoder.  The frames' projection,
    the non-causal attention + MLP blocks of ``enc_layers`` with RoPE at
    ``arange(T_enc)``, each recomputed in the backward pass under
    ``remat``, then ``enc_norm``.  The reference's projection keeps the
    frames' dtype, so f32 frames make a bf16 model's encoder output f32
    and its decoder's layer scan fails; here the product is cast to the
    model's dtype, as the reference casts the vision stub's patches."""
    if not cfg.is_encdec:
        return None
    x = sc(_project(batch["frames"], sc(params.frontend_proj, "params"),
                    params.embed.dtype), "residual")
    positions = _positions(0, x.shape[1], x.device)
    for lp in params.enc_layers:
        args = (cfg, lp, x, positions, impl, sc)
        x = (checkpoint(_enc_unit, *args, use_reentrant=False) if remat
             else _enc_unit(*args))
    return sc(L.rms_norm(x, params.enc_norm, cfg.norm_eps), "block_in")


def _enc_unit(cfg: ModelConfig, p: Block, x, positions, impl: str,
              sc=L.no_sc):
    x, _, _ = _apply_attn_block(cfg, sc(p, "params"), x, positions, None, 0,
                                decode=False, impl=impl, causal=False, sc=sc)
    return x


# ---------------------------------------------------------------------------
# Public entry points
# ---------------------------------------------------------------------------


def _positions(start: int, n: int, device) -> torch.Tensor:
    return torch.arange(start, start + n, dtype=torch.int32, device=device)


def _embed_inputs(cfg: ModelConfig, params: Transformer, batch: Dict,
                  sc=L.no_sc):
    """Returns (the decoder's input embeddings, loss mask or None).  The
    vision stub's patches, projected, come before the tokens; the mask is
    zero on them."""
    tokens = batch["tokens"]
    x = L.embed_lookup(sc(params.embed, "params"), tokens)
    mask = None
    if cfg.frontend == "vision_stub":
        patches = _project(batch["patches"],
                           sc(params.frontend_proj, "params"), x.dtype)
        x = torch.cat([patches, x], dim=1)
        B, P = patches.shape[:2]
        mask = torch.cat([
            torch.zeros((B, P), dtype=torch.float32, device=x.device),
            torch.ones(tuple(tokens.shape), dtype=torch.float32,
                       device=x.device)], dim=1)
    return sc(x, "residual"), mask


def forward_logits(cfg: ModelConfig, params: Transformer, batch,
                   impl: str = "auto") -> torch.Tensor:
    """Full-sequence logits (B, S, V) without a cache: the teacher-forcing
    forward (the reference test's ``_full_logits``).  ``batch`` holds
    ``tokens`` (B, S_tok) and the frontend's ``patches`` or ``frames``;
    a tensor is taken as the tokens.  With patches, S counts them too."""
    if isinstance(batch, torch.Tensor):
        batch = {"tokens": batch}
    x, _ = _embed_inputs(cfg, params, batch)
    positions = _positions(0, x.shape[1], x.device)
    cross_src = _encode(cfg, params, batch, False, impl)
    x, _, _ = _stack(cfg, params, x, positions, None, 0, decode=False,
                     impl=impl, cross_src=cross_src)
    return L.rms_norm(x, params.final_norm, cfg.norm_eps) @ params.lm_head


def forward_train(cfg: ModelConfig, params: Transformer, batch: Dict,
                  remat: bool = True, moe_offset=None, impl: str = "auto",
                  sc=L.no_sc):
    """Full-sequence forward to the loss; returns (loss, metrics).

    ``batch`` holds int ``tokens`` and ``targets`` (B, S), and the
    frontend's stub: ``patches`` (B, n_patches, frontend_dim) for the
    vision stub, ``frames`` (B, T_enc, frontend_dim) for the audio stub,
    in any float dtype (each projected in the promoted dtype, then cast to
    the model's).  Embeddings (patches first), the encoder (whisper), the
    stack (each layer, with the shared block that follows it, under
    ``torch.utils.checkpoint`` when ``remat``; the encoder's layers too),
    the final norm, then ``chunked_softmax_xent`` over the LM head with
    the patches' positions masked out (their targets padded with zeros),
    plus 0.01 times each ``*_loss`` aux of the stack (the MoE's
    load-balance and z losses, averaged over layers).  Every kind trains:
    the flash, gmm, ssd and wkv kernels run their forwards inside autograd
    ops whose backwards are plain PyTorch.  ``moe_offset`` rotates the
    MoE's admission order (GCR-MoE).  ``impl="ref"`` sends every kernel
    to its plain version on the card.  ``sc`` is the sharding hook
    (``parallel.ShardingRules.constrain``, or none)."""
    _check_supported(cfg)
    x, mask = _embed_inputs(cfg, params, batch, sc)
    positions = _positions(0, x.shape[1], x.device)
    cross_src = _encode(cfg, params, batch, remat, impl, sc)
    x, _, aux = _stack(cfg, params, x, positions, None, 0, decode=False,
                       impl=impl, moe_offset=moe_offset, remat=remat,
                       cross_src=cross_src, sc=sc)
    x = sc(L.rms_norm(x, params.final_norm, cfg.norm_eps), "block_in")
    targets = batch["targets"]
    if cfg.frontend == "vision_stub":
        # the patches' positions carry no targets
        pad = torch.zeros((targets.shape[0], x.shape[1] - targets.shape[1]),
                          dtype=targets.dtype, device=targets.device)
        targets = torch.cat([pad, targets], dim=1)
    loss = L.chunked_softmax_xent(x, sc(params.lm_head, "params"), targets,
                                  mask, sc=sc)
    for key, val in aux.items():
        if key.endswith("_loss"):
            loss = loss + 0.01 * val
    return loss, {"loss": loss, **aux}


def prefill(cfg: ModelConfig, params: Transformer, batch: Dict,
            max_len: int, impl: str = "auto", sc=L.no_sc):
    """Process the prompt ``batch["tokens"]`` (B, S_tok), after the vision
    stub's ``patches`` or with the audio stub's ``frames`` encoded; returns
    (last-token logits (B, 1, V), populated cache).  The cache's ``pos``
    counts the patches too; the cross caches hold the encoder's length.
    ``impl="ref"`` sends prompt, encoder and cross-attention, the expert
    products, the SSD scan and the WKV to their plain versions even on
    the card (for comparing)."""
    x, _ = _embed_inputs(cfg, params, batch, sc)
    B, S = x.shape[:2]
    positions = _positions(0, S, x.device)
    cross_src = _encode(cfg, params, batch, False, impl, sc)
    enc_len = 0 if cross_src is None else cross_src.shape[1]
    if sc is L.no_sc:
        caches = init_cache(cfg, B, max_len, x.device, enc_len)
    else:
        # shapes only: the hook allocates each rank's own shards
        caches = sc((cache_layout(cfg, B, max_len, enc_len), x.device),
                    "cache")
    x, caches, _ = _stack(cfg, params, x, positions, caches, 0,
                          decode=False, impl=impl, cross_src=cross_src, sc=sc)
    caches["pos"] = S
    x = L.rms_norm(sc(x, "block_in")[:, -1:], params.final_norm,
                   cfg.norm_eps)
    return sc(x @ sc(params.lm_head, "params"), "logits"), caches


def decode_step(cfg: ModelConfig, params: Transformer, caches: Dict,
                tokens: torch.Tensor, sc=L.no_sc):
    """One serving step: tokens (B, 1) -> (logits (B, 1, V), caches).  The
    caches are updated in place and returned; cross-attention reads the
    cross caches prefill wrote."""
    x = sc(L.embed_lookup(sc(params.embed, "params"), tokens), "residual")
    pos = caches["pos"]
    positions = _positions(pos, tokens.shape[1], x.device)
    x, caches, _ = _stack(cfg, params, x, positions, caches, pos,
                          decode=True, sc=sc)
    caches["pos"] = pos + tokens.shape[1]
    x = L.rms_norm(x, params.final_norm, cfg.norm_eps)
    return sc(x @ sc(params.lm_head, "params"), "logits"), caches


# ---------------------------------------------------------------------------
# Shapes in the reference's layout (for the sharding rules)
# ---------------------------------------------------------------------------


def _tree_insert(tree: Dict, parts, value) -> None:
    for part in parts[:-1]:
        tree = tree.setdefault(part, {})
    tree[parts[-1]] = value


def param_shapes(cfg_or_params) -> Dict:
    """The reference's ``param_shapes`` tree: each parameter's shape
    (``torch.Size``) in the reference's nested layout, ``layers`` and
    ``enc_layers`` stacked on a leading layer axis.  Takes a config (the
    model is built on the meta device, nothing allocated) or a
    ``Transformer`` (a DTensor parameter gives its global shape)."""
    params = (cfg_or_params if isinstance(cfg_or_params, nn.Module)
              else Transformer(cfg_or_params, "meta"))
    per_key: Dict[str, list] = {}
    for name, p in params.named_parameters():
        parts = name.split(".")
        if parts[0] in ("layers", "enc_layers"):
            key = ".".join(parts[:1] + parts[2:])
            per_key.setdefault(key, []).append(tuple(p.shape))
        else:
            per_key[name] = [None, tuple(p.shape)]
    tree: Dict = {}
    for key, shapes in per_key.items():
        shape = (shapes[1] if shapes[0] is None
                 else (len(shapes),) + shapes[0])
        _tree_insert(tree, key.split("."), torch.Size(shape))
    return tree


def cache_shapes(cfg: ModelConfig, B: int, max_len: int,
                 enc_len: int = 0) -> Dict:
    """The reference's ``cache_shapes`` tree: ``pos`` a scalar and each
    per-layer (per-invocation) list stacked on a leading axis, as shapes;
    nothing allocated."""
    cache = init_cache(cfg, B, max_len, "meta", enc_len)

    def stack(items):
        return {name: (stack([it[name] for it in items])
                       if isinstance(val, dict)
                       else torch.Size((len(items),) + tuple(val.shape)))
                for name, val in items[0].items()}

    out = {"pos": torch.Size(()), "layers": stack(cache["layers"])}
    for part in ("shared", "cross"):
        if part in cache:
            out[part] = stack(cache[part])
    return out
