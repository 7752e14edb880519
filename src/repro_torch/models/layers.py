"""Shared layers: the port of ``repro.models.layers`` for the dense GQA
decoder, whisper's encoder and cross-attention, in train, prefill and
decode modes, and its losses.

Conventions (as in the reference):
* weights keep JAX's ``x @ W`` layout ``(in, out)``, so carrying the
  reference's parameters over is a copy, never a transpose;
* activations flow as (batch, seq, ...); prefill attention is flat-head
  ``(B, S, H, D)`` and reads GQA KV heads without repeating them, decode
  attention is grouped ``(B, S, n_kv, G, D)``;
* KV caches are ring buffers of ``cache_len`` slots; unwritten slots have
  a negative position and are masked.

Modules (``Attention``, ``MLP``) only hold parameters; the computation is
in plain functions that take them, with the reference's names.
Parameters are built without grad, so serving records no graph;
``steps.init_train_state`` turns grad on for training.

``sc`` is the reference's sharding hook, called at the reference's call
sites with the same kinds: ``no_sc`` (the default) returns its input, and
``parallel.ShardingRules.constrain`` pins a DTensor to the kind's
placements.
"""

from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn
from torch.distributed.tensor import Replicate, Shard
from torch.utils.checkpoint import checkpoint

from ..kernels import _sharded
from ..kernels.flash_attention.ops import flash_attention_fwd
from ..kernels.flash_attention.ref import attention_ref
from ..runtime import trace

NEG_INF = -1e30


def no_sc(x, kind: Optional[str] = None):
    """The sharding hook without rules: the identity."""
    return x


def split_heads(x: torch.Tensor, *shape: int) -> torch.Tensor:
    """``x.reshape(*shape)``, where the last two sizes of ``shape`` split
    x's last dim into (heads, head_dim).  A DTensor whose last dim is
    split over mesh dims whose sizes do not divide the head count is first
    gathered on those (the reference's rule: a head count that does not
    divide its axis stays replicated); DTensor cannot reshape a split that
    falls inside a head."""
    if _sharded.is_sharded(x):
        heads, last = shape[-2], x.ndim - 1
        keep, n = [], 1
        for i, pl in enumerate(x.placements):
            if isinstance(pl, Shard) and pl.dim == last:
                size = x.device_mesh.size(i)
                if heads % (n * size):
                    pl = Replicate()
                else:
                    n *= size
            keep.append(pl)
        if keep != list(x.placements):
            x = x.redistribute(x.device_mesh, keep)
    return x.reshape(*shape)


class _MergeHeads(torch.autograd.Function):
    """A DTensor's (..., heads, head_dim) flattened to (..., width), whose
    gradient goes back through ``split_heads``: the gradient may arrive
    split over a mesh dim that does not divide the heads (DTensor picks
    its layout), where a plain reshape's backward would raise."""

    @staticmethod
    def forward(ctx, x, shape):
        ctx.in_shape = tuple(x.shape)
        return x.reshape(shape)

    @staticmethod
    def backward(ctx, grad):
        return split_heads(grad, *ctx.in_shape), None


def merge_heads(x: torch.Tensor, *shape: int) -> torch.Tensor:
    """``x.reshape(*shape)``, the last two dims of x (heads, head_dim)
    flattened into the last of ``shape``; a DTensor's gradient is split
    back by ``split_heads``."""
    if _sharded.is_sharded(x):
        return _MergeHeads.apply(x, shape)
    return x.reshape(*shape)


def _param(shape, device, dtype) -> nn.Parameter:
    # built without grad (serving records no graph); training turns it on
    return nn.Parameter(torch.empty(shape, device=device, dtype=dtype),
                        requires_grad=False)


class Attention(nn.Module):
    """Parameters of ``repro.models.layers.attention_params``."""

    def __init__(self, d_model: int, n_heads: int, n_kv: int, d_head: int,
                 qk_norm: bool, *, device, dtype) -> None:
        super().__init__()
        self.wq = _param((d_model, n_heads * d_head), device, dtype)
        self.wk = _param((d_model, n_kv * d_head), device, dtype)
        self.wv = _param((d_model, n_kv * d_head), device, dtype)
        self.wo = _param((n_heads * d_head, d_model), device, dtype)
        if qk_norm:
            self.q_norm = _param((d_head,), device, dtype)
            self.k_norm = _param((d_head,), device, dtype)


class MLA(nn.Module):
    """Parameters of DeepSeek-V2's latent attention without a q latent
    (the port's own; the reference has none): ``wq`` (d, H x (nope +
    rope)), ``wkv_a`` (d, r + rope) giving the latent c_kv and one rope
    key shared by every head, ``kv_norm`` (r,) on c_kv, ``wkv_b`` (r, H x
    (nope + v)) giving each head's k_nope and v, ``wo`` (H x v, d).  Head
    h's columns are ``[h * width, (h + 1) * width)``, nope before rope
    (q) and k_nope before v (kv_b), as HF's ``view(..., H, width)``."""

    def __init__(self, d_model: int, n_heads: int, rank: int, nope: int,
                 rope: int, v_dim: int, *, device, dtype) -> None:
        super().__init__()
        self.wq = _param((d_model, n_heads * (nope + rope)), device, dtype)
        self.wkv_a = _param((d_model, rank + rope), device, dtype)
        self.kv_norm = _param((rank,), device, dtype)
        self.wkv_b = _param((rank, n_heads * (nope + v_dim)), device, dtype)
        self.wo = _param((n_heads * v_dim, d_model), device, dtype)


class MLP(nn.Module):
    """Parameters of ``repro.models.layers.mlp_params`` (SwiGLU)."""

    def __init__(self, d_model: int, d_ff: int, *, device, dtype) -> None:
        super().__init__()
        self.wi_gate = _param((d_model, d_ff), device, dtype)
        self.wi_up = _param((d_model, d_ff), device, dtype)
        self.wo = _param((d_ff, d_model), device, dtype)


# ---------------------------------------------------------------------------
# Initializers (the reference's laws, drawn from a torch.Generator)
# ---------------------------------------------------------------------------


def dense_init_(w: torch.Tensor, generator: torch.Generator) -> None:
    """N(0, 1/in_dim) for an (in, out) weight, or a stack (..., in, out)
    of them, drawn in f32."""
    draw = torch.randn(w.shape, generator=generator, device=w.device,
                       dtype=torch.float32)
    w.copy_(draw * (1.0 / math.sqrt(w.shape[-2])))


def embed_init_(w: torch.Tensor, generator: torch.Generator) -> None:
    draw = torch.randn(w.shape, generator=generator, device=w.device,
                       dtype=torch.float32)
    w.copy_(draw * 0.02)


def embed_lookup(table: torch.Tensor, tokens: torch.Tensor) -> torch.Tensor:
    """``table[tokens]``; a DTensor table is looked up on each rank's own
    vocab range (``kernels._sharded.embedding``)."""
    if _sharded.is_sharded(table):
        return _sharded.embedding(table, tokens)
    return table[tokens]


# ---------------------------------------------------------------------------
# Norms and rotary embeddings
# ---------------------------------------------------------------------------


def rms_norm(x: torch.Tensor, weight: torch.Tensor,
             eps: float = 1e-5) -> torch.Tensor:
    x32 = x.float()
    var = x32.square().mean(dim=-1, keepdim=True)
    y = x32 * torch.rsqrt(var + eps)
    return (y * weight.float()).to(x.dtype)


def rope_frequencies(head_dim: int, theta: float,
                     device=None) -> torch.Tensor:
    half = head_dim // 2
    exps = torch.arange(0, half, dtype=torch.float32, device=device) / half
    return 1.0 / (theta ** exps)


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float) -> torch.Tensor:
    """x: (..., seq, heads..., d_head); positions: (..., seq) int."""
    half = x.shape[-1] // 2
    freqs = rope_frequencies(x.shape[-1], theta, x.device)
    angles = positions.float()[..., None] * freqs          # (..., S, half)
    for _ in range(x.dim() - angles.dim() - 1):            # head axes
        angles = angles[..., None, :]
    cos, sin = torch.cos(angles), torch.sin(angles)
    x1, x2 = x[..., :half], x[..., half:]
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def yarn_mscale(factor: float, mscale: float) -> float:
    """HF's ``yarn_get_mscale``: 0.1 mscale ln(factor) + 1 (1 at factor
    <= 1)."""
    return 1.0 if factor <= 1 else 0.1 * mscale * math.log(factor) + 1.0


def yarn_correction_range(beta_fast: float, beta_slow: float, dim: int,
                          theta: float, original_len: int
                          ) -> Tuple[int, int]:
    """HF's ``yarn_find_correction_range``: the rotary pair indices where
    the ramp from unscaled (fast rotations) to scaled (slow) frequencies
    starts and ends."""
    def at(rotations):
        return (dim * math.log(original_len / (rotations * 2 * math.pi))
                / (2 * math.log(theta)))
    return (max(math.floor(at(beta_fast)), 0),
            min(math.ceil(at(beta_slow)), dim - 1))


def yarn_frequencies(dim: int, theta: float, factor: float,
                     original_len: int, beta_fast: float, beta_slow: float,
                     device=None) -> torch.Tensor:
    """HF's ``DeepseekV2YarnRotaryEmbedding`` inverse frequencies (dim /
    2,), f32: theta^(-2i/dim) below the ramp, that over ``factor`` above
    it, blended linearly across it."""
    exps = torch.arange(0, dim, 2, dtype=torch.float32, device=device) / dim
    extra = 1.0 / theta ** exps
    inter = 1.0 / (factor * theta ** exps)
    lo, hi = yarn_correction_range(beta_fast, beta_slow, dim, theta,
                                   original_len)
    hi = hi + 0.001 if lo == hi else hi
    ramp = ((torch.arange(dim // 2, dtype=torch.float32, device=device) - lo)
            / (hi - lo)).clamp(0, 1)
    return inter * ramp + extra * (1 - ramp)


def yarn_rope(x: torch.Tensor, positions: torch.Tensor,
              inv_freq: torch.Tensor, cos_scale: float) -> torch.Tensor:
    """x (B, S, H, dim) rotated as HF's DeepSeek-V2 ``apply_rotary_pos_emb``
    rotates it: the interleaved pairs (2i, 2i + 1) are first gathered into
    halves (x[0::2], then x[1::2]), then the first half rotated against
    the second by angle position x inv_freq[i], cos and sin times
    ``cos_scale`` (mscale / mscale_all_dim).  Returns f32."""
    B, S, H, dim = x.shape
    x = x.float().view(B, S, H, dim // 2, 2).transpose(-1, -2) \
        .reshape(B, S, H, dim)
    ang = positions.float()[:, None] * inv_freq                # (S, dim/2)
    cos = (torch.cos(ang) * cos_scale)[:, None, :]
    sin = (torch.sin(ang) * cos_scale)[:, None, :]
    x1, x2 = x[..., :dim // 2], x[..., dim // 2:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


# ---------------------------------------------------------------------------
# Attention
# ---------------------------------------------------------------------------

# Flat-head attention with materialised scores (the reference's
# ``_plain_attention``); it takes GQA KV heads without repeating them.
_plain_attention = attention_ref


def _grouped_decode_attention(q, k, v, q_pos, k_pos, window: int):
    """Decode attention without KV repetition (cache stays kv-width).

    q: (B,S,Hkv,G,D); k,v: (B,T,Hkv,D)."""
    scale = 1.0 / math.sqrt(q.shape[-1])
    scores = torch.einsum("bshgd,bthd->bhgst", q, k).float() * scale
    mask = k_pos[None, :] <= q_pos[:, None]
    if window:
        mask &= (q_pos[:, None] - k_pos[None, :]) < window
    mask &= (k_pos >= 0)[None, :]
    scores = torch.where(mask, scores, NEG_INF)
    probs = torch.softmax(scores, dim=-1).to(q.dtype)
    return torch.einsum("bhgst,bthd->bshgd", probs, v)


def _cache_write(cache: Dict, k: torch.Tensor, v: torch.Tensor,
                 cache_pos: int) -> Dict:
    """Write the last min(S, Tc) tokens of k/v into the ring buffer.

    In place (``index_copy_``), where the reference builds new arrays:
    this saves a copy of every layer's cache per step.  Returns ``cache``.
    DTensor caches (split by the rules' cache specs) are written by each
    rank in its own slots (``kernels._sharded.cache_write``).
    """
    if _sharded.is_sharded(cache["k"]):
        _sharded.cache_write(cache, k, v, cache_pos)
        return cache
    return _ring_write(cache, {"k": k, "v": v}, cache_pos)


def _ring_write(cache: Dict, new: Dict[str, torch.Tensor],
                cache_pos: int) -> Dict:
    """Write the last min(S, Tc) tokens of each leaf of ``new`` (B, S,
    ...) into the ring buffer of the same name (B, Tc, ...), in place;
    the leaves share S and Tc, so one slot index serves them all.
    Returns ``cache``."""
    first = next(iter(new))
    Tc, S = cache[first].shape[1], new[first].shape[1]
    Lw = min(S, Tc)
    slots = (cache_pos + S - Lw
             + torch.arange(Lw, device=new[first].device)) % Tc
    for name, t in new.items():
        cache[name].index_copy_(1, slots, t[:, -Lw:].to(cache[name].dtype))
    return cache


def _cache_slot_positions(Tc: int, cache_pos: int, S: int,
                          device=None) -> torch.Tensor:
    """Absolute position held by ring slot i after writing S tokens:
    p(i) = last - ((last - i) mod Tc), last = cache_pos + S - 1; negative
    if the slot has never been written."""
    last = cache_pos + S - 1
    idx = torch.arange(Tc, dtype=torch.int32, device=device)
    k_pos = last - torch.remainder(last - idx, Tc)
    return torch.where(k_pos <= last, k_pos, -1)


def multihead_attention(
    p: Attention,
    x: torch.Tensor,                # (B, S, d_model)
    positions: torch.Tensor,        # (S,) int32 absolute positions of x
    cache: Optional[Dict],          # {"k","v"} ring buffers or None
    cache_pos: int,                 # tokens already in the cache
    *,
    n_heads: int,
    n_kv: int,
    d_head: int,
    qk_norm: bool = False,
    rope_theta: float = 1e4,
    window: int = 0,
    causal: bool = True,
    decode: bool = False,           # True: attend over the cache (S small)
    kv_src: Optional[torch.Tensor] = None,  # cross-attention source
    is_cross: bool = False,         # cross-attention (kv from kv_src/cache)
    eps: float = 1e-5,
    impl: str = "auto",             # prompt attention: auto | ref
    sc=no_sc,                       # sharding hook
) -> Tuple[torch.Tensor, Optional[Dict]]:
    """Self- or cross-attention.  Returns (output (B,S,d_model), cache).

    Modes:
      no cache - attend within the sequence (training, the teacher-forcing
                 forward, the encoder).
      prefill  - cache given, decode=False: attend within the sequence,
                 write the last min(S, cache_len) tokens into the ring.
      decode   - cache given, decode=True: write the current token(s),
                 attend over the whole ring.

    Cross-attention (``is_cross``) projects K and V from ``kv_src`` (the
    encoder's output, (B, T_src, d_model)) and applies no RoPE; its key
    positions are ``arange(T_src)``.  In prefill it writes that K/V into
    the static cross cache (T_src slots); in decode it reads the cache
    and writes nothing.  Self-attention applies RoPE to q and k at
    ``positions``.  ``causal=False`` (the encoder, cross-attention) masks
    only unwritten key slots.

    Prompt, encoder and cross-attention (no cache, or prefill) go through
    ``flash_attention_fwd``: the Hopper kernel for every CUDA tensor, the
    plain version for a CPU tensor; with grad enabled it is the
    differentiable op, whose backward is the reference's blocked flash
    backward in plain PyTorch.  The reference takes its flash path only
    when ``S % 512 == 0 and T % 1024 == 0`` and plain attention otherwise:
    a tiling constraint of its XLA scan, not part of the model, so the
    port takes the same op at every S and T.  Decode attention is plain
    PyTorch, as it is plain XLA in the reference: grouped (no KV
    repetition), masked by positions for self-attention, an unmasked
    softmax over the cross cache for cross-attention.
    """
    B, S, _ = x.shape
    q = split_heads(x @ p.wq, B, S, n_heads, d_head)
    if is_cross and decode:
        k, v = cache["k"], cache["v"]
    else:
        src = x if kv_src is None else kv_src
        T = src.shape[1]
        k = split_heads(src @ p.wk, B, T, n_kv, d_head)
        v = split_heads(src @ p.wv, B, T, n_kv, d_head)
        if qk_norm:
            q = rms_norm(q, p.q_norm, eps)
            k = rms_norm(k, p.k_norm, eps)
        if not is_cross:
            q = apply_rope(q, positions, rope_theta)
            k = apply_rope(k, positions, rope_theta)
        if cache is not None:
            cache = _cache_write(cache, k, v, cache_pos)
    if decode and _sharded.is_sharded(cache["k"]):
        # sequence-split caches: the softmax reduced across the ranks
        k_pos = (_cache_slot_positions(cache["k"].shape[1], cache_pos, S,
                                       x.device) if causal else None)
        out = _sharded.decode_attention(q, cache["k"], cache["v"],
                                        positions, k_pos, window, causal,
                                        n_kv)
    elif decode:
        qg = q.reshape(B, S, n_kv, n_heads // n_kv, d_head)
        if causal:
            k_pos = _cache_slot_positions(cache["k"].shape[1], cache_pos, S,
                                          x.device)
            out = _grouped_decode_attention(qg, cache["k"], cache["v"],
                                            positions, k_pos, window)
        else:
            scores = torch.einsum("bshgd,bthd->bhgst", qg, k).float() \
                * (1.0 / math.sqrt(d_head))
            probs = torch.softmax(scores, dim=-1).to(q.dtype)
            out = torch.einsum("bhgst,bthd->bshgd", probs, v)
    else:
        if n_heads == n_kv:
            # full MHA: pin k/v to the heads layout (GQA kv heads are
            # placed by the kernel op, which reads them natively)
            k = sc(k, "heads")
            v = sc(v, "heads")
        q = sc(q, "heads")
        k_pos = (torch.arange(k.shape[1], dtype=torch.int32,
                              device=x.device) if is_cross else positions)
        out = flash_attention_fwd(q, k, v, positions, k_pos, window=window,
                                  causal=causal, impl=impl)
        out = sc(out, "heads")
    return merge_heads(out, B, S, n_heads * d_head) @ p.wo, cache


# ---------------------------------------------------------------------------
# Latent attention (DeepSeek-V2's MLA)
# ---------------------------------------------------------------------------

_YARN: Dict[tuple, torch.Tensor] = {}


def _yarn_inv_freq(dim: int, theta: float, yarn: Tuple, device
                   ) -> torch.Tensor:
    """``yarn_frequencies`` (plain rotary frequencies without a factor),
    made once a device."""
    key = (dim, theta, yarn, str(device))
    if key not in _YARN:
        factor, original, fast, slow = yarn[:4]
        _YARN[key] = (yarn_frequencies(dim, theta, factor, original, fast,
                                       slow, device) if factor
                      else rope_frequencies(dim, theta, device))
    return _YARN[key]


def mla_scales(yarn: Tuple) -> Tuple[float, float]:
    """(cos_scale, softmax_mult) of YaRN (factor, original length,
    beta_fast, beta_slow, mscale, mscale_all_dim): cos and sin are
    scaled by mscale / mscale_all_dim's ``yarn_mscale``s, and the
    softmax scale, head_dim^-0.5, by mscale_all_dim's squared (HF's
    ``DeepseekV2Attention``).  (1, 1) without YaRN."""
    factor, _, _, _, mscale, mscale_all = yarn
    if not factor:
        return 1.0, 1.0
    cos_scale = yarn_mscale(factor, mscale) / yarn_mscale(factor, mscale_all)
    mult = yarn_mscale(factor, mscale_all) ** 2 if mscale_all else 1.0
    return cos_scale, mult


def mla_attention(
    p: MLA,
    x: torch.Tensor,                # (B, S, d_model)
    positions: torch.Tensor,        # (S,) int32 absolute positions of x
    cache: Optional[Dict],          # {"c_kv", "k_pe"} ring buffers or None
    cache_pos: int,                 # tokens already in the cache
    *,
    n_heads: int,
    nope: int,
    rope: int,
    v_dim: int,
    rope_theta: float,
    yarn: Tuple,                    # (factor, original length, beta_fast,
                                    #  beta_slow, mscale, mscale_all_dim)
    eps: float,
    decode: bool = False,
    impl: str = "auto",             # prompt attention: auto | ref
) -> Tuple[torch.Tensor, Optional[Dict]]:
    """DeepSeek-V2's latent attention; returns (output (B,S,d), cache).

    q (nope + rope a head) and the latent c_kv with one rope key k_pe
    shared by every head are projected from x; c_kv is RMS-normed
    (``kv_norm``); q's rope part and k_pe are rotated by ``yarn_rope``.
    The cache holds c_kv (B, T, r) and k_pe (B, T, rope), ring buffers
    as the KV caches (``_ring_write``).

    Prompt (``decode`` False; training and the teacher-forcing forward
    too): the span ``repro_torch.model.mla.expand`` expands c_kv by
    ``wkv_b`` to each head's k_nope and v, and runs
    ``flash_attention_fwd`` at qk nope + rope, v ``v_dim``, q multiplied
    by YaRN's softmax factor (the kernel scales by (nope + rope)^-0.5).

    Decode: the absorbed form, in the device span
    ``repro_torch.model.mla.decode``: q_nope taken through kv_b's k half
    to the latent width, scores over the cached c_kv and k_pe (f32
    softmax, YaRN's scale, masked by the slots' positions), the
    probabilities times c_kv, then kv_b's v half; the counter
    ``mla.latent_rows`` adds the B x written positions read."""
    B, S, _ = x.shape
    H, rank = n_heads, p.kv_norm.shape[0]
    dtype = x.dtype
    inv_freq = _yarn_inv_freq(rope, rope_theta, tuple(yarn[:4]), x.device)
    cos_scale, mult = mla_scales(tuple(yarn))
    q = (x @ p.wq).view(B, S, H, nope + rope)
    kv = x @ p.wkv_a
    c_kv = rms_norm(kv[..., :rank], p.kv_norm, eps)
    k_pe = yarn_rope(kv[..., None, rank:], positions, inv_freq,
                     cos_scale).to(dtype)                       # (B,S,1,rope)
    q_pe = yarn_rope(q[..., nope:], positions, inv_freq, cos_scale)
    if cache is not None:
        _ring_write(cache, {"c_kv": c_kv, "k_pe": k_pe[:, :, 0]}, cache_pos)
    if decode:
        T = cache["c_kv"].shape[1]
        with trace.device_span("repro_torch.model.mla.decode", x.device):
            w = p.wkv_b.view(rank, H, nope + v_dim)
            q_lat = torch.einsum("bshn,chn->bshc", q[..., :nope],
                                 w[..., :nope])
            scores = (torch.einsum("bshc,btc->bhst", q_lat, cache["c_kv"])
                      .float()
                      + torch.einsum("bshr,btr->bhst", q_pe.to(dtype),
                                     cache["k_pe"]).float())
            scores = scores * (mult / math.sqrt(nope + rope))
            k_pos = _cache_slot_positions(T, cache_pos, S, x.device)
            visible = (k_pos[None, :] <= positions[:, None]) \
                & (k_pos >= 0)[None, :]
            probs = torch.softmax(torch.where(visible, scores, NEG_INF),
                                  dim=-1).to(dtype)
            o_lat = torch.einsum("bhst,btc->bshc", probs, cache["c_kv"])
            out = torch.einsum("bshc,chv->bshv", o_lat, w[..., nope:])
        trace.count("mla.latent_rows", B * min(cache_pos + S, T))
    else:
        with trace.span("repro_torch.model.mla.expand"):
            kvb = (c_kv @ p.wkv_b).view(B, S, H, nope + v_dim)
            k = torch.cat([kvb[..., :nope],
                           k_pe.expand(B, S, H, rope)], dim=-1)
            qs = torch.cat([q[..., :nope].float(), q_pe], dim=-1)
            qs = (qs * mult).to(dtype) if mult != 1.0 else qs.to(dtype)
            out = flash_attention_fwd(qs, k, kvb[..., nope:], positions,
                                      positions, causal=True, impl=impl)
    return out.reshape(B, S, H * v_dim) @ p.wo, cache


# ---------------------------------------------------------------------------
# Dense (SwiGLU) MLP
# ---------------------------------------------------------------------------


def mlp(p: MLP, x: torch.Tensor) -> torch.Tensor:
    return (F.silu(x @ p.wi_gate) * (x @ p.wi_up)) @ p.wo


# ---------------------------------------------------------------------------
# Loss
# ---------------------------------------------------------------------------


def cross_entropy(logits: torch.Tensor, targets: torch.Tensor,
                  mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Numerically-stable CE; logits (B,S,V) any float dtype, targets int."""
    logits = logits.float()
    m = logits.amax(dim=-1, keepdim=True)
    lse = m[..., 0] + torch.log(torch.exp(logits - m).sum(dim=-1))
    nll = lse - _gold(logits, targets)
    if mask is not None:
        return (nll * mask).sum() / torch.clamp(mask.sum(), min=1.0)
    return nll.mean()


def _gold(logits: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
    """The targets' logits; a vocab-sharded DTensor gathers each rank's
    own range (``kernels._sharded.vocab_gather``)."""
    if _sharded.is_sharded(logits):
        return _sharded.vocab_gather(logits, targets)
    return torch.gather(logits, -1, targets[..., None].long())[..., 0]


def _xent_chunk(x, w, targets, mask, sc=no_sc):
    logits = sc(x @ w, "logits").float()
    m = logits.amax(dim=-1, keepdim=True)
    lse = m[..., 0] + torch.log(torch.exp(logits - m).sum(dim=-1))
    return ((lse - _gold(logits, targets)) * mask).sum(), mask.sum()


def chunked_softmax_xent(x: torch.Tensor, w: torch.Tensor,
                         targets: torch.Tensor,
                         mask: Optional[torch.Tensor],
                         chunk: int = 512, sc=no_sc) -> torch.Tensor:
    """CE over the LM head without materializing full (B,S,V) logits.

    Walks sequence chunks, recomputing each chunk's logits in the backward
    pass (``torch.utils.checkpoint``, the reference's ``jax.checkpoint``).
    Transient memory drops from O(B*S*V) to O(B*chunk*V).  For S <= chunk
    it is the plain ``cross_entropy`` of the whole logits.  Masked tokens
    count neither in the sum nor in the count; the last chunk may be short
    (the reference needs S to divide)."""
    B, S, D = x.shape
    if S <= chunk:
        return cross_entropy(sc(x @ w, "logits"), targets, mask)
    if mask is None:
        mask = torch.ones((B, S), dtype=torch.float32, device=x.device)
    tot = torch.zeros((), dtype=torch.float32, device=x.device)
    cnt = torch.zeros((), dtype=torch.float32, device=x.device)
    for s0 in range(0, S, chunk):
        part = slice(s0, s0 + chunk)
        nll, n = checkpoint(_xent_chunk, x[:, part], w, targets[:, part],
                            mask[:, part], sc, use_reentrant=False)
        tot, cnt = tot + nll, cnt + n
    return tot / torch.clamp(cnt, min=1.0)
