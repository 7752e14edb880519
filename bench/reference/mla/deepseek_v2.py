"""A plain float32 DeepSeek-V2: the reference that a served DeepSeek-V2
(Lite) model's tokens are judged against (arXiv:2405.04434; the
equations of the published ``modeling_deepseek.py``).

Per layer: RMSNorm, then multi-head latent attention in its expanded
form, as the paper writes it: q = h W_q (each head's 128 dims without
rope and 64 with), the latent c = RMSNorm(h W_dkv) of 512 and one rope
key k_pe = h W_kr shared by every head, each head's k = [c W_uk, k_pe]
and v = c W_uv, causal softmax attention over every earlier position,
then W_o.  q's and k's rope parts are rotated by YaRN: the published
``DeepseekV2YarnRotaryEmbedding`` computed in float64 (inverse
frequencies blended across the ramp between ``beta_fast`` and
``beta_slow`` rotations, cos and sin times mscale / mscale_all_dim),
each head's rope pairs taken interleaved (2i, 2i + 1) as the published
code reads them; the softmax scale is 192^-0.5 times mscale_all_dim's
``yarn_get_mscale`` squared.  Then RMSNorm and, in the first
``first_k_dense_replace`` layers, the dense SwiGLU MLP, in the others
the mixture: a softmax router in float32, the ``top_k`` most probable
experts with their probabilities as gates (not renormalised,
``norm_topk_prob`` false, times ``routed_scaling_factor``), admitted
while the expert's capacity in the token's admission group lasts
(``decoder.admitted``: a prompt is one group and each decoded token its
own), plus the shared experts, one SwiGLU of ``n_shared_experts`` x the
expert width that every token passes through.  A final RMSNorm and the
LM head.

It does not use the absorbed form that the served model decodes with:
every position's keys and values are expanded from the latent, so the
served decode is checked against other arithmetic.  There is no cache
and no batching of unequal work: a row is its whole sequence, in
float32 with TF32 off, attention in blocks of queries over the keys up
to the block's last, so that it fits beside the model's weights.  The
weights are the benchmark's tensors under the port's leaf names (the
leading dense layers as ``dense_layers.<i>.*``, the others stacked under
``layers``), read through ``decoder.Weights``: float32, or rounded
through float8 first for the control.

The contract's other parts: ``spec`` (the widths, from the published
``config.json`` keys), ``check_program`` and ``model_flops``.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from bench.reference.decoder import (TOKEN_BLOCK, Weights,  # noqa: F401
                                     admitted, exact_f32, rms_norm)
from bench.work import visible_pairs

QUERY_BLOCK = 1024

# the benchmark's widths against the port's ModelConfig fields
PROGRAM_FIELDS = {
    "n_layers": "n_layers", "d_model": "d_model", "n_heads": "n_heads",
    "n_kv_heads": "n_kv_heads", "kv_lora_rank": "kv_lora_rank",
    "qk_nope_head_dim": "qk_nope_head_dim",
    "qk_rope_head_dim": "qk_rope_head_dim", "v_head_dim": "v_head_dim",
    "head_dim": "head_dim", "n_dense_layers": "n_dense_layers",
    "d_ff": "d_ff", "n_experts": "n_experts", "top_k": "n_experts_active",
    "expert_d_ff": "moe_d_ff", "n_shared_experts": "moe_shared_experts",
    "renormalize": "moe_renormalize",
    "capacity_factor": "moe_capacity_factor", "vocab_size": "vocab_size",
    "window": "sliding_window", "rope_theta": "rope_theta",
    "norm_eps": "norm_eps", "dtype": "dtype"}
YARN_FIELDS = {"factor": "yarn_factor",
               "original_max_position_embeddings": "yarn_original_max_len",
               "beta_fast": "yarn_beta_fast", "beta_slow": "yarn_beta_slow",
               "mscale": "yarn_mscale",
               "mscale_all_dim": "yarn_mscale_all_dim"}
# published settings this reference (and the port) computes only as
# given here
SUPPORTED = {"q_lora_rank": None, "scoring_func": "softmax",
             "topk_method": "greedy", "n_group": 1, "topk_group": 1,
             "moe_layer_freq": 1, "hidden_act": "silu",
             "attention_bias": False, "tie_word_embeddings": False}


def spec(cfg_file: dict) -> dict:
    """The widths, from the published keys of a DeepSeek-V2 config."""
    nope, rope = cfg_file["qk_nope_head_dim"], cfg_file["qk_rope_head_dim"]
    yarn = cfg_file["rope_scaling"]
    if yarn.get("type") != "yarn":
        raise ValueError(f"rope_scaling {yarn}: only yarn is modelled")
    return {
        "n_layers": cfg_file["num_hidden_layers"],
        "d_model": cfg_file["hidden_size"],
        "n_heads": cfg_file["num_attention_heads"],
        "n_kv_heads": cfg_file["num_key_value_heads"],
        "kv_lora_rank": cfg_file["kv_lora_rank"],
        "qk_nope_head_dim": nope, "qk_rope_head_dim": rope,
        "v_head_dim": cfg_file["v_head_dim"], "head_dim": nope + rope,
        "n_dense_layers": cfg_file["first_k_dense_replace"],
        "d_ff": cfg_file["intermediate_size"],
        "n_experts": cfg_file["n_routed_experts"],
        "top_k": cfg_file["num_experts_per_tok"],
        "expert_d_ff": cfg_file["moe_intermediate_size"],
        "n_shared_experts": cfg_file["n_shared_experts"],
        "renormalize": bool(cfg_file["norm_topk_prob"]),
        "routed_scaling_factor": float(cfg_file["routed_scaling_factor"]),
        "capacity_factor": float(cfg_file["moe_capacity_factor"]),
        "vocab_size": cfg_file["vocab_size"], "window": 0,
        "rope_theta": float(cfg_file["rope_theta"]),
        "yarn": {k: float(yarn[k]) if k != "original_max_position_embeddings"
                 else int(yarn[k]) for k in YARN_FIELDS},
        "norm_eps": float(cfg_file["rms_norm_eps"]),
        "dtype": cfg_file["torch_dtype"],
        "supported": {k: cfg_file.get(k) for k in SUPPORTED},
    }


def check_program(spec: dict, cfg) -> dict:
    """{name: (benchmark, port)} where the port's ``ModelConfig`` differs
    from ``spec``; ``kind`` where its blocks are not DeepSeek-V2's (MoE
    blocks with latent attention after the dense ones, no QK norm, no
    frontend); a published setting this reference does not compute as
    published (``SUPPORTED``; gates scaled other than by 1) under its
    own name."""
    bad = {k: (spec[k], getattr(cfg, f)) for k, f in PROGRAM_FIELDS.items()
           if spec[k] != getattr(cfg, f)}
    bad.update({f"yarn.{k}": (spec["yarn"][k], getattr(cfg, f))
                for k, f in YARN_FIELDS.items()
                if spec["yarn"][k] != getattr(cfg, f)})
    if cfg.block_pattern != ("moe",) or cfg.qk_norm \
            or cfg.frontend != "none":
        bad["kind"] = (("moe",), cfg.block_pattern, cfg.qk_norm,
                       cfg.frontend)
    bad.update({k: (spec["supported"][k], v) for k, v in SUPPORTED.items()
                if spec["supported"][k] != v})
    if spec["routed_scaling_factor"] != 1.0:
        bad["routed_scaling_factor"] = (spec["routed_scaling_factor"], 1.0)
    return bad


def yarn_get_mscale(factor: float, mscale: float) -> float:
    return 1.0 if factor <= 1 else 0.1 * mscale * math.log(factor) + 1.0


def yarn_rotary(spec: dict, device):
    """(inverse frequencies (rope / 2,) f64, cos / sin factor, softmax
    scale): the published YaRN rotary embedding and attention scale."""
    y, dim, base = spec["yarn"], spec["qk_rope_head_dim"], spec["rope_theta"]

    def correction(rotations):
        return (dim * math.log(y["original_max_position_embeddings"]
                               / (rotations * 2 * math.pi))
                / (2 * math.log(base)))

    low = max(math.floor(correction(y["beta_fast"])), 0)
    high = min(math.ceil(correction(y["beta_slow"])), dim - 1)
    if low == high:
        high += 0.001
    extra = 1.0 / base ** (torch.arange(0, dim, 2, dtype=torch.float64,
                                        device=device) / dim)
    inter = extra / y["factor"]
    ramp = ((torch.arange(dim // 2, dtype=torch.float64, device=device)
             - low) / (high - low)).clamp(0, 1)
    inv_freq = inter * ramp + extra * (1 - ramp)
    cos_factor = (yarn_get_mscale(y["factor"], y["mscale"])
                  / yarn_get_mscale(y["factor"], y["mscale_all_dim"]))
    scale = spec["head_dim"] ** -0.5
    if y["mscale_all_dim"]:
        scale *= yarn_get_mscale(y["factor"], y["mscale_all_dim"]) ** 2
    return inv_freq, cos_factor, scale


def rope(x, positions, inv_freq, cos_factor):
    """x (..., T, H, dim), positions (T,): the published rotation, each
    head's interleaved pairs gathered into halves (x[0::2], x[1::2]), the
    first half rotated against the second."""
    half = x.shape[-1] // 2
    x = torch.cat([x[..., 0::2], x[..., 1::2]], dim=-1)
    ang = positions.double()[:, None] * inv_freq[None]
    cos = (torch.cos(ang) * cos_factor).float()[:, None, :]
    sin = (torch.sin(ang) * cos_factor).float()[:, None, :]
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


def attention(q, k, v, scale):
    """One row: q, k (T, H, Dq), v (T, H, Dv); causal.  Returns (T, H *
    Dv).  A block of queries reads the keys up to its last position."""
    T, H, _ = q.shape
    out = torch.empty((T, H, v.shape[-1]), dtype=q.dtype, device=q.device)
    pos = torch.arange(T, device=q.device)
    for s in range(0, T, QUERY_BLOCK):
        e = min(s + QUERY_BLOCK, T)
        scores = torch.einsum("qhd,khd->hqk", q[s:e], k[:e]) * scale
        visible = pos[None, :e] <= pos[s:e, None]
        scores = scores.masked_fill(~visible, float("-inf"))
        out[s:e] = torch.einsum("hqk,khd->qhd", torch.softmax(scores, -1),
                                v[:e])
    return out.reshape(T, -1)


def mla(h, get, spec, positions, rotary):
    """h (N, T, d) normed; the latent attention's output (N, T, d)."""
    N, T, _ = h.shape
    H, r = spec["n_heads"], spec["kv_lora_rank"]
    nope, rdim = spec["qk_nope_head_dim"], spec["qk_rope_head_dim"]
    inv_freq, cos_factor, scale = rotary
    q = (h @ get("attn.wq")).view(N, T, H, nope + rdim)
    kv = h @ get("attn.wkv_a")
    c = rms_norm(kv[..., :r], get("attn.kv_norm"), spec["norm_eps"])
    k_pe = rope(kv[..., None, r:], positions, inv_freq, cos_factor)
    kvb = (c @ get("attn.wkv_b")).view(N, T, H, nope + spec["v_head_dim"])
    q = torch.cat([q[..., :nope],
                   rope(q[..., nope:], positions, inv_freq, cos_factor)], -1)
    k = torch.cat([kvb[..., :nope], k_pe.expand(N, T, H, rdim)], -1)
    v = kvb[..., nope:]
    out = torch.stack([attention(q[n], k[n], v[n], scale) for n in range(N)])
    return out @ get("attn.wo")


def swiglu(x, wg, wu, wo):
    flat = x.reshape(-1, x.shape[-1])
    out = torch.empty_like(flat)
    for s in range(0, flat.shape[0], TOKEN_BLOCK):
        xb = flat[s:s + TOKEN_BLOCK]
        out[s:s + TOKEN_BLOCK] = (F.silu(xb @ wg) * (xb @ wu)) @ wo
    return out.reshape(x.shape)


def moe(x, W, i, groups, spec):
    """x (N, T, d) normed, MoE layer i of ``layers``; the routed experts'
    output plus the shared experts' (N, T, d)."""
    N, T, d = x.shape
    k = spec["top_k"]
    probs = torch.softmax(x @ W.layer("moe.router", i), dim=-1)
    gates, experts = torch.topk(probs, k, dim=-1)               # (N, T, k)
    if spec["renormalize"]:
        gates = gates / gates.sum(-1, keepdim=True)
    gates = gates * spec["routed_scaling_factor"]
    keep = torch.stack([admitted(experts[n], groups, spec)
                        for n in range(N)])
    flat_x = x.reshape(N * T, d)
    out = torch.zeros_like(flat_x)
    experts, gates, keep = (experts.reshape(N * T, k),
                            gates.reshape(N * T, k), keep.reshape(N * T, k))
    for e in range(spec["n_experts"]):
        tok, slot = torch.nonzero((experts == e) & keep, as_tuple=True)
        if tok.numel() == 0:
            continue
        wg, wu, wo = (W.expert(name, i, e)
                      for name in ("moe.wi_gate", "moe.wi_up", "moe.wo"))
        xe = flat_x[tok]
        out.index_add_(0, tok,
                       (F.silu(xe @ wg) * (xe @ wu)) @ wo * gates[tok, slot,
                                                                   None])
    shared = swiglu(x, W.layer("moe.shared_wi_gate", i),
                    W.layer("moe.shared_wi_up", i),
                    W.layer("moe.shared_wo", i))
    return out.reshape(N, T, d) + shared


@torch.no_grad()
def logits(spec: dict, W: Weights, tokens: torch.Tensor, groups: list,
           at: list) -> torch.Tensor:
    """float32 logits (N, len(at), vocab) at positions ``at`` of each of
    the N rows of ``tokens`` (N, T), every row's whole sequence computed
    at once.  ``groups`` are the MoE's admission groups' lengths along a
    row (a prompt, then each decoded token alone)."""
    if sum(groups) != tokens.shape[1]:
        raise ValueError(f"groups {groups} do not cover {tokens.shape[1]}")
    with exact_f32():
        T, eps = tokens.shape[1], spec["norm_eps"]
        pos = torch.arange(T, device=tokens.device)
        rotary = yarn_rotary(spec, tokens.device)
        x = W.top("embed")[tokens]
        for i in range(spec["n_layers"]):
            dense = i < spec["n_dense_layers"]
            j = i - spec["n_dense_layers"]

            def get(key):
                return (W.top(f"dense_layers.{i}.{key}") if dense
                        else W.layer(key, j))

            x = x + mla(rms_norm(x, get("ln1"), eps), get, spec, pos, rotary)
            h = rms_norm(x, get("ln2"), eps)
            x = x + (swiglu(h, get("mlp.wi_gate"), get("mlp.wi_up"),
                            get("mlp.wo")) if dense
                     else moe(h, W, j, groups, spec))
        h = rms_norm(x[:, at], W.top("final_norm"), eps)
        return h @ W.top("lm_head")


def token_flops(spec: dict) -> int:
    """The projections' and MLPs' FLOPs of one token through the stack:
    each layer's q, latent and rope key, the latent's expansion to keys
    and values, and o; the dense layers' SwiGLU; the MoE layers' router,
    ``top_k`` routed experts and the shared experts."""
    d, H, r = spec["d_model"], spec["n_heads"], spec["kv_lora_rank"]
    nope, rdim, vd = (spec["qk_nope_head_dim"], spec["qk_rope_head_dim"],
                      spec["v_head_dim"])
    attn = 2 * (d * H * (nope + rdim) + d * (r + rdim)
                + r * H * (nope + vd) + H * vd * d)
    dense = 3 * 2 * d * spec["d_ff"]
    moe_ = (2 * d * spec["n_experts"]
            + (spec["top_k"] + spec["n_shared_experts"]) * 3 * 2 * d
            * spec["expert_d_ff"])
    n_dense = spec["n_dense_layers"]
    return (spec["n_layers"] * attn + n_dense * dense
            + (spec["n_layers"] - n_dense) * moe_)


def model_flops(spec: dict, B: int, S: int, start: int) -> int:
    """Useful FLOPs of one call over B rows of S new tokens at positions
    start .. start + S - 1 (a prefill: start 0; a decode step: S 1):
    ``token_flops`` of each token, attention in the expanded form (QK^T at
    nope + rope and PV at v a head, for every visible pair) and the LM
    head on the last position of each row.  The absorbed decode's own
    products are not counted: the count is the model's, not the
    method's."""
    per_row = S * token_flops(spec)
    per_row += (2 * spec["n_heads"] * (spec["head_dim"] + spec["v_head_dim"])
                * visible_pairs(S, 0, start) * spec["n_layers"])
    per_row += 2 * spec["d_model"] * spec["vocab_size"]
    return B * per_row
