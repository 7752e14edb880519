"""A plain float32 decoder: the reference that a served model's tokens
are judged against.

It follows the model's equations and nothing of the program's layout:
token embedding; per layer RMSNorm, grouped-query attention with rotary
embeddings (the first half of each head rotated against the second) over
every earlier position, the last ``window`` of them where the model has
a sliding window, then RMSNorm and either the SwiGLU MLP or the mixture
of experts; a final RMSNorm and the LM head.  The mixture routes each
token to its ``top_k`` most probable experts under an f32 router, their
gates renormalised, and admits a token to an expert only while the
expert's capacity in the token's admission group lasts, counting claims
in token order: a prompt is one group and each decoded token its own
(the capacity rule ``max(8, ceil8(int(n * top_k * factor / E)))`` of the
model's serving).  A dropped (token, expert) pair adds nothing.

There is no cache and no batching of unequal work: a row is its whole
sequence (the prompt and the served tokens), computed at once, in
float32 with TF32 off, layer by layer over all rows and attention in
blocks of queries, so that it fits beside the model's weights.  The
weights are the benchmark's own tensors, read through ``Weights``, each
upcast to float32 (or first rounded through float8 for the control).

It is the ``reference`` of the configurations in Mixtral's key names
(dense GQA with SwiGLU, or top-k experts): besides ``Weights`` and
``logits`` it gives the harness their widths (``spec``, which is
``bench.spec.model_spec``), the check of the port's configuration
(``check_program``) and ``mfu``'s FLOPs (``model_flops``, which is
``bench.work.model_flops``).  ``Weights``, ``rms_norm``, ``fp8_round``
and ``exact_f32`` serve other references too.
"""

from __future__ import annotations

import contextlib
import math

import torch
import torch.nn.functional as F

from bench.spec import model_spec as spec  # noqa: F401  (the contract's)
from bench.work import model_flops  # noqa: F401  (the contract's)

# the benchmark's widths against the fields of the port's ModelConfig
PROGRAM_FIELDS = {"n_layers": "n_layers", "d_model": "d_model",
                  "n_heads": "n_heads", "n_kv_heads": "n_kv_heads",
                  "head_dim": "head_dim", "vocab_size": "vocab_size",
                  "window": "sliding_window", "rope_theta": "rope_theta",
                  "norm_eps": "norm_eps", "dtype": "dtype"}
MOE_FIELDS = {"n_experts": "n_experts", "top_k": "n_experts_active",
              "expert_d_ff": "moe_d_ff",
              "capacity_factor": "moe_capacity_factor"}

QUERY_BLOCK = 1024
TOKEN_BLOCK = 8192
FP8_MAX = 448.0          # largest finite float8_e4m3fn


@contextlib.contextmanager
def exact_f32():
    """float32 matmuls without TF32, restored after."""
    old = (torch.backends.cuda.matmul.allow_tf32,
           torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = old


def fp8_round(w: torch.Tensor, per: int = 0) -> torch.Tensor:
    """w rounded through float8 e4m3 with one scale per tensor (per = 0)
    or per slice of its first ``per`` dims, back in float32."""
    w = w.float()
    amax = w.abs().amax(dim=tuple(range(per, w.dim())), keepdim=True)
    scale = amax.clamp_min(1e-30) / FP8_MAX
    return (w / scale).to(torch.float8_e4m3fn).float() * scale


class Weights:
    """The benchmark's weight tensors seen as float32: ``weights`` is
    {"embed", "final_norm", "lm_head", "layers": {key: (L, ...)}}.  With
    ``fp8`` every matrix and the embedding are rounded through float8
    e4m3 first (one scale a matrix, an expert's its own), the router and
    the norms are not: the control."""

    def __init__(self, weights: dict, fp8: bool = False) -> None:
        self.w = weights
        self.fp8 = fp8

    def _cast(self, key: str, t: torch.Tensor) -> torch.Tensor:
        if not self.fp8 or t.dim() < 2 or key.endswith("router"):
            return t.float()
        return fp8_round(t, per=t.dim() - 2)

    def top(self, key: str) -> torch.Tensor:
        return self._cast(key, self.w[key])

    def layer(self, key: str, i: int) -> torch.Tensor:
        return self._cast(key, self.w["layers"][key][i])

    def expert(self, key: str, i: int, e: int) -> torch.Tensor:
        return self._cast(key, self.w["layers"][key][i][e])


def check_program(spec: dict, cfg) -> dict:
    """{width: (benchmark, port)} where the port's ``ModelConfig`` differs
    from ``spec``, field by field, and ``kind`` where its blocks are not
    plain attention with the SwiGLU MLP or the experts."""
    moe = bool(spec["n_experts"])
    fields = dict(PROGRAM_FIELDS, **(MOE_FIELDS if moe else
                                     {"d_ff": "d_ff"}))
    bad = {k: (spec[k], getattr(cfg, f)) for k, f in fields.items()
           if spec[k] != getattr(cfg, f)}
    kind = ("moe",) if moe else ("attn",)
    if cfg.block_pattern != kind or cfg.qk_norm or cfg.frontend != "none":
        bad["kind"] = (kind, cfg.block_pattern, cfg.qk_norm, cfg.frontend)
    return bad


def rms_norm(x, w, eps):
    return x * torch.rsqrt(x.square().mean(-1, keepdim=True) + eps) * w


def rope(x, positions, theta):
    """x (..., T, H, D), positions (T,): the first half of each head
    rotated against the second by angle position / theta^(2i/D)."""
    half = x.shape[-1] // 2
    inv = 1.0 / theta ** (torch.arange(half, dtype=torch.float64,
                                       device=x.device) / half)
    ang = positions.double()[:, None] * inv[None]
    cos = torch.cos(ang).float()[:, None, :]
    sin = torch.sin(ang).float()[:, None, :]
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


def attention(q, k, v, window):
    """One row: q (T, Hq, D), k and v (T, Hkv, D); query head h reads key
    head h // (Hq / Hkv); causal, and within ``window`` when set.
    Returns (T, Hq * D)."""
    T, Hq, D = q.shape
    Hkv = k.shape[1]
    G = Hq // Hkv
    qg = q.reshape(T, Hkv, G, D).permute(1, 2, 0, 3)       # (Hkv, G, T, D)
    kt, vt = k.permute(1, 0, 2), v.permute(1, 0, 2)          # (Hkv, T, D)
    pos = torch.arange(T, device=q.device)
    out = torch.empty((Hkv, G, T, D), dtype=q.dtype, device=q.device)
    for s in range(0, T, QUERY_BLOCK):
        qb = qg[:, :, s:s + QUERY_BLOCK]
        scores = torch.einsum("hgqd,hkd->hgqk", qb, kt) / math.sqrt(D)
        dist = pos[s:s + QUERY_BLOCK, None] - pos[None, :]
        visible = dist >= 0
        if window:
            visible &= dist < window
        scores = scores.masked_fill(~visible, float("-inf"))
        out[:, :, s:s + QUERY_BLOCK] = torch.einsum(
            "hgqk,hkd->hgqd", torch.softmax(scores, dim=-1), vt)
    return out.permute(2, 0, 1, 3).reshape(T, Hq * D)


def capacity(n: int, top_k: int, factor: float, n_experts: int) -> int:
    cap = int(n * top_k * factor / n_experts)
    return max(8, ((cap + 7) // 8) * 8)


def admitted(experts, groups, spec):
    """experts (T, k) of one row; groups: the admission groups' lengths in
    order.  True where the (token, expert) pair is within its expert's
    capacity in its group, counting claims in token order."""
    E, k = spec["n_experts"], spec["top_k"]
    ok = torch.ones_like(experts, dtype=torch.bool)
    start = 0
    for n in groups:
        cap = capacity(n, k, spec["capacity_factor"], E)
        if n * k > cap:                        # a group that can overflow
            flat = experts[start:start + n].reshape(-1)
            claims = F.one_hot(flat, E).cumsum(0)
            rank = claims.gather(1, flat[:, None])[:, 0] - 1
            ok[start:start + n] = (rank < cap).reshape(n, k)
        start += n
    return ok


def moe(x, W, i, groups, spec):
    """x (N, T, d) normed; the mixture's output (N, T, d)."""
    N, T, d = x.shape
    E, k = spec["n_experts"], spec["top_k"]
    probs = torch.softmax(x @ W.layer("moe.router", i), dim=-1)
    gates, experts = torch.topk(probs, k, dim=-1)               # (N, T, k)
    gates = gates / gates.sum(-1, keepdim=True)
    keep = torch.stack([admitted(experts[n], groups, spec)
                        for n in range(N)])
    flat_x = x.reshape(N * T, d)
    out = torch.zeros_like(flat_x)
    experts, gates, keep = (experts.reshape(N * T, k),
                            gates.reshape(N * T, k), keep.reshape(N * T, k))
    for e in range(E):
        tok, slot = torch.nonzero((experts == e) & keep, as_tuple=True)
        if tok.numel() == 0:
            continue
        wg, wu, wo = (W.expert(name, i, e)
                      for name in ("moe.wi_gate", "moe.wi_up", "moe.wo"))
        xe = flat_x[tok]
        ye = (F.silu(xe @ wg) * (xe @ wu)) @ wo
        out.index_add_(0, tok, ye * gates[tok, slot, None])
    return out.reshape(N, T, d)


def mlp(x, W, i):
    wg, wu, wo = (W.layer("mlp.wi_gate", i), W.layer("mlp.wi_up", i),
                  W.layer("mlp.wo", i))
    flat = x.reshape(-1, x.shape[-1])
    out = torch.empty_like(flat)
    for s in range(0, flat.shape[0], TOKEN_BLOCK):
        xb = flat[s:s + TOKEN_BLOCK]
        out[s:s + TOKEN_BLOCK] = (F.silu(xb @ wg) * (xb @ wu)) @ wo
    return out.reshape(x.shape)


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
        N, T = tokens.shape
        Hq, Hkv, D = spec["n_heads"], spec["n_kv_heads"], spec["head_dim"]
        eps, pos = spec["norm_eps"], torch.arange(T, device=tokens.device)
        x = W.top("embed")[tokens]
        for i in range(spec["n_layers"]):
            h = rms_norm(x, W.layer("ln1", i), eps)
            q = rope((h @ W.layer("attn.wq", i)).view(N, T, Hq, D), pos,
                     spec["rope_theta"])
            kk = rope((h @ W.layer("attn.wk", i)).view(N, T, Hkv, D), pos,
                      spec["rope_theta"])
            v = (h @ W.layer("attn.wv", i)).view(N, T, Hkv, D)
            att = torch.stack([attention(q[n], kk[n], v[n], spec["window"])
                               for n in range(N)])
            del q, kk, v
            x = x + att @ W.layer("attn.wo", i)
            h = rms_norm(x, W.layer("ln2", i), eps)
            x = x + (moe(h, W, i, groups, spec) if spec["n_experts"]
                     else mlp(h, W, i))
        h = rms_norm(x[:, at], W.top("final_norm"), eps)
        return h @ W.top("lm_head")
