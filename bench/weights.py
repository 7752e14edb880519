"""The model's weights, made on the device from the seed.

One ``torch.Generator`` on the device draws each kind of leaf for all
layers at once (``layers.<i>.attn.wq`` for every i is one call), in the
dtype it is served in, and scales it in place: a few large calls, no
host copy.  The laws: an (in, out) matrix N(0, 1/in) (``"matrix"``);
the embedding N(0, 0.02^2) (``"embed"``); a norm's weight 1 + N(0,
0.1^2), so the check sees it (``"norm"``).  ``embed`` takes the
embedding's law, a leaf that holds one vector a layer (a norm's weight)
the norm's, and every other leaf the matrix's.

The result is the benchmark's own dict of tensors (``make``), which the
reference reads; ``to_program`` hands the same tensors, as views, to the
port's ``Transformer``.
"""

from __future__ import annotations

import math
from collections import defaultdict

import torch
from torch import nn

LAYERS = "layers"


def _layout(cfg) -> tuple:
    """(the port's module on the meta device, nothing allocated; {group:
    (shape, dtype)} of its leaves, a layer's leaf grouped over layers;
    {group: layers} for the layers' groups)."""
    from repro_torch.models import Transformer

    model = Transformer(cfg, "meta")
    groups, counts = {}, defaultdict(int)
    for name, p in model.named_parameters():
        parts = name.split(".")
        if parts[0] == LAYERS:
            key = ".".join(parts[2:])
            counts[key] += 1
        else:
            key = name
        groups[key] = (tuple(p.shape), p.dtype)
    return model, groups, counts


def _law(key: str, shape: tuple) -> str:
    """The law of a leaf of one layer's (or the model's) ``shape``."""
    if key == "embed":
        return "embed"
    return "norm" if len(shape) == 1 else "matrix"


@torch.no_grad()
def make(cfg, seed: int, device) -> dict:
    """{"embed", "final_norm", "lm_head": tensors, "layers": {key: (L,
    ...) tensor}} drawn from ``seed`` on ``device``."""
    _, groups, counts = _layout(cfg)
    gen = torch.Generator(device=device).manual_seed(seed % 2**63)
    out = {LAYERS: {}}
    for key in sorted(groups):
        shape, dtype = groups[key]
        kind = _law(key, shape)
        if key in counts:
            shape = (counts[key],) + shape
        t = torch.empty(shape, dtype=dtype, device=device)
        t.normal_(generator=gen)
        if kind == "norm":
            t.mul_(0.1).add_(1.0)
        elif kind == "embed":
            t.mul_(0.02)
        else:
            t.mul_(1.0 / math.sqrt(t.shape[-2]))
        if key in counts:
            out[LAYERS][key] = t
        else:
            out[key] = t
    return out


def to_program(cfg, weights: dict):
    """The port's ``Transformer`` whose parameters are the tensors of
    ``weights`` (views, no copy), without grad, as serving builds them."""
    model, groups, _ = _layout(cfg)
    for name, p in list(model.named_parameters()):
        parts = name.split(".")
        if parts[0] == LAYERS:
            t = weights[LAYERS][".".join(parts[2:])][int(parts[1])]
        else:
            t = weights[name]
        if tuple(t.shape) != tuple(p.shape) or t.dtype != p.dtype:
            raise ValueError(f"{name}: made {tuple(t.shape)} {t.dtype}, the "
                             f"model holds {tuple(p.shape)} {p.dtype}")
        owner, _, attr = name.rpartition(".")
        setattr(model.get_submodule(owner) if owner else model, attr,
                nn.Parameter(t, requires_grad=False))
    return model
