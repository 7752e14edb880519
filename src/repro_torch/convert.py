"""Carry the reference's weights and caches across, through numpy.

The reference keeps parameters as a nested dict whose ``layers`` subtree
is stacked on a leading layer axis; the port keeps one module per layer.
Names map one to one: ``params["layers"]["attn"]["wq"][i]`` is
``Transformer.layers[i].attn.wq``, ``params["layers"]["moe"]["wi_gate"][i]``
is ``Transformer.layers[i].moe.wi_gate`` (``mamba`` and ``rwkv`` alike),
and the unstacked
``params["shared_attn"]["attn"]["wq"]`` is ``Transformer.shared_attn.attn.wq``.
numpy has no bf16, so arrays arrive widened to f32 and are cast to each
parameter's dtype on the way in: the model's dtype, and f32 for the MoE
router, Mamba2's A_log, dt_bias and D and RWKV6's decay_w0 and bonus_u,
as in the reference.
"""

from __future__ import annotations

from typing import Dict, Mapping, Optional

import numpy as np
import torch
from torch import nn

from . import resolve_device
from .config import ModelConfig
from .models.transformer import Transformer

# cache entries kept in f32 whatever the model's dtype
_F32_STATES = ("ssm", "wkv")


def _flatten(tree: Mapping, prefix: str = "") -> Dict[str, np.ndarray]:
    out: Dict[str, np.ndarray] = {}
    for key, val in tree.items():
        if isinstance(val, Mapping):
            out.update(_flatten(val, f"{prefix}{key}."))
        else:
            out[f"{prefix}{key}"] = val
    return out


@torch.no_grad()
def load_numpy_(module: nn.Module, tree: Mapping) -> nn.Module:
    """Copy a nested dict of numpy arrays into ``module``'s parameters, in
    place.  A ``layers`` subtree is stacked on its leading axis and fills
    ``module.layers[i]``.  Raises unless the names and shapes match
    exactly."""
    flat = _flatten(tree)
    seen = set()
    for name, param in module.named_parameters():
        parts = name.split(".")
        if parts[0] == "layers":
            key = ".".join(["layers"] + parts[2:])
            if key not in flat:
                raise KeyError(f"{key} missing from the numpy tree")
            arr = np.asarray(flat[key])[int(parts[1])]
        else:
            key = name
            if key not in flat:
                raise KeyError(f"{key} missing from the numpy tree")
            arr = np.asarray(flat[key])
        if tuple(arr.shape) != tuple(param.shape):
            raise ValueError(f"{name}: numpy shape {arr.shape} != "
                             f"{tuple(param.shape)}")
        param.copy_(torch.from_numpy(np.array(arr, np.float32)))
        seen.add(key)
    extra = set(flat) - seen
    if extra:
        raise KeyError(f"numpy tree has names the module lacks: "
                       f"{sorted(extra)}")
    return module


def params_from_numpy(tree: Mapping, cfg: ModelConfig, device=None,
                      dtype: Optional[torch.dtype] = None) -> Transformer:
    """The reference ``init_params`` pytree (as numpy arrays) -> the port's
    ``Transformer`` on ``device`` in ``dtype`` (default: ``cfg.dtype``)."""
    return load_numpy_(Transformer(cfg, device, dtype), tree)


def cache_from_numpy(tree: Mapping, device=None,
                     dtype: Optional[torch.dtype] = None) -> Dict:
    """The reference's cache, stacked on a leading layer (or invocation)
    axis -> the port's ``{"pos": int, "layers": [...], "shared": [...]}``
    of one nested dict per layer.  Tensors take ``dtype`` (default f32),
    except the recurrent states (Mamba2's ``ssm``, RWKV6's ``wkv``), which
    are f32 in both packages."""
    device = resolve_device(device)

    def put(name, a):
        dt = (torch.float32 if name in _F32_STATES
              else (dtype or torch.float32))
        return torch.tensor(np.asarray(a, np.float32), device=device,
                            dtype=dt)

    def unstack(sub: Mapping, i: int) -> Dict:
        return {name: unstack(val, i) if isinstance(val, Mapping)
                else put(name, np.asarray(val)[i])
                for name, val in sub.items()}

    def per_layer(sub: Mapping):
        n = len(next(iter(_flatten(sub).values())))
        return [unstack(sub, i) for i in range(n)]

    cache = {"pos": int(tree["pos"]), "layers": per_layer(tree["layers"])}
    if "shared" in tree:
        cache["shared"] = per_layer(tree["shared"])
    return cache


def cache_to_numpy(cache: Dict) -> Dict:
    """The port's cache -> the reference's layout, as f32 numpy arrays."""
    def stack(items):
        return {name: stack([it[name] for it in items])
                if isinstance(val, Mapping)
                else np.stack([it[name].detach().float().cpu().numpy()
                               for it in items])
                for name, val in items[0].items()}

    out = {"pos": np.int32(cache["pos"]), "layers": stack(cache["layers"])}
    if "shared" in cache:
        out["shared"] = stack(cache["shared"])
    return out
