"""Carry the reference's weights and caches across, through numpy.

The reference keeps parameters as a nested dict whose ``layers`` and
``enc_layers`` subtrees are stacked on a leading layer axis; the port keeps
one module per layer.  Names map one to one:
``params["layers"]["attn"]["wq"][i]`` is ``Transformer.layers[i].attn.wq``,
``params["layers"]["moe"]["wi_gate"][i]`` is
``Transformer.layers[i].moe.wi_gate`` (``mamba``, ``rwkv``, ``cross`` and
``ln_cross`` alike), ``params["enc_layers"]["mlp"]["wo"][i]`` is
``Transformer.enc_layers[i].mlp.wo``, and the unstacked
``params["shared_attn"]["attn"]["wq"]`` is ``Transformer.shared_attn.attn.wq``
(``enc_norm`` and ``frontend_proj`` alike).
Sharded (DTensor) parameters and moments are gathered (``full_tensor``, a
collective every rank joins) on the way out, and a loaded leaf is placed
as its parameter is: a full array is cut locally to the parameter's
placements, and a DTensor (one per layer for a stacked leaf, as
``CheckpointManager.restore(shardings=)`` returns them) is redistributed
to them.
numpy has no bf16, so arrays arrive widened to f32 and are cast to each
parameter's dtype on the way in: the model's dtype, and f32 for the MoE
router, Mamba2's A_log, dt_bias and D and RWKV6's decay_w0 and bonus_u,
as in the reference.  ``params_to_numpy`` goes the other way (bf16
widened to f32, exactly), and ``opt_state_to_numpy`` /
``opt_state_from_numpy`` carry the AdamW state, whose moments mirror the
parameter tree.
"""

from __future__ import annotations

from typing import Callable, Dict, Mapping, Optional

import numpy as np
import torch
from torch import nn
from torch.distributed.tensor import DTensor, distribute_tensor

from . import resolve_device
from .config import ModelConfig
from .models.transformer import Transformer

# cache entries kept in f32 whatever the model's dtype
_F32_STATES = ("ssm", "wkv")
# subtrees stacked on a leading layer axis in the reference
_STACKED = ("layers", "enc_layers")


def _flatten(tree: Mapping, prefix: str = "") -> Dict[str, np.ndarray]:
    out: Dict[str, np.ndarray] = {}
    for key, val in tree.items():
        if isinstance(val, Mapping):
            out.update(_flatten(val, f"{prefix}{key}."))
        else:
            out[f"{prefix}{key}"] = val
    return out


def _tree_key(name: str):
    """A parameter name -> (its key in the flattened reference tree, its
    index on the stacked layer axis or None)."""
    parts = name.split(".")
    if parts[0] in _STACKED:
        return ".".join(parts[:1] + parts[2:]), int(parts[1])
    return name, None


def _from_tree(module: nn.Module, tree: Mapping,
               put: Callable[[str, torch.Tensor, np.ndarray], None]) -> None:
    """Call ``put(name, param, array)`` for each parameter of ``module``
    with its array in the reference-layout ``tree``.  Raises unless the
    names and shapes match exactly."""
    flat = _flatten(tree)
    seen = set()
    for name, param in module.named_parameters():
        key, layer = _tree_key(name)
        if key not in flat:
            raise KeyError(f"{key} missing from the numpy tree")
        arr = flat[key]
        if not isinstance(arr, (torch.Tensor, list)):
            arr = np.asarray(arr)
        if layer is not None:
            arr = arr[layer]
        if tuple(arr.shape) != tuple(param.shape):
            raise ValueError(f"{name}: numpy shape {arr.shape} != "
                             f"{tuple(param.shape)}")
        put(name, param, arr)
        seen.add(key)
    extra = set(flat) - seen
    if extra:
        raise KeyError(f"numpy tree has names the module lacks: "
                       f"{sorted(extra)}")


def _to_tree(module: nn.Module, value: Callable[[str, torch.Tensor],
                                                torch.Tensor]) -> Dict:
    """The reference-layout nested dict of ``value(name, param)`` for each
    parameter of ``module``, on its device: per-layer values stacked on a
    leading layer axis under ``layers`` and ``enc_layers`` (copies), the
    others as they are (the live tensors, detached)."""
    flat: Dict[str, list] = {}
    stacked = set()
    for name, param in module.named_parameters():
        key, layer = _tree_key(name)
        val = value(name, param).detach()
        if isinstance(val, DTensor):
            val = val.full_tensor()
        flat.setdefault(key, []).append(val)
        if layer is not None:
            stacked.add(key)
    tree: Dict = {}
    for key, vals in flat.items():
        *path, leaf = key.split(".")
        node = tree
        for part in path:
            node = node.setdefault(part, {})
        node[leaf] = torch.stack(vals) if key in stacked else vals[0]
    return tree


def to_numpy(t: torch.Tensor) -> np.ndarray:
    """A host copy of ``t``; bf16 (which numpy lacks) widened to f32,
    which holds every bf16 value exactly.  A DTensor is gathered first
    (every rank must call)."""
    if isinstance(t, DTensor):
        t = t.full_tensor()
    dtype = torch.float32 if t.dtype == torch.bfloat16 else t.dtype
    return t.detach().to("cpu", dtype, copy=True).numpy()


def _numpy(tree: Mapping) -> Dict:
    return {k: _numpy(v) if isinstance(v, Mapping) else to_numpy(v)
            for k, v in tree.items()}


def _placed(param: torch.Tensor, arr) -> torch.Tensor:
    """``arr`` (numpy, a full tensor or a DTensor) as ``param`` holds it:
    on its device, and for a DTensor parameter in its placements."""
    if not isinstance(arr, torch.Tensor):
        arr = torch.from_numpy(np.array(arr, np.float32))
    if not isinstance(param, DTensor):
        return arr.full_tensor() if isinstance(arr, DTensor) else arr
    if isinstance(arr, DTensor):
        return arr.redistribute(param.device_mesh, param.placements)
    return distribute_tensor(arr, param.device_mesh, param.placements,
                             src_data_rank=None)


@torch.no_grad()
def load_numpy_(module: nn.Module, tree: Mapping) -> nn.Module:
    """Copy a nested dict of numpy arrays into ``module``'s parameters, in
    place.  A ``layers`` (``enc_layers``) subtree is stacked on its
    leading axis and fills ``module.layers[i]`` (``enc_layers[i]``).
    A leaf may also be a tensor or DTensor, or for a stacked subtree a
    list of one per layer; each is placed as its parameter is (module
    docstring).  Raises unless the names and shapes match exactly."""
    _from_tree(module, tree, lambda name, param, arr: param.copy_(
        _placed(param, arr)))
    return module


def params_to_tree(module: nn.Module) -> Dict:
    """``module``'s parameters in the reference's layout, in their own
    dtypes and on their device (``layers`` stacked on a leading layer
    axis); leaves that are not stacked are the live parameters."""
    return _to_tree(module, lambda name, param: param)


def params_to_numpy(module: nn.Module) -> Dict:
    """The inverse of ``load_numpy_``: ``module``'s parameters as the
    reference's ``init_params`` pytree of numpy arrays, bf16 widened to
    f32."""
    return _numpy(params_to_tree(module))


def opt_state_to_tree(opt_state: Dict, params: nn.Module) -> Dict:
    """The port's AdamW state (moments keyed by parameter name) in the
    reference's ``adamw_init`` layout: ``{"m": tree, "v": tree, "count":
    int32}``, each moment tree shaped like the parameters' (as
    ``params_to_tree``)."""
    return {"m": _to_tree(params, lambda name, p: opt_state["m"][name]),
            "v": _to_tree(params, lambda name, p: opt_state["v"][name]),
            "count": opt_state["count"].detach()}


def opt_state_to_numpy(opt_state: Dict, params: nn.Module) -> Dict:
    """``opt_state_to_tree`` as numpy arrays (moments f32, count int32)."""
    return _numpy(opt_state_to_tree(opt_state, params))


@torch.no_grad()
def opt_state_from_numpy(tree: Mapping, params: nn.Module) -> Dict:
    """The reference's AdamW state (numpy) -> the port's, on the
    parameters' device: f32 moments keyed by parameter name, an int32
    count.  Leaves that are already tensors (DTensors placed by
    ``CheckpointManager.restore(shardings=)``) are kept, as f32."""
    def moments(sub: Mapping) -> Dict[str, torch.Tensor]:
        out: Dict[str, torch.Tensor] = {}

        def put(name, param, arr):
            if isinstance(arr, torch.Tensor):
                out[name] = arr.float()
            else:
                out[name] = torch.tensor(np.asarray(arr, np.float32),
                                         device=param.device)

        _from_tree(params, sub, put)
        return out

    count = tree["count"]
    if isinstance(count, torch.Tensor):
        count = count.to(torch.int32)
    else:
        device = next(params.parameters()).device
        count = torch.tensor(int(np.asarray(count)), dtype=torch.int32,
                             device=device)
    return {"m": moments(tree["m"]), "v": moments(tree["v"]),
            "count": count}


def params_from_numpy(tree: Mapping, cfg: ModelConfig, device=None,
                      dtype: Optional[torch.dtype] = None) -> Transformer:
    """The reference ``init_params`` pytree (as numpy arrays) -> the port's
    ``Transformer`` on ``device`` in ``dtype`` (default: ``cfg.dtype``)."""
    return load_numpy_(Transformer(cfg, device, dtype), tree)


def cache_from_numpy(tree: Mapping, device=None,
                     dtype: Optional[torch.dtype] = None) -> Dict:
    """The reference's cache, stacked on a leading layer (or invocation)
    axis -> the port's ``{"pos": int, "layers": [...], "shared": [...],
    "cross": [...]}`` of one nested dict per layer (``cross``: the static
    cross-attention ``{"k", "v"}`` of an encoder-decoder).  Tensors take ``dtype`` (default f32),
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
    for part in ("shared", "cross"):
        if part in tree:
            cache[part] = per_layer(tree[part])
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
    for part in ("shared", "cross"):
        if part in cache:
            out[part] = stack(cache[part])
    return out
