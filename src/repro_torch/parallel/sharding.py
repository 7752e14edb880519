"""Sharding rules: the port of ``repro.parallel.sharding``.  They map
params / batches / caches / optimizer state to the production mesh (DP x
TP (+EP/SP), hierarchical DP across pods) as DTensor placements.

Scheme (DESIGN.md section 5), the reference's:

* **DP**: batch over ``data`` (and ``pod`` when multi-pod).
* **TP** over ``model``: attention by flat Q heads; MLP column->row; vocab
  on the model axis for both embedding and LM head.
* **EP** over ``model`` for MoE expert banks when n_experts divides the
  axis; otherwise TP inside experts.
* **SP**: the train/prefill residual stream is sharded (dp, model, None)
  on (B, S, D).
* **Decode**: batch on ``data`` when divisible; KV caches sharded along
  the sequence dim on ``model`` (and on ``data`` too for batch=1); SSM/WKV
  states shard heads on ``model``.
* **ZeRO-1**: optimizer moments additionally shard their largest
  replicated dim over the DP axes.
* **FSDP**: leaves of at least 2^20 elements additionally shard their
  leading (stacked-layer / vocab) dim over dp.

Divisibility is always checked; a dim that does not divide its axis stays
replicated.

The rules come in two layers:

(a) **Specs**: tuples of axis names, one entry per dim (``None``, an axis,
    or a tuple of axes such as ``("pod", "data")``; a one-axis tuple is
    written as the axis, as ``PartitionSpec`` does).  They are computed
    exactly as the reference computes them, on the reference's tree names
    and shapes: nested dicts whose ``layers`` and ``enc_layers`` leaves
    are stacked on a leading layer axis (``transformer.param_shapes``,
    ``transformer.cache_shapes``).  They read only the mesh's axis names
    and sizes, so a shape-only stand-in with ``shape`` (a dict) and
    ``axis_names`` serves as well as a ``DeviceMesh``.
(b) **Placements**: a spec becomes one DTensor placement per mesh dim
    (``Shard(d)`` where the spec puts that axis on dim d, else
    ``Replicate()``).  An entry with several axes shards its dim on each
    of them in the mesh's order, major to minor, which is the reference's
    order.  The port keeps one module per layer, so a stacked leaf's
    leading layer entry has no counterpart: where the reference puts dp
    there (FSDP, or ZeRO-1 on the layer dim), the port shards the layer's
    leaf over dp on its **first free dim that dp divides** instead.  Each
    rank then holds the same number of bytes of every reference leaf as a
    reference device does.  Under ``constrain(x, "params")`` a block's
    leaves are gathered back over dp before use (each layer's slice
    gathered on demand, inside the recomputed region).

``constrain(x, kind)`` is the model's ``sc`` hook: a DTensor is
redistributed to the kind's placements (``residual``, ``logits``,
``heads``, ``moe_buf``, as the reference's ``with_sharding_constraint``);
a plain tensor goes through unchanged.  One kind is the port's own:
``block_in``, a block's normed input with the residual's sequence split
gathered (split by batch only), the all-gather that XLA's partitioner
inserts before a sequence-parallel block's projections; the model asks
for it where a block reads the whole sequence (projections, token
shifts, convolutions, the LM head).
"""

from __future__ import annotations

from types import SimpleNamespace
from typing import (Any, Dict, List, Mapping, NamedTuple, Optional, Sequence,
                    Tuple)

import numpy as np
import torch
from torch import nn
from torch.distributed.tensor import (DTensor, Replicate, Shard,
                                      distribute_tensor)
from torch.distributed.tensor._utils import \
    compute_local_shape_and_global_offset

from ..config import ModelConfig, ShapeSpec

Spec = Tuple[Any, ...]
# subtrees stacked on a leading layer axis in the reference
_STACKED = ("layers", "enc_layers")


def _mesh_shape(mesh) -> Dict[str, int]:
    """Axis name -> size, for a ``DeviceMesh`` or a shape-only stand-in."""
    names = getattr(mesh, "mesh_dim_names", None)
    if names is not None:
        return dict(zip(names, mesh.shape))
    return dict(mesh.shape)


def _axis_size(shape: Mapping[str, int], axis) -> int:
    if axis is None:
        return 1
    if isinstance(axis, tuple):
        out = 1
        for a in axis:
            out *= shape[a]
        return out
    return shape[axis]


def _entry(axis):
    """A spec entry as ``PartitionSpec`` keeps it: a one-axis tuple is the
    axis."""
    if isinstance(axis, tuple) and len(axis) == 1:
        return axis[0]
    return axis


def _shape_of(leaf) -> Tuple[int, ...]:
    return tuple(leaf.shape) if hasattr(leaf, "shape") else tuple(leaf)


def _is_leaf(v) -> bool:
    return not isinstance(v, Mapping)


def _map_with_path(fn, tree: Mapping, path: Tuple[str, ...] = ()) -> Dict:
    return {k: (fn(path + (k,), v) if _is_leaf(v)
                else _map_with_path(fn, v, path + (k,)))
            for k, v in tree.items()}


def _zip_map(fn, a: Mapping, b: Mapping) -> Dict:
    return {k: (fn(a[k], b[k]) if _is_leaf(a[k]) else _zip_map(fn, a[k], b[k]))
            for k in a}


class LeafSharding(NamedTuple):
    """Where one leaf of a reference-layout state tree goes: its mesh and
    placements, which for a ``stacked`` leaf (``layers`` / ``enc_layers``)
    are those of each layer's leaf."""
    mesh: Any
    placements: List
    stacked: bool = False

    def place(self, arr: np.ndarray):
        """The full array (the same on every rank) as a DTensor, or for a
        stacked leaf one DTensor per layer; each rank keeps its part."""
        t = torch.from_numpy(np.ascontiguousarray(arr))
        if self.stacked:
            return [distribute_tensor(t[i], self.mesh, self.placements,
                                      src_data_rank=None)
                    for i in range(t.shape[0])]
        return distribute_tensor(t, self.mesh, self.placements,
                                 src_data_rank=None)


class ShardingRules:
    def __init__(self, cfg: ModelConfig, mesh,
                 shape: Optional[ShapeSpec] = None,
                 fsdp: bool = True) -> None:
        self.cfg = cfg
        self.mesh = mesh
        self.shape = shape
        self.mesh_shape = _mesh_shape(mesh)
        self.axis_names: Tuple[str, ...] = tuple(self.mesh_shape)
        self.multi_pod = "pod" in self.axis_names
        self.dp: Tuple[str, ...] = (("pod", "data") if self.multi_pod
                                    else ("data",))
        self.tp: Optional[str] = "model"
        self.dp_size = _axis_size(self.mesh_shape, self.dp)
        self.tp_size = _axis_size(self.mesh_shape, self.tp)
        # FSDP: additionally shard large weights over the data axes
        self.fsdp = fsdp
        self.fsdp_min_elems = 1 << 20
        # dp-only policy: when the per-shard model width would fall under
        # 128, for TRAIN shapes with batch divisible by the whole mesh, fold
        # the model axis into data parallelism (params FSDP-sharded)
        if (shape is not None and shape.kind == "train"
                and cfg.d_model // max(self.tp_size, 1) < 128
                and shape.global_batch % (self.dp_size * self.tp_size) == 0):
            self.dp = tuple(self.dp) + (self.tp,)
            self.dp_size *= self.tp_size
            self.tp = None
            self.tp_size = 1

    # -- helpers -------------------------------------------------------------
    def _size(self, axis) -> int:
        return _axis_size(self.mesh_shape, axis)

    def _maybe(self, dim: int, axis):
        """axis if dim divides its total size, else None (replicated)."""
        return axis if dim % self._size(axis) == 0 else None

    def _batch_axis(self, b: int):
        return self.dp if b % self.dp_size == 0 else None

    @staticmethod
    def _spec(entries: Sequence) -> Spec:
        return tuple(_entry(e) for e in entries)

    # -- (a) specs: parameters -------------------------------------------------
    def _param_spec(self, path: Tuple[str, ...], shape: Tuple[int, ...]
                    ) -> Spec:
        name = path[-1]
        parent = path[-2] if len(path) >= 2 else ""
        tp = self.tp
        nd = len(shape)

        def spec_from(last_dims: Dict[int, Any]) -> Spec:
            entries = [None] * nd
            for rel, axis in last_dims.items():
                if axis is not None and shape[nd + rel] % self._size(
                        axis) == 0:
                    entries[nd + rel] = axis
            return self._spec(entries)

        replicated = (None,) * nd
        if name == "embed":
            return spec_from({-2: tp})            # vocab-sharded
        if name == "lm_head":
            return spec_from({-1: tp})
        if name == "frontend_proj":
            return spec_from({-1: tp})
        if parent in ("attn", "cross"):
            heads_ok = self.cfg.n_heads % self.tp_size == 0
            kv_ok = self.cfg.n_kv_heads % self.tp_size == 0
            if name == "wq":
                return spec_from({-1: tp} if heads_ok else {})
            if name in ("wk", "wv"):
                return spec_from({-1: tp} if kv_ok else {})
            if name == "wo":
                return spec_from({-2: tp} if heads_ok else {})
            return replicated                     # q_norm / k_norm
        if parent == "mlp":
            if name in ("wi_gate", "wi_up"):
                return spec_from({-1: tp})
            if name == "wo":
                return spec_from({-2: tp})
        if parent == "moe":
            if name == "router":
                return replicated
            if self.cfg.n_experts % self.tp_size == 0:
                return spec_from({-3: tp})        # expert-parallel bank
            if name in ("wi_gate", "wi_up"):
                return spec_from({-1: tp})
            return spec_from({-2: tp})
        if parent == "mamba":
            if name in ("w_z", "w_x"):
                return spec_from({-1: tp})
            if name in ("conv_x_w", "conv_x_b", "norm_w"):
                return spec_from({-1: tp})
            if name == "out_proj":
                return spec_from({-2: tp})
            return replicated
        if parent == "rwkv":
            if name in ("w_r", "w_k", "w_v", "w_g", "c_k"):
                return spec_from({-1: tp})
            if name in ("w_o", "c_v"):
                return spec_from({-2: tp})
            return replicated
        return replicated                         # norms, scalars, misc

    def _apply_fsdp(self, spec: Spec, shape: Tuple[int, ...]) -> Spec:
        """Shard the LEADING (stacked-layer / vocab) dim over dp, never an
        inner one."""
        size = 1
        for d in shape:
            size *= d
        if size < self.fsdp_min_elems or not shape:
            return spec
        entries = list(spec) + [None] * (len(shape) - len(spec))
        dp_axis = self.dp if self.multi_pod else self.dp[0]
        if entries[0] is None and shape[0] % self.dp_size == 0 \
                and shape[0] > 1:
            entries[0] = dp_axis
            return self._spec(entries)
        return spec

    def param_specs(self, params_tree: Mapping) -> Dict:
        """Nested dict of specs for a reference-layout tree of leaves with
        ``shape`` (or shape tuples)."""
        def f(path, leaf):
            shape = _shape_of(leaf)
            spec = self._param_spec(path, shape)
            if self.fsdp:
                spec = self._apply_fsdp(spec, shape)
            return spec
        return _map_with_path(f, params_tree)

    # -- (a) specs: optimizer state (ZeRO-1) -----------------------------------
    def zero1_spec(self, spec: Spec, shape: Tuple[int, ...]) -> Spec:
        entries = list(spec) + [None] * (len(shape) - len(spec))
        used = set()
        for e in entries:
            for a in (e if isinstance(e, tuple) else (e,)):
                if a is not None:
                    used.add(a)
        if any(a in used for a in self.dp):
            return self._spec(entries)   # FSDP already shards over dp
        for i, (e, d) in enumerate(zip(entries, shape)):
            if e is None and d % self.dp_size == 0 and d > 1:
                entries[i] = self.dp if self.multi_pod else self.dp[0]
                break
        return self._spec(entries)

    def opt_specs(self, params_tree: Mapping, zero1: bool = True) -> Dict:
        pspecs = self.param_specs(params_tree)
        return _zip_map(
            lambda spec, leaf: (self.zero1_spec(spec, _shape_of(leaf))
                                if zero1 else spec), pspecs, params_tree)

    # -- (a) specs: batches and caches -----------------------------------------
    def batch_specs(self, batch_tree: Mapping) -> Dict:
        def f(path, leaf):
            shape = _shape_of(leaf)
            return self._spec([self._batch_axis(shape[0])]
                              + [None] * (len(shape) - 1))
        return _map_with_path(f, batch_tree)

    def cache_specs(self, cache_tree: Mapping, batch: int) -> Dict:
        """Decode-cache specs.  Leaves are (L, B, ...) stacked buffers, as
        ``transformer.cache_shapes`` gives them."""
        b_axis = self._batch_axis(batch)

        def f(path, leaf):
            shape = _shape_of(leaf)
            nd = len(shape)
            if nd == 0:                       # pos scalar
                return ()
            name = path[-1]
            entries: list = [None] * nd
            if name in ("k", "v") and nd == 5:
                # (L, B, T, kv, dh): batch on dp; seq on model (+dp if b=1)
                entries[1] = b_axis
                seq_axes = (self.tp if b_axis is not None
                            else (tuple(self.dp) + (self.tp,)))
                entries[2] = self._maybe(shape[2], seq_axes)
            elif name == "ssm" and nd == 5:    # (L,B,H,P,N)
                entries[1] = b_axis
                entries[2] = self._maybe(shape[2], self.tp)
            elif name == "wkv" and nd == 5:    # (L,B,H,P,P)
                entries[1] = b_axis
                entries[2] = self._maybe(shape[2], self.tp)
            elif nd >= 2:                      # shifts, conv states, misc
                entries[1] = b_axis
                if name == "x" and nd == 4:    # mamba conv state (L,B,K,di)
                    entries[3] = self._maybe(shape[3], self.tp)
            return self._spec(entries)
        return _map_with_path(f, cache_tree)

    # -- (a) specs: activations --------------------------------------------------
    def activation_spec(self, shape: Tuple[int, ...], kind: str
                        ) -> Optional[Spec]:
        """The spec ``constrain`` pins an activation of ``shape`` to, or
        None where the reference leaves it alone."""
        nd = len(shape)
        if kind == "residual":
            if nd != 3:
                return None
            b, s, _ = shape
            s_axis = self._maybe(s, self.tp) if s > 1 else None
            return self._spec([self._batch_axis(b), s_axis, None])
        if kind == "block_in":
            if nd != 3:
                return None
            return self._spec([self._batch_axis(shape[0]), None, None])
        if kind == "logits":
            return self._spec([self._batch_axis(shape[0])]
                              + [None] * (nd - 2)
                              + [self._maybe(shape[-1], self.tp)])
        if kind == "heads":
            # q/k/v in flat-head layout (B, S, H, D): heads on model
            if nd != 4:
                return None
            return self._spec([self._batch_axis(shape[0]), None,
                               self._maybe(shape[2], self.tp), None])
        if kind == "moe_buf":
            # (B, E, C, D) grouped expert capacity buffer: groups on dp,
            # experts on model (EP) when E divides the axis, else TP on D
            if nd != 4:
                return None
            b_axis = self._batch_axis(shape[0])
            if shape[1] % self.tp_size == 0:
                return self._spec([b_axis, self.tp, None, None])
            return self._spec([b_axis, None, None,
                               self._maybe(shape[3], self.tp)])
        return None

    # -- (b) placements ----------------------------------------------------------
    def placements(self, spec: Spec) -> List:
        """One placement per mesh dim: ``Shard(d)`` where the spec puts
        that axis on dim d, else ``Replicate()``."""
        out: List = [Replicate()] * len(self.axis_names)
        for d, entry in enumerate(spec):
            if entry is None:
                continue
            axes = entry if isinstance(entry, tuple) else (entry,)
            idx = [self.axis_names.index(a) for a in axes]
            if idx != sorted(idx):
                raise NotImplementedError(
                    f"spec entry {entry} is not in the mesh's axis order "
                    f"{self.axis_names}")
            for i in idx:
                if out[i] != Replicate():
                    raise ValueError(f"axis {self.axis_names[i]} used twice "
                                     f"in {spec}")
                out[i] = Shard(d)
        return out

    def _move_lead(self, spec: Spec, shape: Tuple[int, ...]) -> Spec:
        """A stacked leaf's spec -> the spec of one layer's leaf (shape
        ``shape``, the stacked shape without its layer dim): the layer
        entry, when there is one, goes to the first free dim it divides."""
        lead, rest = spec[0], list(spec[1:])
        if lead is not None:
            for i, d in enumerate(shape):
                if rest[i] is None and d > 1 and d % self._size(lead) == 0:
                    rest[i] = lead
                    break
        return self._spec(rest)

    def leaf_specs(self, module: nn.Module, zero1: bool = False
                   ) -> Dict[str, Spec]:
        """The spec of each of ``module``'s parameters, by parameter name:
        the reference's spec of its leaf (``opt_specs`` with ``zero1``),
        the stacked layer entry moved as the module docstring says."""
        from ..models.transformer import param_shapes
        tree = param_shapes(module)
        specs = _flatten(self.opt_specs(tree, zero1))
        out = {}
        for name, p in module.named_parameters():
            parts = name.split(".")
            if parts[0] in _STACKED:
                key = ".".join(parts[:1] + parts[2:])
                out[name] = self._move_lead(specs[key], tuple(p.shape))
            else:
                out[name] = specs[name]
        return out

    def param_placements(self, module: nn.Module) -> Dict[str, List]:
        return {n: self.placements(s)
                for n, s in self.leaf_specs(module).items()}

    def opt_placements(self, module: nn.Module, zero1: bool = True
                       ) -> Dict[str, List]:
        return {n: self.placements(s)
                for n, s in self.leaf_specs(module, zero1).items()}

    # -- (b) placing tensors -------------------------------------------------------
    def distribute(self, t: torch.Tensor, placements) -> DTensor:
        """``t`` (the full value, the same on every rank) as a DTensor with
        ``placements``: each rank keeps its own part, no communication."""
        return distribute_tensor(t, self.mesh, placements, src_data_rank=None)

    @torch.no_grad()
    def distribute_params(self, module: nn.Module) -> nn.Module:
        """Replace each parameter of ``module`` (full, the same on every
        rank) by its DTensor under ``param_placements``, in place."""
        placements = self.param_placements(module)
        for mname, mod in module.named_modules():
            for pname, p in list(mod.named_parameters(recurse=False)):
                name = f"{mname}.{pname}" if mname else pname
                d = self.distribute(p.detach(), placements[name])
                setattr(mod, pname, nn.Parameter(d, p.requires_grad))
        return module

    @torch.no_grad()
    def distribute_opt(self, opt_state: Dict, module: nn.Module,
                       zero1: bool = True) -> Dict:
        """The AdamW state's moments (full) as DTensors under
        ``opt_placements`` (ZeRO-1); the count replicated."""
        placements = self.opt_placements(module, zero1)

        def place(moments):
            return {n: self.distribute(t, placements[n])
                    for n, t in moments.items()}
        count = opt_state["count"]
        if not isinstance(count, DTensor):
            count = self.distribute(count, [Replicate()] * len(
                self.axis_names))
        return {"m": place(opt_state["m"]), "v": place(opt_state["v"]),
                "count": count}

    def shard_batch(self, batch: Mapping[str, torch.Tensor]) -> Dict:
        """A global batch (the same on every rank) as DTensors under
        ``batch_specs``."""
        specs = self.batch_specs(batch)
        return {k: v if isinstance(v, DTensor)
                else self.distribute(v, self.placements(specs[k]))
                for k, v in batch.items()}

    def param_shardings(self, module: nn.Module) -> Dict:
        """Reference-layout tree of ``LeafSharding`` for ``module``'s
        parameters, for ``CheckpointManager.restore(shardings=)``: a
        stacked leaf is placed layer by layer, as ``convert.load_numpy_``
        reads it."""
        return _state_tree(module, self.param_placements(module), self.mesh)

    def opt_shardings(self, module: nn.Module, zero1: bool = True) -> Dict:
        """The AdamW state's ``LeafSharding`` tree (ZeRO-1 moments)."""
        pl = _state_tree(module, self.opt_placements(module, zero1),
                         self.mesh)
        rep = LeafSharding(self.mesh, [Replicate()] * len(self.axis_names))
        return {"m": pl, "v": pl, "count": rep}

    # -- the model's hook ----------------------------------------------------------
    def _gathered(self, p: torch.Tensor) -> torch.Tensor:
        """A parameter with its dp axes gathered (FSDP / ZeRO slices
        reassembled); its model placement kept."""
        if not isinstance(p, DTensor):
            return p
        keep = [Replicate() if self.axis_names[i] in self._dp_axes()
                else pl for i, pl in enumerate(p.placements)]
        if list(p.placements) == keep:
            return p
        return p.redistribute(self.mesh, keep)

    def _dp_axes(self) -> Tuple[str, ...]:
        return tuple(a for a in self.dp if a is not None)

    def _gather_module(self, module: nn.Module) -> SimpleNamespace:
        ns = SimpleNamespace()
        for name, p in module.named_parameters(recurse=False):
            setattr(ns, name, self._gathered(p))
        for name, child in module.named_children():
            setattr(ns, name, self._gather_module(child))
        return ns

    def _zeros(self, leaf, placements, device) -> DTensor:
        """Zeros of ``leaf``'s shape and dtype as a DTensor under
        ``placements``, each rank allocating only its own shard on
        ``device``."""
        shape = torch.Size(leaf.shape)
        local_shape, _ = compute_local_shape_and_global_offset(
            shape, self.mesh, placements)
        local = torch.zeros(local_shape, dtype=leaf.dtype, device=device)
        stride = [1] * len(shape)          # the whole tensor's, contiguous
        for d in range(len(shape) - 2, -1, -1):
            stride[d] = stride[d + 1] * shape[d + 1]
        return DTensor.from_local(local, self.mesh, placements,
                                  run_check=False, shape=shape,
                                  stride=tuple(stride))

    def place_cache(self, cache: Dict, device) -> Dict:
        """A zeroed cache laid out as ``cache`` (``transformer.init_cache``'s
        structure: one dict a layer, invocation or cross-attention; its
        leaves give only shapes and dtypes: ``transformer.cache_layout``)
        as DTensors under ``cache_specs``, each layer's leaf taking its
        stacked spec without the layer entry.  Each rank allocates only its
        own shards, on ``device``."""
        def stack(items):
            return {k: stack([it[k] for it in items]) if isinstance(v, dict)
                    else (len(items),) + tuple(v.shape)
                    for k, v in items[0].items()}

        def place(items, specs):
            return [{k: place([v], specs[k])[0] if isinstance(v, dict)
                     else self._zeros(v, self.placements(specs[k][1:]),
                                      device)
                     for k, v in it.items()} for it in items]

        parts = [p for p in ("layers", "shared", "cross") if p in cache]
        first = cache["layers"][0]
        while isinstance(first, dict):
            first = next(iter(first.values()))
        specs = self.cache_specs({p: stack(cache[p]) for p in parts},
                                 batch=first.shape[0])
        return {"pos": cache["pos"],
                **{p: place(cache[p], specs[p]) for p in parts}}

    def constrain(self, x, kind: str = "residual"):
        """Pin an activation to the mesh (called by the model).  A plain
        tensor is returned as it is.  ``kind="params"`` takes a module (or
        one parameter) and returns it with its leaves gathered over dp;
        ``kind="cache"`` takes a pair (a cache of shapes, the device) and
        returns it zeroed and placed (``place_cache``)."""
        if kind == "params":
            if isinstance(x, nn.Module):
                return self._gather_module(x)
            return self._gathered(x)
        if kind == "cache":
            return self.place_cache(*x)
        if not isinstance(x, DTensor):
            return x
        spec = self.activation_spec(tuple(x.shape), kind)
        if spec is None:
            return x
        placements = self.placements(spec)
        if list(x.placements) == placements:
            return x
        return x.redistribute(self.mesh, placements)


def _flatten(tree: Mapping, prefix: str = "") -> Dict[str, Any]:
    out: Dict[str, Any] = {}
    for key, val in tree.items():
        if isinstance(val, Mapping):
            out.update(_flatten(val, f"{prefix}{key}."))
        else:
            out[f"{prefix}{key}"] = val
    return out


def _state_tree(module: nn.Module, placements: Dict[str, List], mesh
                ) -> Dict:
    tree: Dict = {}
    for name, _ in module.named_parameters():
        parts = name.split(".")
        stacked = parts[0] in _STACKED
        if stacked:
            parts = parts[:1] + parts[2:]
        node = tree
        for part in parts[:-1]:
            node = node.setdefault(part, {})
        node[parts[-1]] = LeafSharding(mesh, placements[name], stacked)
    return tree
