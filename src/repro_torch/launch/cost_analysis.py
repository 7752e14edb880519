"""Per-device cost of one rank's program: the port's counterpart of
``repro.launch.hlo_analysis``.

The reference compiles each cell and walks the post-SPMD HLO, which is
the per-device program.  The port runs eagerly, so ``CostCounter`` is a
``TorchDispatchMode`` that sees one rank's program op by op as it runs
(rank 0 of the dry run's fake process group, on meta tensors, or a real
step on the card).  A DTensor op is handed back to DTensor (the mode
returns ``NotImplemented``), which runs it on the rank's local shards and
redistributes them; those local ops and collectives come back to the
mode, so everything it counts is **local**: what this rank computes and
holds.  (``torch.utils.flop_counter.FlopCounterMode`` around DTensor
counts global shapes instead.)  The shape propagation DTensor runs on fake
tensors is not counted.

What each figure is, against the reference's:

* ``flops``: each aten op by ``FlopCounterMode``'s formulas (matmuls,
  convolutions, attention; elementwise ops count zero, where the HLO
  walker counts one an output element), and each kernel op
  (``repro_torch::flash_fwd``, ``gmm``, ``ssd``, ``wkv``) by its own
  ``work()``, registered as its FLOP formula.
* ``bytes``: each op's tensor inputs and outputs read and written once, at
  op granularity, which is what the eager program moves (the walker counts
  at XLA-fusion granularity, so fused elementwise chains count once
  there).  Views and allocations move nothing; a kernel op counts its
  ``work()`` bytes; collectives count under ``collectives`` instead.
* ``collectives``: functional (``_c10d_functional``) and in-place
  (``c10d``) collectives by kind, count and bytes, the bytes of each
  result (the gathered tensor of an all-gather, the reduced one of an
  all-reduce, the local part of a reduce-scatter: the walker's
  result-shape convention), also by the mesh dims (or ``world``) whose
  group they run over.  On a ``cpu`` mesh DTensor replaces the all-to-all
  of a Shard -> Shard redistribution by an all-gather and a chunk; that
  all-gather is counted as the all-to-all a ``cuda`` mesh runs.
* ``memory``: the peak of live storage bytes as the ops run, each storage
  counted from the op that allocates it until its last reference dies
  (meta storages have no allocator: tracked by weak references), split as
  the reference's record is: ``argument_bytes`` (storages alive when the
  step starts), ``output_bytes`` (storages the step made that are alive
  when it ends), ``temp_bytes`` (the peak less the arguments) and
  ``peak_bytes``.  A kernel's own scratch copies inside its launch are
  not seen.
"""

from __future__ import annotations

import sys
import weakref
from typing import Any, Dict, Iterable, Optional

import torch
import torch.distributed as dist
from torch import nn
from torch._subclasses.fake_tensor import FakeTensor
from torch.distributed.distributed_c10d import _resolve_process_group
from torch.distributed.tensor import DTensor
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten
from torch.utils.flop_counter import flop_registry

from ..config import H100
from ..kernels.flash_attention import ops as _fa
from ..kernels.mamba2_ssd import ops as _sd
from ..kernels.moe_gmm import ops as _gm
from ..kernels.rwkv6_wkv import ops as _wk

KERNEL_WORK = {
    "repro_torch::flash_fwd": _fa.op_work,
    "repro_torch::gmm": _gm.op_work,
    "repro_torch::ssd": _sd.op_work,
    "repro_torch::wkv": _wk.op_work,
}

# collective kinds, as the reference names them, by op-name fragment
_KINDS = (("all_gather", "all-gather"), ("allgather", "all-gather"),
          ("reduce_scatter", "reduce-scatter"),
          ("all_reduce", "all-reduce"), ("allreduce", "all-reduce"),
          ("all_to_all", "all-to-all"), ("alltoall", "all-to-all"),
          ("broadcast", "broadcast"))
_COLLECTIVE_NS = ("_c10d_functional", "c10d")
# ops that allocate without writing, or only wrap
_FREE = {"aten::empty", "aten::empty_strided", "aten::empty_like",
         "aten::new_empty", "aten::new_empty_strided", "aten::lift_fresh",
         "_c10d_functional::wait_tensor",
         "_c10d_functional::_wrap_tensor_autograd"}


def _tensors(tree) -> list:
    return [t for t in tree_flatten(tree)[0] if isinstance(t, torch.Tensor)]


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _is_view(func) -> bool:
    return any(r.alias_info is not None and not r.alias_info.is_write
               for r in func._schema.returns)


def _collective_kind(name: str) -> Optional[str]:
    for frag, kind in _KINDS:
        if frag in name:
            return kind
    return None


def _group_name(args) -> Optional[str]:
    """The group a collective runs over: its ``group_name`` (functional)
    or its ProcessGroup (in-place c10d)."""
    for a in reversed(args):
        if isinstance(a, str):
            return a
        if isinstance(a, torch.ScriptObject):
            try:
                return dist.ProcessGroup.unbox(a).group_name
            except (RuntimeError, TypeError, AttributeError):
                continue
    return None


def _in_cpu_alltoall() -> bool:
    """Whether DTensor's ``shard_dim_alltoall`` is on the stack: on a
    ``cpu`` mesh (the dry run's fake group) it gathers and chunks where a
    ``cuda`` mesh runs one all-to-all."""
    f = sys._getframe(2)
    for _ in range(12):
        if f is None:
            return False
        if f.f_code.co_name == "shard_dim_alltoall":
            return True
        f = f.f_back
    return False


def local_tensors(*trees) -> Iterable[torch.Tensor]:
    """Every tensor in ``trees`` (dicts, lists, tuples, modules), each
    DTensor as its local shard."""
    for tree in trees:
        if isinstance(tree, nn.Module):
            tree = [p for p in tree.parameters()]
        if isinstance(tree, dict):
            tree = list(tree.values())
        if isinstance(tree, (list, tuple)):
            yield from local_tensors(*tree)
        elif isinstance(tree, DTensor):
            yield tree.to_local()
        elif isinstance(tree, torch.Tensor):
            yield tree


class CostCounter(TorchDispatchMode):
    """Counts one rank's FLOPs, bytes, collectives and live storage while
    active (module docstring).  ``mesh`` names the collectives' groups by
    its dims; a group whose ranks all sit in one node of the H100's
    ``gpus_per_node`` runs over NVLink, any other over the network."""

    def __init__(self, mesh=None) -> None:
        super().__init__()
        self.flops = 0
        self.bytes = 0
        self.collectives: Dict[str, Dict[str, int]] = {}
        self.by_dim: Dict[str, Dict[str, Dict[str, int]]] = {}
        self.kernels: Dict[str, Dict[str, int]] = {}
        self.mesh = mesh
        self._dims: Dict[str, str] = {}
        self.links: Dict[str, str] = {}
        self._live: Dict[int, Any] = {}
        self._created: set = set()
        self.live_bytes = 0
        self.peak_bytes = 0
        self.argument_bytes = 0

    # -- groups ------------------------------------------------------------
    def _label(self, group_name: Optional[str]) -> str:
        """The mesh dims a group spans (``data``, ``data+model``, ...), or
        ``world``; its link is recorded in ``links``."""
        if group_name in self._dims:
            return self._dims[group_name]
        if group_name is None:
            return "unknown group"
        group = _resolve_process_group(group_name)
        ranks = sorted(dist.get_process_group_ranks(group))
        label = f"group of {len(ranks)}"
        if len(ranks) == dist.get_world_size():
            label = "world"
        elif self.mesh is not None:
            grid = self.mesh.mesh
            names = self.mesh.mesh_dim_names or [
                str(i) for i in range(grid.dim())]
            coords = [(grid == r).nonzero()[0].tolist() for r in ranks]
            varying = [names[d] for d in range(grid.dim())
                       if len({c[d] for c in coords}) > 1]
            if varying:
                label = "+".join(varying)
        nodes = {r // H100.gpus_per_node for r in ranks}
        self._dims[group_name] = label
        self.links[label] = "nvlink" if len(nodes) == 1 else "network"
        return label

    def link_bw(self, label: str) -> float:
        return (H100.nvlink_bw if self.links.get(label) == "nvlink"
                else H100.network_bw)

    # -- memory ------------------------------------------------------------
    def _track(self, t: torch.Tensor, created: bool) -> None:
        if isinstance(t, FakeTensor) or t.is_sparse:
            return
        st = t.untyped_storage()
        key = id(st)
        if key in self._live:
            return
        n = st.nbytes()

        def free(_ref, key=key, n=n):
            self._live.pop(key, None)
            self._created.discard(key)
            self.live_bytes -= n

        self._live[key] = (weakref.ref(st, free), n)
        self.live_bytes += n
        if created:
            self._created.add(key)
        else:
            self.argument_bytes += n
        self.peak_bytes = max(self.peak_bytes, self.live_bytes)

    def add_arguments(self, *trees) -> None:
        """Count the storages of ``trees`` (the step's arguments: params,
        optimizer state, batch, caches) as live from the start."""
        for t in local_tensors(*trees):
            self._track(t, created=False)

    @property
    def output_bytes(self) -> int:
        return sum(self._live[k][1] for k in self._created if k in self._live)

    # -- dispatch ------------------------------------------------------------
    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if any(t not in (torch.Tensor, nn.Parameter, FakeTensor)
               and issubclass(t, torch.Tensor) for t in types):
            # DTensor (or an async collective's wrapper): let it run the
            # local ops, which come back here
            return NotImplemented
        out = func(*args, **kwargs)
        ins, outs = _tensors((args, kwargs)), _tensors(out)
        if any(isinstance(t, FakeTensor) for t in ins + outs):
            return out            # DTensor's shape propagation
        for t in ins:
            self._track(t, created=False)
        for t in outs:
            self._track(t, created=True)
        self._count(func, args, kwargs, ins, outs, out)
        return out

    def _count(self, func, args, kwargs, ins, outs, out) -> None:
        name = func._schema.name
        if name in _FREE:
            return
        if name in KERNEL_WORK:
            flops, nbytes = KERNEL_WORK[name](*args, **kwargs)
            k = self.kernels.setdefault(name.split("::")[1], {
                "count": 0, "flops": 0, "bytes": 0})
            k["count"] += 1
            k["flops"] += flops
            k["bytes"] += nbytes
            self.flops += flops
            self.bytes += nbytes
            return
        if func.namespace in _COLLECTIVE_NS:
            kind = _collective_kind(name)
            if kind is not None:
                nbytes = sum(_nbytes(t) for t in outs)
                if kind == "all-gather" and _in_cpu_alltoall():
                    # DTensor's stand-in for an all-to-all on a cpu mesh:
                    # counted as the all-to-all the card's mesh runs,
                    # whose result is the size of its input
                    kind, nbytes = "all-to-all", sum(_nbytes(t) for t in ins)
                self._collective(kind, _group_name(args), nbytes)
            return
        formula = flop_registry.get(func._overloadpacket)
        if formula is not None:
            self.flops += int(formula(*args, **kwargs, out_val=out))
        if not _is_view(func):
            self.bytes += sum(_nbytes(t) for t in ins + outs)

    def _collective(self, kind: str, group: Optional[str], nbytes: int
                    ) -> None:
        label = self._label(group)
        for rec in (self.collectives.setdefault(kind, {"count": 0,
                                                       "bytes": 0}),
                    self.by_dim.setdefault(label, {}).setdefault(
                        kind, {"count": 0, "bytes": 0})):
            rec["count"] += 1
            rec["bytes"] += nbytes

    # -- results -------------------------------------------------------------
    @property
    def collective_bytes(self) -> int:
        return sum(v["bytes"] for v in self.collectives.values())

    def collective_seconds(self) -> float:
        """Each collective's result bytes over its group's link (NVLink
        inside a node, the network across nodes), summed."""
        return sum(rec["bytes"] / self.link_bw(label)
                   for label, kinds in self.by_dim.items()
                   for rec in kinds.values())

    def memory(self) -> Dict[str, int]:
        return {"argument_bytes": self.argument_bytes,
                "output_bytes": self.output_bytes,
                "temp_bytes": self.peak_bytes - self.argument_bytes,
                "peak_bytes": self.peak_bytes}
