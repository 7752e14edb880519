"""Hierarchical gradient synchronization with a compressed cross-pod hop:
the port of ``repro.parallel.collectives``.

``hierarchical_grad_sync`` implements the multi-pod reduction the mesh was
designed for (DESIGN.md section 5):

    1. reduce-scatter over ``data``   (fast intra-pod links)
    2. all-reduce      over ``pod``   (slow inter-pod link - optionally
                                       int8-compressed)
    3. all-gather      over ``data``  (intra-pod)

vs. a flat all-reduce over (pod, data), this moves 1/data of the bytes over
the slow link.  It stays a standalone function, as in the reference: the
train step sums gradients over dp when it pins them to the parameters'
placements (``steps._pin``), not through this function.
"""

from __future__ import annotations

from typing import Any, Mapping

import torch
import torch.distributed as dist

from ..optim.compression import quantize_int8


def _group(mesh, axis: str):
    """The process group of ``axis``, or None where the mesh lacks it."""
    if axis not in (mesh.mesh_dim_names or ()):
        return None
    return mesh.get_group(axis)


def _sum(t: torch.Tensor, group) -> torch.Tensor:
    if group is not None:
        dist.all_reduce(t, group=group)
    return t


def _sync_one(g: torch.Tensor, data, pod, n_data: int, n_pod: int,
              compress: bool) -> torch.Tensor:
    # 1. intra-pod reduce-scatter over 'data' (tiled on the leading axis)
    part = torch.empty((g.shape[0] // n_data,) + tuple(g.shape[1:]),
                       dtype=g.dtype, device=g.device)
    dist.reduce_scatter_tensor(part, g.contiguous(), group=data)
    # 2. cross-pod all-reduce (optionally int8)
    if compress:
        q, scale = quantize_int8(part)
        qsum = _sum(q.to(torch.int32), pod)
        ssum = _sum(scale.clone(), pod)   # conservative shared scale
        part = (qsum.float() * (ssum / float(n_pod))).to(g.dtype)
    else:
        part = _sum(part, pod)
    # 3. intra-pod all-gather
    out = torch.empty_like(g)
    dist.all_gather_into_tensor(out, part.contiguous(), group=data)
    return out


def hierarchical_grad_sync(grads: Mapping[str, Any], mesh,
                           compress: bool = False) -> dict:
    """grads: name-keyed dict (nested dicts too) of this rank's partial
    gradients, plain tensors laid out with the batch split over ('pod',
    'data').  Returns the fully-summed gradients, the same on every rank
    of a (pod, data) group.

    A leaf whose leading dim the data axis divides is reduce-scattered over
    ``data``, summed over ``pod`` (with ``compress``, the int32 sum of its
    int8 ``q`` times the pods' mean scale, the reference's formula) and
    all-gathered over ``data``.  Any other leaf is summed over both axes
    in full precision.  A mesh without a ``pod`` axis has one pod."""
    data, pod = _group(mesh, "data"), _group(mesh, "pod")
    n_data = dist.get_world_size(data)
    n_pod = dist.get_world_size(pod) if pod is not None else 1

    def sync(g):
        if isinstance(g, Mapping):
            return {k: sync(v) for k, v in g.items()}
        if g.dim() >= 1 and g.shape[0] % n_data == 0:
            return _sync_one(g, data, pod, n_data, n_pod, compress)
        return _sum(_sum(g.clone(), data), pod)

    return {k: sync(v) for k, v in grads.items()}
