"""Mesh construction: the port of ``repro.launch.mesh``.

Both builders are FUNCTIONS (never module-level constants), so importing
this module touches no process group; each needs one started (the
launcher starts it from ``torchrun``'s environment, a dry run may start
the ``fake`` group of ``world_size=512``) and returns an
``init_device_mesh`` over all of its ranks.  The device type is the
group's: ``cuda`` under NCCL, ``cpu`` under gloo (and the fake group).

Axes:
  single-pod : (data=16, model=16)                = 256 devices
  multi-pod  : (pod=2, data=16, model=16)         = 512 devices

The ``pod`` axis is the slow dimension: gradient sync is hierarchical -
reduce-scatter on ``data`` inside a pod, all-reduce of the small shards
across ``pod``, all-gather back on ``data``
(``parallel.collectives.hierarchical_grad_sync``).
"""

from __future__ import annotations

import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh


def mesh_device_type() -> str:
    """``cuda`` when the started group's backend is NCCL, else ``cpu``."""
    return "cuda" if dist.get_backend() == "nccl" else "cpu"


def make_production_mesh(*, multi_pod: bool = False) -> DeviceMesh:
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return init_device_mesh(mesh_device_type(), shape, mesh_dim_names=axes)


def make_host_mesh(model: int = 1) -> DeviceMesh:
    """(data = world // model, model) over every rank of the group."""
    world = dist.get_world_size()
    if world % model:
        raise ValueError(f"--model-parallel {model} does not divide the "
                         f"{world} ranks")
    return init_device_mesh(mesh_device_type(), (world // model, model),
                            mesh_dim_names=("data", "model"))
