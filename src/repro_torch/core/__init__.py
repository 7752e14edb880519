"""The port's own copies of ``repro.core``: GCR serving admission
(``admission``, ``pod_aware``), the host-thread substrate the trainer
runs on (``atomics``, ``waiting``, the lock zoo in ``locks`` and the GCR
wrapper in ``gcr``), which the prefetch pipeline and the checkpoint writer
lock through, the paper's GCR-NUMA (``gcr_numa`` over ``topology``) and
the seeded lock-contention ``simulator`` behind the paper's figures."""

from .admission import GCRAdmission, NoAdmission, StreamState
from .atomics import AtomicInt, AtomicRef
from .gcr import GCR, gcr_wrap
from .gcr_numa import GCRNuma, gcr_numa_wrap
from .locks import LOCKS, make_lock
from .pod_aware import GCRPod
from .topology import Topology

__all__ = [
    "AtomicInt",
    "AtomicRef",
    "GCR",
    "GCRAdmission",
    "GCRNuma",
    "GCRPod",
    "LOCKS",
    "NoAdmission",
    "StreamState",
    "Topology",
    "gcr_numa_wrap",
    "gcr_wrap",
    "make_lock",
]
