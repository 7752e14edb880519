"""The port's own copies of ``repro.core``: GCR serving admission
(``admission``, ``pod_aware``) and the host-thread substrate the trainer
runs on (``atomics``, ``waiting``, the lock zoo in ``locks`` and the GCR
wrapper in ``gcr``), which the prefetch pipeline and the checkpoint writer
lock through."""

from .admission import GCRAdmission, NoAdmission, StreamState
from .atomics import AtomicInt, AtomicRef
from .gcr import GCR, gcr_wrap
from .locks import LOCKS, make_lock
from .pod_aware import GCRPod

__all__ = [
    "AtomicInt",
    "AtomicRef",
    "GCR",
    "GCRAdmission",
    "GCRPod",
    "LOCKS",
    "NoAdmission",
    "StreamState",
    "gcr_wrap",
    "make_lock",
]
