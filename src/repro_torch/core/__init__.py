"""GCR admission control (the port's own copy of ``repro.core``'s serving
admission classes)."""

from .admission import GCRAdmission, NoAdmission, StreamState
from .pod_aware import GCRPod

__all__ = ["GCRAdmission", "GCRPod", "NoAdmission", "StreamState"]
