"""Real-model serving: GCR admission in front of fixed batch slots."""

from .engine import TorchServeEngine, make_admission

__all__ = ["TorchServeEngine", "make_admission"]
