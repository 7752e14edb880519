"""The synthetic token source and its GCR-locked prefetch pipeline."""

from .pipeline import PipelineState, PrefetchPipeline, SyntheticTokens

__all__ = ["PipelineState", "PrefetchPipeline", "SyntheticTokens"]
