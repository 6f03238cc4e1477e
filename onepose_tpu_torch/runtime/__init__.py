"""Serving runtime of the port: the fused pose pipeline."""

from onepose_tpu_torch.runtime.pipeline import ObjectAnnotation, PosePipeline, stack_annotations

__all__ = ["ObjectAnnotation", "PosePipeline", "stack_annotations"]
