"""Feature-matching 2D object detection (the `detect` command's detector)."""

from onepose_tpu_torch.detector.feature_detector import (
    FeatureObjectDetector,
    ReferenceDB,
    select_reference_views,
)

__all__ = ["FeatureObjectDetector", "ReferenceDB", "select_reference_views"]
