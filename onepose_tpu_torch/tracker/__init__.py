"""Frame-to-frame tracking with windowed bundle adjustment."""

from onepose_tpu_torch.tracker.ba_tracker import BATracker, TrackerConfig, TrackerState

__all__ = ["BATracker", "TrackerConfig", "TrackerState"]
