"""Sparse object mapping (SfM with known poses): the core of `map`.

Port of onepose_tpu/sfm/: covisibility pair selection -> pair matching
(`parallel.sfm_parallel`) -> epipolar verification -> track building ->
batched DLT triangulation + Gauss-Newton refinement -> filtering / merging
-> per-point descriptor aggregation (`mapping.run_mapping` drives them,
with optional LM bundle adjustment, `ops.lm`). Device stages run in full
fp32 on CUDA unless the caller names the CPU; graph stages are host numpy
and the native union-find (`onepose_tpu_torch.native`).
"""

from onepose_tpu_torch.sfm.aggregate import (
    aggregate_point_features,
    assign_matrix_for_frame,
    build_leaf_slots,
)
from onepose_tpu_torch.sfm.covis import covis_pairs_from_poses
from onepose_tpu_torch.sfm.filtering import (
    filter_points_by_box,
    merge_close_points,
    track_length_for_max_points,
)
from onepose_tpu_torch.sfm.tracks import Tracks, build_tracks
from onepose_tpu_torch.sfm.triangulate import triangulate_and_filter_tracks
from onepose_tpu_torch.sfm.verify import epipolar_verify_matches

__all__ = [
    "Tracks",
    "aggregate_point_features",
    "assign_matrix_for_frame",
    "build_leaf_slots",
    "build_tracks",
    "covis_pairs_from_poses",
    "epipolar_verify_matches",
    "filter_points_by_box",
    "merge_close_points",
    "track_length_for_max_points",
    "triangulate_and_filter_tracks",
]
