"""Pose geometry of the port: rotations, projection, P3P, RANSAC-PnP and
pose-error metrics (batched over leading axes)."""

from onepose_tpu_torch.geometry.metrics import aggregate_metrics, query_pose_error
from onepose_tpu_torch.geometry.projection import project_points, reprojection_errors
from onepose_tpu_torch.geometry.ransac import ransac_pnp
from onepose_tpu_torch.geometry.rotations import (
    angle_axis_rotate_point,
    angle_axis_to_rotmat,
    qvec_to_rotmat,
    rotmat_to_angle_axis,
    rotmat_to_qvec,
)

__all__ = [
    "aggregate_metrics",
    "angle_axis_rotate_point",
    "angle_axis_to_rotmat",
    "project_points",
    "qvec_to_rotmat",
    "query_pose_error",
    "ransac_pnp",
    "reprojection_errors",
    "rotmat_to_angle_axis",
    "rotmat_to_qvec",
]
