"""Pose-error metrics: cm-degree recall, the OnePose acceptance metric.

Port of onepose_tpu/geometry/metrics.py: translation error in centimeters
(||t_pred - t_gt|| * 100), rotation error as the geodesic angle in degrees;
recall at X requires both below X.
"""

from __future__ import annotations

import numpy as np
import torch


def query_pose_error(
    pose_pred: torch.Tensor, pose_gt: torch.Tensor
) -> tuple[torch.Tensor, torch.Tensor]:
    """(rotation error deg, translation error cm) between [..., 3|4, 4] poses."""
    Rp, Rg = pose_pred[..., :3, :3], pose_gt[..., :3, :3]
    tp, tg = pose_pred[..., :3, 3], pose_gt[..., :3, 3]
    trans_err_cm = torch.linalg.vector_norm(tp - tg, dim=-1) * 100.0
    rel = torch.einsum("...ij,...kj->...ik", Rp, Rg)  # Rp @ Rg^T
    trace = rel.diagonal(dim1=-2, dim2=-1).sum(-1).clamp(-1.0, 3.0)
    rot_err_deg = torch.rad2deg(torch.arccos((trace - 1.0) / 2.0))
    return rot_err_deg, trans_err_cm


def aggregate_metrics(R_errs, t_errs, thresholds=(1, 3, 5)) -> dict:
    """cm-deg recall at each threshold over a dataset (host side)."""
    R, t = (
        np.asarray(x.detach().cpu() if isinstance(x, torch.Tensor) else x, dtype=np.float64)
        for x in (R_errs, t_errs)
    )
    return {
        f"{thr}cm@{thr}degree": float(np.mean((R < thr) & (t < thr))) if R.size else 0.0
        for thr in thresholds
    }
