"""Track triangulation on the device: gather observations, DLT, refine, gate.

Port of onepose_tpu/sfm/triangulate.py: one batched masked DLT over all
tracks, Gauss-Newton point refinement, and COLMAP-equivalent gates (4 px
maximum reprojection error, positive depth, 1.5 degrees minimum
triangulation angle, at least 2 inlier observations). Full fp32, TF32 off.
"""

from __future__ import annotations

import torch

from onepose_tpu_torch.geometry.triangulation import (
    refine_points_gn,
    triangulate_tracks_dlt,
    triangulation_residuals,
)
from onepose_tpu_torch.utils.precision import fp32_matmuls


def gather_track_observations(tracks_obs_frame, tracks_obs_kpt, tracks_obs_mask, keypoints, K,
                              R, t):
    """Per-track (uv [T, L, 2], K_t [T, L, 3, 3], R_t [T, L, 3, 3], t_t
    [T, L, 3]) from the [T, L] padded track layout and per-frame arrays
    (keypoints [F, N, 2]; K, R, t [F, ...]); padded slots read frame 0,
    keypoint 0."""
    f = torch.clamp(tracks_obs_frame.long(), min=0)
    k = torch.clamp(tracks_obs_kpt.long(), min=0)
    return keypoints[f, k], K[f], R[f], t[f]


def triangulation_angles(xyz, R, t, obs_mask) -> torch.Tensor:
    """Max pairwise triangulation angle (deg) per track: xyz [T, 3]; R/t
    [T, L, ...]; obs_mask [T, L]."""
    centers = -torch.einsum("tlji,tlj->tli", R, t)  # [T, L, 3]
    rays = xyz[:, None, :] - centers
    rays = rays / torch.clamp(torch.linalg.vector_norm(rays, dim=-1, keepdim=True), min=1e-12)
    cos = torch.einsum("tli,tmi->tlm", rays, rays)
    pair_mask = obs_mask[:, :, None] & obs_mask[:, None, :]
    cos = torch.where(pair_mask, torch.clamp(cos, -1.0, 1.0), torch.ones_like(cos))
    return torch.rad2deg(torch.arccos(cos.amin(dim=(-1, -2))))


@fp32_matmuls()
def triangulate_and_filter_tracks(
    tracks_obs_frame: torch.Tensor,
    tracks_obs_kpt: torch.Tensor,
    tracks_obs_mask: torch.Tensor,
    keypoints: torch.Tensor,
    K: torch.Tensor,
    R: torch.Tensor,
    t: torch.Tensor,
    max_reproj_px: float = 4.0,
    min_tri_angle_deg: float = 1.5,
    refine_iters: int = 5,
) -> dict:
    """Triangulation of the padded track set. Returns dict(xyz [T, 3], ok
    [T], mean_reproj [T], tri_angle [T], obs_inlier [T, L]: the
    per-observation reprojection gate)."""
    uv, K_t, R_t, t_t = gather_track_observations(
        tracks_obs_frame, tracks_obs_kpt, tracks_obs_mask, keypoints, K, R, t)
    P = torch.einsum("tlij,tljk->tlik", K_t, torch.cat([R_t, t_t[..., None]], dim=-1))
    xyz0, ok_dlt = triangulate_tracks_dlt(uv, P, tracks_obs_mask)
    xyz = refine_points_gn(xyz0, uv, K_t, R_t, t_t, tracks_obs_mask, iters=refine_iters)
    # Keep the refinement only where it is finite.
    xyz = torch.where(torch.isfinite(xyz).all(dim=-1, keepdim=True), xyz, xyz0)

    mean_err, frac_pos = triangulation_residuals(xyz, uv, K_t, R_t, t_t, tracks_obs_mask)
    angle = triangulation_angles(xyz, R_t, t_t, tracks_obs_mask)

    # Per-observation gate for downstream observation pruning.
    p_cam = torch.einsum("tlij,tj->tli", R_t, xyz) + t_t
    pix = torch.einsum("tlij,tlj->tli", K_t, p_cam)
    uv_hat = pix[..., :2] / torch.clamp(torch.abs(pix[..., 2:3]), min=1e-9)
    obs_err = torch.linalg.vector_norm(uv_hat - uv, dim=-1)
    obs_inlier = tracks_obs_mask & (obs_err < max_reproj_px) & (p_cam[..., 2] > 0)

    ok = (ok_dlt & (mean_err < max_reproj_px) & (frac_pos > 0.99)
          & (angle > min_tri_angle_deg) & (obs_inlier.sum(dim=-1) >= 2))
    return {"xyz": xyz, "ok": ok, "mean_reproj": mean_err, "tri_angle": angle,
            "obs_inlier": obs_inlier}
