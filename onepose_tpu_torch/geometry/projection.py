"""Pinhole projection and reprojection errors.

Port of onepose_tpu/geometry/projection.py.
"""

from __future__ import annotations

import torch


def project_points(
    pts3d: torch.Tensor,
    K: torch.Tensor,
    R: torch.Tensor,
    t: torch.Tensor,
    eps: float = 1e-9,
) -> tuple[torch.Tensor, torch.Tensor]:
    """pts3d [..., N, 3] world points through K [..., 3, 3] and the
    world->camera R [..., 3, 3], t [..., 3]. Returns (uv [..., N, 2],
    depth [..., N])."""
    p_cam = torch.einsum("...ij,...nj->...ni", R, pts3d) + t[..., None, :]
    depth = p_cam[..., 2]
    p_img = torch.einsum("...ij,...nj->...ni", K, p_cam)
    z = p_img[..., 2:3]
    z_safe = torch.where(z >= 0, z.clamp(min=eps), z.clamp(max=-eps))
    return p_img[..., :2] / z_safe, depth


def reprojection_errors(
    pts3d: torch.Tensor,
    pts2d: torch.Tensor,
    K: torch.Tensor,
    R: torch.Tensor,
    t: torch.Tensor,
) -> torch.Tensor:
    """Euclidean pixel reprojection error per point [..., N]."""
    uv, _ = project_points(pts3d, K, R, t)
    return torch.linalg.vector_norm(uv - pts2d, dim=-1)
