"""Batched multi-view triangulation (DLT) with masked observations.

Port of onepose_tpu/geometry/triangulation.py: every track is padded to T
observations with a validity mask, and thousands of tracks are solved in
batched 4x4 symmetric eigendecompositions (`torch.linalg.eigh`,
ascending, as `jnp.linalg.eigh`; chunks of EIGH_BATCH systems), then
refined by damped Gauss-Newton with one 3x3 solve per track. The JAX
package takes the refinement's Jacobian from `jax.jacfwd`; here it is
written out. Full fp32, TF32 off.
"""

from __future__ import annotations

import torch

from onepose_tpu_torch.utils.precision import fp32_matmuls


# Systems per batched eigh call. On the card cuSOLVER's batched eigh
# (cusolverDnXsyevBatched, torch 2.11 with CUDA 12.8) rejects a batch of
# 39441 4x4 systems with CUSOLVER_STATUS_INVALID_VALUE and takes 12000, so
# a large track set is solved in chunks (`map` at 4096 keypoints over 160
# frames triangulates about 40000 tracks).
EIGH_BATCH = 8192


def _dlt_solve(A_sq: torch.Tensor) -> torch.Tensor:
    """Smallest eigenvector of symmetric [..., 4, 4] (null space of A)."""
    flat = A_sq.reshape(-1, 4, 4)
    if flat.shape[0] == 0:
        return flat.new_zeros(A_sq.shape[:-1])
    # ascending eigenvalues; the first column is the smallest one's vector
    vecs = torch.cat([torch.linalg.eigh(c)[1][:, :, 0] for c in flat.split(EIGH_BATCH)])
    return vecs.reshape(A_sq.shape[:-1])


@fp32_matmuls()
def triangulate_tracks_dlt(uv: torch.Tensor, P: torch.Tensor,
                           obs_mask: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Triangulate tracks with known cameras by masked DLT.

    uv: [..., T, 2] pixel observations; P: [..., T, 3, 4] projection
    matrices (K @ [R|t]); obs_mask: [..., T] validity. Returns (xyz [..., 3],
    ok [...]: at least 2 valid observations and a well-conditioned
    system). A track with fewer than 2 observations has an all-zero system
    and an arbitrary vector: read xyz only where ok."""
    w = obs_mask.to(uv.dtype)
    r0 = (uv[..., 0:1] * P[..., 2, :] - P[..., 0, :]) * w[..., None]  # [..., T, 4]
    r1 = (uv[..., 1:2] * P[..., 2, :] - P[..., 1, :]) * w[..., None]
    A_sq = torch.einsum("...ti,...tj->...ij", r0, r0) + torch.einsum("...ti,...tj->...ij", r1, r1)
    x = _dlt_solve(A_sq)
    wcomp = x[..., 3]
    denom = torch.where(torch.abs(wcomp) < 1e-12, torch.full_like(wcomp, 1e-12), wcomp)
    xyz = x[..., :3] / denom[..., None]
    n_obs = obs_mask.sum(dim=-1)
    ok = (n_obs >= 2) & (torch.abs(wcomp) > 1e-12) & torch.isfinite(xyz).all(dim=-1)
    return xyz, ok


def triangulate_two_view(uv0: torch.Tensor, uv1: torch.Tensor, P0: torch.Tensor,
                         P1: torch.Tensor) -> torch.Tensor:
    """Two-view DLT for [..., N, 2] correspondences; returns [..., N, 3]."""
    uv = torch.stack([uv0, uv1], dim=-2)  # [..., N, 2, 2]
    P = torch.stack([P0, P1], dim=-3)[..., None, :, :, :].expand(uv.shape[:-2] + (2, 3, 4))
    mask = torch.ones(uv.shape[:-1], dtype=torch.bool, device=uv.device)
    return triangulate_tracks_dlt(uv, P, mask)[0]


@fp32_matmuls()
def triangulation_residuals(xyz, uv, K, R, t, obs_mask) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-track mean reprojection error and positive-depth share.

    xyz: [..., 3]; uv: [..., T, 2]; K/R: [..., T, 3, 3]; t: [..., T, 3];
    obs_mask: [..., T]. Returns (mean_err [...], frac_pos_depth [...])."""
    p_cam = torch.einsum("...tij,...j->...ti", R, xyz) + t
    depth = p_cam[..., 2]
    pix = torch.einsum("...tij,...tj->...ti", K, p_cam)
    uv_hat = pix[..., :2] / torch.clamp(torch.abs(pix[..., 2:3]), min=1e-9)
    err = torch.linalg.vector_norm(uv_hat - uv, dim=-1)
    w = obs_mask.to(err.dtype)
    n = torch.clamp(w.sum(dim=-1), min=1.0)
    return (err * w).sum(dim=-1) / n, ((depth > 0) * w).sum(dim=-1) / n


def _residual_and_jacobian(x, uv, K, R, t, KR):
    """r = pix[:2] / max(|pix[2]|, 1e-9) - uv with pix = K (R x + t), and
    its Jacobian d r / d x (KR = K R), per observation: x [..., 3] ->
    ([..., T, 2], [..., T, 2, 3]). Where |pix[2]| <= 1e-9 the denominator
    is constant."""
    p = torch.einsum("...tij,...j->...ti", R, x) + t
    pix = torch.einsum("...tij,...tj->...ti", K, p)
    z = pix[..., 2]
    denom = torch.clamp(torch.abs(z), min=1e-9)
    q = pix[..., :2] / denom[..., None]
    dden = torch.where(torch.abs(z) > 1e-9, torch.sign(z), torch.zeros_like(z))
    J = (KR[..., :2, :] - q[..., :, None] * (dden[..., None] * KR[..., 2, :])[..., None, :]) \
        / denom[..., None, None]
    return q - uv, J


@fp32_matmuls()
def refine_points_gn(xyz0, uv, K, R, t, obs_mask, iters: int = 5,
                     damping: float = 1e-4) -> torch.Tensor:
    """Levenberg-style Gauss-Newton refinement of triangulated points,
    batched over tracks ([T] leading): each step solves a 3x3 normal system
    per track, H = J^T W J + damping I, g = J^T W r, x <- x - H^-1 g."""
    KR = K @ R  # [T, L, 3, 3]: d pix / d x
    w = obs_mask.to(xyz0.dtype)[..., None]  # [T, L, 1]
    eye = damping * torch.eye(3, dtype=xyz0.dtype, device=xyz0.device)
    xyz = xyz0
    for _ in range(iters):
        r, J = _residual_and_jacobian(xyz, uv, K, R, t, KR)
        Jw = J * w[..., None]
        H = torch.einsum("...tri,...trj->...ij", Jw, J) + eye
        g = torch.einsum("...tri,...tr->...i", Jw, r * w)
        xyz = xyz + torch.linalg.solve(H, -g)
    return xyz
