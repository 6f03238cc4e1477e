"""Sparse bundle-adjustment Levenberg-Marquardt solver on the device.

Port of onepose_tpu/ops/lm.py. Residual (the reference's
SnavelyReprojectionErrorV2): camera (angle_axis[3], t[3]); p_cam = R(aa) X
+ t; prediction f * (x/z, y/z) + (cx, cy); residual prediction -
observation.

The normal equations have the classic BA sparsity: Hpp point blocks (3x3)
and Hcc camera blocks (6x6) are block-diagonal; the points are eliminated
by the Schur complement and the small dense reduced camera system is
solved. Block sums are `index_add_` (the JAX package's segment sums; on
CUDA they add in atomic order, so the last bits differ from call to
call); the camera-point coupling U[p, c] is dense, [P, W, 6, 3]; the
products are einsums, as the JAX package leaves them to XLA. The per-
observation Jacobians come from `torch.func.jacfwd` under `vmap`, as the
JAX package takes them from `jax.jacfwd`. The iterations are a Python
loop whose accept / reject stays on the device (`torch.where`, no host
read). Full fp32, TF32 off.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch.func import jacfwd, vmap

from onepose_tpu_torch.geometry.rotations import angle_axis_rotate_point
from onepose_tpu_torch.utils.precision import fp32_matmuls


def _project(X: torch.Tensor, cam: torch.Tensor, feat: torch.Tensor) -> torch.Tensor:
    """Residual [..., 2] of points X [..., 3] seen by cameras cam [..., 6]
    against features (u, v, f, cx, cy) [..., 5]."""
    p = angle_axis_rotate_point(cam[..., :3], X) + cam[..., 3:6]
    z = p[..., 2]
    z_safe = torch.where(torch.abs(z) < 1e-9, torch.full_like(z, 1e-9), z)
    u = feat[..., 2] * (p[..., 0] / z_safe) + feat[..., 3]
    v = feat[..., 2] * (p[..., 1] / z_safe) + feat[..., 4]
    return torch.stack([u - feat[..., 0], v - feat[..., 1]], dim=-1)


def snavely_residuals(points, cam_poses, features, pt_idx, cam_idx, obs_mask) -> torch.Tensor:
    """Masked reprojection residuals [M, 2]. points [P, 3]; cam_poses [W, 6]
    (angle-axis, t); features [M, 5] = (u, v, f, cx, cy); pt_idx / cam_idx
    [M]; obs_mask [M]."""
    r = _project(points[pt_idx], cam_poses[cam_idx], features)
    return r * obs_mask.to(r.dtype)[:, None]


def _obs_jacobians(points, cam_poses, features, pt_idx, cam_idx, obs_mask):
    """(r [M, 2], Jp [M, 2, 3], Jc [M, 2, 6]), masked observations zeroed."""
    X, cam = points[pt_idx], cam_poses[cam_idx]
    r = _project(X, cam, features)
    Jp, Jc = vmap(jacfwd(_project, argnums=(0, 1)))(X, cam, features)
    w = obs_mask.to(r.dtype)
    return r * w[:, None], Jp * w[:, None, None], Jc * w[:, None, None]


def _segment_sum(x: torch.Tensor, idx: torch.Tensor, n: int) -> torch.Tensor:
    return torch.zeros((n,) + x.shape[1:], dtype=x.dtype, device=x.device).index_add_(0, idx, x)


def _solve_normal_equations(r, Jp, Jc, pt_idx, cam_idx, n_points: int, n_cams: int, lam,
                            fix_cam_mask):
    """One damped GN step via the Schur complement: (dx_points [P, 3],
    dx_cams [W, 6])."""
    dtype, dev = r.dtype, r.device
    Hpp = _segment_sum(torch.einsum("mri,mrj->mij", Jp, Jp), pt_idx, n_points)  # [P, 3, 3]
    Hcc = _segment_sum(torch.einsum("mri,mrj->mij", Jc, Jc), cam_idx, n_cams)  # [W, 6, 6]
    bp = _segment_sum(-torch.einsum("mri,mr->mi", Jp, r), pt_idx, n_points)  # [P, 3]
    bc = _segment_sum(-torch.einsum("mri,mr->mi", Jc, r), cam_idx, n_cams)  # [W, 6]

    # Camera gauge: fixed cameras take no step.
    if fix_cam_mask is not None:
        fixed = fix_cam_mask.to(dtype)  # [W], 1 = fixed
        bc = bc * (1 - fixed)[:, None]

    # LM damping (multiplicative on the diagonal).
    eye3 = torch.eye(3, dtype=dtype, device=dev)
    eye6 = torch.eye(6, dtype=dtype, device=dev)
    Hpp_d = Hpp + lam * eye3 * torch.clamp(torch.diagonal(Hpp, dim1=-2, dim2=-1),
                                           min=1e-6)[..., None] * eye3
    Hcc_d = Hcc + lam * eye6 * torch.clamp(torch.diagonal(Hcc, dim1=-2, dim2=-1),
                                           min=1e-6)[..., None] * eye6
    # inv_ex / solve_ex: a singular system gives non-finite values, as JAX's
    # LU does, where inv / solve would raise (and sync the host).
    Hpp_inv = torch.linalg.inv_ex(Hpp_d + 1e-9 * eye3, check_errors=False)[0]  # [P, 3, 3]

    # Camera-point coupling: U[p, c] = sum over observations of Jc^T Jp.
    A = torch.einsum("mri,mrj->mij", Jc, Jp)  # [M, 6, 3]
    U = _segment_sum(A, pt_idx * n_cams + cam_idx, n_points * n_cams).reshape(
        n_points, n_cams, 6, 3)

    # Schur complement S = Hcc - U Hpp^-1 U^T and the reduced right side.
    UHinv = torch.einsum("pcij,pjk->pcik", U, Hpp_inv)  # [P, W, 6, 3]
    S_red = torch.einsum("pcik,pdlk->cidl", UHinv, U)  # [W, 6, W, 6]
    cams = torch.arange(n_cams, device=dev)
    S = torch.zeros((n_cams, 6, n_cams, 6), dtype=dtype, device=dev)
    S[cams, :, cams, :] = Hcc_d
    S = S - S_red
    rhs = bc - torch.einsum("pcik,pk->ci", UHinv, bp)  # [W, 6]

    if fix_cam_mask is not None:
        fixed = fix_cam_mask.to(dtype)
        free = 1 - fixed
        S = S * free[:, None, None, None] * free[None, None, :, None]
        S[cams, :, cams, :] += eye6[None] * fixed[:, None, None]
        rhs = rhs * free[:, None]

    S_flat = S.reshape(n_cams * 6, n_cams * 6)
    dc = torch.linalg.solve_ex(S_flat + 1e-9 * torch.eye(n_cams * 6, dtype=dtype, device=dev),
                               rhs.reshape(-1), check_errors=False)[0].reshape(n_cams, 6)

    # Back-substitute the points: dp = Hpp^-1 (bp - U^T dc).
    Ut_dc = torch.einsum("pcij,ci->pj", U, dc)  # [P, 3]
    dp = torch.einsum("pij,pj->pi", Hpp_inv, bp - Ut_dc)
    return dp, dc


@fp32_matmuls()
def ba_solve(
    points: torch.Tensor,
    cam_poses: torch.Tensor,
    features: torch.Tensor,
    pt_idx: torch.Tensor,
    cam_idx: torch.Tensor,
    obs_mask: torch.Tensor,
    point_mask: Optional[torch.Tensor] = None,
    fix_cam_mask: Optional[torch.Tensor] = None,
    n_iters: int = 5,
    init_lambda: float = 1e-3,
) -> dict:
    """Levenberg-Marquardt bundle adjustment.

    points [P, 3]; cam_poses [W, 6] (angle-axis, translation) world->cam;
    features [M, 5] (u, v, f, cx, cy); pt_idx / cam_idx [M] (padded
    observations must have obs_mask False; indices are clipped); obs_mask
    [M]; point_mask [P]: optimise only these points; fix_cam_mask [W]: 1 =
    keep this camera fixed. A step is taken where it lowers the cost (and
    the cost is finite): lambda x 0.3, else lambda x 6, clipped to
    [1e-9, 1e6]. Returns dict(points, cam_poses, cost_initial, cost_final,
    lambda), all on the device."""
    pt_idx = torch.clamp(pt_idx.long(), 0, points.shape[0] - 1)
    cam_idx = torch.clamp(cam_idx.long(), 0, cam_poses.shape[0] - 1)

    def cost(pts, cams):
        r = snavely_residuals(pts, cams, features, pt_idx, cam_idx, obs_mask)
        return 0.5 * torch.sum(r * r)

    c0 = cost(points, cam_poses)
    pts, cams = points, cam_poses
    lam = torch.tensor(init_lambda, dtype=points.dtype, device=points.device)
    for _ in range(n_iters):
        r, Jp, Jc = _obs_jacobians(pts, cams, features, pt_idx, cam_idx, obs_mask)
        dp, dc = _solve_normal_equations(r, Jp, Jc, pt_idx, cam_idx, pts.shape[0],
                                         cams.shape[0], lam, fix_cam_mask)
        if point_mask is not None:
            dp = dp * point_mask.to(dp.dtype)[:, None]
        cand_pts, cand_cams = pts + dp, cams + dc
        c_old, c_new = cost(pts, cams), cost(cand_pts, cand_cams)
        improved = (c_new < c_old) & torch.isfinite(c_new)
        pts = torch.where(improved, cand_pts, pts)
        cams = torch.where(improved, cand_cams, cams)
        lam = torch.clamp(torch.where(improved, lam * 0.3, lam * 6.0), 1e-9, 1e6)
    return {"points": pts, "cam_poses": cams, "cost_initial": c0, "cost_final": cost(pts, cams),
            "lambda": lam}
