"""Distributed Schur-complement bundle adjustment over the points axis.

Port of onepose_tpu/parallel/distributed_ba.py. Point blocks are
independent, so the points and their observations are split over the
mesh's points axis: each rank assembles its points' Hpp blocks, its
camera-point coupling and its share of the reduced camera system; the
[W, 6] gradient, the [W, 6, 6] camera blocks, the [W, 6, W, 6] Schur
reduction and the cost are all-reduced over the points group; every rank
solves the same 6W x 6W camera system, and the point back-substitution
stays local. The accept / reject of each LM step reads the all-reduced
costs, so every rank takes the same decision.

Observation layout: the host groups observations by the shard that owns
their point (`partition_obs_by_point`, numpy), so no point's Hpp block or
back-substitution needs another rank.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from onepose_tpu_torch.ops.lm import _obs_jacobians, _segment_sum, snavely_residuals
from onepose_tpu_torch.parallel.mesh import POINTS_AXIS, Mesh, gather, shard
from onepose_tpu_torch.utils import comm
from onepose_tpu_torch.utils.precision import fp32_matmuls


def partition_obs_by_point(
    n_points: int,
    n_shards: int,
    features: np.ndarray,
    pt_idx: np.ndarray,
    cam_idx: np.ndarray,
    obs_mask: np.ndarray,
):
    """Group observations by point shard, padded to the largest shard.

    Shard s owns points [s * P/D, (s+1) * P/D). Returns arrays stacked on
    axis 0 = shard: features [D, M_max, 5], local point ids [D, M_max]
    (relative to the shard's block), cam_idx [D, M_max], mask [D, M_max]."""
    if n_points % n_shards:
        raise ValueError(f"{n_points} points do not divide {n_shards} shards")
    block = n_points // n_shards
    owner = np.asarray(pt_idx) // block
    valid = np.asarray(obs_mask)
    per_shard = [np.nonzero((owner == s) & valid)[0] for s in range(n_shards)]
    m_max = max(max((len(ix) for ix in per_shard), default=1), 1)

    f_out = np.zeros((n_shards, m_max, features.shape[-1]), features.dtype)
    p_out = np.zeros((n_shards, m_max), np.int32)
    c_out = np.zeros((n_shards, m_max), np.int32)
    m_out = np.zeros((n_shards, m_max), bool)
    for s, ix in enumerate(per_shard):
        n = len(ix)
        f_out[s, :n] = features[ix]
        p_out[s, :n] = pt_idx[ix] - s * block
        c_out[s, :n] = cam_idx[ix]
        m_out[s, :n] = True
    return f_out, p_out, c_out, m_out


def _local_assemble(points_l, cams, feats, pt_idx, cam_idx, mask, lam) -> dict:
    """This rank's blocks and its contributions to the reduced system."""
    n_local, n_cams = points_l.shape[0], cams.shape[0]
    r, Jp, Jc = _obs_jacobians(points_l, cams, feats, pt_idx, cam_idx, mask)
    Hpp = _segment_sum(torch.einsum("mri,mrj->mij", Jp, Jp), pt_idx, n_local)
    bp = _segment_sum(-torch.einsum("mri,mr->mi", Jp, r), pt_idx, n_local)
    Hcc = _segment_sum(torch.einsum("mri,mrj->mij", Jc, Jc), cam_idx, n_cams)
    bc = _segment_sum(-torch.einsum("mri,mr->mi", Jc, r), cam_idx, n_cams)
    eye3 = torch.eye(3, dtype=r.dtype, device=r.device)
    Hpp_d = Hpp + lam * torch.clamp(torch.diagonal(Hpp, dim1=-2, dim2=-1),
                                    min=1e-6)[..., None] * eye3
    Hpp_inv = torch.linalg.inv_ex(Hpp_d + 1e-9 * eye3, check_errors=False)[0]  # never raises
    A = torch.einsum("mri,mrj->mij", Jc, Jp)  # [M, 6, 3]
    U = _segment_sum(A, pt_idx * n_cams + cam_idx, n_local * n_cams).reshape(
        n_local, n_cams, 6, 3)
    UHinv = torch.einsum("pcij,pjk->pcik", U, Hpp_inv)
    return {
        "Hcc": Hcc, "bc": bc,
        "S_red": torch.einsum("pcik,pdlk->cidl", UHinv, U),
        "rhs_red": torch.einsum("pcik,pk->ci", UHinv, bp),
        "Hpp_inv": Hpp_inv, "bp": bp, "U": U,
    }


@fp32_matmuls()
def distributed_ba_solve(
    mesh: Mesh,
    points: torch.Tensor,
    cam_poses: torch.Tensor,
    features: torch.Tensor,
    pt_idx: torch.Tensor,
    cam_idx: torch.Tensor,
    obs_mask: torch.Tensor,
    fix_cam_mask: Optional[torch.Tensor] = None,
    n_iters: int = 5,
    init_lambda: float = 1e-3,
) -> dict:
    """LM bundle adjustment with the points split over mesh's points axis.

    points [P, 3] (P divisible by the points axis); the per-shard
    observation arrays of `partition_obs_by_point`, stacked on axis 0 =
    shard: features [D, M, 5], pt_idx [D, M] (local ids), cam_idx [D, M],
    obs_mask [D, M]. Every rank passes the whole arrays and works on its
    shard; cameras are replicated. Returns dict(points [P, 3], cam_poses,
    cost_initial, cost_final), whole on every rank."""
    group = mesh.group(POINTS_AXIS)
    dtype, dev = points.dtype, points.device
    n_cams = cam_poses.shape[0]
    blk = (POINTS_AXIS, None)
    pts = shard(mesh, points, blk)
    feats = shard(mesh, features, (POINTS_AXIS, None, None))[0]
    pt_l = shard(mesh, pt_idx, blk)[0].long()
    cam_l = shard(mesh, cam_idx, blk)[0].long()
    mask_l = shard(mesh, obs_mask, blk)[0]
    fix = fix_cam_mask if fix_cam_mask is not None else torch.zeros(n_cams, dtype=dtype,
                                                                    device=dev)
    fix = fix.to(dtype)
    free = 1.0 - fix
    eye6 = torch.eye(6, dtype=dtype, device=dev)
    diag = torch.arange(n_cams, device=dev)

    def cost(p, c):
        r = snavely_residuals(p, c, feats, pt_l, cam_l, mask_l)
        return comm.all_reduce(0.5 * torch.sum(r * r), group)

    cms = cam_poses
    lam = torch.tensor(init_lambda, dtype=dtype, device=dev)
    c0 = cost(pts, cms)
    for _ in range(n_iters):
        loc = _local_assemble(pts, cms, feats, pt_l, cam_l, mask_l, lam)
        Hcc, bc, S_red, rhs_red = (comm.all_reduce(loc[k], group)
                                   for k in ("Hcc", "bc", "S_red", "rhs_red"))
        Hcc_d = Hcc + lam * torch.clamp(torch.diagonal(Hcc, dim1=-2, dim2=-1),
                                        min=1e-6)[..., None] * eye6
        S = torch.zeros((n_cams, 6, n_cams, 6), dtype=dtype, device=dev)
        S[diag, :, diag, :] = Hcc_d
        S = (S - S_red) * free[:, None, None, None] * free[None, None, :, None]
        S[diag, :, diag, :] += eye6[None] * fix[:, None, None]
        rhs = (bc - rhs_red) * free[:, None]
        dc = torch.linalg.solve_ex(
            S.reshape(n_cams * 6, n_cams * 6)
            + 1e-9 * torch.eye(n_cams * 6, dtype=dtype, device=dev),
            rhs.reshape(-1), check_errors=False)[0].reshape(n_cams, 6)
        Ut_dc = torch.einsum("pcij,ci->pj", loc["U"], dc)
        dp = torch.einsum("pij,pj->pi", loc["Hpp_inv"], loc["bp"] - Ut_dc)
        c_old, c_new = cost(pts, cms), cost(pts + dp, cms + dc)
        improved = (c_new < c_old) & torch.isfinite(c_new)
        pts = torch.where(improved, pts + dp, pts)
        cms = torch.where(improved, cms + dc, cms)
        lam = torch.clamp(torch.where(improved, lam * 0.3, lam * 6.0), 1e-9, 1e6)
    return {"points": gather(mesh, pts, blk), "cam_poses": cms, "cost_initial": c0,
            "cost_final": cost(pts, cms)}
