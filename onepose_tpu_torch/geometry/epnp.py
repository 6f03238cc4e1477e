"""Batched EPnP: closed-form pose from masked 2D-3D correspondences.

Port of onepose_tpu/geometry/epnp.py, batched over a leading frame axis
where JAX vmaps a per-frame function:

1. Four control points from the weighted centroid + PCA of the 3D points.
2. Barycentric coordinates per point.
3. M^T M (12x12) eigendecomposition -> null-space basis.
4. beta initialization for the cases N = 1, 2, 3, then Gauss-Newton on the
   4 betas over the control-point distance constraints.
5. Camera-frame control points -> camera points -> weighted Kabsch for R, t.

Where JAX differentiates the betas' residuals with `jax.jacfwd`, the port
writes their Jacobian in closed form. `jnp.linalg.lstsq` (SVD, rcond =
eps * max(m, n)) is written out over `torch.linalg.svd`, which runs on the
card as on the CPU (CUDA's `torch.linalg.lstsq` has only a QR driver that
needs full rank). Singular solves go through `solve_ex`, which gives
non-finite values instead of raising, as JAX does. A decomposition never
sees a non-finite input: such a batch entry is decomposed as zeros and its
outputs set to NaN afterwards, so the NaN travels on exactly as in JAX,
and the final `ok` turns it into the identity pose.

Differs on purpose: the principal axes that place the control points take
a fixed sign (`canonical_axes`), where JAX keeps LAPACK's. With noisy
correspondences EPnP's answer depends on those signs (flipping an axis
changes every alpha): JAX's noisy poses move by up to about 1e-3 with
them, and LAPACK and cuSOLVER differ, so the port fixes them and the card
and the CPU give one pose. A weighted cloud with no spread (its largest variance
at or below the 1e-12 clamp of `_control_points`: all points equal) is
not ok, where JAX reports ok with an arbitrary pose. On an exactly planar
cloud the fourth control point's alphas are 0, M^T M has a four-fold null
space and the fp32 solve is decided by rounding, in JAX as here (ROADMAP
C16): float64 inputs run the whole solve in float64, which recovers such
poses.
"""

from __future__ import annotations

import torch

from onepose_tpu_torch.utils.precision import fp32_matmuls

_PAIRS = [(0, 1), (0, 2), (0, 3), (1, 2), (1, 3), (2, 3)]


def _finite(x: torch.Tensor, dims: int) -> torch.Tensor:
    """Per batch entry: every value of the trailing `dims` axes finite."""
    return torch.isfinite(x).flatten(-dims).all(-1)


def _guarded(fn, x: torch.Tensor, dims: int):
    """fn(x) with non-finite batch entries replaced by zeros, and each
    output of those entries set to NaN: the decomposition never sees a
    non-finite value (LAPACK and cuSOLVER may raise on one)."""
    good = _finite(x, dims)
    outs = fn(torch.where(good.reshape(good.shape + (1,) * dims), x, 0.0))
    single = not isinstance(outs, tuple)
    outs = (outs,) if single else outs
    outs = tuple(torch.where(good.reshape(good.shape + (1,) * (o.dim() - good.dim())), o,
                             torch.nan) for o in outs)
    return outs[0] if single else outs


def _solve(A: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """A^-1 b by LU without raising on a singular A (non-finite results,
    as jnp.linalg.solve gives)."""
    return torch.linalg.solve_ex(A, b, check_errors=False)[0]


def _lstsq(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """jnp.linalg.lstsq(a, b)[0] for [..., m, n] a and [..., m] b: the SVD
    pseudo-inverse with singular values below eps * max(m, n) * s_max (and
    zeros) dropped."""
    m, n = a.shape[-2:]
    rcond = torch.finfo(a.dtype).eps * max(m, n)
    u, s, vt = _guarded(lambda x: torch.linalg.svd(x, full_matrices=False), a, 2)
    keep = (s > 0) & (s >= rcond * s[..., :1])
    s_inv = torch.where(keep, 1.0 / torch.where(keep, s, 1.0), 0.0)
    utb = (u.transpose(-1, -2) @ b[..., None])[..., 0]
    return (vt.transpose(-1, -2) @ (s_inv * utb)[..., None])[..., 0]


def canonical_axes(vecs: torch.Tensor) -> torch.Tensor:
    """Eigenvectors (columns of [..., n, n]) with each one's component of
    largest magnitude made positive (the first such on ties)."""
    idx = vecs.abs().argmax(dim=-2, keepdim=True)
    sign = torch.sign(torch.gather(vecs, -2, idx))
    return vecs * torch.where(sign == 0, 1.0, sign)


def _control_points(pts3d: torch.Tensor, w: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """([B, 4, 3] control points: centroid + scaled principal axes, [B] the
    largest variance of the weighted cloud)."""
    wsum = w.sum(-1).clamp(min=1e-9)
    c0 = (pts3d * w[..., None]).sum(-2) / wsum[:, None]
    d = pts3d - c0[:, None]
    cov = ((d * w[..., None]).transpose(-1, -2) @ d) / wsum[:, None, None]
    eigval, eigvec = _guarded(torch.linalg.eigh, cov, 2)  # ascending
    eigvec = canonical_axes(eigvec)
    # Scale axes by sqrt(variance); clamp so planar/degenerate clouds still
    # give an invertible basis.
    max_std = torch.sqrt(eigval[:, 2].clamp(min=1e-12))
    std = torch.sqrt(eigval.clamp(min=1e-12))
    std = torch.maximum(std, 1e-3 * max_std.clamp(min=1e-6)[:, None])
    ctrl = c0[:, None] + (eigvec * std[:, None, :]).transpose(-1, -2)  # rows c0 + std_i v_i
    return torch.cat([c0[:, None], ctrl], dim=1), eigval[:, 2]


def _barycentric(pts3d: torch.Tensor, ctrl: torch.Tensor) -> torch.Tensor:
    """Alphas [B, N, 4] s.t. p = sum_j alpha_j * ctrl_j, sum alpha = 1."""
    basis = (ctrl[:, 1:] - ctrl[:, :1]).transpose(-1, -2)  # [B, 3, 3]
    coeff = _solve(basis, (pts3d - ctrl[:, :1]).transpose(-1, -2)).transpose(-1, -2)
    return torch.cat([1.0 - coeff.sum(-1, keepdim=True), coeff], dim=-1)


def _build_MtM(alphas, pts2d, K, w) -> torch.Tensor:
    """M^T M [B, 12, 12] without materializing M [B, 2N, 12]."""
    fu, fv = K[:, 0, 0, None, None], K[:, 1, 1, None, None]
    uc, vc = K[:, 0, 2, None], K[:, 1, 2, None]
    u, v = pts2d[..., 0], pts2d[..., 1]
    B, N = alphas.shape[:2]
    zeros = torch.zeros_like(alphas)
    # Row u: [a*fu, 0, a*(uc-u)] interleaved over control points.
    ru = torch.stack([alphas * fu, zeros, alphas * (uc - u)[..., None]], dim=-1)
    rv = torch.stack([zeros, alphas * fv, alphas * (vc - v)[..., None]], dim=-1)
    ru = ru.reshape(B, N, 12) * w[..., None]
    rv = rv.reshape(B, N, 12) * w[..., None]
    return ru.transpose(-1, -2) @ ru + rv.transpose(-1, -2) @ rv


def _pair_diffs(V: torch.Tensor) -> torch.Tensor:
    """[B, 4 basis, 6 pairs, 3] differences of the control points' basis
    vectors over the 6 control-point pairs."""
    return torch.stack([V[:, :, i] - V[:, :, j] for i, j in _PAIRS], dim=2)


def _beta_inits(V: torch.Tensor, dist_w: torch.Tensor) -> torch.Tensor:
    """Closed-form beta initializations for EPnP cases N=1, 2, 3.

    V: [B, 4 basis, 4 ctrl, 3]. Returns [B, 3, 4] candidate beta vectors
    (the cases that use 1, 2 or 3 null-space basis vectors)."""
    diffs = _pair_diffs(V)
    g = torch.einsum("zaps,zbps->zabp", diffs, diffs)  # [B, 4, 4, 6]
    rho = dist_w ** 2  # [B, 6]
    zero = torch.zeros_like(rho[:, 0])

    # Case N=1: b1^2 * g[0,0] = rho.
    b1_sq = (g[:, 0, 0] * rho).sum(-1) / (g[:, 0, 0] ** 2).sum(-1).clamp(min=1e-12)
    beta_c1 = torch.stack([torch.sqrt(b1_sq.clamp(min=0.0)), zero, zero, zero], dim=-1)

    # Case N=2: unknowns [b11, b12, b22]; L is [6, 3].
    L2 = torch.stack([g[:, 0, 0], 2 * g[:, 0, 1], g[:, 1, 1]], dim=-1)
    sol2 = _lstsq(L2, rho)
    b1 = torch.sqrt(sol2[:, 0].abs().clamp(min=1e-12))
    b2 = (torch.sqrt(sol2[:, 2].abs().clamp(min=1e-12)) * torch.sign(sol2[:, 1])
          * torch.sign(sol2[:, 0]))
    beta_c2 = torch.stack([b1, b2, zero, zero], dim=-1)

    # Case N=3: unknowns [b11, b12, b13, b22, b23, b33]; L is [6, 6].
    L3 = torch.stack([g[:, 0, 0], 2 * g[:, 0, 1], 2 * g[:, 0, 2], g[:, 1, 1], 2 * g[:, 1, 2],
                      g[:, 2, 2]], dim=-1)
    eye6 = torch.eye(6, dtype=V.dtype, device=V.device)
    sol3 = _solve(L3 + 1e-10 * eye6, rho[..., None])[..., 0]
    b1_3 = torch.sqrt(sol3[:, 0].abs().clamp(min=1e-12))
    b2_3 = (torch.sqrt(sol3[:, 3].abs().clamp(min=1e-12)) * torch.sign(sol3[:, 1])
            * torch.sign(sol3[:, 0]))
    b3_3 = (torch.sqrt(sol3[:, 5].abs().clamp(min=1e-12)) * torch.sign(sol3[:, 2])
            * torch.sign(sol3[:, 0]))
    beta_c3 = torch.stack([b1_3, b2_3, b3_3, zero], dim=-1)
    return torch.stack([beta_c1, beta_c2, beta_c3], dim=1)


def _beta_residuals_and_jacobian(betas, diffs, rho):
    """Residuals r [B, C, 6] of betas [B, C, 4] (C candidates a frame) on
    the 6 control-point distances, and dr/db [B, C, 6, 4] in closed form.

    r_p(b) = |d_p(b)|^2 - rho_p with d_p(b) = sum_k b_k D_kp, so
    dr_p / db_k = 2 d_p(b) . D_kp: the Jacobian JAX takes with jax.jacfwd.
    diffs [B, 4, 6, 3] (`_pair_diffs`); rho [B, 6] the squared distances."""
    d = torch.einsum("zck,zkps->zcps", betas, diffs)  # [B, C, 6, 3]
    r = (d * d).sum(-1) - rho[:, None]
    J = 2.0 * torch.einsum("zcps,zkps->zcpk", d, diffs)
    return r, J


def _beta_gn(betas: torch.Tensor, V: torch.Tensor, dist_w: torch.Tensor,
             iters: int = 8) -> torch.Tensor:
    """Gauss-Newton on betas [B, C, 4]: match the control-point distances.
    V [B, 4 basis, 4 ctrl, 3]; dist_w [B, 6]."""
    diffs, rho = _pair_diffs(V), dist_w ** 2
    eye4 = 1e-9 * torch.eye(4, dtype=betas.dtype, device=betas.device)
    for _ in range(iters):
        r, J = _beta_residuals_and_jacobian(betas, diffs, rho)
        Jt = J.transpose(-1, -2)
        betas = betas + _solve(Jt @ J + eye4, -(Jt @ r[..., None]))[..., 0]
    return betas


def _kabsch(pw: torch.Tensor, pc: torch.Tensor, w: torch.Tensor):
    """Weighted rigid alignment world->camera over [..., N, 3] points:
    returns (R [..., 3, 3], t [..., 3])."""
    wsum = w.sum(-1).clamp(min=1e-9)[..., None]
    mu_w = (pw * w[..., None]).sum(-2) / wsum
    mu_c = (pc * w[..., None]).sum(-2) / wsum
    H = ((pc - mu_c[..., None, :]) * w[..., None]).transpose(-1, -2) @ (pw - mu_w[..., None, :])
    U, _, Vt = _guarded(torch.linalg.svd, H, 2)
    d = torch.linalg.det(U @ Vt)
    D = torch.ones(H.shape[:-1], dtype=H.dtype, device=H.device)
    D = torch.cat([D[..., :2], d[..., None]], dim=-1)
    R = (U * D[..., None, :]) @ Vt
    t = mu_c - (R @ mu_w[..., None])[..., 0]
    return R, t


@fp32_matmuls()
def epnp_solve(
    pts3d: torch.Tensor,
    pts2d: torch.Tensor,
    K: torch.Tensor,
    mask: torch.Tensor,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """EPnP pose from masked correspondences, per frame.

    pts3d [B, N, 3] world points; pts2d [B, N, 2] pixels; K [B, 3, 3];
    mask [B, N] bool (at least 4 true entries for a meaningful answer).
    Returns (R [B, 3, 3] world->cam, t [B, 3], ok [B] bool); a frame that
    is not ok gets the identity pose, never a NaN."""
    dtype = torch.promote_types(pts3d.dtype, torch.float32)
    pts3d, pts2d, K = pts3d.to(dtype), pts2d.to(dtype), K.to(dtype)
    w = mask.to(dtype)
    B = pts3d.shape[0]

    ctrl_w, spread = _control_points(pts3d, w)  # [B, 4, 3], [B]
    alphas = _barycentric(pts3d, ctrl_w)  # [B, N, 4]
    MtM = _build_MtM(alphas, pts2d, K, w)
    _, vecs = _guarded(torch.linalg.eigh, MtM, 2)  # ascending eigenvalues
    V = vecs[..., :4].transpose(-1, -2).reshape(B, 4, 4, 3)  # [B, basis k, ctrl j, xyz]

    dist_w = torch.stack([torch.linalg.vector_norm(ctrl_w[:, i] - ctrl_w[:, j], dim=-1)
                          for i, j in _PAIRS], dim=-1)  # [B, 6]

    # Standard EPnP: try the N=1/2/3 beta cases, Gauss-Newton refine each on
    # the distance constraints, and keep the candidate with the lowest
    # weighted reprojection error.
    betas = _beta_gn(_beta_inits(V, dist_w), V, dist_w)  # [B, 3, 4]
    ctrl_c = torch.einsum("zck,zkjs->zcjs", betas, V)  # [B, 3, 4, 3]
    pc = alphas[:, None] @ ctrl_c  # [B, 3, N, 3] camera-frame points
    # Fix the global sign so the (weighted) average depth is positive.
    depth_sign = torch.sign((pc[..., 2] * w[:, None]).sum(-1))
    depth_sign = torch.where(depth_sign == 0, 1.0, depth_sign)
    pc = pc * depth_sign[..., None, None]
    pw3 = pts3d[:, None].expand_as(pc)
    w3 = w[:, None].expand(-1, 3, -1)
    Rs, ts = _kabsch(pw3, pc, w3)  # [B, 3, 3, 3], [B, 3, 3]
    p_cam = pw3 @ Rs.transpose(-1, -2) + ts[..., None, :]
    pix = p_cam @ K[:, None].transpose(-1, -2)
    z = pix[..., 2].abs().clamp(min=1e-9)
    uv = pix[..., :2] / z[..., None]
    errs = (torch.linalg.vector_norm(uv - pts2d[:, None], dim=-1) * w3).sum(-1)
    errs = torch.where(torch.isfinite(errs), errs, torch.inf)  # [B, 3]
    best = errs.argmin(dim=-1)  # first minimum, as jnp.argmin
    R = Rs[torch.arange(B, device=Rs.device), best]
    t = ts[torch.arange(B, device=ts.device), best]
    # A cloud with no spread (all points equal, within the variance clamp
    # of _control_points) has no pose: not ok, where JAX reports ok.
    ok = (mask.sum(-1) >= 4) & (spread > 1e-12) & _finite(R, 2) & _finite(t, 1)
    R = torch.where(ok[:, None, None], R, torch.eye(3, dtype=dtype, device=R.device))
    t = torch.where(ok[:, None], t, 0.0)
    return R, t, ok
