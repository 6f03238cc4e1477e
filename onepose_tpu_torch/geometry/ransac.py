"""Fixed-iteration batched RANSAC-PnP + SE(3) Gauss-Newton refinement.

Port of onepose_tpu/geometry/ransac.py, batched over a leading frame axis
where JAX vmaps a per-frame function. P3P hypotheses from minimal samples,
preemptive two-stage scoring, Gauss-Newton refinement on the inliers.

With epnp_refit, EPnP on the consensus inliers (`geometry.epnp`) is a
second initialization of the refinement, taken per frame where its
inlier reprojection error is no larger than the best P3P pose's, as in the
JAX package.

Random draws: JAX draws `jax.random.uniform(key, (n_hyp, 3))` per frame.
The port takes those uniforms as `draws [B, n_hyp, 3]` (the parity tests
inject JAX's), or draws them from a `torch.Generator`.

Ties: hypotheses are ranked by integer inlier counts, where ties are the
norm, so every top-k is a stable descending sort (lowest index first, as
jax.lax.top_k) and argmax takes the first maximum, as jnp.argmax does.

Devices: `ransac_pnp` runs the plain version below (`ransac_pnp_plain`)
on CPU tensors and K9, the CUDA kernel pair of `ops/kernels/ransac_pnp.py`,
on CUDA tensors; on any other device it raises. It never falls back.

Spans (`utils.profiling.span`) of the plain version, in order: `pnp.sample`
(the inputs in fp32, the minimal samples), `pnp.p3p`, `pnp.preempt`,
`pnp.score`, `pnp.refine` (the EPnP re-solve and Gauss-Newton), `pnp.final`
(the final inliers and the pose). On the card: `pnp.hypotheses` (the inputs
and launch A), `pnp.refine` (launch B); with epnp_refit `pnp.score` (launch
B's second scoring) before `pnp.refine` (the EPnP choice, then the rest of
launch B).
"""

from __future__ import annotations

from typing import Optional

import torch

from onepose_tpu_torch.geometry.epnp import epnp_solve
from onepose_tpu_torch.geometry.p3p import p3p_solve
from onepose_tpu_torch.geometry.rotations import angle_axis_to_rotmat, rotmat_to_angle_axis
from onepose_tpu_torch.ops.kernels import ransac_pnp as k9
from onepose_tpu_torch.utils.precision import fp32_matmuls
from onepose_tpu_torch.utils.profiling import span


def _sample_minimal_sets(
    draws: torch.Tensor, order: torch.Tensor, n_valid: torch.Tensor
) -> torch.Tensor:
    """[B, H, k] valid indices from uniforms draws [B, H, k], sampled with
    replacement among the first n_valid entries of `order` [B, N]."""
    n = n_valid[:, None, None]
    r = torch.minimum(
        (draws * n.clamp(min=1).to(draws.dtype)).to(torch.int64), (n - 1).clamp(min=0)
    )
    b, h, k = r.shape
    return torch.gather(order, 1, r.reshape(b, h * k)).reshape(b, h, k)


def _reproj_err(R, t, K, pts3d, pts2d):
    """Reprojection error [..., N] of pts3d [..., N, 3] under poses R
    [..., 3, 3], t [..., 3] (leading axes broadcast); inf behind the camera."""
    p_cam = pts3d @ R.transpose(-1, -2) + t[..., None, :]
    pix = p_cam @ K.transpose(-1, -2)
    z = pix[..., 2]
    uv = pix[..., :2] / z.abs().clamp(min=1e-9)[..., None]
    err = torch.linalg.vector_norm(uv - pts2d, dim=-1)
    return torch.where(z > 1e-6, err, torch.inf)


def _skew(v: torch.Tensor) -> torch.Tensor:
    """[..., 3] -> [..., 3, 3] cross-product matrices."""
    x, y, z = v.unbind(-1)
    o = torch.zeros_like(x)
    return torch.stack([o, -z, y, z, o, -x, -y, x, o], dim=-1).reshape(v.shape + (3,))


def _rotmat_derivatives(aa: torch.Tensor) -> torch.Tensor:
    """dR/daa_i [B, 3 (i), 3, 3] of angle_axis_to_rotmat at aa [B, 3].

    Closed form (Gallego & Yezzi, "A compact formula for the derivative of
    a 3-D rotation in exponential coordinates", 2015):
    dR/dv_i = (v_i [v]x + [v x (I - R) e_i]x) R / |v|^2, and [e_i]x on the
    first-order branch below 1e-8 rad, which is what differentiating the
    JAX function gives."""
    R = angle_axis_to_rotmat(aa)
    theta2 = (aa * aa).sum(-1)
    small = torch.sqrt(theta2) < 1e-8
    eye = torch.eye(3, dtype=aa.dtype, device=aa.device)
    I_minus_R = eye - R  # columns (I - R) e_i
    cross = torch.linalg.cross(
        aa[:, None, :].expand(-1, 3, -1), I_minus_R.transpose(1, 2), dim=-1
    )  # [B, 3 (i), 3]
    dR = (aa[:, :, None, None] * _skew(aa)[:, None] + _skew(cross)) @ R[:, None]
    dR = dR / torch.where(small, 1.0, theta2)[:, None, None, None]
    return torch.where(small[:, None, None, None], _skew(eye)[None], dR)


def _residuals_and_jacobian(x, K, pts3d, pts2d, weights):
    """Weighted reprojection residuals r [B, 2N] at x = (aa, t) [B, 6] and
    their Jacobian dr/dx [B, 2N, 6] in closed form: the derivative of the
    JAX package's residual function, which it takes with jax.jacfwd."""
    R = angle_axis_to_rotmat(x[:, :3])
    p_cam = pts3d @ R.transpose(1, 2) + x[:, None, 3:]  # [B, N, 3]
    pix = p_cam @ K.transpose(1, 2)
    z = pix[..., 2]
    zc = z.abs().clamp(min=1e-9)
    uv = pix[..., :2] / zc[..., None]
    w = weights[..., None]
    r = ((uv - pts2d) * w).reshape(x.shape[0], -1)

    dR = _rotmat_derivatives(x[:, :3])  # [B, 3, 3, 3]
    dp_daa = torch.einsum("bikl,bnl->bnki", dR, pts3d)  # [B, N, 3, 3]
    dp_dt = torch.eye(3, dtype=x.dtype, device=x.device).expand_as(dp_daa)
    dpix = K[:, None] @ torch.cat([dp_daa, dp_dt], dim=-1)  # [B, N, 3, 6]
    dz = torch.where(z.abs() > 1e-9, torch.sign(z), 0.0)[..., None, None] * dpix[..., 2:3, :]
    duv = (dpix[..., :2, :] * zc[..., None, None] - pix[..., :2, None] * dz) / (
        zc * zc
    )[..., None, None]
    J = (duv * w[..., None]).reshape(x.shape[0], -1, 6)
    return r, J


def _gn_refine(R0, t0, K, pts3d, pts2d, weights, iters: int = 5, damping: float = 1e-6):
    """Gauss-Newton on (angle-axis, t) per frame, minimizing weighted
    reprojection error. R0 [B, 3, 3], t0 [B, 3], pts [B, N, .], weights [B, N]."""
    x = torch.cat([rotmat_to_angle_axis(R0), t0], dim=-1)  # [B, 6]
    eye = damping * torch.eye(6, dtype=x.dtype, device=x.device)
    for _ in range(iters):
        r, J = _residuals_and_jacobian(x, K, pts3d, pts2d, weights)
        Jt = J.transpose(-1, -2)
        H = Jt @ J + eye
        # A frame whose H is singular gets non-finite steps, as from JAX's
        # LU, and comes back not ok; the batch does not raise (ROADMAP C20).
        dx = torch.linalg.solve_ex(H, -(Jt @ r[..., None]), check_errors=False)[0][..., 0]
        x = x + dx
    return angle_axis_to_rotmat(x[:, :3]), x[:, 3:]


def _take(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """x [B, M, ...] at idx [B, K] along axis 1."""
    shape = idx.shape + x.shape[2:]
    flat = idx.reshape(idx.shape + (1,) * (x.dim() - 2)).expand(shape)
    return torch.gather(x, 1, flat)


def _valid_first(mask: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(order [B, N], n_valid [B]): the valid indices first, in index order
    (a stable sort of ~mask), and how many there are."""
    return torch.argsort((~mask).to(torch.int8), dim=1, stable=True), mask.sum(dim=1)


def _p3p_hypotheses(pts2d, pts3d_s, K, idx) -> tuple:
    """The P3P poses of the samples idx [B, H, 3]: (Rs [B, 4H, 3, 3], ts
    [B, 4H, 3], oks [B, 4H]), up to 4 a sample; a sample that repeats an
    index is not ok."""
    B, n_hyp = idx.shape[:2]
    distinct = (
        (idx[..., 0] != idx[..., 1]) & (idx[..., 0] != idx[..., 2]) & (idx[..., 1] != idx[..., 2])
    )
    sample3d = _take(pts3d_s, idx.reshape(B, -1)).reshape(B, n_hyp, 3, 3)
    sample2d = _take(pts2d, idx.reshape(B, -1)).reshape(B, n_hyp, 3, 2)
    Rs, ts, oks = p3p_solve(sample3d, sample2d, K[:, None])  # [B, H, 4, ...]
    return (Rs.reshape(B, -1, 3, 3), ts.reshape(B, -1, 3),
            (oks & distinct[..., None]).reshape(B, -1))


def _preemptive_keep(Rs, ts, oks, pts2d, pts3d_s, K, order, n_valid,
                     reproj_threshold: float) -> torch.Tensor:
    """The first of the two scoring stages: every candidate ranked by its
    inliers on a compacted subset of the points (the first 128 valid
    ones); the indices [B, n_keep] of the best 64 (a stable sort)."""
    n_sub = min(128, pts2d.shape[1])
    n_keep = min(64, Rs.shape[1])
    sub_ids = order[:, :n_sub]
    sub_valid = torch.arange(n_sub, device=pts2d.device)[None, :] < n_valid[:, None]
    errs_sub = _reproj_err(
        Rs, ts, K[:, None], _take(pts3d_s, sub_ids)[:, None], _take(pts2d, sub_ids)[:, None]
    )  # [B, 4H, n_sub]
    counts_sub = ((errs_sub < reproj_threshold) & sub_valid[:, None, :]).sum(-1) * oks.int()
    return torch.sort(counts_sub, dim=-1, descending=True, stable=True)[1][:, :n_keep]


def _score_kept(Rs, ts, oks, keep, pts2d, pts3d_s, K, mask, reproj_threshold: float) -> tuple:
    """The second scoring stage: the kept candidates on every point. (R
    [B, 3, 3], t [B, 3], inliers [B, N], count [B]) of the first best.
    The count is multiplied by ok and the inlier mask is not, as in the
    JAX package: a failed P3P pose (R = 0) can be the best of a frame
    with no ok candidate (ROADMAP, reference behaviours)."""
    R_keep, t_keep = _take(Rs, keep), _take(ts, keep)
    errs = _reproj_err(R_keep, t_keep, K[:, None], pts3d_s[:, None], pts2d[:, None])
    inl = (errs < reproj_threshold) & mask[:, None, :]  # [B, keep, N]
    counts = inl.sum(-1) * _take(oks, keep).int()
    best = counts.argmax(dim=-1)[:, None]  # first maximum
    return (_take(R_keep, best)[:, 0], _take(t_keep, best)[:, 0], _take(inl, best)[:, 0],
            _take(counts, best)[:, 0])


def _uniform_draws(draws, B: int, n_hyp: int, generator, dev) -> torch.Tensor:
    """draws [B, n_hyp, 3] as fp32 on `dev`, drawn with `generator` when None."""
    dtype = torch.float32
    if draws is None:
        draws = torch.rand((B, n_hyp, 3), generator=generator, dtype=dtype,
                           device=generator.device if generator is not None else dev)
    draws = draws.to(device=dev, dtype=dtype)
    if draws.shape != (B, n_hyp, 3):
        raise ValueError(f"draws must be [{B}, {n_hyp}, 3], got {tuple(draws.shape)}")
    return draws


@fp32_matmuls()
def ransac_pnp(
    pts2d: torch.Tensor,
    pts3d: torch.Tensor,
    K: torch.Tensor,
    mask: torch.Tensor,
    draws: Optional[torch.Tensor] = None,
    reproj_threshold: float = 5.0,
    n_hyp: int = 512,
    refine_iters: int = 5,
    scale: float = 1000.0,
    epnp_refit: bool = False,
    generator: Optional[torch.Generator] = None,
) -> dict:
    """RANSAC PnP over masked 2D-3D matches, batched over frames.

    pts2d [B, N, 2]; pts3d [B, N, 3]; K [B, 3, 3]; mask [B, N] valid
    matches. draws [B, n_hyp, 3] uniforms in [0, 1), or None to draw them
    with `generator`. Each 3-point sample yields up to 4 P3P poses, all
    scored. Returns dict(pose [B, 4, 4], R, t, inliers [B, N],
    num_inliers [B], ok [B]); t in the input's units. epnp_refit adds the
    EPnP re-solve on the inliers as an initialization candidate of the
    Gauss-Newton refinement. `ransac_pnp_plain` on CPU tensors, K9 on CUDA
    tensors; a raise on any other device."""
    args = (pts2d, pts3d, K, mask, draws, reproj_threshold, n_hyp, refine_iters, scale,
            epnp_refit, generator)
    if pts2d.device.type == "cpu":
        return ransac_pnp_plain(*args)
    return _ransac_pnp_card(*args)


def _ransac_pnp_card(pts2d, pts3d, K, mask, draws, reproj_threshold, n_hyp, refine_iters,
                     scale, epnp_refit, generator) -> dict:
    """`ransac_pnp` as K9: launch A, then launch B; with epnp_refit, launch
    B's second scoring, the EPnP choice of `ransac_pnp_plain` on the card,
    then the rest of launch B from the chosen pose."""
    dtype = torch.float32
    with span("pnp.hypotheses"):
        pts2d, pts3d, K = (x.to(dtype).contiguous() for x in (pts2d, pts3d, K))
        mask = mask.contiguous()
        draws = _uniform_draws(draws, pts2d.shape[0], n_hyp, generator, pts2d.device)
        hyp = k9.hypotheses(pts2d, pts3d, K, mask, draws.contiguous(), reproj_threshold, scale)
    if not epnp_refit:
        with span("pnp.refine"):
            return k9.refine(hyp, pts2d, pts3d, K, mask, reproj_threshold, refine_iters, scale)
    with span("pnp.score"):
        best = k9.score(hyp, pts2d, pts3d, K, mask, reproj_threshold, scale)
    with span("pnp.refine"):
        pts3d_s = pts3d * scale
        R_ref, t_ref, ok_ref = epnp_solve(pts3d_s, pts2d, K, best.inliers)
        inl = best.inliers.to(dtype)
        use_ref = ok_ref & ((_reproj_err(R_ref, t_ref, K, pts3d_s, pts2d) * inl).sum(-1)
                            <= (_reproj_err(best.R, best.t, K, pts3d_s, pts2d) * inl).sum(-1))
        R1 = torch.where(use_ref[:, None, None], R_ref, best.R)
        t1 = torch.where(use_ref[:, None], t_ref, best.t)
        return k9.refine(hyp, pts2d, pts3d, K, mask, reproj_threshold, refine_iters, scale,
                         start=k9.start_from(R1, t1, best))


@fp32_matmuls()
def ransac_pnp_plain(
    pts2d: torch.Tensor,
    pts3d: torch.Tensor,
    K: torch.Tensor,
    mask: torch.Tensor,
    draws: Optional[torch.Tensor] = None,
    reproj_threshold: float = 5.0,
    n_hyp: int = 512,
    refine_iters: int = 5,
    scale: float = 1000.0,
    epnp_refit: bool = False,
    generator: Optional[torch.Generator] = None,
) -> dict:
    """`ransac_pnp` in plain PyTorch, on any device: what `ransac_pnp` runs
    on CPU tensors, and K9's yardstick on the card (where `ransac_pnp`
    never takes it)."""
    dtype = torch.float32
    dev = pts2d.device
    B = pts2d.shape[0]
    with span("pnp.sample"):
        pts2d = pts2d.to(dtype)
        pts3d_s = pts3d.to(dtype) * scale
        K = K.to(dtype)
        draws = _uniform_draws(draws, B, n_hyp, generator, dev)

        order, n_valid = _valid_first(mask)
        idx = _sample_minimal_sets(draws, order, n_valid)  # [B, H, 3]
    with span("pnp.p3p"):
        Rs, ts, oks = _p3p_hypotheses(pts2d, pts3d_s, K, idx)
    with span("pnp.preempt"):
        keep = _preemptive_keep(Rs, ts, oks, pts2d, pts3d_s, K, order, n_valid,
                                reproj_threshold)
    with span("pnp.score"):
        R_best, t_best, inliers, n_in = _score_kept(Rs, ts, oks, keep, pts2d, pts3d_s, K, mask,
                                                    reproj_threshold)

    # Refine on the inliers, from the best P3P pose or, with epnp_refit,
    # from the EPnP re-solve where its inlier error is no larger (a point
    # behind either camera makes both sums NaN or inf, as in JAX).
    with span("pnp.refine"):
        R1, t1 = R_best, t_best
        if epnp_refit:
            R_ref, t_ref, ok_ref = epnp_solve(pts3d_s, pts2d, K, inliers)
            inl = inliers.to(dtype)
            use_ref = ok_ref & ((_reproj_err(R_ref, t_ref, K, pts3d_s, pts2d) * inl).sum(-1)
                                <= (_reproj_err(R_best, t_best, K, pts3d_s, pts2d) * inl).sum(-1))
            R1 = torch.where(use_ref[:, None, None], R_ref, R_best)
            t1 = torch.where(use_ref[:, None], t_ref, t_best)
        R2, t2 = _gn_refine(R1, t1, K, pts3d_s, pts2d, inliers.to(dtype), iters=refine_iters)

    with span("pnp.final"):
        err_final = _reproj_err(R2, t2, K, pts3d_s, pts2d)
        inliers_final = (err_final < reproj_threshold) & mask
        ok = n_in >= 4
        eye3 = torch.eye(3, dtype=dtype, device=dev).expand(B, 3, 3)
        R_out = torch.where(ok[:, None, None], R2, eye3)
        t_out = torch.where(ok[:, None], t2 / scale, 0.0)
        pose = torch.eye(4, dtype=dtype, device=dev).repeat(B, 1, 1)
        pose[:, :3, :3] = R_out
        pose[:, :3, 3] = t_out
        inliers_out = inliers_final & ok[:, None]
        num_inliers = torch.where(ok, (inliers_final & mask).sum(-1), 0)
    return {
        "pose": pose,
        "R": R_out,
        "t": t_out,
        "inliers": inliers_out,
        "num_inliers": num_inliers,
        "ok": ok,
    }
