"""Closed-form P3P minimal solver (Grunert), batched over leading axes.

Port of onepose_tpu/geometry/p3p.py. Bearing vectors, Grunert's quartic in
the distance ratio (roots by Durand-Kerner iteration in complex64), a
Newton polish of the three distances, then rigid alignment of two triads.
Each sample gives up to 4 candidate poses; RANSAC scores them all. Where
JAX vmaps over samples and roots, the port carries them as batch axes.
"""

from __future__ import annotations

import torch


def _solve_quartic(c4, c3, c2, c1, c0, iters: int = 40):
    """Roots of c4 x^4 + ... + c0 ([...] coefficients) by Durand-Kerner.
    Returns (roots [..., 4] real parts, is_real [..., 4])."""
    c4 = torch.where(c4.abs() < 1e-10, 1e-10, c4)
    b3, b2, b1, b0 = ((c / c4).to(torch.complex64) for c in (c3, c2, c1, c0))

    def p(x):
        return (((x + b3[..., None]) * x + b2[..., None]) * x + b1[..., None]) * x + b0[..., None]

    bound = 1.0 + torch.maximum(
        torch.maximum(b3.abs(), b2.abs()), torch.maximum(b1.abs(), b0.abs())
    )
    seed = torch.tensor([(0.4 + 0.9j) ** k for k in range(4)], dtype=torch.complex64,
                        device=c4.device)
    x = seed * bound[..., None].to(torch.complex64)
    eye_c = torch.eye(4, dtype=torch.complex64, device=c4.device)
    tiny = torch.tensor(1e-12 + 0j, dtype=torch.complex64, device=c4.device)
    for _ in range(iters):
        diff = x[..., :, None] - x[..., None, :] + eye_c  # diagonal 0 -> 1
        denom = torch.prod(diff, dim=-1)
        denom = torch.where(denom.abs() < 1e-12, tiny, denom)
        x = x - p(x) / denom
    is_real = x.imag.abs() < 1e-3 * (1.0 + x.real.abs())
    return x.real.float(), is_real


def _solve3x3(A: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """x = A^-1 b for [..., 3, 3] systems via the adjugate (no pivoting)."""
    a00, a01, a02 = A[..., 0, 0], A[..., 0, 1], A[..., 0, 2]
    a10, a11, a12 = A[..., 1, 0], A[..., 1, 1], A[..., 1, 2]
    a20, a21, a22 = A[..., 2, 0], A[..., 2, 1], A[..., 2, 2]
    c00 = a11 * a22 - a12 * a21
    c01 = a12 * a20 - a10 * a22
    c02 = a10 * a21 - a11 * a20
    det = a00 * c00 + a01 * c01 + a02 * c02
    det = torch.where(det.abs() < 1e-20, 1e-20, det)
    c10 = a02 * a21 - a01 * a22
    c11 = a00 * a22 - a02 * a20
    c12 = a01 * a20 - a00 * a21
    c20 = a01 * a12 - a02 * a11
    c21 = a02 * a10 - a00 * a12
    c22 = a00 * a11 - a01 * a10
    b0, b1, b2 = b[..., 0], b[..., 1], b[..., 2]
    x0 = (c00 * b0 + c10 * b1 + c20 * b2) / det
    x1 = (c01 * b0 + c11 * b1 + c21 * b2) / det
    x2 = (c02 * b0 + c12 * b1 + c22 * b2) / det
    return torch.stack([x0, x1, x2], dim=-1)


def _norm(x: torch.Tensor) -> torch.Tensor:
    return torch.linalg.vector_norm(x, dim=-1)


def _triad(p1, p2, p3):
    e1 = p2 - p1
    e1 = e1 / _norm(e1).clamp(min=1e-12)[..., None]
    n = torch.linalg.cross(e1, p3 - p1, dim=-1)
    e3 = n / _norm(n).clamp(min=1e-12)[..., None]
    e2 = torch.linalg.cross(e3, e1, dim=-1)
    return torch.stack([e1, e2, e3], dim=-1)  # columns


def p3p_solve(
    pts3d: torch.Tensor, pts2d: torch.Tensor, K: torch.Tensor
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """P3P from 3 correspondences per sample.

    pts3d [..., 3, 3] world points; pts2d [..., 3, 2] pixels; K [..., 3, 3]
    (broadcast). Returns (R [..., 4, 3, 3], t [..., 4, 3], valid [..., 4]),
    world->camera."""
    K = K.float()
    fx, fy = K[..., 0, 0, None], K[..., 1, 1, None]
    cx, cy = K[..., 0, 2, None], K[..., 1, 2, None]
    x = (pts2d[..., 0] - cx) / fx
    y = (pts2d[..., 1] - cy) / fy
    v = torch.stack([x, y, torch.ones_like(x)], dim=-1)
    v = v / _norm(v)[..., None]  # [..., 3, 3] bearings

    P1, P2, P3 = pts3d[..., 0, :], pts3d[..., 1, :], pts3d[..., 2, :]
    a = _norm(P2 - P3)
    b = _norm(P1 - P3).clamp(min=1e-9)
    c = _norm(P1 - P2)
    cos_a = (v[..., 1, :] * v[..., 2, :]).sum(-1)
    cos_b = (v[..., 0, :] * v[..., 2, :]).sum(-1)
    cos_g = (v[..., 0, :] * v[..., 1, :]).sum(-1)

    a2b = (a * a) / (b * b)
    c2b = (c * c) / (b * b)
    acb = a2b - c2b
    # Grunert's system (see the JAX module): u(v) = N(v) / D(v) substituted
    # into the second distance equation gives N^2 + D^2 Q - 2 cos_g N D = 0.
    N = [1.0 + acb, -2.0 * acb * cos_b, acb - 1.0]
    D = [2.0 * cos_g, -2.0 * cos_a]
    Q = [1.0 - c2b, 2.0 * c2b * cos_b, -c2b]

    def polymul(p, q, out_len):
        out = [torch.zeros_like(acb) for _ in range(out_len)]
        for i in range(len(p)):
            for j in range(len(q)):
                out[i + j] = out[i + j] + p[i] * q[j]
        return out

    nn_ = polymul(N, N, 5)
    ddq = polymul(polymul(D, D, 3), Q, 5)
    nd = polymul(N, D, 5)
    poly = [nn_[i] + ddq[i] - 2.0 * cos_g * nd[i] for i in range(5)]
    roots, is_real = _solve_quartic(poly[4], poly[3], poly[2], poly[1], poly[0])  # [..., 4]

    # Per root: broadcast the sample's quantities over a root axis.
    ex = lambda t: t[..., None]  # noqa: E731
    cos_a4, cos_b4, cos_g4, acb4 = ex(cos_a), ex(cos_b), ex(cos_g), ex(acb)
    a4, b4, c4 = ex(a), ex(b), ex(c)
    vr = roots
    denom_u = 2.0 * (cos_g4 - vr * cos_a4)
    denom_u = torch.where(denom_u.abs() < 1e-9, 1e-9, denom_u)
    u = ((-1.0 + acb4) * vr * vr - 2.0 * acb4 * cos_b4 * vr + 1.0 + acb4) / denom_u
    s1 = torch.sqrt((b4 * b4) / (vr * vr - 2.0 * vr * cos_b4 + 1.0).clamp(min=1e-12))
    s = torch.stack([s1, u * s1, vr * s1], dim=-1)  # [..., 4, 3]

    # Newton polish on the original distance system.
    eye3 = torch.eye(3, dtype=s.dtype, device=s.device)
    for _ in range(4):
        s1_, s2_, s3_ = s.unbind(-1)
        F = torch.stack(
            [
                s1_ * s1_ + s2_ * s2_ - 2 * s1_ * s2_ * cos_g4 - c4 * c4,
                s1_ * s1_ + s3_ * s3_ - 2 * s1_ * s3_ * cos_b4 - b4 * b4,
                s2_ * s2_ + s3_ * s3_ - 2 * s2_ * s3_ * cos_a4 - a4 * a4,
            ],
            dim=-1,
        )
        zero = torch.zeros_like(s1_)
        J = 2.0 * torch.stack(
            [
                torch.stack([s1_ - s2_ * cos_g4, s2_ - s1_ * cos_g4, zero], dim=-1),
                torch.stack([s1_ - s3_ * cos_b4, zero, s3_ - s1_ * cos_b4], dim=-1),
                torch.stack([zero, s2_ - s3_ * cos_a4, s3_ - s2_ * cos_a4], dim=-1),
            ],
            dim=-2,
        )
        s = s + _solve3x3(J + 1e-9 * eye3, -F)

    s1, s2, s3 = s.unbind(-1)
    v4 = v[..., None, :, :]  # [..., 1, 3, 3]
    C1 = s1[..., None] * v4[..., 0, :]
    C2 = s2[..., None] * v4[..., 1, :]
    C3 = s3[..., None] * v4[..., 2, :]
    Tw = _triad(P1, P2, P3)[..., None, :, :]  # [..., 1, 3, 3]
    Tc = _triad(C1, C2, C3)  # [..., 4, 3, 3]
    R = Tc @ Tw.transpose(-1, -2)
    t = C1 - (R @ P1[..., None, :, None])[..., 0]
    ok = (
        (s1 > 0)
        & (s2 > 0)
        & (s3 > 0)
        & torch.isfinite(R).flatten(-2).all(-1)
        & torch.isfinite(t).all(-1)
    )
    return R, t, ok & is_real
