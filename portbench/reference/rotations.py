"""Rotation parameterizations: quaternion, rotation matrix, angle-axis.

A frozen copy of the port's `geometry/rotations.py`, used by the
benchmark's reference RANSAC-PnP. qvec is (w, x, y, z), Hamilton
convention, unit norm; poses are world->camera (x_cam = R @ x_world + t).
Every function is branch-free over leading batch axes.
"""

from __future__ import annotations

import torch


def qvec_to_rotmat(qvec: torch.Tensor) -> torch.Tensor:
    """Unit quaternion (w, x, y, z) [..., 4] -> rotation matrix [..., 3, 3]."""
    w, x, y, z = qvec.unbind(-1)
    r = torch.stack(
        [
            1 - 2 * (y * y + z * z),
            2 * (x * y - w * z),
            2 * (x * z + w * y),
            2 * (x * y + w * z),
            1 - 2 * (x * x + z * z),
            2 * (y * z - w * x),
            2 * (x * z - w * y),
            2 * (y * z + w * x),
            1 - 2 * (x * x + y * y),
        ],
        dim=-1,
    )
    return r.reshape(qvec.shape[:-1] + (3, 3))


def rotmat_to_qvec(R: torch.Tensor) -> torch.Tensor:
    """Rotation matrix [..., 3, 3] -> unit quaternion (w, x, y, z) [..., 4].

    Shepperd-style: all four candidates, the one with the largest pivot
    selected (first on ties), canonical sign w >= 0."""
    m00, m01, m02 = R[..., 0, 0], R[..., 0, 1], R[..., 0, 2]
    m10, m11, m12 = R[..., 1, 0], R[..., 1, 1], R[..., 1, 2]
    m20, m21, m22 = R[..., 2, 0], R[..., 2, 1], R[..., 2, 2]
    tr = m00 + m11 + m22
    qw = torch.stack(
        [1.0 + tr, 1.0 + m00 - m11 - m22, 1.0 + m11 - m00 - m22, 1.0 + m22 - m00 - m11],
        dim=-1,
    )
    qw = torch.sqrt(qw.clamp(min=1e-12)) / 2.0
    w0, x1, y2, z3 = qw.unbind(-1)
    cand = torch.stack(
        [
            torch.stack([w0, (m21 - m12) / (4 * w0), (m02 - m20) / (4 * w0),
                         (m10 - m01) / (4 * w0)], dim=-1),
            torch.stack([(m21 - m12) / (4 * x1), x1, (m01 + m10) / (4 * x1),
                         (m02 + m20) / (4 * x1)], dim=-1),
            torch.stack([(m02 - m20) / (4 * y2), (m01 + m10) / (4 * y2), y2,
                         (m12 + m21) / (4 * y2)], dim=-1),
            torch.stack([(m10 - m01) / (4 * z3), (m02 + m20) / (4 * z3),
                         (m12 + m21) / (4 * z3), z3], dim=-1),
        ],
        dim=-2,
    )  # [..., 4 candidates, 4]
    pick = qw.argmax(dim=-1)
    q = torch.gather(cand, -2, pick[..., None, None].expand(pick.shape + (1, 4)))[..., 0, :]
    q = q / torch.linalg.vector_norm(q, dim=-1, keepdim=True)
    return q * torch.where(q[..., :1] < 0, -1.0, 1.0)


def angle_axis_to_rotmat(aa: torch.Tensor) -> torch.Tensor:
    """Angle-axis [..., 3] -> rotation matrix [..., 3, 3] (Rodrigues);
    first order I + skew(aa) below 1e-8 rad."""
    theta = torch.linalg.vector_norm(aa, dim=-1, keepdim=True)
    small = theta < 1e-8
    axis = aa / torch.where(small, torch.ones_like(theta), theta)
    x, y, z = axis.unbind(-1)
    t = theta[..., 0]
    c, s = torch.cos(t), torch.sin(t)
    C = 1 - c
    R = torch.stack(
        [
            c + x * x * C, x * y * C - z * s, x * z * C + y * s,
            y * x * C + z * s, c + y * y * C, y * z * C - x * s,
            z * x * C - y * s, z * y * C + x * s, c + z * z * C,
        ],
        dim=-1,
    ).reshape(aa.shape[:-1] + (3, 3))
    ax, ay, az = aa.unbind(-1)
    one = torch.ones_like(ax)
    R_small = torch.stack(
        [one, -az, ay, az, one, -ax, -ay, ax, one], dim=-1
    ).reshape(aa.shape[:-1] + (3, 3))
    return torch.where(small[..., None], R_small, R)


def rotmat_to_angle_axis(R: torch.Tensor) -> torch.Tensor:
    """Rotation matrix [..., 3, 3] -> angle-axis [..., 3], via the quaternion."""
    q = rotmat_to_qvec(R)
    w = q[..., 0].clamp(-1.0, 1.0)
    v = q[..., 1:]
    vn = torch.linalg.vector_norm(v, dim=-1)
    theta = 2.0 * torch.atan2(vn, w)
    scale = torch.where(vn < 1e-12, 2.0, theta / vn.clamp(min=1e-12))
    return v * scale[..., None]


def angle_axis_rotate_point(aa: torch.Tensor, p: torch.Tensor) -> torch.Tensor:
    """Rotate points p [..., 3] by angle-axis aa [..., 3] without building R."""
    theta2 = (aa * aa).sum(dim=-1, keepdim=True)
    theta = torch.sqrt(theta2.clamp(min=1e-24))
    small = theta2 < 1e-16
    axis = aa / theta
    c, s = torch.cos(theta), torch.sin(theta)
    d = (axis * p).sum(dim=-1, keepdim=True)
    cross = torch.linalg.cross(axis.expand_as(p), p, dim=-1)
    rotated = p * c + cross * s + axis * d * (1 - c)
    return torch.where(small, p + torch.linalg.cross(aa.expand_as(p), p, dim=-1), rotated)
