"""Two-view geometric verification on the device.

Port of onepose_tpu/sfm/verify.py. With the known relative pose of each
pair, matches are verified against the epipolar constraint: the symmetric
epipolar distance w.r.t. E = [t_rel]x R_rel lifted to pixels by the
intrinsics, batched over pairs, in full fp32 (TF32 off, `fp32_matmuls`).
"""

from __future__ import annotations

import torch

from onepose_tpu_torch.utils.precision import fp32_matmuls


def _skew(t: torch.Tensor) -> torch.Tensor:
    z = torch.zeros_like(t[..., 0])
    return torch.stack(
        [
            torch.stack([z, -t[..., 2], t[..., 1]], dim=-1),
            torch.stack([t[..., 2], z, -t[..., 0]], dim=-1),
            torch.stack([-t[..., 1], t[..., 0], z], dim=-1),
        ],
        dim=-2,
    )


@fp32_matmuls()
def fundamental_from_poses(K0, R0, t0, K1, R1, t1) -> torch.Tensor:
    """F mapping pixels of image 0 to epipolar lines in image 1.

    Poses are world->camera. Relative pose cam0->cam1: R_rel = R1 R0^T,
    t_rel = t1 - R_rel t0; E = [t_rel]x R_rel; F = K1^-T E K0^-1. Batched
    over leading dims."""
    R_rel = R1 @ R0.transpose(-1, -2)
    t_rel = t1 - torch.einsum("...ij,...j->...i", R_rel, t0)
    E = _skew(t_rel) @ R_rel
    # A singular K gives a non-finite F (its pairs then fail the gate), as
    # jnp.linalg.inv does; torch.linalg.inv would raise for the batch.
    K0_inv, K1_inv = (torch.linalg.inv_ex(k, check_errors=False)[0] for k in (K0, K1))
    return K1_inv.transpose(-1, -2) @ E @ K0_inv


@fp32_matmuls()
def symmetric_epipolar_distance(uv0: torch.Tensor, uv1: torch.Tensor,
                                F: torch.Tensor) -> torch.Tensor:
    """Symmetric epipolar distance in pixels for [..., N, 2] matches."""
    ones = torch.ones_like(uv0[..., :1])
    x0 = torch.cat([uv0, ones], dim=-1)
    x1 = torch.cat([uv1, ones], dim=-1)
    Fx0 = torch.einsum("...ij,...nj->...ni", F, x0)  # lines in image 1
    Ftx1 = torch.einsum("...ji,...nj->...ni", F, x1)  # lines in image 0
    num = torch.abs(torch.sum(x1 * Fx0, dim=-1))
    d1 = num / torch.clamp(torch.linalg.vector_norm(Fx0[..., :2], dim=-1), min=1e-9)
    d0 = num / torch.clamp(torch.linalg.vector_norm(Ftx1[..., :2], dim=-1), min=1e-9)
    return 0.5 * (d0 + d1)


@fp32_matmuls()
def epipolar_verify_matches(uv0, uv1, match_mask, K0, R0, t0, K1, R1, t1,
                            max_epipolar_px: float = 4.0) -> torch.Tensor:
    """Verify matched point pairs against the known relative pose.

    uv0/uv1: [..., N, 2] matched pixel pairs (uv1[i] matched to uv0[i]);
    match_mask: [..., N] validity. Returns the refined mask. The 4 px gate
    mirrors COLMAP's default two-view geometry max error."""
    F = fundamental_from_poses(K0, R0, t0, K1, R1, t1)
    d = symmetric_epipolar_distance(uv0, uv1, F)
    return match_mask & (d < max_epipolar_px)
