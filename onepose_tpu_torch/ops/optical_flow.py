"""Pyramidal Lucas-Kanade optical flow.

Port of onepose_tpu/ops/optical_flow.py (the reference tracker's
cv2.calcOpticalFlowPyrLK: a 15 x 15 window, 3 levels, 10 iterations, eps
0.03). Coarse to fine over a 3-level pyramid; per point a fixed-iteration
LK update on a bilinearly sampled window. The JAX package vmaps one point;
here every point is a row of [N, (2r+1)^2] windows, and each level's
pyramid image and gradients are computed once for all points (XLA hoists
them out of the vmap).

Written to the JAX package's numerics:
- the 2x downsample blurs with the 5 x 5 binomial kernel, zero-padded
  (`convolve2d(mode="same")`; the kernel is symmetric, so correlation is
  convolution), then takes every other row and column;
- the gradients are central differences, zero on the border rows and
  columns;
- the bilinear sample clips the integer corner to [0, size - 2] but not
  the weights, so outside the image it extrapolates linearly (written by
  hand: `F.grid_sample`'s border rules differ);
- the 2 x 2 system G + 1e-9 I is inverted in closed form. Where G is
  singular (a blank window, a straight edge: 1e-9 vanishes against a G of
  order 1e3 in fp32), the inverse is inf or NaN, as `jnp.linalg.inv`
  returns it without complaint; `torch.linalg.inv` would raise there. Such
  a point fails the eigenvalue test, so its status is False;
- all 10 iterations run, a converged point frozen by `torch.where` (no
  early exit, so no host read).
Full fp32, TF32 off (the blur is a convolution).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from onepose_tpu_torch.utils.precision import fp32_matmuls


def _downsample2(img: torch.Tensor) -> torch.Tensor:
    """Anti-aliased 2x downsample ([H, W] -> [ceil(H/2), ceil(W/2)])."""
    k = torch.tensor([1.0, 4.0, 6.0, 4.0, 1.0], dtype=img.dtype, device=img.device)
    k2d = torch.outer(k, k)
    k2d = k2d / k2d.sum()
    blurred = F.conv2d(img[None, None], k2d[None, None], padding=2)[0, 0]
    return blurred[::2, ::2]


def _grad(img: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Central-difference gradients, zero on the border."""
    gx = torch.zeros_like(img)
    gy = torch.zeros_like(img)
    gx[:, 1:-1] = (img[:, 2:] - img[:, :-2]) * 0.5
    gy[1:-1, :] = (img[2:, :] - img[:-2, :]) * 0.5
    return gx, gy


def _bilinear(img: torch.Tensor, ys: torch.Tensor, xs: torch.Tensor) -> torch.Tensor:
    """img [H, W] at (ys, xs) of any shape; corners clipped, weights not."""
    h, w = img.shape
    x0 = torch.floor(xs)
    y0 = torch.floor(ys)
    wx = xs - x0
    wy = ys - y0
    x0i = x0.to(torch.int64).clamp(0, w - 2)
    y0i = y0.to(torch.int64).clamp(0, h - 2)
    flat = img.reshape(-1)
    base = y0i * w + x0i
    v00 = flat[base]
    v10 = flat[base + 1]
    v01 = flat[base + w]
    v11 = flat[base + w + 1]
    return (v00 * (1 - wx) * (1 - wy) + v10 * wx * (1 - wy)
            + v01 * (1 - wx) * wy + v11 * wx * wy)


def _track_level(im0, im1, p0, v, oy, ox, win_radius, iterations, eps, min_eig):
    """One pyramid level for all points p0 [N, 2] from flow v [N, 2]:
    (v_new [N, 2], ok [N])."""
    gx, gy = _grad(im0)
    ys = p0[:, 1:2] + oy  # [N, T]
    xs = p0[:, 0:1] + ox
    t0 = _bilinear(im0, ys, xs)
    ix = _bilinear(gx, ys, xs)
    iy = _bilinear(gy, ys, xs)
    gxx = (ix * ix).sum(-1)
    gxy = (ix * iy).sum(-1)
    gyy = (iy * iy).sum(-1)
    tr = gxx + gyy
    det = gxx * gyy - gxy * gxy
    lam_min = tr / 2 - torch.sqrt(torch.clamp(tr * tr / 4 - det, min=0.0))
    ok = lam_min > min_eig * (2 * win_radius + 1) ** 2
    # (G + 1e-9 I)^-1 in closed form: inf / NaN where it is singular.
    a, d = gxx + 1e-9, gyy + 1e-9
    det_r = a * d - gxy * gxy
    i00, i01, i11 = d / det_r, -gxy / det_r, a / det_r

    done = torch.zeros_like(ok)
    for _ in range(iterations):
        t1 = _bilinear(im1, ys + v[:, 1:2], xs + v[:, 0:1])
        diff = t0 - t1
        b0 = (diff * ix).sum(-1)
        b1 = (diff * iy).sum(-1)
        dv = torch.stack([i00 * b0 + i01 * b1, i01 * b0 + i11 * b1], dim=-1)
        v_new = v + dv
        done_new = done | (torch.linalg.vector_norm(dv, dim=-1) < eps)
        v = torch.where(done[:, None], v, v_new)
        done = done_new
    return v, ok


@fp32_matmuls()
def pyramidal_lk(
    img0: torch.Tensor,
    img1: torch.Tensor,
    pts: torch.Tensor,
    win_radius: int = 7,
    num_levels: int = 3,
    iterations: int = 10,
    eps: float = 0.03,
    min_eig: float = 1e-4,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Track points from img0 to img1.

    img0 / img1: [H, W] grayscale float on one device; pts: [N, 2] (x, y).
    Returns (new_pts [N, 2], status [N] bool). win_radius 7 = a 15 x 15
    window."""
    h, w = img0.shape
    pyr0, pyr1 = [img0], [img1]
    for _ in range(num_levels - 1):
        pyr0.append(_downsample2(pyr0[-1]))
        pyr1.append(_downsample2(pyr1[-1]))

    offs = torch.arange(-win_radius, win_radius + 1, dtype=img0.dtype, device=img0.device)
    oy, ox = torch.meshgrid(offs, offs, indexing="ij")
    oy, ox = oy.reshape(1, -1), ox.reshape(1, -1)

    p = pts.to(img0.dtype)
    v = torch.zeros_like(p)
    ok = torch.ones(p.shape[0], dtype=torch.bool, device=p.device)
    for lvl in range(num_levels - 1, -1, -1):
        v, ok_lvl = _track_level(pyr0[lvl], pyr1[lvl], p / 2.0**lvl, v, oy, ox, win_radius,
                                 iterations, eps, min_eig)
        ok = ok & ok_lvl
        if lvl > 0:
            v = v * 2.0
    new_p = p + v
    inside = ((new_p[:, 0] >= 0) & (new_p[:, 0] < w - 1)
              & (new_p[:, 1] >= 0) & (new_p[:, 1] < h - 1))
    return new_p, ok & inside
