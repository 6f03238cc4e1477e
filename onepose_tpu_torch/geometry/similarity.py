"""Batched 2D similarity (4-DoF) RANSAC.

Port of onepose_tpu/geometry/similarity.py, batched over a leading view
axis where the JAX detector vmaps over reference views: z -> alpha z + beta
over complex coordinates (alpha = s e^{i theta}) from 2-point minimal
samples, a fixed batch of hypotheses scored at once, then a weighted
least-squares refit on the inliers, kept where it has no fewer inliers.

Random draws: JAX draws `jax.random.gumbel(key, (n_hyp, n))` per view and
takes each hypothesis' two points as the top 2 of the draws plus the mask's
log (0 or -inf). The port takes those draws as `gumbel [V, n_hyp, n]` (the
parity tests inject JAX's), or draws them from a `torch.Generator`. The top
2 is a stable descending sort, as jax.lax.top_k takes the lowest index
first on ties (the -inf of masked points).
"""

from __future__ import annotations

from typing import Optional

import torch

from onepose_tpu_torch.utils.precision import fp32_matmuls


def _complex(p: torch.Tensor) -> torch.Tensor:
    return torch.complex(p[..., 0], p[..., 1])


def _fit_two_point(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Similarity from 2 correspondences a, b [..., 2, 2]; returns [..., 4]:
    (re alpha, im alpha, re beta, im beta)."""
    az, az2 = _complex(a[..., 0, :]), _complex(a[..., 1, :])
    bz, bz2 = _complex(b[..., 0, :]), _complex(b[..., 1, :])
    denom = az2 - az
    denom = torch.where(denom.abs() < 1e-9, torch.full_like(denom, 1e-9), denom)
    alpha = (bz2 - bz) / denom
    beta = bz - alpha * az
    return torch.stack([alpha.real, alpha.imag, beta.real, beta.imag], dim=-1)


def _apply(params: torch.Tensor, pts: torch.Tensor) -> torch.Tensor:
    """Apply (alpha, beta) params [..., 4] to points [..., N, 2] (the
    leading axes broadcast)."""
    ar, ai, br, bi = (params[..., k, None] for k in range(4))
    x, y = pts[..., 0], pts[..., 1]
    return torch.stack([ar * x - ai * y + br, ai * x + ar * y + bi], dim=-1)


def _refit_ls(src, dst, w):
    """Weighted least-squares similarity per view (closed form over complex):
    src, dst [V, N, 2], w [V, N] -> [V, 4]."""
    ws = w.sum(-1).clamp(min=1e-9)
    sz, dz = _complex(src), _complex(dst)
    mu_s = (sz * w).sum(-1) / ws
    mu_d = (dz * w).sum(-1) / ws
    ds, dd = sz - mu_s[:, None], dz - mu_d[:, None]
    num = (w * dd * torch.conj(ds)).sum(-1)
    den = (w * ds.abs() ** 2).sum(-1)
    alpha = num / den.clamp(min=1e-12)
    beta = mu_d - alpha * mu_s
    return torch.stack([alpha.real, alpha.imag, beta.real, beta.imag], dim=-1)


def gumbel_draws(shape, generator: Optional[torch.Generator] = None,
                 device=None) -> torch.Tensor:
    """Standard Gumbel draws -log(-log(u)), u uniform in [tiny, 1)."""
    u = torch.rand(shape, generator=generator, device=device)
    return -torch.log(-torch.log(u.clamp(min=torch.finfo(torch.float32).tiny)))


@fp32_matmuls()
def ransac_similarity(
    src: torch.Tensor,
    dst: torch.Tensor,
    mask: torch.Tensor,
    inlier_px: float = 6.0,
    n_hyp: int = 128,
    gumbel: Optional[torch.Tensor] = None,
    generator: Optional[torch.Generator] = None,
) -> dict:
    """RANSAC similarity src -> dst per view.

    src, dst [V, N, 2]; mask [V, N]; gumbel [V, n_hyp, N] or None (drawn
    from `generator` on src's device). Returns dict(params [V, 4], A [V,
    2, 3] affine (cv2 layout), inliers [V, N], num_inliers [V], ok [V])."""
    src, dst = src.float(), dst.float()
    V, n = src.shape[:2]
    dev = src.device
    if gumbel is None:
        gumbel = gumbel_draws((V, n_hyp, n), generator,
                              generator.device if generator is not None else dev)
    gumbel = gumbel.to(device=dev, dtype=torch.float32)
    if gumbel.shape != (V, n_hyp, n):
        raise ValueError(f"gumbel must be [{V}, {n_hyp}, {n}], got {tuple(gumbel.shape)}")
    logits = torch.where(mask, 0.0, -torch.inf)
    g = gumbel + logits[:, None, :]
    idx = torch.sort(g, dim=-1, descending=True, stable=True)[1][..., :2]  # [V, H, 2]

    def take(p):  # p [V, N, 2] at idx -> [V, H, 2, 2]
        flat = idx.reshape(V, -1)
        return torch.gather(p, 1, flat[..., None].expand(-1, -1, 2)).reshape(V, n_hyp, 2, 2)

    params = _fit_two_point(take(src), take(dst))  # [V, H, 4]
    pred = _apply(params, src[:, None])  # [V, H, N, 2]
    err = torch.linalg.vector_norm(pred - dst[:, None], dim=-1)
    inl = (err < inlier_px) & mask[:, None, :]
    counts = inl.sum(-1)
    best = counts.argmax(dim=-1)  # first maximum, as jnp.argmax
    ar = torch.arange(V, device=dev)
    inliers = inl[ar, best]
    best_count = counts[ar, best]

    refined = _refit_ls(src, dst, inliers.to(src.dtype))
    err_r = torch.linalg.vector_norm(_apply(refined, src) - dst, dim=-1)
    inliers_r = (err_r < inlier_px) & mask
    use_refined = inliers_r.sum(-1) >= best_count
    out_params = torch.where(use_refined[:, None], refined, params[ar, best])
    out_inliers = torch.where(use_refined[:, None], inliers_r, inliers)

    a_r, a_i, b_r, b_i = out_params.unbind(-1)
    A = torch.stack([torch.stack([a_r, -a_i, b_r], -1), torch.stack([a_i, a_r, b_i], -1)], dim=-2)
    num = out_inliers.sum(-1)
    return {"params": out_params, "A": A, "inliers": out_inliers, "num_inliers": num,
            "ok": num >= 2}
