"""Parity of the port's EPnP (geometry/epnp.py) and RANSAC-PnP's EPnP refit
with the JAX package on the CPU.

JAX's `epnp_solve` is per frame: it is vmapped over the same frames the
port takes as a batch. Clouds of 60 points in a 0.2 m cube at 0.7 m,
K with f = 600 px, 20% of the points masked; the eigenvectors of the
decompositions may differ in sign between the packages, so poses are
compared, not bases. The principal axes that place EPnP's control
points are a different matter: with noise the pose depends on their
signs, which the port fixes (`canonical_axes`) and JAX takes from
LAPACK. The JAX side runs with its 3x3 eigh given the same signs
(`jax_axes`); without that, JAX's noisy poses move by up to 1.3e-3.
Tolerances: R and t within 1e-4.

Exactly planar clouds leave the fourth control point with alphas of 0 and
the fp32 solve decided by rounding in both packages (ROADMAP C16): the
parity case takes clouds 1% as thick as they are wide, and an exactly
planar cloud is held to its true pose with float64 inputs.

RANSAC draws are JAX's own, injected as in tests/test_torch_geometry.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_geometry import K_NP, _jax_ransac, _random_rotations, _ransac_batch

import onepose_tpu.geometry.epnp as jax_epnp_module
from onepose_tpu.geometry.epnp import epnp_solve as jax_epnp
from onepose_tpu_torch.geometry import metrics
from onepose_tpu_torch.geometry.epnp import (
    _beta_residuals_and_jacobian,
    _pair_diffs,
    epnp_solve,
)
from onepose_tpu_torch.geometry.ransac import ransac_pnp

torch.set_num_threads(2)

B, N = 6, 60


def _clouds(seed, noise=0.5, thickness=1.0, mask_frac=0.2):
    """B frames: points, pixels (with noise), K, mask, and the true R, t."""
    rng = np.random.default_rng(seed)
    _, R = _random_rotations(rng, B)
    t = np.stack([np.array([0.02 * b - 0.05, -0.01, 0.7], np.float32) for b in range(B)])
    P = ((rng.random((B, N, 3)) - 0.5) * 0.2).astype(np.float32)
    P[..., 2] *= thickness
    pc = np.einsum("bij,bnj->bni", R, P) + t[:, None]
    uv = pc @ K_NP.T
    uv = uv[..., :2] / uv[..., 2:]
    uv = (uv + rng.normal(size=uv.shape) * noise).astype(np.float32)
    mask = rng.random((B, N)) >= mask_frac
    return P, uv, np.broadcast_to(K_NP, (B, 3, 3)).copy(), mask, R, t


@pytest.fixture
def jax_axes(monkeypatch):
    """JAX's epnp with its 3x3 eigenvectors (the control points' principal
    axes) signed as the port signs them; its 12x12 eigh is left alone."""
    eigh = jnp.linalg.eigh

    def signed(a, *args, **kw):
        w, v = eigh(a, *args, **kw)
        if a.shape[-1] != 3:
            return w, v
        idx = jnp.argmax(jnp.abs(v), axis=-2, keepdims=True)
        sign = jnp.sign(jnp.take_along_axis(v, idx, axis=-2))
        return w, v * jnp.where(sign == 0, 1.0, sign)

    jax.clear_caches()  # no jitted caller may keep a trace of the unpatched eigh
    monkeypatch.setattr(jax_epnp_module.jnp.linalg, "eigh", signed)
    yield
    jax.clear_caches()


def _both(P, uv, K, mask):
    want = jax.vmap(jax_epnp)(*(jnp.asarray(x) for x in (P, uv, K, mask)))
    got = epnp_solve(*(torch.from_numpy(x) for x in (P, uv, K, mask)))
    return got, [np.asarray(w) for w in want]


@pytest.mark.parametrize("case", ["noisy", "noiseless", "thin"])
def test_epnp_matches_jax(case, jax_axes):
    noise, thickness = {"noisy": (0.5, 1.0), "noiseless": (0.0, 1.0), "thin": (0.5, 0.01)}[case]
    P, uv, K, mask, R_gt, t_gt = _clouds(seed=len(case), noise=noise, thickness=thickness)
    (R, t, ok), (R_j, t_j, ok_j) = _both(P, uv, K, mask)
    np.testing.assert_array_equal(ok.numpy(), ok_j)
    assert ok.all()
    np.testing.assert_allclose(R.numpy(), R_j, atol=1e-4)
    np.testing.assert_allclose(t.numpy(), t_j, atol=1e-4)
    # And both near the truth (0.5 px of noise on 48 points).
    pose = torch.eye(4).repeat(B, 1, 1)
    pose[:, :3, :3], pose[:, :3, 3] = R, t
    gt = torch.eye(4).repeat(B, 1, 1)
    gt[:, :3, :3], gt[:, :3, 3] = torch.from_numpy(R_gt), torch.from_numpy(t_gt)
    re, te = metrics.query_pose_error(pose, gt)
    assert (re < 1.0).all() and (te < 1.0).all(), (re, te)


def test_epnp_exactly_planar_cloud():
    """C16: on an exactly planar cloud both packages' fp32 solves stay
    finite and ok; the port in float64 recovers every true pose (within
    1e-5: the solve's fixed dampings of 1e-9 and 1e-10 bound it)."""
    P, uv, K, mask, R_gt, t_gt = _clouds(seed=11, noise=0.0, thickness=0.0, mask_frac=0.0)
    (R, t, ok), (R_j, t_j, ok_j) = _both(P, uv, K, mask)
    assert ok.all() and ok_j.all()
    assert torch.isfinite(R).all() and torch.isfinite(t).all()
    assert np.isfinite(R_j).all() and np.isfinite(t_j).all()
    pc = np.einsum("bij,bnj->bni", R_gt, P.astype(np.float64)) + t_gt[:, None]
    uv64 = pc @ K_NP.astype(np.float64).T
    uv64 = uv64[..., :2] / uv64[..., 2:]
    R64, t64, ok64 = epnp_solve(torch.from_numpy(P.astype(np.float64)), torch.from_numpy(uv64),
                                torch.from_numpy(K.astype(np.float64)), torch.from_numpy(mask))
    assert R64.dtype == torch.float64 and ok64.all()
    np.testing.assert_allclose(R64.numpy(), R_gt, atol=1e-5)
    np.testing.assert_allclose(t64.numpy(), t_gt, atol=1e-5)


def test_epnp_degenerate_inputs_stay_finite(jax_axes):
    """Fewer than 4 valid points, none valid, all points equal, a NaN in a
    masked slot's pixel (which reaches M^T M as NaN * 0, in JAX too):
    finite output, ok False, the identity pose. JAX agrees but on equal
    points, where it reports ok with an arbitrary pose and the port not ok
    (on purpose: epnp.py's docstring)."""
    P, uv, K, mask, _, _ = _clouds(seed=5)
    mask[0, 3:] = False
    mask[1] = False
    P[2] = 0.3
    mask[3, 7] = False
    uv[3, 7] = np.nan
    (R, t, ok), (R_j, t_j, ok_j) = _both(P, uv, K, mask)
    assert torch.isfinite(R).all() and torch.isfinite(t).all()
    assert ok.tolist() == [False, False, False, False, True, True]
    np.testing.assert_array_equal(ok.numpy()[[0, 1, 3]], ok_j[[0, 1, 3]])
    assert ok_j[2]
    eye = torch.eye(3).expand(4, 3, 3)
    torch.testing.assert_close(R[:4], eye, rtol=0, atol=0)
    assert (t[:4] == 0).all()


def test_beta_jacobian_matches_autodiff():
    """The betas' closed-form Jacobian equals forward-mode autodiff of the
    same residuals (what JAX takes with jax.jacfwd), in float64."""
    from torch.func import jacfwd, vmap

    g = torch.Generator().manual_seed(0)
    V = torch.randn(4, 4, 4, 3, generator=g, dtype=torch.float64)
    betas = torch.randn(4, 3, 4, generator=g, dtype=torch.float64)
    rho = torch.rand(4, 6, generator=g, dtype=torch.float64)
    diffs = _pair_diffs(V)

    def res(b, D, r):
        d = torch.einsum("k,kps->ps", b, D)
        return (d * d).sum(-1) - r

    r, J = _beta_residuals_and_jacobian(betas, diffs, rho)
    flat = lambda x: x.reshape(-1, *x.shape[2:])  # noqa: E731
    rep = lambda x: x[:, None].expand(-1, 3, *x.shape[1:])  # noqa: E731
    args = (flat(betas), flat(rep(diffs)), flat(rep(rho)))
    np.testing.assert_allclose(flat(r).numpy(), vmap(res)(*args).numpy(), rtol=1e-12)
    np.testing.assert_allclose(flat(J).numpy(), vmap(jacfwd(res))(*args).numpy(), rtol=1e-10,
                               atol=1e-12)


@pytest.mark.parametrize("noise,n_hyp", [(0.5, 64), (0.0, 32)])
def test_ransac_epnp_refit_matches_jax(noise, n_hyp, jax_axes):
    """ransac_pnp(epnp_refit=True) with JAX's draws injected: the same
    poses (1e-4), inliers and counts as JAX's, and the true pose."""
    pts2d, pts3d, K, mask, pose_gt = _ransac_batch(seed=20 + n_hyp, noise=noise)
    keys = jax.random.split(jax.random.PRNGKey(3), pts2d.shape[0])

    from onepose_tpu.geometry.ransac import ransac_pnp as jax_ransac

    want = jax.vmap(lambda k, a, b, c, d: jax_ransac(k, a, b, c, d, n_hyp=n_hyp,
                                                      epnp_refit=True))(
        keys, *(jnp.asarray(x) for x in (pts2d, pts3d, K, mask)))
    draws = np.stack([np.asarray(jax.random.uniform(k, (n_hyp, 3))) for k in keys])
    got = ransac_pnp(*(torch.from_numpy(x) for x in (pts2d, pts3d, K, mask)),
                     draws=torch.from_numpy(draws), n_hyp=n_hyp, epnp_refit=True)
    np.testing.assert_array_equal(got["ok"].numpy(), np.asarray(want["ok"]))
    np.testing.assert_allclose(got["pose"].numpy(), np.asarray(want["pose"]), atol=1e-4)
    np.testing.assert_array_equal(got["inliers"].numpy(), np.asarray(want["inliers"]))
    np.testing.assert_array_equal(got["num_inliers"].numpy(), np.asarray(want["num_inliers"]))
    re, te = metrics.query_pose_error(got["pose"], torch.from_numpy(pose_gt))
    assert (re < 1.0).all() and (te < 1.0).all()
    # The refit changes nothing about what RANSAC reports beside the pose.
    plain, _ = _jax_ransac(jax.random.PRNGKey(3), n_hyp, pts2d, pts3d, K, mask)
    np.testing.assert_array_equal(got["ok"].numpy(), np.asarray(plain["ok"]))
