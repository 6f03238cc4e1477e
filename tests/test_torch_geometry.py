"""Parity of the port's pose geometry with the JAX package on the CPU:
rotations, projection, P3P, RANSAC-PnP and pose-error metrics.

RANSAC draws are JAX's own: per frame, jax.random.uniform(key_b, (n_hyp,
3)) with key_b = jax.random.split(key, B)[b], which is what the vmapped
JAX solve draws; the port takes them as `draws`. Tolerances: rotations and
projections 1e-5; raw P3P candidates 1e-3; poses 1e-4 (Gauss-Newton converges to the same optimum
from fp32 hypotheses that differ in the last bits); inlier masks identical.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from onepose_tpu.geometry import metrics as jax_metrics
from onepose_tpu.geometry import projection as jax_projection
from onepose_tpu.geometry import rotations as jax_rot
from onepose_tpu.geometry.p3p import p3p_solve as jax_p3p
from onepose_tpu.geometry.ransac import ransac_pnp as jax_ransac
from onepose_tpu_torch.geometry import metrics, projection, rotations
from onepose_tpu_torch.geometry.p3p import p3p_solve
from onepose_tpu_torch.geometry.ransac import ransac_pnp

torch.set_num_threads(2)

K_NP = np.array([[600.0, 0, 256], [0, 600.0, 256], [0, 0, 1]], np.float32)


def _random_rotations(rng, n):
    q = rng.normal(size=(n, 4)).astype(np.float32)
    q /= np.linalg.norm(q, axis=-1, keepdims=True)
    return q, np.array(jax_rot.qvec_to_rotmat(jnp.asarray(q)))


def test_rotation_round_trips_match_jax():
    rng = np.random.default_rng(0)
    q, R = _random_rotations(rng, 64)
    q[:3] = [[1, 0, 0, 0], [0, 1, 0, 0], [0, 0, 0, 1]]  # identity and half turns
    R = np.array(jax_rot.qvec_to_rotmat(jnp.asarray(q)))
    t = torch.from_numpy
    np.testing.assert_allclose(rotations.qvec_to_rotmat(t(q)).numpy(), R, atol=1e-6)
    np.testing.assert_allclose(rotations.rotmat_to_qvec(t(R)).numpy(),
                               np.asarray(jax_rot.rotmat_to_qvec(jnp.asarray(R))), atol=1e-5)
    aa = np.array(jax_rot.rotmat_to_angle_axis(jnp.asarray(R)))
    np.testing.assert_allclose(rotations.rotmat_to_angle_axis(t(R)).numpy(), aa, atol=1e-5)
    aa_small = np.concatenate([aa, rng.normal(size=(4, 3)).astype(np.float32) * 1e-9])
    np.testing.assert_allclose(rotations.angle_axis_to_rotmat(t(aa_small)).numpy(),
                               np.asarray(jax_rot.angle_axis_to_rotmat(jnp.asarray(aa_small))),
                               atol=1e-5)
    p = rng.normal(size=(aa_small.shape[0], 3)).astype(np.float32)
    np.testing.assert_allclose(
        rotations.angle_axis_rotate_point(t(aa_small), t(p)).numpy(),
        np.asarray(jax_rot.angle_axis_rotate_point(jnp.asarray(aa_small), jnp.asarray(p))),
        atol=1e-5,
    )
    # Round trip through the port alone.
    R_back = rotations.angle_axis_to_rotmat(rotations.rotmat_to_angle_axis(t(R))).numpy()
    np.testing.assert_allclose(R_back, R, atol=1e-5)


def test_projection_and_metrics_match_jax():
    rng = np.random.default_rng(1)
    _, R = _random_rotations(rng, 3)
    tr = rng.normal(size=(3, 3)).astype(np.float32) * 0.1 + [0, 0, 2]
    pts = rng.normal(size=(3, 20, 3)).astype(np.float32) * 0.3
    Ks = np.broadcast_to(K_NP, (3, 3, 3)).copy()
    t = torch.from_numpy
    uv, depth = projection.project_points(t(pts), t(Ks), t(R), t(tr.astype(np.float32)))
    juv, jdepth = jax_projection.project_points(*(jnp.asarray(x) for x in (pts, Ks, R, tr)))
    np.testing.assert_allclose(uv.numpy(), np.asarray(juv), atol=1e-3, rtol=1e-6)
    np.testing.assert_allclose(depth.numpy(), np.asarray(jdepth), atol=1e-6)
    err = projection.reprojection_errors(t(pts), uv + 1.0, t(Ks), t(R), t(tr.astype(np.float32)))
    np.testing.assert_allclose(err.numpy(), np.sqrt(2.0), atol=1e-3)

    pose_a = np.tile(np.eye(4, dtype=np.float32), (3, 1, 1))
    pose_b = pose_a.copy()
    pose_a[:, :3, :3] = R
    pose_b[:, :3, 3] = tr
    re, te = metrics.query_pose_error(t(pose_a), t(pose_b))
    jre, jte = jax_metrics.query_pose_error(jnp.asarray(pose_a), jnp.asarray(pose_b))
    np.testing.assert_allclose(re.numpy(), np.asarray(jre), atol=1e-3)
    np.testing.assert_allclose(te.numpy(), np.asarray(jte), atol=1e-4)
    assert metrics.aggregate_metrics(re, te) == jax_metrics.aggregate_metrics(
        np.asarray(jre), np.asarray(jte))


def _scene(rng, n, R, t):
    pts3d = ((rng.random((n, 3)) - 0.5) * 0.2).astype(np.float32)
    pc = pts3d @ R.T + t
    uv = pc @ K_NP.T
    return pts3d, (uv[:, :2] / uv[:, 2:3]).astype(np.float32)


def test_p3p_candidates_match_jax():
    rng = np.random.default_rng(2)
    _, Rs = _random_rotations(rng, 16)
    samples3d, samples2d = [], []
    for R in Rs:
        p3, p2 = _scene(rng, 3, R, np.array([0.01, -0.02, 0.7], np.float32))
        samples3d.append(p3 * 1000.0)
        samples2d.append(p2)
    s3, s2 = np.stack(samples3d), np.stack(samples2d)
    jR, jt, jok = jax.vmap(lambda a, b: jax_p3p(a, b, jnp.asarray(K_NP)))(
        jnp.asarray(s3), jnp.asarray(s2))
    R, t, ok = p3p_solve(torch.from_numpy(s3), torch.from_numpy(s2), torch.from_numpy(K_NP))
    # A root's realness is a cut (|imag| < 1e-3 (1 + |real|)) that fp32
    # rounding can move a near-degenerate root across: allow 1 in 32 flags.
    jok, ok = np.asarray(jok), ok.numpy()
    assert (ok != jok).sum() <= ok.size // 32
    both = ok & jok
    assert both.any(axis=1).all()
    # Raw minimal-solver candidates: the fp32 quartic is ill-conditioned
    # (the JAX module says so), so candidates agree to 1e-3 in R and to
    # 0.5 mm in t; RANSAC's Gauss-Newton refine removes the difference.
    np.testing.assert_allclose(R.numpy()[both], np.asarray(jR)[both], atol=1e-3)
    np.testing.assert_allclose(t.numpy()[both], np.asarray(jt)[both], atol=0.5)
    # Every sample recovers its ground-truth rotation among its candidates.
    err = np.abs(R.numpy() - Rs[:, None]).max(axis=(-1, -2))
    assert (np.where(ok, err, np.inf).min(axis=1) < 1e-3).all()


def _ransac_batch(seed, n=120, n_pad=24, outlier_frac=0.3, noise=0.5):
    rng = np.random.default_rng(seed)
    frames, poses = [], []
    for b in range(2):
        _, R = _random_rotations(rng, 1)
        t = np.array([0.01 * b, -0.02, 0.7], np.float32)
        pts3d, pts2d = _scene(rng, n, R[0], t)
        pts2d = pts2d + rng.normal(size=pts2d.shape).astype(np.float32) * noise
        out = rng.random(n) < outlier_frac
        pts2d[out] = rng.random((out.sum(), 2)).astype(np.float32) * 512
        mask = np.ones(n + n_pad, bool)
        mask[n:] = False
        pad = lambda x: np.concatenate([x, np.zeros((n_pad,) + x.shape[1:], x.dtype)])  # noqa: E731
        frames.append((pad(pts2d), pad(pts3d), mask))
        pose = np.eye(4, dtype=np.float32)
        pose[:3, :3], pose[:3, 3] = R[0], t
        poses.append(pose)
    stack = lambda i: np.stack([f[i] for f in frames])  # noqa: E731
    return stack(0), stack(1), np.stack([K_NP, K_NP]), stack(2), np.stack(poses)


def _jax_ransac(key, n_hyp, pts2d, pts3d, K, mask):
    keys = jax.random.split(key, pts2d.shape[0])
    out = jax.vmap(lambda k, a, b, c, d: jax_ransac(k, a, b, c, d, n_hyp=n_hyp))(
        keys, *(jnp.asarray(x) for x in (pts2d, pts3d, K, mask)))
    draws = np.stack([np.asarray(jax.random.uniform(k, (n_hyp, 3))) for k in keys])
    return out, draws


@pytest.mark.parametrize("noise,n_hyp", [(0.5, 64), (0.0, 32)])
def test_ransac_pnp_matches_jax_with_injected_draws(noise, n_hyp):
    """30% outliers and padded slots. noise=0 makes many hypotheses reach
    the same full inlier count, so the ranking runs on ties throughout."""
    pts2d, pts3d, K, mask, pose_gt = _ransac_batch(seed=int(noise * 10) + n_hyp, noise=noise)
    want, draws = _jax_ransac(jax.random.PRNGKey(7), n_hyp, pts2d, pts3d, K, mask)
    got = ransac_pnp(*(torch.from_numpy(x) for x in (pts2d, pts3d, K, mask)),
                     draws=torch.from_numpy(draws), n_hyp=n_hyp)
    np.testing.assert_array_equal(got["ok"].numpy(), np.asarray(want["ok"]))
    assert got["ok"].all()
    np.testing.assert_allclose(got["pose"].numpy(), np.asarray(want["pose"]), atol=1e-4)
    np.testing.assert_array_equal(got["inliers"].numpy(), np.asarray(want["inliers"]))
    np.testing.assert_array_equal(got["num_inliers"].numpy(), np.asarray(want["num_inliers"]))
    re, te = metrics.query_pose_error(got["pose"], torch.from_numpy(pose_gt))
    assert (re < 1.0).all() and (te < 1.0).all()


def test_ransac_pnp_generator_draws_and_degenerate_frames():
    """Without injected draws the port draws from a torch.Generator; a
    frame with fewer than 4 valid matches comes back not ok, finite."""
    pts2d, pts3d, K, mask, pose_gt = _ransac_batch(seed=3)
    mask[1, 3:] = False
    g = torch.Generator().manual_seed(0)
    got = ransac_pnp(*(torch.from_numpy(x) for x in (pts2d, pts3d, K, mask)), n_hyp=128,
                     generator=g)
    assert got["ok"].tolist() == [True, False]
    assert torch.isfinite(got["pose"]).all()
    assert int(got["num_inliers"][1]) == 0 and not got["inliers"][1].any()
    re, te = metrics.query_pose_error(got["pose"][:1], torch.from_numpy(pose_gt[:1]))
    assert re.item() < 1.0 and te.item() < 1.0


def test_ransac_epnp_refit_is_not_ported_yet():
    pts2d, pts3d, K, mask, _ = _ransac_batch(seed=4)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        ransac_pnp(*(torch.from_numpy(x) for x in (pts2d, pts3d, K, mask)), epnp_refit=True)


def test_gauss_newton_jacobian_matches_autodiff():
    """The closed-form Jacobian of the GN residuals equals forward-mode
    autodiff of the same residuals (what the JAX package takes with
    jax.jacfwd), including a frame on the first-order small-angle branch.
    float64, so the comparison sees the formula, not rounding."""
    from torch.func import jacfwd, vmap

    from onepose_tpu_torch.geometry.ransac import _residuals_and_jacobian

    def residuals(x, K, P, p, w):
        R = rotations.angle_axis_to_rotmat(x[:3])
        pix = (P @ R.T + x[3:]) @ K.T
        uv = pix[:, :2] / pix[:, 2].abs().clamp(min=1e-9)[:, None]
        return ((uv - p) * w[:, None]).reshape(-1)

    g = torch.Generator().manual_seed(0)
    B, N = 3, 50
    x = torch.randn(B, 6, generator=g, dtype=torch.float64)
    x[:, 3:] += torch.tensor([0.0, 0.0, 800.0], dtype=torch.float64)
    x[2, :3] = 1e-10  # first-order branch of angle_axis_to_rotmat
    K = torch.from_numpy(K_NP).double().expand(B, 3, 3)
    P = torch.randn(B, N, 3, generator=g, dtype=torch.float64) * 100
    p = torch.rand(B, N, 2, generator=g, dtype=torch.float64) * 512
    w = (torch.rand(B, N, generator=g) < 0.7).double()
    r, J = _residuals_and_jacobian(x, K, P, p, w)
    np.testing.assert_allclose(r.numpy(), vmap(residuals)(x, K, P, p, w).numpy(), rtol=1e-12)
    J_ad = vmap(jacfwd(residuals))(x, K, P, p, w)
    np.testing.assert_allclose(J.numpy(), J_ad.numpy(), rtol=1e-9, atol=1e-9 * float(J_ad.abs().max()))
