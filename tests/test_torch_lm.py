"""Parity of the port's LM bundle adjuster (`onepose_tpu_torch.ops.lm`)
with onepose_tpu/ops/lm.py on the CPU.

Both get the same numpy BA window (the construction of
tests/test_ops.py::make_ba_problem: 60 points seen by 6 cameras on a
ring, GT plus perturbed starts). Residuals and Jacobians (the JAX package
takes them from jax.jacfwd, the port from torch.func.jacfwd) agree to
fp32 rounding; one Schur-complement step to 1e-5 relative of its largest
entry; whole solves, cameras fixed, anchored or free, to the tolerances
stated at each test (fp32 sums in another order).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.spatial.transform import Rotation

from onepose_tpu.ops import lm as jax_lm
from onepose_tpu_torch.ops import lm

torch.set_num_threads(2)


def make_ba_problem(rng, n_pts=60, n_cams=6, noise_pts=0.01, noise_cam=0.02):
    """Synthetic BA window with GT and perturbed starts."""
    pts_gt = (rng.random((n_pts, 3)) - 0.5) * 0.4
    f, cx, cy = 500.0, 256.0, 256.0
    cams_gt = []
    for i in range(n_cams):
        ang = 2 * np.pi * i / max(n_cams, 8)
        center = np.array([np.cos(ang), np.sin(ang), 0.6]) * 1.2
        z = -center / np.linalg.norm(center)
        x = np.cross([0, 0, 1.0], z)
        x /= np.linalg.norm(x)
        R = np.stack([x, np.cross(z, x), z])
        cams_gt.append(np.concatenate([Rotation.from_matrix(R).as_rotvec(), -R @ center]))
    cams_gt = np.stack(cams_gt)
    uv, pt_idx, cam_idx = [], [], []
    for c in range(n_cams):
        R = Rotation.from_rotvec(cams_gt[c, :3]).as_matrix()
        pc = pts_gt @ R.T + cams_gt[c, 3:]
        uv.append(np.stack([f * pc[:, 0] / pc[:, 2] + cx, f * pc[:, 1] / pc[:, 2] + cy], -1))
        pt_idx.append(np.arange(n_pts))
        cam_idx.append(np.full(n_pts, c))
    uv = np.concatenate(uv)
    features = np.concatenate([uv, np.tile([f, cx, cy], (len(uv), 1))], 1).astype(np.float32)
    return {
        "pts_gt": pts_gt,
        "cams_gt": cams_gt,
        "pts0": (pts_gt + rng.normal(size=pts_gt.shape) * noise_pts).astype(np.float32),
        "cams0": (cams_gt + rng.normal(size=cams_gt.shape) * noise_cam).astype(np.float32),
        "features": features,
        "pt_idx": np.concatenate(pt_idx).astype(np.int32),
        "cam_idx": np.concatenate(cam_idx).astype(np.int32),
    }


def _args(prob, mask):
    return (prob["pts0"], prob["cams0"], prob["features"], prob["pt_idx"], prob["cam_idx"], mask)


def test_residuals_and_jacobians_match_jax():
    prob = make_ba_problem(np.random.default_rng(0))
    mask = np.random.default_rng(1).random(len(prob["pt_idx"])) < 0.8
    args = _args(prob, mask)
    want = [np.asarray(x) for x in jax_lm._obs_jacobians(*map(jnp.asarray, args))]
    targs = [torch.from_numpy(a) for a in args]
    targs[3], targs[4] = targs[3].long(), targs[4].long()
    got = [x.numpy() for x in lm._obs_jacobians(*targs)]
    for g, w, name in zip(got, want, ("r", "Jp", "Jc")):
        np.testing.assert_allclose(g, w, rtol=1e-5, atol=1e-5 * np.abs(w).max(), err_msg=name)
    assert not got[1][~mask].any()
    r = lm.snavely_residuals(*targs).numpy()
    np.testing.assert_allclose(r, np.asarray(jax_lm.snavely_residuals(
        *map(jnp.asarray, args))), atol=1e-4)
    gt = [torch.from_numpy(np.asarray(prob[k], np.float32)) for k in ("pts_gt", "cams_gt")]
    assert float(lm.snavely_residuals(*gt, *targs[2:]).abs().max()) < 1e-2


@pytest.mark.parametrize("fix", ["anchored", "free", "all_fixed"])
def test_schur_step_matches_jax(fix):
    """One damped Gauss-Newton step through the Schur complement: the first
    camera fixed, none fixed, or all fixed (then no camera moves); within
    1e-5 of the step's largest entry (1e-4 with the gauge free)."""
    prob = make_ba_problem(np.random.default_rng(2))
    mask = np.ones(len(prob["pt_idx"]), bool)
    fixed = {"anchored": np.eye(6)[0], "free": None, "all_fixed": np.ones(6)}[fix]
    args = _args(prob, mask)
    r, Jp, Jc = jax_lm._obs_jacobians(*map(jnp.asarray, args))
    want = [np.asarray(x) for x in jax_lm._solve_normal_equations(
        r, Jp, Jc, jnp.asarray(prob["pt_idx"]), jnp.asarray(prob["cam_idx"]), 60, 6, 1e-3,
        None if fixed is None else jnp.asarray(fixed, jnp.float32))]
    t = [torch.from_numpy(np.array(x)) for x in (r, Jp, Jc)]
    got = [x.numpy() for x in lm._solve_normal_equations(
        *t, torch.from_numpy(prob["pt_idx"]).long(), torch.from_numpy(prob["cam_idx"]).long(), 60,
        6, torch.tensor(1e-3), None if fixed is None else torch.tensor(fixed, dtype=torch.float32))]
    # With no camera fixed the gauge is free and only the damping conditions
    # the reduced system: its fp32 rounding grows to a few 1e-5 of the step.
    rel = 1e-4 if fix == "free" else 1e-5
    for g, w, name in zip(got, want, ("dp", "dc")):
        np.testing.assert_allclose(g, w, atol=rel * max(np.abs(w).max(), 1e-6), err_msg=name)
    if fix == "all_fixed":
        assert not got[1].any()
    if fix == "anchored":
        assert not got[1][0].any() and got[1][1:].any()


MODES = ["anchored", "points_only", "free", "frozen_points"]


def _solves(mode, n_iters):
    """JAX's and the port's ba_solve on the same window: the first camera
    anchored at GT (as tests/test_ops.py::test_converges_to_gt), cameras
    fixed (map's default global BA), no camera fixed, or every point
    frozen; every seventh observation masked."""
    prob = make_ba_problem(np.random.default_rng(3))
    if mode == "anchored":
        prob["cams0"][0] = prob["cams_gt"][0]
    mask = np.ones(len(prob["pt_idx"]), bool)
    mask[::7] = False
    fixed = {"anchored": np.eye(6)[0], "points_only": np.ones(6)}.get(mode)
    pmask = np.zeros(60, bool) if mode == "frozen_points" else None
    want = jax_lm.ba_solve(
        *map(jnp.asarray, _args(prob, mask)),
        point_mask=None if pmask is None else jnp.asarray(pmask),
        fix_cam_mask=None if fixed is None else jnp.asarray(fixed, jnp.float32), n_iters=n_iters)
    got = lm.ba_solve(
        *[torch.from_numpy(a) for a in _args(prob, mask)],
        point_mask=None if pmask is None else torch.from_numpy(pmask),
        fix_cam_mask=None if fixed is None else torch.tensor(fixed, dtype=torch.float32),
        n_iters=n_iters)
    return prob, {k: v.numpy() for k, v in got.items()}, {k: np.asarray(v) for k, v in want.items()}


@pytest.mark.parametrize("mode", MODES)
def test_ba_solve_steps_match_jax(mode):
    """Two LM steps, before the cost reaches fp32's floor: the same accept /
    reject decisions (lambda equal), points and cameras within 1e-4, costs
    within 1e-3 relative (with every point frozen the camera step still
    comes from the system with the points free, whose gauge only the
    damping fixes: the cameras differ by about 2e-5 and the cost by 1e-4
    relative)."""
    _, got, want = _solves(mode, 2)
    np.testing.assert_allclose(got["points"], want["points"], atol=1e-4)
    np.testing.assert_allclose(got["cam_poses"], want["cam_poses"], atol=1e-4)
    for k in ("cost_initial", "cost_final"):
        np.testing.assert_allclose(got[k], want[k], rtol=1e-3, atol=1e-6, err_msg=k)
    np.testing.assert_allclose(got["lambda"], want["lambda"], rtol=1e-6)


@pytest.mark.parametrize("mode", MODES)
def test_ba_solve_converges_as_jax(mode):
    """Eight LM steps. Once the cost sits at fp32's floor (near 1e-8) or in
    a flat valley (points frozen away from the truth), accept / reject turns
    on near ties and lambda's path may part from JAX's, so lambda is not
    compared; points and cameras within 5e-4 (1e-5 of their spread is
    observed when converged; the flat valley of frozen points drifts to
    3e-4), costs within 1e-3 relative."""
    prob, got, want = _solves(mode, 8)
    np.testing.assert_allclose(got["points"], want["points"], atol=5e-4)
    np.testing.assert_allclose(got["cam_poses"], want["cam_poses"], atol=5e-4)
    for k in ("cost_initial", "cost_final"):
        np.testing.assert_allclose(got[k], want[k], rtol=1e-3, atol=1e-6, err_msg=k)
    assert got["cost_final"] < got["cost_initial"]
    if mode == "frozen_points":
        np.testing.assert_array_equal(got["points"], prob["pts0"])
    if mode == "points_only":
        np.testing.assert_array_equal(got["cam_poses"], prob["cams0"])
    if mode in ("anchored", "free"):
        assert got["cost_final"] < got["cost_initial"] * 1e-3


# Windows whose normal equations are exactly singular in fp32 once lambda's
# damping (1e-9 of the diagonal) and the 1e-9 ridge are lost beside the
# entries. "inv": one point seen by one camera (its other observation
# masked), whose 3 x 3 block has rank 2: torch.linalg.inv raised. "solve":
# one point seen by two cameras, whose reduced camera system is singular:
# torch.linalg.solve raised. JAX's LU gives non-finite steps, which LM
# rejects.
SINGULAR_BA = {
    "inv": dict(pts=[[0.0, 1.0, 1.0]],
                cams=[[0.0, 0.0, 0.0, 0.0, -1.0, 0.0], [0.0, 0.0, 0.0, -1.0, 0.0, 0.0]],
                feats=[[436.0, 103.0, 256.0, 256.0, 256.0], [223.0, 103.0, 256.0, 256.0, 256.0]],
                pt=[0, 0], cam=[0, 1], mask=[False, True]),
    "solve": dict(pts=[[-2.0, 0.0, 3.0]],
                  cams=[[0.0, 0.0, 0.0, 0.0, 1.0, 0.0], [0.0, 0.0, 0.0, 1.0, 1.0, 0.0]],
                  feats=[[297.0, 442.0, 64.0, 256.0, 256.0], [208.0, 31.0, 64.0, 256.0, 256.0]],
                  pt=[0, 0], cam=[0, 1], mask=[True, True]),
}


def singular_ba_args(case: str) -> tuple:
    """(points, cameras, features, pt_idx, cam_idx, obs_mask) of SINGULAR_BA[case]."""
    p = SINGULAR_BA[case]
    return (np.asarray(p["pts"], np.float32), np.asarray(p["cams"], np.float32),
            np.asarray(p["feats"], np.float32), np.asarray(p["pt"], np.int32),
            np.asarray(p["cam"], np.int32), np.asarray(p["mask"], bool))


@pytest.mark.parametrize("case", sorted(SINGULAR_BA))
def test_ba_solve_on_a_singular_system_matches_jax(case):
    """No raise: both steps rejected as in JAX (points, cameras and lambda
    equal), costs within fp32 rounding of JAX's."""
    args = singular_ba_args(case)
    want = jax_lm.ba_solve(*map(jnp.asarray, args), n_iters=2, init_lambda=1e-9)
    got = lm.ba_solve(*map(torch.from_numpy, args), n_iters=2, init_lambda=1e-9)
    for k in ("points", "cam_poses", "lambda"):
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]), err_msg=k)
    np.testing.assert_array_equal(got["points"].numpy(), args[0])
    for k in ("cost_initial", "cost_final"):
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]), rtol=1e-6, err_msg=k)
