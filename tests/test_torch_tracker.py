"""The port's BATracker (`tracker/ba_tracker.py`) against the JAX package's,
on the CPU, at cut shapes.

Both trackers get the same frames, keypoints and descriptors; the port's
flow RANSAC gets JAX's draws (`uniform(PRNGKey(frame_count), (n_hyp, 3))`,
as JAX's `track` keys itself). Tolerances: the flags (flow_ok, used_motion)
and counts (n_tracked, n_new_points) equal; poses and the other float
state within 1e-3 (rotation entries, metres, pixels), the point buffer
within 5e-3 m (a point triangulated from two views 1 cm apart moves along
its ray by fp32 rounding of the 4 x 4 DLT system's eigenvector; LM in fp32
on both sides takes its steps alike on these scenes).
- tests/test_tracker.py:49 (orbit tracking; `slow` there) at 128 x 128,
  80 points, 6 frames: as JAX's, and against the ground truth as JAX's
  test holds it (every frame within 5 cm / 5 degrees, most within 1);
- tests/test_tracker.py:123 (the motion fallback on a blank frame);
- the reprojection gate's median with `jnp.median`'s semantics: one NaN
  (a keyframe slot without 3D) keeps the gate silent, and with every slot
  matched the even count fires it at the mean of the two middle errors;
- the rollback: after a non-keyframe frame every state tensor but
  `pose_hist` is bit-equal to the one before;
- a point buffer that fills up (new ids past the capacity are dropped);
- `update_kf`: a 20 cm jump rejected with the state untouched, a 2 cm one
  taken, both as JAX;
- one `_megastep` and one `_unpack` per tracked frame.
"""

import dataclasses
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_tracker import look_at, render_scene

import onepose_tpu.tracker.ba_tracker as jax_bt
import onepose_tpu_torch.tracker.ba_tracker as bt
from onepose_tpu.geometry import query_pose_error
from onepose_tpu_torch.tracker import BATracker, TrackerConfig

torch.set_num_threads(2)

POSE_ABS = 1e-3
POINT_ABS = 5e-3
IMG = 128
KW = dict(window_size=4, n_kpts=64, point_capacity=256, kf_interval=2, ransac_hyp=32,
          ba_iters=3)


def _jax_draws(frame_count: int, n_hyp: int) -> torch.Tensor:
    u = jax.random.uniform(jax.random.PRNGKey(frame_count), (n_hyp, 3))
    return torch.from_numpy(np.array(u))[None]


class _World:
    """The orbit of tests/test_tracker.py at IMG px: a frame's image,
    keypoints (the visible points' projections, 0.2 px noise after frame
    0), unit descriptors and mask."""

    def __init__(self, seed, n_pts=80, c=16, N=64):
        self.rng = np.random.default_rng(seed)
        rng = self.rng
        self.pts3d = ((rng.random((n_pts, 3)) - 0.5) * 0.2).astype(np.float32)
        self.tex = rng.random(n_pts) * 6.28
        f = 300.0 * IMG / 160
        self.K = np.array([[f, 0, IMG / 2], [0, f, IMG / 2], [0, 0, 1]], np.float32)
        self.desc = rng.normal(size=(n_pts, c)).astype(np.float32)
        self.desc /= np.linalg.norm(self.desc, axis=-1, keepdims=True)
        self.c, self.N = c, N

    @staticmethod
    def camera(i):
        ang = 0.02 * i
        return look_at(np.array([np.cos(ang) * 0.6, np.sin(ang) * 0.6, 0.35 + 0.002 * i]))

    def frame(self, i):
        pose = self.camera(i)
        image, uv, vis = render_scene(self.rng, pose, self.K, self.pts3d, self.tex, IMG)
        ids = np.nonzero(vis)[0][: self.N]
        n = len(ids)
        kp = np.zeros((self.N, 2), np.float32)
        kp[:n] = uv[ids] + (self.rng.normal(size=(n, 2)) * 0.2 if i else 0.0)
        ds = np.zeros((self.N, self.c), np.float32)
        ds[:n] = self.desc[ids]
        m = np.zeros(self.N, bool)
        m[:n] = True
        return pose, image, kp, ds, m, ids


def _pair(world, kw=KW):
    """Both trackers initialised on the world's frame 0."""
    jt = jax_bt.BATracker(jax_bt.TrackerConfig(**kw))
    pt = BATracker(TrackerConfig(**kw), device="cpu")
    pose0, im0, kp, ds, m, ids0 = world.frame(0)
    p3d = np.full(kw["n_kpts"], -1, np.int32)
    p3d[: len(ids0)] = np.arange(len(ids0))
    jt.initialize(jnp.asarray(im0), kp, ds, m, p3d, world.pts3d[ids0], pose0, world.K)
    pt.initialize(im0, kp, ds, m, p3d, world.pts3d[ids0], pose0, world.K)
    return jt, pt, pose0


def _track_both(jt, pt, image, kp, ds, m, K):
    draws = _jax_draws(jt._frame_count, jt.cfg.ransac_hyp)
    a = jt.track(jnp.asarray(image), kp, ds, m, K)
    b = pt.track(image, kp, ds, m, K, draws=draws)
    for k in ("flow_ok", "used_motion", "n_tracked", "n_new_points"):
        assert a[k] == b[k], (k, a[k], b[k])
    for k in ("pose", "pose_init", "pose_flow"):
        np.testing.assert_allclose(b[k], a[k], atol=POSE_ABS, err_msg=k)
    return b


def _assert_states_close(st, jst):
    for f in dataclasses.fields(st):
        got, want = getattr(st, f.name).numpy(), np.asarray(getattr(jst, f.name))
        if got.dtype.kind == "f":
            atol = POINT_ABS if f.name == "points" else POSE_ABS
            np.testing.assert_allclose(got, want, atol=atol, err_msg=f.name)
        else:
            np.testing.assert_array_equal(got, want, err_msg=f.name)


def test_orbit_tracking_matches_jax():
    world = _World(0)
    jt, pt, _ = _pair(world)
    errs = []
    for i in range(1, 7):
        pose, im, kp, ds, m, _ = world.frame(i)
        out = _track_both(jt, pt, im, kp, ds, m, world.K)
        r, t = query_pose_error(jnp.asarray(out["pose"]), jnp.asarray(pose))
        errs.append((float(r), float(t)))
    _assert_states_close(pt.state, jt.state)
    r_errs, t_errs = np.array(errs).T
    assert r_errs.max() < 5.0 and t_errs.max() < 5.0, errs
    assert (r_errs < 1.0).mean() > 0.5, errs


def test_motion_fallback_on_blank_frame_matches_jax():
    world = _World(1, n_pts=60)
    jt, pt, pose0 = _pair(world)
    N, c = KW["n_kpts"], world.c
    blank = np.zeros((IMG, IMG), np.float32)
    out = _track_both(jt, pt, blank, np.zeros((N, 2), np.float32), np.zeros((N, c), np.float32),
                      np.zeros(N, bool), world.K)
    assert out["used_motion"] and np.isfinite(out["pose"]).all()
    _, t_err = query_pose_error(jnp.asarray(out["pose"]), jnp.asarray(pose0))
    assert float(t_err) < 5.0


def test_jnp_median_semantics():
    rng = np.random.default_rng(2)
    for x in (rng.random(7), rng.random(8), np.array([1.0, 2.0, 2.6, 10.0]),
              np.array([1.0, np.nan, 3.0]), np.array([np.inf, 1.0, 2.0, 5.0]), rng.random(1)):
        x = x.astype(np.float32)
        got = bt.jnp_median(torch.from_numpy(x)).item()
        want = float(jnp.median(jnp.asarray(x)))
        assert got == want or (np.isnan(got) and np.isnan(want)), (x, got, want)
    # torch's own medians differ: the lower middle value, and NaNs dropped.
    assert torch.median(torch.tensor([1.0, 2.0, 2.6, 10.0])).item() == 2.0
    assert bt.jnp_median(torch.tensor([1.0, 2.0, 2.6, 10.0])).item() == pytest.approx(2.3)


@pytest.mark.parametrize("case", ["one_nan", "even_count"])
def test_reprojection_gate_median(case):
    """Four keyframe slots matched one to one (orthonormal descriptors),
    each query keypoint off its projection by err px. one_nan: slot 3 has
    no 3D id, so the gate's median is NaN and every 3D match is kept, the
    30 px one too (nanmedian would give 2 and drop it). even_count: every
    slot has 3D, median (2 + 2.6) / 2 = 2.3, threshold 2.76: three kept
    (the lower middle value, 2, would keep two)."""
    kw = dict(window_size=3, n_kpts=4, point_capacity=8, ba_iters=2, ransac_hyp=8)
    pts3d = np.array([[0.05, 0.02, 0.0], [-0.04, 0.03, 0.01], [0.01, -0.05, 0.02],
                      [-0.02, -0.01, -0.03]], np.float32)
    K = np.array([[300.0, 0, 64], [0, 300.0, 64], [0, 0, 1]], np.float32)
    pose = look_at(np.array([0.6, 0.1, 0.3]))
    uv = (pts3d @ pose[:3, :3].T + pose[:3, 3]) @ K.T
    uv = (uv[:, :2] / uv[:, 2:]).astype(np.float32)
    errs = [1.0, 2.0, 30.0, 0.5] if case == "one_nan" else [1.0, 2.0, 2.6, 10.0]
    q = (uv + np.array(errs, np.float32)[:, None] * [1.0, 0.0]).astype(np.float32)
    descs = np.eye(4, 8, dtype=np.float32)
    mask = np.ones(4, bool)
    p3d = np.arange(4, dtype=np.int32)
    if case == "one_nan":
        p3d[3] = -1
    image = np.zeros((128, 128), np.float32)
    jt = jax_bt.BATracker(jax_bt.TrackerConfig(**kw))
    pt = BATracker(TrackerConfig(**kw), device="cpu")
    jt.initialize(jnp.asarray(image), uv, descs, mask, p3d, pts3d, pose, K)
    pt.initialize(image, uv, descs, mask, p3d, pts3d, pose, K)
    _, jout = jax_bt._track_ba_step(jt.state, jnp.asarray(q), jnp.asarray(descs),
                                    jnp.asarray(mask), jnp.asarray(K), jnp.asarray(pose),
                                    jax.random.PRNGKey(0), jt.cfg)
    _, out = bt._track_ba_step(pt.state, torch.from_numpy(q), torch.from_numpy(descs),
                               torch.from_numpy(mask), torch.from_numpy(K),
                               torch.from_numpy(pose.astype(np.float32)), pt.cfg)
    want = 3
    assert int(jout["n_tracked"]) == want
    assert int(out["n_tracked"]) == want


def test_rollback_after_non_keyframe():
    world = _World(3)
    jt, pt, _ = _pair(world)
    for i in (1, 2):  # frame_count 1 (no commit), then 2 (a keyframe)
        before = {f: getattr(pt.state, f).clone() for f in bt._FIELDS}
        pose, im, kp, ds, m, _ = world.frame(i)
        out = _track_both(jt, pt, im, kp, ds, m, world.K)
        changed = [f for f in bt._FIELDS if not torch.equal(getattr(pt.state, f), before[f])]
        if i == 1:
            assert changed == ["pose_hist"], changed
        else:
            assert out["flow_ok"] and {"kf_slot", "kf_image", "frame_kpts", "points"} <= set(
                changed), changed
        _assert_states_close(pt.state, jt.state)


def test_point_buffer_fills_up():
    world = _World(0)
    _, _, _, _, _, ids0 = world.frame(0)
    world = _World(0)
    kw = {**KW, "point_capacity": len(ids0) + 5}
    jt, pt, _ = _pair(world, kw)
    stored = []
    for i in range(1, 5):
        pose, im, kp, ds, m, _ = world.frame(i)
        stored.append(_track_both(jt, pt, im, kp, ds, m, world.K)["n_new_points"])
    assert int(pt.state.n_points) == kw["point_capacity"], stored
    assert max(stored) == 5  # a frame that triangulated more stored what fitted
    _assert_states_close(pt.state, jt.state)


def test_update_kf_rejection_matches_jax():
    world = _World(4)
    jt, pt, pose0 = _pair(world)
    _, im, kp, ds, m, ids = world.frame(1)
    p3d = np.full(KW["n_kpts"], -1, np.int32)
    p3d[: len(ids)] = ids
    for shift_m, accepted in ((0.2, False), (0.02, True)):
        pose = pose0.copy()
        pose[0, 3] += shift_m
        before = {f: getattr(pt.state, f) for f in bt._FIELDS}
        a = jt.update_kf(jnp.asarray(im), kp, ds, m, p3d, pose, world.K)
        b = pt.update_kf(im, kp, ds, m, p3d, pose, world.K)
        assert a == b == accepted
        if not accepted:
            assert all(getattr(pt.state, f) is before[f] for f in bt._FIELDS)
        _assert_states_close(pt.state, jt.state)
    assert int(pt.state.kf_slot) == 1 and pt._frame_count == 2


def test_track_is_one_megastep_one_unpack():
    world = _World(2, n_pts=40)
    kw = dict(window_size=3, n_kpts=32, point_capacity=128, kf_interval=2, ransac_hyp=32,
              ba_iters=2)
    pt = BATracker(TrackerConfig(**kw), device="cpu")
    pose0, im0, kp, ds, m, ids0 = world.frame(0)
    kp, ds, m = kp[:32], ds[:32], m[:32]
    p3d = np.full(32, -1, np.int32)
    n0 = min(len(ids0), 32)
    p3d[:n0] = np.arange(n0)
    pt.initialize(im0, kp, ds, m, p3d, world.pts3d[ids0[:n0]], pose0, world.K)
    calls = []
    orig_mega, orig_unpack = bt._megastep, BATracker._unpack

    def spy_mega(*a, **k):
        calls.append("dispatch")
        return orig_mega(*a, **k)

    def spy_unpack(self, packed):
        calls.append("fetch")
        return orig_unpack(self, packed)

    with mock.patch.object(bt, "_megastep", spy_mega), \
            mock.patch.object(BATracker, "_unpack", spy_unpack):
        for _ in range(3):
            calls.clear()
            pt.track(im0, kp, ds, m, world.K)
            assert calls == ["dispatch", "fetch"], calls


def test_tracker_raises_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("this machine has CUDA: the no-CUDA error cannot be shown here")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        BATracker(TrackerConfig())
