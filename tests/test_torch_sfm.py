"""Parity of the port's SfM core (`onepose_tpu_torch.sfm`, the union-find
core `onepose_tpu_torch.native`, `geometry/triangulation.py`) with the JAX
package on the CPU, one test per module, then `run_mapping` end to end.

Both packages get the same numpy inputs from a seed: a planted object
scene (a numpy copy of tests/test_sfm.py::make_scene) and a numpy
mutual-NN pair matcher (the semantics of its nn_pair_matcher), handed to
both. Integer and host results (pairs, tracks, labels, thresholds, merge
groups, leaves, assign matrices, counts) must be identical; points,
distances and errors carry a tolerance stated at each test: fp32 with
another summation order, about 1e-6 relative on coordinates of a few
tenths.
"""

import shutil

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from onepose_tpu import native as jax_native
from onepose_tpu.geometry import triangulation as jax_tri
from onepose_tpu.sfm import aggregate as jax_agg
from onepose_tpu.sfm import covis as jax_covis
from onepose_tpu.sfm import filtering as jax_filt
from onepose_tpu.sfm import tracks as jax_tracks
from onepose_tpu.sfm import triangulate as jax_triangulate
from onepose_tpu.sfm import verify as jax_verify
from onepose_tpu.sfm.mapping import MappingConfig as JaxMappingConfig
from onepose_tpu.sfm.mapping import run_mapping as jax_run_mapping
from onepose_tpu_torch import native
from onepose_tpu_torch.geometry import triangulation
from onepose_tpu_torch.sfm import aggregate, covis, filtering, tracks, triangulate, verify
from onepose_tpu_torch.sfm.mapping import MappingConfig, run_mapping

torch.set_num_threads(2)

CPU = "cpu"


def look_at_pose(center, target=np.zeros(3), up_hint=np.array([0.0, 0.0, 1.0])):
    z = target - center
    z = z / np.linalg.norm(z)
    x = np.cross(up_hint, z)
    if np.linalg.norm(x) < 1e-6:
        x = np.cross(np.array([0.0, 1.0, 0.0]), z)
    x /= np.linalg.norm(x)
    y = np.cross(z, x)
    R = np.stack([x, y, z], axis=0)
    pose = np.eye(4)
    pose[:3, :3] = R
    pose[:3, 3] = -R @ center
    return pose


def make_scene(rng, n_pts=300, n_frames=12, n_slots=256, img=512, noise=0.0):
    """Synthetic object + ring of cameras (tests/test_sfm.py::make_scene):
    frame features + ground truth."""
    pts = (rng.random((n_pts, 3)) - 0.5) * 0.2
    desc_gt = rng.normal(size=(n_pts, 32)).astype(np.float32)
    desc_gt /= np.linalg.norm(desc_gt, axis=-1, keepdims=True)
    K = np.array([[500.0, 0, img / 2], [0, 500.0, img / 2], [0, 0, 1]])
    poses, kpts, descs, scores, masks, gt_ids = [], [], [], [], [], []
    for f in range(n_frames):
        ang = 2 * np.pi * f / n_frames
        pose = look_at_pose(np.array([np.cos(ang), np.sin(ang), 0.4 + 0.1 * np.sin(3 * ang)]))
        R, t = pose[:3, :3], pose[:3, 3]
        pc = pts @ R.T + t
        uv = pc @ K.T
        uv = uv[:, :2] / uv[:, 2:3]
        vis = ((pc[:, 2] > 0.1) & (uv[:, 0] > 8) & (uv[:, 0] < img - 8)
               & (uv[:, 1] > 8) & (uv[:, 1] < img - 8))
        ids = np.nonzero(vis)[0][:n_slots]
        n = len(ids)
        kp = np.zeros((n_slots, 2), np.float32)
        kp[:n] = uv[ids] + rng.normal(size=(n, 2)) * noise
        de = np.ones((n_slots, 32), np.float32)
        de[:n] = desc_gt[ids]
        sc = np.zeros((n_slots,), np.float32)
        sc[:n] = rng.random(n)
        mk = np.zeros(n_slots, bool)
        mk[:n] = True
        gid = np.full(n_slots, -1, np.int64)
        gid[:n] = ids
        poses.append(pose)
        kpts.append(kp)
        descs.append(de)
        scores.append(sc)
        masks.append(mk)
        gt_ids.append(gid)
    return {
        "pts": pts,
        "desc_gt": desc_gt,
        "K": np.broadcast_to(K, (n_frames, 3, 3)).astype(np.float32),
        "poses": np.stack(poses).astype(np.float32),
        "keypoints": np.stack(kpts),
        "descriptors": np.stack(descs),
        "scores": np.stack(scores),
        "mask": np.stack(masks),
        "gt_ids": np.stack(gt_ids),
    }


def nn_pair_matcher(scene, distance_thresh=0.2):
    """Mutual nearest neighbours by cosine similarity, masked slots out,
    best match within `distance_thresh` of cosine distance (the semantics
    of onepose_tpu/models/nn_matcher.py::mutual_nn_match), in numpy."""
    desc, mask = scene["descriptors"], scene["mask"]

    def match(pairs):
        out = []
        for i, j in np.asarray(pairs):
            sim = desc[i] @ desc[j].T
            sim = np.where(mask[i][:, None] & mask[j][None, :], sim, -1e9)
            idx0, idx1 = sim.argmax(1), sim.argmax(0)
            best0 = sim.max(1)
            valid = (np.arange(len(idx0)) == idx1[idx0]) & (best0 > -5e8)
            valid &= (1.0 - best0 <= distance_thresh) & mask[i]
            out.append(np.where(valid, idx0, -1))
        return np.stack(out)

    return match


def _scene_matches(seed=42, noise=0.3, **kw):
    scene = make_scene(np.random.default_rng(seed), noise=noise, **kw)
    pairs = covis.covis_pairs_from_poses(scene["poses"], num_matched=6)
    return scene, pairs, nn_pair_matcher(scene)(pairs)


# --- 1. native union-find --------------------------------------------------


def _random_edges(rng, n, m):
    return rng.integers(0, n, m), rng.integers(0, n, m)


def test_native_builds_and_matches_python_and_jax():
    """The g++ build, its Python fallback and the JAX package's native core
    give identical labels: connected components of random edge graphs, and
    the distance-gated merge of clustered points."""
    assert native.backend().split()[0] == ("g++" if shutil.which("g++") else "python")
    assert native.library_path().parent == native.BUILD_DIR
    assert native.BUILD_DIR.parts[-2:] == ("build", "torch_native")
    rng = np.random.default_rng(0)
    for n, m in ((1, 0), (50, 30), (400, 350), (1000, 5000)):
        ea, eb = _random_edges(rng, n, m)
        got = native.connected_components(n, ea, eb)
        np.testing.assert_array_equal(got, native.connected_components_py(n, ea, eb))
        np.testing.assert_array_equal(got, jax_native.connected_components(n, ea, eb))
        assert bool((got <= np.arange(n)).all())  # roots are minimum members
    xyz = np.repeat(rng.random((60, 3)), 3, axis=0) + rng.normal(size=(180, 3)) * 4e-4
    ca, cb = _random_edges(rng, 180, 4000)
    got = native.merge_close(xyz, ca, cb, 1e-3)
    np.testing.assert_array_equal(got, native.merge_close_py(xyz, ca, cb, 1e-3))
    np.testing.assert_array_equal(got, jax_native.merge_close(xyz, ca, cb, 1e-3))
    assert 60 <= len(np.unique(got)) < 180
    with pytest.raises(ValueError, match="edges"):
        native.connected_components(3, np.array([0]), np.array([3]))


# --- 2. covisibility -------------------------------------------------------


@pytest.mark.parametrize("two_seqs", [False, True])
def test_covis_pairs_match_jax(two_seqs):
    scene = make_scene(np.random.default_rng(1), n_frames=16)
    seq = np.arange(16) % 2 if two_seqs else None
    for k in (2, 4, 10):
        got = covis.covis_pairs_from_poses(scene["poses"], seq, num_matched=k)
        want = jax_covis.covis_pairs_from_poses(scene["poses"], seq, num_matched=k)
        np.testing.assert_array_equal(got, want)
        assert len(got) > 0


# --- 3. tracks -------------------------------------------------------------


def test_build_tracks_matches_jax():
    """Identical padded tracks, in the same order, from the scene's matches
    with conflicts planted (two keypoints of a frame on one track) and
    tracks longer than the capacity cut to it."""
    scene, pairs, m0 = _scene_matches()
    m0 = m0.copy()
    m0[0, 1] = m0[0, 0]  # a conflict: two keypoints of frame i on one of frame j
    for kw in (dict(), dict(max_track_length=5), dict(min_track_length=4)):
        got = tracks.build_tracks(pairs, m0, 12, 256, **kw)
        want = jax_tracks.build_tracks(pairs, m0, 12, 256, **kw)
        for k in ("obs_frame", "obs_kpt", "obs_mask", "lengths"):
            np.testing.assert_array_equal(getattr(got, k), getattr(want, k), err_msg=k)
        assert got.n_tracks > 100
    empty = tracks.build_tracks(pairs, np.full_like(m0, -1), 12, 256)
    assert empty.n_tracks == 0 and empty.max_len == 32


# --- 4. filtering ----------------------------------------------------------


def test_filtering_matches_jax():
    rng = np.random.default_rng(2)
    lengths = rng.integers(2, 12, 700)
    for cap in (10, 100, 333, 700, 5000):
        assert (filtering.track_length_for_max_points(lengths, cap)
                == jax_filt.track_length_for_max_points(lengths, cap))
    corners = np.array([[0, 1, 0], [0, 1, 1], [1, 1, 1], [1, 1, 0],
                        [0, 0, 0], [0, 0, 1], [1, 0, 1], [1, 0, 0]], float) * 0.2 - 0.1
    pts = (rng.random((500, 3)) - 0.5) * 0.3
    np.testing.assert_array_equal(filtering.filter_points_by_box(pts, corners),
                                  jax_filt.filter_points_by_box(pts, corners))
    # Clusters of 1 to 3 points within 1 mm, ids not 0..n-1.
    centres = (rng.random((150, 3)) - 0.5) * 0.2
    pts = np.concatenate([centres, centres[:80] + 3e-4, centres[:30] - 4e-4])
    ids = rng.permutation(1000)[:len(pts)]
    got_xyz, got_groups = filtering.merge_close_points(pts, ids, 1e-3)
    want_xyz, want_groups = jax_filt.merge_close_points(pts, ids, 1e-3)
    np.testing.assert_array_equal(got_xyz, want_xyz)
    assert got_groups.keys() == want_groups.keys()
    for k in want_groups:
        np.testing.assert_array_equal(got_groups[k], want_groups[k])
    assert len(got_xyz) < len(pts)


# --- 5. aggregation, leaves, assign matrices -------------------------------


def test_aggregate_leaves_assign_match_jax():
    """From the scene's tracks, a gate that drops some observations, merge
    groups of several tracks and some tracks not ok: identical per-point
    features, leaves (the same draws from default_rng(leaf_seed)) and
    assign matrices."""
    scene, pairs, m0 = _scene_matches()
    tr = tracks.build_tracks(pairs, m0, 12, 256)
    rng = np.random.default_rng(3)
    inlier = tr.obs_mask & (rng.random(tr.obs_mask.shape) < 0.9)
    ok = rng.random(tr.n_tracks) < 0.9
    order = rng.permutation(tr.n_tracks)
    groups = {g: order[g * 3:(g + 1) * 3] for g in range(tr.n_tracks // 3)}
    args = (inlier, ok, groups, scene["descriptors"], scene["scores"])
    got = aggregate.aggregate_point_features(tr, *args)
    want = jax_agg.aggregate_point_features(jax_tracks.Tracks(
        tr.obs_frame, tr.obs_kpt, tr.obs_mask, tr.lengths), *args)
    for k in ("desc_concat", "scores_concat", "idxs", "desc_avg", "scores_avg"):
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    assert got["frame_obs"] == want["frame_obs"]
    for num_leaf in (4, 8):
        lg = aggregate.build_leaf_slots(got["desc_concat"], got["scores_concat"], got["idxs"],
                                        num_leaf, rng=np.random.default_rng(0))
        lw = jax_agg.build_leaf_slots(want["desc_concat"], want["scores_concat"], want["idxs"],
                                      num_leaf, rng=np.random.default_rng(0))
        for k in ("leaf_desc", "leaf_scores", "leaf_mask"):
            np.testing.assert_array_equal(lg[k], lw[k], err_msg=k)
    n_points = len(groups)
    for f, obs in got["frame_obs"].items():
        obs = obs + [(obs[0][0], 0), (-1, 2), (3, n_points)]  # conflicts, out of range
        np.testing.assert_array_equal(aggregate.assign_matrix_for_frame(obs, 256, n_points),
                                      jax_agg.assign_matrix_for_frame(obs, 256, n_points))


# --- 6. epipolar verification ----------------------------------------------


def test_epipolar_verify_matches_jax():
    """Distances within 1e-4 px of JAX's (fp32, another order); masks
    identical away from the 4 px gate (|d - 4| > 1e-3)."""
    scene, pairs, m0 = _scene_matches()
    rng = np.random.default_rng(4)
    m0 = np.where(rng.random(m0.shape) < 0.2, rng.integers(0, 256, m0.shape), m0)  # outliers
    i, j = pairs[:, 0], pairs[:, 1]
    kp, K, P = scene["keypoints"], scene["K"], scene["poses"]
    uv0 = kp[i[:, None], np.arange(256)[None]]
    uv1 = kp[j[:, None], np.maximum(m0, 0)]
    valid = m0 >= 0
    cams = (K[i], P[i, :3, :3], P[i, :3, 3], K[j], P[j, :3, :3], P[j, :3, 3])
    Fj = np.asarray(jax_verify.fundamental_from_poses(*map(jnp.asarray, cams)))
    Ft = verify.fundamental_from_poses(*map(torch.from_numpy, cams)).numpy()
    np.testing.assert_allclose(Ft, Fj, rtol=1e-5, atol=1e-9)
    dj = np.asarray(jax_verify.symmetric_epipolar_distance(jnp.asarray(uv0), jnp.asarray(uv1),
                                                            jnp.asarray(Fj)))
    dt = verify.symmetric_epipolar_distance(torch.from_numpy(uv0), torch.from_numpy(uv1),
                                            torch.from_numpy(np.array(Fj))).numpy()
    np.testing.assert_allclose(dt, dj, rtol=1e-5, atol=1e-4)
    got = verify.epipolar_verify_matches(torch.from_numpy(uv0), torch.from_numpy(uv1),
                                         torch.from_numpy(valid),
                                         *map(torch.from_numpy, cams)).numpy()
    want = np.asarray(jax_verify.epipolar_verify_matches(
        jnp.asarray(uv0), jnp.asarray(uv1), jnp.asarray(valid), *map(jnp.asarray, cams)))
    away = np.abs(dj - 4.0) > 1e-3
    np.testing.assert_array_equal(got[away], want[away])
    assert 0.1 < want.mean() < valid.mean()  # the gate cuts the planted outliers


def test_epipolar_verify_with_a_singular_K_matches_jax():
    """A pair whose first K is all zero: F is not finite and the pair's
    matches all fail the gate, as in JAX (jnp.linalg.inv does not raise);
    the other pairs are verified as before."""
    scene, pairs, m0 = _scene_matches()
    i, j = pairs[:, 0], pairs[:, 1]
    kp, K, P = scene["keypoints"], scene["K"], scene["poses"]
    uv0 = kp[i[:, None], np.arange(256)[None]]
    uv1 = kp[j[:, None], np.maximum(m0, 0)]
    valid = m0 >= 0
    K0 = K[i].copy()
    K0[0] = 0.0
    cams = (K0, P[i, :3, :3], P[i, :3, 3], K[j], P[j, :3, :3], P[j, :3, 3])
    got = verify.epipolar_verify_matches(torch.from_numpy(uv0), torch.from_numpy(uv1),
                                         torch.from_numpy(valid),
                                         *map(torch.from_numpy, cams)).numpy()
    want = np.asarray(jax_verify.epipolar_verify_matches(
        jnp.asarray(uv0), jnp.asarray(uv1), jnp.asarray(valid), *map(jnp.asarray, cams)))
    assert valid[0].any() and not want[0].any()
    np.testing.assert_array_equal(got, want)


# --- 7. triangulation ------------------------------------------------------


def _tri_inputs(seed=5, n=64, L=6):
    """Tracks of L views of points seen by the scene's cameras, 1 px noise,
    some observations masked, some tracks left with one or none."""
    scene = make_scene(np.random.default_rng(seed))
    rng = np.random.default_rng(seed + 1)
    pts = (rng.random((n, 3)) - 0.5) * 0.2
    fr = np.stack([rng.choice(12, L, replace=False) for _ in range(n)])
    R, t, K = scene["poses"][fr, :3, :3], scene["poses"][fr, :3, 3], scene["K"][fr]
    pc = np.einsum("tlij,tj->tli", R, pts) + t
    pix = np.einsum("tlij,tlj->tli", K, pc)
    uv = (pix[..., :2] / pix[..., 2:] + rng.normal(size=(n, L, 2))).astype(np.float32)
    mask = rng.random((n, L)) < 0.8
    mask[:3] = False
    mask[3, 1:] = False
    P = np.einsum("tlij,tljk->tlik", K, np.concatenate([R, t[..., None]], -1))
    return pts, uv, K, R, t, mask, P.astype(np.float32)


def test_triangulation_matches_jax():
    """DLT: ok identical, xyz within 1e-4 (a few tenths of a metre, fp32
    eigenvectors) where ok; two-view DLT likewise; residuals within 1e-4
    px; 5 GN steps within 1e-5 of JAX's and closer to the planted
    points than the DLT."""
    pts, uv, K, R, t, mask, P = _tri_inputs()
    xj, okj = map(np.asarray, jax_tri.triangulate_tracks_dlt(
        jnp.asarray(uv), jnp.asarray(P), jnp.asarray(mask)))
    xt, okt = triangulation.triangulate_tracks_dlt(
        torch.from_numpy(uv), torch.from_numpy(P), torch.from_numpy(mask))
    xt, okt = xt.numpy(), okt.numpy()
    np.testing.assert_array_equal(okt, okj)
    assert not okt[:4].any() and okt[4:].all()
    np.testing.assert_allclose(xt[okt], xj[okj], atol=1e-4)
    two_j = np.asarray(jax_tri.triangulate_two_view(
        jnp.asarray(uv[:, 0]), jnp.asarray(uv[:, 1]), jnp.asarray(P[0, 0]), jnp.asarray(P[0, 1])))
    two_t = triangulation.triangulate_two_view(
        torch.from_numpy(uv[:, 0]), torch.from_numpy(uv[:, 1]), torch.from_numpy(P[0, 0]),
        torch.from_numpy(P[0, 1])).numpy()
    np.testing.assert_allclose(two_t, two_j, atol=1e-4)
    cams = tuple(np.asarray(x, np.float32) for x in (K, R, t))
    ej, fj = map(np.asarray, jax_tri.triangulation_residuals(
        jnp.asarray(xj), jnp.asarray(uv), *map(jnp.asarray, cams), jnp.asarray(mask)))
    et, ft = triangulation.triangulation_residuals(
        torch.from_numpy(xj), torch.from_numpy(uv), *map(torch.from_numpy, cams),
        torch.from_numpy(mask))
    np.testing.assert_allclose(et.numpy()[okj], ej[okj], atol=1e-4)
    np.testing.assert_array_equal(ft.numpy(), fj)
    gj = np.asarray(jax_tri.refine_points_gn(jnp.asarray(xj), jnp.asarray(uv),
                                             *map(jnp.asarray, cams), jnp.asarray(mask)))
    gt = triangulation.refine_points_gn(torch.from_numpy(xj), torch.from_numpy(uv),
                                        *map(torch.from_numpy, cams),
                                        torch.from_numpy(mask)).numpy()
    np.testing.assert_allclose(gt[okj], gj[okj], atol=1e-5)
    err = lambda x: np.linalg.norm(x[okj] - pts[okj], axis=-1).mean()  # noqa: E731
    assert err(gt) < err(xt)


def test_triangulation_of_a_non_finite_track_matches_jax():
    """A NaN pixel in one valid observation: JAX's eigh gives that track NaN
    (not ok), where torch.linalg.eigh raised for the whole batch; ok is
    JAX's and the other tracks within 1e-4 of JAX's."""
    pts, uv, K, R, t, mask, P = _tri_inputs()
    uv = uv.copy()
    assert mask[5, 0]
    uv[5, 0, 0] = np.nan
    xj, okj = map(np.asarray, jax_tri.triangulate_tracks_dlt(
        jnp.asarray(uv), jnp.asarray(P), jnp.asarray(mask)))
    xt, okt = triangulation.triangulate_tracks_dlt(
        torch.from_numpy(uv), torch.from_numpy(P), torch.from_numpy(mask))
    assert not okj[5] and okj.sum() > 50
    np.testing.assert_array_equal(okt.numpy(), okj)
    np.testing.assert_allclose(xt.numpy()[okj], xj[okj], atol=1e-4)


def test_refine_points_without_damping_matches_jax():
    """damping=0 leaves the tracks with no valid observation an all-zero 3 x
    3 system: non-finite there, as JAX's LU gives (torch.linalg.solve
    raised for the batch); the same tracks are finite in both packages and
    the triangulated ones within 1e-5 of JAX's."""
    pts, uv, K, R, t, mask, P = _tri_inputs()
    xj, okj = map(np.asarray, jax_tri.triangulate_tracks_dlt(
        jnp.asarray(uv), jnp.asarray(P), jnp.asarray(mask)))
    cams = tuple(np.asarray(x, np.float32) for x in (K, R, t))
    gj = np.asarray(jax_tri.refine_points_gn(jnp.asarray(xj), jnp.asarray(uv),
                                             *map(jnp.asarray, cams), jnp.asarray(mask),
                                             damping=0.0))
    gt = triangulation.refine_points_gn(torch.from_numpy(xj), torch.from_numpy(uv),
                                        *map(torch.from_numpy, cams), torch.from_numpy(mask),
                                        damping=0.0).numpy()
    finite = np.isfinite(gj).all(-1)
    assert not finite[:3].any() and finite[okj].all()
    np.testing.assert_array_equal(np.isfinite(gt).all(-1), finite)
    np.testing.assert_allclose(gt[okj], gj[okj], atol=1e-5)


def test_dlt_solves_in_chunks(monkeypatch):
    """The batched eigh runs in chunks of EIGH_BATCH systems (cuSOLVER
    rejects a batch of about 40000): chunks of 5 give the same vectors as
    one call, and JAX's DLT; an empty track set gives an empty result."""
    pts, uv, K, R, t, mask, P = _tri_inputs()
    args = (torch.from_numpy(uv), torch.from_numpy(P), torch.from_numpy(mask))
    whole, ok = triangulation.triangulate_tracks_dlt(*args)
    monkeypatch.setattr(triangulation, "EIGH_BATCH", 5)
    assert len(uv) > 10  # several chunks, the last one ragged
    chunked, ok_c = triangulation.triangulate_tracks_dlt(*args)
    np.testing.assert_array_equal(ok_c.numpy(), ok.numpy())
    np.testing.assert_array_equal(chunked.numpy()[ok.numpy()], whole.numpy()[ok.numpy()])
    xj, okj = map(np.asarray, jax_tri.triangulate_tracks_dlt(*map(jnp.asarray, (uv, P, mask))))
    np.testing.assert_array_equal(ok_c.numpy(), okj)
    np.testing.assert_allclose(chunked.numpy()[okj], xj[okj], atol=1e-4)
    empty, ok_e = triangulation.triangulate_tracks_dlt(*(a[:0] for a in args))
    assert empty.shape == (0, 3) and ok_e.shape == (0,)


# --- 8. triangulate and filter ---------------------------------------------


def test_triangulate_and_filter_tracks_matches_jax():
    """The scene's tracks: ok, obs_inlier identical; xyz within 1e-5 where
    ok; mean reprojection error within 1e-4 px; angles within 1e-3 deg."""
    scene, pairs, m0 = _scene_matches()
    tr = tracks.build_tracks(pairs, m0, 12, 256)
    kp, K, P = scene["keypoints"], scene["K"], scene["poses"]
    args = (tr.obs_frame, tr.obs_kpt, tr.obs_mask, kp, K, P[:, :3, :3], P[:, :3, 3])
    want = {k: np.asarray(v) for k, v in jax_triangulate.triangulate_and_filter_tracks(
        *map(jnp.asarray, args)).items()}
    got = {k: v.numpy() for k, v in triangulate.triangulate_and_filter_tracks(
        *(torch.from_numpy(np.ascontiguousarray(a)) for a in args)).items()}
    ok = want["ok"]
    np.testing.assert_array_equal(got["ok"], ok)
    np.testing.assert_array_equal(got["obs_inlier"], want["obs_inlier"])
    assert ok.mean() > 0.9
    np.testing.assert_allclose(got["xyz"][ok], want["xyz"][ok], atol=1e-5)
    np.testing.assert_allclose(got["mean_reproj"][ok], want["mean_reproj"][ok], atol=1e-4)
    np.testing.assert_allclose(got["tri_angle"][ok], want["tri_angle"][ok], atol=1e-3)


# --- 10. run_mapping end to end --------------------------------------------


@pytest.mark.parametrize("ba", ["off", "points", "cameras"])
def test_run_mapping_matches_jax(ba):
    """tests/test_sfm.py::TestMappingEndToEnd's setup (300 points, 12
    frames, 0.3 px noise, max_points3d 500, num_covis 6, 512 slots), global
    BA off, on with the cameras fixed, and on refining the cameras: the
    same pairs, tracks, integer stats, leaf masks and assign matrices;
    points within 1e-5 (2e-5 after BA), descriptors within 1e-6, errors
    within 1e-5 px, refined poses within 1e-5."""
    scene = make_scene(np.random.default_rng(42), n_pts=300, n_frames=12, noise=0.3)
    matcher = nn_pair_matcher(scene)
    seen = []

    def match(pairs):
        seen.append(np.array(pairs))
        return matcher(pairs)

    kw = dict(max_points3d=500, num_covis=6, global_ba=ba != "off",
              global_ba_refine_cameras=ba == "cameras")
    args = (scene["keypoints"], scene["descriptors"], scene["scores"], scene["mask"],
            scene["K"], scene["poses"], match)
    want = jax_run_mapping(*args, config=JaxMappingConfig(**kw), pad_points_to=512)
    got = run_mapping(*args, config=MappingConfig(**kw), pad_points_to=512, device=CPU)
    np.testing.assert_array_equal(seen[0], seen[1])
    for k in ("num_frames", "num_pairs", "num_tracks", "num_points3d",
              "track_length_threshold", "num_observations"):
        assert got.stats[k] == want.stats[k], k
    assert got.stats.keys() == want.stats.keys()
    for k, v in want.stats.items():
        assert abs(got.stats[k] - v) <= 1e-5, k
    assert 150 < got.stats["num_points3d"] <= 500
    atol = 1e-5 if ba == "off" else 2e-5
    np.testing.assert_allclose(got.points_xyz, want.points_xyz, atol=atol)
    anno = {k: getattr(got.annotation, k) for k in
            ("points3d", "desc3d", "leaf_desc", "mask3d", "leaf_mask")}
    assert all(v.device.type == CPU for v in anno.values())
    for k, v in anno.items():
        w = np.asarray(getattr(want.annotation, k))
        assert v.shape == w.shape and v.numpy().dtype == w.dtype, k
        if w.dtype == bool:
            np.testing.assert_array_equal(v.numpy(), w, err_msg=k)
        else:
            np.testing.assert_allclose(v.numpy(), w, atol=atol if k == "points3d" else 1e-6,
                                       err_msg=k)
    for k in ("leaf_scores", "scores_avg", "desc_concat", "scores_concat", "idxs"):
        np.testing.assert_array_equal(getattr(got, k), getattr(want, k), err_msg=k)
    assert got.frame_assign.keys() == want.frame_assign.keys()
    for f, am in want.frame_assign.items():
        np.testing.assert_array_equal(got.frame_assign[f], am)
    if ba == "cameras":
        np.testing.assert_allclose(got.refined_poses, want.refined_poses, atol=1e-5)
    else:
        assert got.refined_poses is None and want.refined_poses is None


def test_run_mapping_checks_its_inputs():
    """A matcher must return exactly one row per pair (a padded chunk's
    extra rows are the matcher's to drop); a mesh of one rank takes the
    one-device BA and maps alike (several ranks:
    tests/test_torch_parallel_serving.py); CUDA without CUDA raises."""
    scene = make_scene(np.random.default_rng(42), n_frames=8)
    args = (scene["keypoints"], scene["descriptors"], scene["scores"], scene["mask"],
            scene["K"], scene["poses"])
    matcher = nn_pair_matcher(scene)
    with pytest.raises(ValueError, match="one row of 256 per pair"):
        run_mapping(*args, lambda p: matcher(np.concatenate([p, p[:1]])), device=CPU)
    from onepose_tpu_torch.parallel.mesh import make_mesh

    plain, meshed = (run_mapping(*args, matcher, config=MappingConfig(global_ba=True, mesh=m),
                                 device=CPU) for m in (None, make_mesh(device="cpu")))
    np.testing.assert_array_equal(meshed.points_xyz, plain.points_xyz)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            run_mapping(*args, matcher)
