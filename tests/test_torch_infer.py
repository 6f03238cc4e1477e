"""The port's `infer` command and its modules against the JAX package's, on
the CPU.

- `Evaluator` (per-frame errors, recalls, sufficient statistics and
  `combine_counts`) on the same poses: recalls and counts identical;
  translation errors within 1e-4 cm and rotation errors by their cosine
  within 1e-6, since both packages take the arccos of a float32 trace (a
  one-ulp change of the trace moves a 0.4 degree error by 1e-3 degrees).
- `FrameLoader`: the native decoder and the cv2 path against JAX's loader
  and cv2, with and without an affine warp.
- `load_matcher_params` on a JAX-written bare checkpoint and on a JAX
  TrainState checkpoint: the bridge's state_dict, exactly.
- The oracle of tests/test_cli.py::test_oracle_feature_cache_cmd1 (planted
  keypoints, one unit descriptor per 3D point, exact projections, injected
  through the feature cache, mapped by JAX `map`): the port's `infer
  device=cpu` gives cmd1 == 1.0 and JAX's per-frame errors within 1e-4.
- The image route with `matcher=gats` on 4 frames with JAX-written
  checkpoints and the dual-softmax head fused on both sides (ROADMAP C
  watch item 4; `match_threshold` 0.02 on both, as in
  tests/test_torch_pipeline.py, so that random weights give matches): the
  same keypoints and the same matches0, read from each command's
  `dump_vis3d` output.
- A roster of two sequences, serial against `batch_objects`.
"""

import functools
import glob
import json
import os.path as osp

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_cli import build_sequence, build_textured_sequence

from onepose_tpu.__main__ import main as jax_main
from onepose_tpu.eval import Evaluator as JaxEvaluator
from onepose_tpu.models.gats_spg import GATsSPG as JaxGATsSPG
from onepose_tpu.models.superpoint import SuperPoint as JaxSuperPoint
from onepose_tpu.utils.checkpoint import save_checkpoint as jax_save_checkpoint
from onepose_tpu_torch.__main__ import main as port_main
from onepose_tpu_torch.cli import common
from onepose_tpu_torch.cli.infer import eval_sequence
from onepose_tpu_torch.eval import Evaluator
from onepose_tpu_torch.models import bridge
from onepose_tpu_torch.models.gats_spg import GATsSPG

torch.set_num_threads(2)


def _last_json(capsys):
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])


# --- Evaluator ---------------------------------------------------------------


def _poses(rng, n, rot_deg, trans_cm):
    """n GT poses and predictions off by up to rot_deg / trans_cm."""
    from scipy.spatial.transform import Rotation

    gt = np.tile(np.eye(4), (n, 1, 1))
    gt[:, :3, :3] = Rotation.random(n, random_state=rng.integers(1 << 30)).as_matrix()
    gt[:, :3, 3] = rng.normal(size=(n, 3)) * 0.2 + [0, 0, 0.7]
    axis = rng.normal(size=(n, 3))
    axis /= np.linalg.norm(axis, axis=1, keepdims=True)
    d = Rotation.from_rotvec(axis * np.radians(rng.random((n, 1)) * rot_deg)).as_matrix()
    pred = gt.copy()
    pred[:, :3, :3] = d @ gt[:, :3, :3]
    pred[:, :3, 3] += rng.normal(size=(n, 3)) * trans_cm / 100 / np.sqrt(3)
    return pred.astype(np.float32), gt.astype(np.float32)


def test_evaluator_matches_jax():
    rng = np.random.default_rng(0)
    ours, theirs = Evaluator(), JaxEvaluator()
    parts = [_poses(rng, 12, 6.0, 6.0), _poses(rng, 1, 2.0, 2.0), _poses(rng, 7, 0.5, 0.5)]
    for pred, gt in parts:
        ours.evaluate(pred, gt)
        theirs.evaluate(pred, gt)
    ours.evaluate(torch.from_numpy(parts[0][0][:3]), parts[0][1][:3])  # tensors welcome
    theirs.evaluate(parts[0][0][:3], parts[0][1][:3])
    ours.evaluate(None, None)  # a failed frame
    theirs.evaluate(None, None)
    r, r_want = np.asarray(ours.r_errs), np.asarray(theirs.r_errs)
    assert np.isinf(r[-1]) and np.isinf(r_want[-1]) and np.isinf(ours.t_errs[-1])
    np.testing.assert_allclose(np.cos(np.radians(r[:-1])), np.cos(np.radians(r_want[:-1])),
                               atol=1e-6)
    np.testing.assert_allclose(ours.t_errs, theirs.t_errs, atol=1e-4)
    counts, want = ours.counts(), theirs.counts()
    assert counts.keys() == want.keys()
    for k in want:  # the sum of 23 rotation errors: 23 x 1e-3 at most
        assert counts[k] == pytest.approx(want[k], abs=3e-2 if k.endswith("_sum") else 0), k
    combined = Evaluator.combine_counts([counts, counts])
    combined_want = JaxEvaluator.combine_counts([want, want])
    assert combined.keys() == combined_want.keys()
    for k in combined_want:
        assert combined[k] == pytest.approx(combined_want[k], abs=2e-3 if k.startswith("mean")
                                            else 0), k
    got, want = ours.summarize(), theirs.summarize()
    assert got.keys() == want.keys()
    for k in want:
        assert got[k] == pytest.approx(want[k], abs=2e-3 if k.startswith("mean") else 0), k
    assert got["num_frames"] == 24 and 0 < got["cmd5"] < 1
    assert ours.r_errs == [] and ours.summarize()["num_frames"] == 0


def test_record_eval_result(tmp_path):
    from onepose_tpu.eval import record_eval_result as jax_record
    from onepose_tpu_torch.eval import record_eval_result

    m = {"cmd1": 0.5, "cmd3": 1.0, "num_frames": 4}
    a, b = record_eval_result(str(tmp_path / "a"), "seq", m), jax_record(str(tmp_path / "b"),
                                                                           "seq", m)
    assert open(a).read() == open(b).read()


# --- FrameLoader -------------------------------------------------------------


@pytest.fixture(scope="module")
def frames(tmp_path_factory):
    cv2 = pytest.importorskip("cv2")
    root = tmp_path_factory.mktemp("frames")
    rng = np.random.default_rng(1)
    paths = []
    for i in range(5):
        img = (rng.random((48, 64, 3)) * 255).astype(np.uint8)
        p = str(root / f"{i}.png")
        cv2.imwrite(p, img)
        paths.append(p)
    return paths


@pytest.mark.parametrize("warp", [False, True])
def test_frame_loader_matches_jax(frames, warp):
    """Both paths of the port's loader against JAX's (native) and JAX's cv2
    path: the same frames in order; the native decode within 1e-6 of JAX's
    native decode, cv2's within 1.5 grey levels of it (cv2 computes BT.601
    in fixed point and rounds to 8 bits, the native decoder keeps the
    float); a missing file yields None."""
    from onepose_tpu.native.frame_loader import FrameLoader as JaxLoader
    from onepose_tpu_torch.geometry.transforms import get_affine_transform
    from onepose_tpu_torch.native.frame_loader import FrameLoader

    paths = frames + [frames[0] + ".missing.png"]
    kw = {}
    if warp:
        affines = np.stack([get_affine_transform((30 + i, 20), (40, 40), 0, (32, 32), inv=True)
                            for i in range(len(paths))])
        kw = dict(out_hw=(32, 32), affines=affines)
    native = FrameLoader(paths, **kw)
    assert native.backend == "native"
    cv = FrameLoader(paths, **kw)
    cv._native = False
    assert cv.backend == "cv2"
    jax_native = JaxLoader(paths, **kw)
    jax_cv = JaxLoader(paths, **kw)
    jax_cv._native = False
    got = [list(x) for x in (native, cv, jax_native, jax_cv)]
    for run in got:
        assert [i for i, _ in run] == list(range(len(paths)))
        assert run[-1][1] is None
    for (_, a), (_, b), (_, c), (_, d) in zip(*(run[:-1] for run in got)):
        assert a.dtype == np.float32 and a.shape == ((32, 32) if warp else (48, 64))
        np.testing.assert_allclose(a, c, atol=1e-6)
        np.testing.assert_allclose(b, d, atol=1e-6)
        assert np.abs(a - b).max() <= 1.5 / 255


# --- load_matcher_params -----------------------------------------------------


def test_load_matcher_params_from_jax_checkpoints(tmp_path):
    """A bare GATsSPG checkpoint and a train loop's TrainState checkpoint,
    both written by the JAX package, give the bridge's state_dict exactly;
    None the seeded init; a Lightning .ckpt in the reference's layout (4
    blocks, 'matcher.' prefixes) the state_dict of its conversion."""
    from test_torch_convert import gats_spg_sd

    from onepose_tpu.models.convert import gats_spg_from_torch
    from onepose_tpu.train.train_step import TrainConfig, create_train_state

    model = JaxGATsSPG(num_blocks=2)
    batch = {"desc2d": jnp.zeros((1, 8, 256)), "desc3d": jnp.zeros((1, 6, 256)),
             "leaf_desc": jnp.zeros((1, 6, 4, 256))}
    state = create_train_state(jax.random.PRNGKey(2), model, TrainConfig(), batch)
    params = state.params
    bare = jax_save_checkpoint(str(tmp_path / "bare"), params, 0)
    full = jax_save_checkpoint(str(tmp_path / "state"), state, 3)
    want = bridge.gats_spg_state_dict(jax.tree.map(np.asarray, params))
    port = GATsSPG(num_blocks=2)
    for path in (bare, full):
        sd = common.load_matcher_params(port, path)
        assert sd.keys() == want.keys()
        for k in want:
            torch.testing.assert_close(sd[k], want[k], rtol=0, atol=0)
        port.load_state_dict(sd)
    a, b = common.load_matcher_params(port, None), common.load_matcher_params(port, None)
    assert all(torch.equal(a[k], b[k]) for k in a)
    ref = gats_spg_sd()
    torch.save({"state_dict": ref, "epoch": 1}, tmp_path / "w.ckpt")
    got = common.load_matcher_params(GATsSPG(), str(tmp_path / "w.ckpt"))
    converted = bridge.gats_spg_state_dict(gats_spg_from_torch(ref))
    assert got.keys() == converted.keys()
    assert all(torch.equal(got[k], converted[k]) for k in converted)
    GATsSPG().load_state_dict(got)
    m, p = common.build_matcher({"matcher": "gats", "weights": {"matcher": bare}})
    assert isinstance(m, GATsSPG) and m.fused_match and p.keys() == want.keys()
    m, p = common.build_matcher({"matcher": "nn", "nn_distance_thresh": 0.5})
    assert p == {} and m.distance_thresh == 0.5


# --- the oracle: infer on JAX map's artifacts ------------------------------


def _oracle_scene(root):
    """tests/test_cli.py::test_oracle_feature_cache_cmd1's sequence and its
    planted-feature cache, mapped by JAX `map`. Returns (seq, out_dir,
    feats_h5, features)."""
    cv2 = pytest.importorskip("cv2")
    pytest.importorskip("h5py")
    from onepose_tpu.sfm.cache import save_features_h5

    rng = np.random.default_rng(7)
    n_frames, n_pts, img, f_len = 8, 40, 128, 200.0
    obj_root = root / "obj"
    seq = obj_root / "seq"
    for sub in ("color", "poses_ba", "intrin_ba"):
        (seq / sub).mkdir(parents=True)
    g = np.stack(np.meshgrid(*[np.linspace(-0.08, 0.08, 4)] * 3), -1).reshape(-1, 3)
    pts3d = (g[rng.permutation(len(g))[:n_pts]]
             + rng.uniform(-0.01, 0.01, (n_pts, 3))).astype(np.float64)
    K = np.array([[f_len, 0, img / 2], [0, f_len, img / 2], [0, 0, 1]], np.float64)
    np.savetxt(str(obj_root / "box3d_corners.txt"),
               np.array([[x, y, z] for y in (0.15, -0.15) for x, z in
                         [(-0.15, -0.15), (-0.15, 0.15), (0.15, 0.15), (0.15, -0.15)]]))
    desc = rng.normal(size=(n_pts, 256)).astype(np.float32)
    desc /= np.linalg.norm(desc, axis=-1, keepdims=True)
    kps = []
    for f in range(n_frames):
        ang = 0.6 * f / n_frames * 2 * np.pi
        center = np.array([np.cos(ang) * 0.6, np.sin(ang) * 0.6, 0.4])
        z = -center / np.linalg.norm(center)
        x = np.cross([0, 0, 1.0], z)
        x /= np.linalg.norm(x)
        y = np.cross(z, x)
        R = np.stack([x, y, z])
        t = -R @ center
        pose = np.eye(4)
        pose[:3, :3], pose[:3, 3] = R, t
        uvw = (pts3d @ R.T + t) @ K.T
        kps.append((uvw[:, :2] / uvw[:, 2:3]).astype(np.float32))
        cv2.imwrite(str(seq / "color" / f"{f}.png"), np.zeros((img, img), np.uint8))
        np.savetxt(str(seq / "poses_ba" / f"{f}.txt"), pose)
        np.savetxt(str(seq / "intrin_ba" / f"{f}.txt"), K)
    features = {"keypoints": np.stack(kps), "descriptors": np.stack([desc] * n_frames),
                "scores": np.ones((n_frames, n_pts), np.float32),
                "mask": np.ones((n_frames, n_pts), bool)}
    out_dir = str(obj_root / "outputs")
    feats_h5 = osp.join(out_dir, "feats-superpoint.h5")
    save_features_h5(feats_h5, [f"{f}.png" for f in range(n_frames)], features["keypoints"],
                     features["descriptors"], features["scores"], features["mask"], (img, img))
    assert jax_main(["map", f"data_dir={seq}", f"out_dir={out_dir}", f"max_keypoints={n_pts}",
                     "num_covis=4", "max_points3d=300", "redo=false"]) == 0
    return str(seq), out_dir, feats_h5, features


def _frame_errors(dump_dir, seq):
    """Per-frame (rotation deg, translation cm) in float64 of the poses a
    command dumped (dump_vis3d) against the sequence's ground truth. The
    angle comes from the chordal distance, |Rp - Rg|_F = 2 sqrt(2)
    sin(theta / 2): the trace's arccos reads about 0.02 degrees of the
    float32 rounding of a rotation near the truth, the chordal form 1e-5."""
    errs = []
    frames = sorted(int(osp.basename(p)) for p in glob.glob(osp.join(dump_dir, "*")))
    for f in frames:
        pose = np.asarray(json.load(open(osp.join(dump_dir, str(f), "camera.json")))["pose_w2c"])
        gt = np.loadtxt(osp.join(seq, "poses_ba", f"{f}.txt"))
        chord = np.linalg.norm(pose[:3, :3] - gt[:3, :3]) / (2 * np.sqrt(2))
        errs.append((np.degrees(2 * np.arcsin(min(chord, 1.0))),
                     np.linalg.norm(pose[:3, 3] - gt[:3, 3]) * 100))
    return np.array(errs)


def test_infer_oracle_matches_jax(tmp_path, capsys):
    """cmd1 == 1.0 and JAX's per-frame errors within 1e-4 on JAX `map`'s
    artifacts; the feature cache handed over as arrays (`eval_sequence`'s
    `features`, the route chip_smoke takes without h5py) gives the same."""
    seq, out_dir, feats_h5, features = _oracle_scene(tmp_path)
    capsys.readouterr()
    common_args = [f"data_dir={seq}", f"anno_dir={osp.join(out_dir, 'anno')}",
                   f"features_h5={feats_h5}", "matcher=nn", "max_keypoints=40", "shape3d=300",
                   "batch=4"]
    assert jax_main(["infer", *common_args, f"dump_vis3d={tmp_path / 'jax_vis'}"]) == 0
    want = _last_json(capsys)
    assert port_main(["infer", *common_args, f"dump_vis3d={tmp_path / 'port_vis'}",
                      "device=cpu"]) == 0
    got = _last_json(capsys)
    assert got.keys() == want.keys()
    assert got["num_frames"] == want["num_frames"] == 8
    assert got["cmd1"] == want["cmd1"] == 1.0, got
    assert got["mean_trans_cm"] < 0.1 and got["mean_rot_deg"] < 0.1, got
    e_got = _frame_errors(str(tmp_path / "port_vis"), seq)
    e_want = _frame_errors(str(tmp_path / "jax_vis"), seq)
    assert e_got.shape == e_want.shape == (8, 2)
    np.testing.assert_allclose(e_got, e_want, atol=1e-4)

    from onepose_tpu_torch.cli.infer import DEFAULTS, build_pipeline
    from onepose_tpu_torch.data.anno_io import annotation_from_npz_dir

    cfg = {**DEFAULTS, "matcher": "nn", "max_keypoints": 40, "batch": 4, "device": "cpu"}
    pipe = build_pipeline(cfg, torch.device("cpu"))
    anno = annotation_from_npz_dir(osp.join(out_dir, "anno"), shape3d=300, device="cpu")
    m = eval_sequence(cfg, seq, anno, pipe, Evaluator(), features=features)
    assert m == pytest.approx({k: v for k, v in got.items()}, abs=1e-9)


# --- the image route with the learned matcher ------------------------------


def _random_annotation(anno_dir, rng, n_pts=48, c=256):
    anno_dir.mkdir(parents=True)
    unit = lambda x: x / np.linalg.norm(x, axis=0, keepdims=True)  # noqa: E731
    xyz = ((rng.random((n_pts, 3)) - 0.5) * 0.2).astype(np.float32)
    idxs = rng.integers(1, 9, n_pts)
    np.savez(anno_dir / "anno_3d_average.npz", keypoints3d=xyz,
             descriptors3d=unit(rng.normal(size=(c, n_pts))).astype(np.float32),
             scores3d=rng.random((n_pts, 1)).astype(np.float32))
    np.savez(anno_dir / "anno_3d_collect.npz", keypoints3d=xyz,
             descriptors3d=unit(rng.normal(size=(c, idxs.sum()))).astype(np.float32),
             scores3d=rng.random((idxs.sum(), 1)).astype(np.float32))
    np.save(anno_dir / "idxs.npy", idxs)


def test_infer_image_route_gats_matches_jax(tmp_path, capsys, monkeypatch):
    import onepose_tpu.cli.common as jax_common
    import onepose_tpu_torch.models.gats_spg as port_gats_spg

    seq = build_sequence(tmp_path, np.random.default_rng(4), n_frames=4, img=96, n_pts=40)
    _random_annotation(tmp_path / "anno", np.random.default_rng(5))
    sp = JaxSuperPoint().init(jax.random.PRNGKey(6), jnp.zeros((1, 64, 64, 1)))
    gm = JaxGATsSPG().init(jax.random.PRNGKey(7), jnp.zeros((1, 8, 256)), jnp.zeros((1, 6, 256)),
                           jnp.zeros((1, 6, 4, 256)))
    sp_ckpt = jax_save_checkpoint(str(tmp_path / "sp"), sp, 0)
    gm_ckpt = jax_save_checkpoint(str(tmp_path / "gm"), gm, 0)
    monkeypatch.setattr(jax_common, "GATsSPG", functools.partial(
        JaxGATsSPG, fused_match=True, gats_use_pallas=True, match_threshold=0.02))
    monkeypatch.setattr(port_gats_spg, "GATsSPG", functools.partial(
        port_gats_spg.GATsSPG, match_threshold=0.02))
    args = [f"data_dir={seq}", f"anno_dir={tmp_path / 'anno'}", "matcher=gats",
            f"weights.superpoint={sp_ckpt}", f"weights.matcher={gm_ckpt}", "max_keypoints=64",
            "shape3d=48", "batch=4"]
    assert jax_main(["infer", *args, f"dump_vis3d={tmp_path / 'jax_vis'}"]) == 0
    want = _last_json(capsys)
    assert port_main(["infer", *args, f"dump_vis3d={tmp_path / 'port_vis'}", "device=cpu"]) == 0
    got = _last_json(capsys)
    assert got.keys() == want.keys() and got["num_frames"] == want["num_frames"] == 4
    n_matched = 0
    for f in range(4):
        a, b = (json.load(open(tmp_path / d / str(f) / "camera.json"))
                for d in ("port_vis", "jax_vis"))
        np.testing.assert_array_equal(np.asarray(a["kpts2d"]), np.asarray(b["kpts2d"]))
        np.testing.assert_array_equal(np.asarray(a["matched_pts3d"]),
                                      np.asarray(b["matched_pts3d"]))
        np.testing.assert_array_equal(np.asarray(a["K"]), np.asarray(b["K"]))
        n_matched += len(a["matched_pts3d"])
    assert n_matched > 0


# --- rosters ----------------------------------------------------------------


def test_infer_roster_batch_objects_matches_serial(tmp_path, capsys):
    """tests/test_cli.py:262 on the port, at its sizes and with its weights
    (JAX's SuperPoint init from PRNGKey(0), written as a checkpoint): two
    objects mapped by the port, served serially and as mixed-object
    batches; the roster's metrics and eval_out files; the reference's
    batch_objects naming is kept."""
    import os

    sp = JaxSuperPoint().init(jax.random.PRNGKey(0), jnp.zeros((1, 64, 64, 1)))
    sp_ckpt = jax_save_checkpoint(str(tmp_path / "sp"), sp, 0)
    seq_dirs = []
    for i, name in enumerate(("a", "b")):
        seq, _ = build_textured_sequence(tmp_path / name, np.random.default_rng(30 + i),
                                         n_frames=6)
        assert port_main(["map", f"data_dir={seq}", "max_keypoints=256", "num_covis=4",
                          "max_points3d=300", f"weights.superpoint={sp_ckpt}", "device=cpu",
                          "cache=false"]) == 0
        capsys.readouterr()
        renamed = osp.join(osp.dirname(seq), f"seq_{name}")
        os.rename(seq, renamed)
        seq_dirs.append(renamed)
    common_args = ["infer", f"data_dir={','.join(seq_dirs)}", "matcher=nn", "max_keypoints=256",
                   "shape3d=300", "batch=4", f"weights.superpoint={sp_ckpt}", "device=cpu"]
    assert port_main(common_args + [f"eval_out={tmp_path / 'eval'}"]) == 0
    serial = _last_json(capsys)
    assert port_main(common_args + ["batch_objects=true", "seq_name=ignored"]) == 0
    mixed = _last_json(capsys)
    assert mixed["num_frames"] == serial["num_frames"] == 12
    assert set(mixed["per_seq"]) == set(serial["per_seq"]) == {"seq_a", "seq_b"}
    for name in mixed["per_seq"]:
        assert mixed["per_seq"][name]["num_frames"] == serial["per_seq"][name]["num_frames"] == 6
    for k in ("cmd3", "cmd5"):
        assert mixed[k] == pytest.approx(serial[k], abs=1e-9), k
    # Batch composition changes the per-frame RANSAC draws: a frame at the
    # 1 cm threshold may flip.
    assert abs(mixed["cmd1"] - serial["cmd1"]) <= 1 / 12 + 1e-9
    assert mixed["cmd3"] == 1.0, mixed
    for f in ("ALL.txt", "seq_a.txt", "seq_b.txt"):
        assert (tmp_path / "eval" / f).exists(), f


def test_infer_single_process_only(tmp_path, capsys):
    """In one process data_parallel=true resolves to no mesh (a world of
    one rank) and gives the metrics of data_parallel=false (several ranks:
    tests/test_torch_distributed_cli.py); without CUDA and without
    device=cpu the command raises before any work."""
    seq = build_sequence(tmp_path, np.random.default_rng(4), n_frames=4, img=96, n_pts=40)
    _random_annotation(tmp_path / "anno", np.random.default_rng(5))
    args = ["infer", f"data_dir={seq}", f"anno_dir={tmp_path / 'anno'}", "matcher=nn",
            "max_keypoints=64", "shape3d=48", "batch=4", "device=cpu"]
    assert port_main(args) == 0
    want = _last_json(capsys)
    assert port_main(args + ["data_parallel=true"]) == 0
    assert _last_json(capsys) == want and want["num_frames"] == 4
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            port_main(["infer", f"data_dir={tmp_path}"])
