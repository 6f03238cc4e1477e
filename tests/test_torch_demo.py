"""The port's `demo` command against the JAX package's, on the CPU.

A tiny sequence: a textured orbit (every point its own texture, as
tests/test_cli.py::build_textured_sequence renders it) written as 160 px
crops in color/ (the detector's reference views, mapped by JAX `map`) and
200 px full frames in color_full/ whose principal point sits 13 px off the
crops' (so the detected box lies inside the frame, not on a clamp at its
edge, where a 1e-5 px difference truncates the crop's first stage to
another whole pixel). Both packages run `demo` with JAX-written msgpack
checkpoints, `matcher=nn`, crop 64, 40 keypoints, redetect_inliers 4,
tracking off and on; the port's per-frame RANSAC draws (`demo.frame_draws`)
are JAX's (PRNGKey(fi) split once for a matcher frame, PRNGKey(fi) for a
tracked one), its detector's Gumbel draws JAX's.

Held: the per-frame route (full-frame detection or the box from the
previous pose; matcher or tracker), the summary's counters and keys, the
results.json keys, each frame's confidence, and the poses where JAX's is
finite: a matcher frame's within 1e-3 (rotation entries and metres), a
tracked frame's within 5e-3 (its window BA fits 3 to 5 tracked points, and
which fp32 LM steps it accepts turns on rounding). Random weights: the
poses are poor, but each package must compute the same ones. On scenes
where a tracked frame's two-view triangulation is near-degenerate, the
two trackers' windows part by rounding (ROADMAP C watch item 11); this
scene is not one of them.
"""

import json

import cv2
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import onepose_tpu.detector.feature_detector as jax_fd
from onepose_tpu.__main__ import main as jax_main
from onepose_tpu.models.superpoint import SuperPoint as JaxSuperPoint
from onepose_tpu.utils.checkpoint import save_checkpoint as jax_save_checkpoint
from onepose_tpu_torch.__main__ import main as port_main
from onepose_tpu_torch.cli import demo
from onepose_tpu_torch.detector import feature_detector as port_fd

torch.set_num_threads(2)

POSE_ABS = 1e-3
TRACKED_POSE_ABS = 5e-3
CROP, FULL, OFFSET, FOCAL = 160, 200, 13, 350.0


def _look_at(center):
    z = -center / np.linalg.norm(center)
    x = np.cross([0, 0, 1.0], z)
    x /= np.linalg.norm(x)
    y = np.cross(z, x)
    R = np.stack([x, y, z])
    pose = np.eye(4)
    pose[:3, :3] = R
    pose[:3, 3] = -R @ center
    return pose


def build_demo_sequence(root, rng, n_frames=10, n_pts=60, scale=0.2, lobes=4):
    seq = root / "obj" / "seq"
    for sub in ("color", "color_full", "poses_ba", "intrin_ba"):
        (seq / sub).mkdir(parents=True)
    pts3d = ((rng.random((n_pts, 3)) - 0.5) * scale).astype(np.float32)
    K = np.array([[FOCAL, 0, CROP / 2], [0, FOCAL, CROP / 2], [0, 0, 1]], np.float32)
    K_full = K.copy()
    K_full[:2, 2] += OFFSET
    half = scale * 0.75
    np.savetxt(root / "obj" / "box3d_corners.txt", np.array(
        [[x, y, z] for y in (half, -half) for x, z in
         [(-half, -half), (-half, half), (half, half), (half, -half)]]))
    amp = rng.uniform(0.4, 1.0, (n_pts, lobes)) * rng.choice([-1.0, 1.0], (n_pts, lobes))
    offs = rng.uniform(-3.5, 3.5, (n_pts, lobes, 2))
    sig = rng.uniform(1.2, 4.0, (n_pts, lobes, 2))
    th = rng.uniform(0, np.pi, (n_pts, lobes))

    def render(pose, Km, img):
        ys, xs = np.mgrid[0:img, 0:img]
        pc = pts3d @ pose[:3, :3].T + pose[:3, 3]
        uv = pc @ Km.T
        uv = uv[:, :2] / uv[:, 2:3]
        image = np.full((img, img), 0.25, np.float32)
        for i, p in enumerate(uv):
            if not (8 < p[0] < img - 8 and 8 < p[1] < img - 8):
                continue
            dx, dy = xs - p[0], ys - p[1]
            val = np.zeros_like(image)
            for k in range(lobes):
                c, s = np.cos(th[i, k]), np.sin(th[i, k])
                u1 = (c * (dx - offs[i, k, 0]) + s * (dy - offs[i, k, 1])) / sig[i, k, 0]
                u2 = (-s * (dx - offs[i, k, 0]) + c * (dy - offs[i, k, 1])) / sig[i, k, 1]
                val += amp[i, k] * np.exp(-(u1 ** 2 + u2 ** 2))
            image += np.exp(-(dx ** 2 + dy ** 2) / 40.0) * val
        return (np.clip(image, 0, 1) * 255).astype(np.uint8)

    for f in range(n_frames):
        ang = 0.5 * f / n_frames * 2 * np.pi
        pose = _look_at(np.array([np.cos(ang) * 0.5, np.sin(ang) * 0.5, 0.3]))
        cv2.imwrite(str(seq / "color" / f"{f}.png"), render(pose, K, CROP))
        cv2.imwrite(str(seq / "color_full" / f"{f}.png"), render(pose, K_full, FULL))
        np.savetxt(seq / "poses_ba" / f"{f}.txt", pose)
        np.savetxt(seq / "intrin_ba" / f"{f}.txt", K)
    (seq / "intrinsics.txt").write_text(
        f"fx: {K_full[0, 0]}\nfy: {K_full[1, 1]}\ncx: {K_full[0, 2]}\ncy: {K_full[1, 2]}")
    return seq


def _jax_frame_draws(fi, n_hyp, route):
    key = jax.random.PRNGKey(fi)
    if route == "matcher":  # PosePipeline splits its key over the batch of 1
        key = jax.random.split(key, 1)[0]
    return torch.from_numpy(np.array(jax.random.uniform(key, (n_hyp, 3))))[None]


def _jax_gumbel(shape, generator=None, device=None):
    """The draws of JAX's detect_bbox: PRNGKey(0) split one key a view."""
    V, H, n = shape
    keys = jax.random.split(jax.random.PRNGKey(0), V)
    return torch.from_numpy(np.stack([np.asarray(jax.random.gumbel(k, (H, n))) for k in keys]))


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    root = tmp_path_factory.mktemp("demo")
    seq = build_demo_sequence(root, np.random.default_rng(0))
    sp = JaxSuperPoint().init(jax.random.PRNGKey(0), jnp.zeros((1, 64, 64, 1)))
    sp_ckpt = jax_save_checkpoint(str(root / "ckpt_sp"), sp, 0)
    out = root / "obj" / "outputs"
    assert jax_main(["map", f"data_dir={seq}", f"out_dir={out}", "max_keypoints=128",
                     "num_covis=4", "max_points3d=200", f"weights.superpoint={sp_ckpt}"]) == 0
    return {"root": root, "seq": seq, "sp": sp_ckpt, "anno": out / "anno"}


def _routes(monkeypatch, module, log):
    """Record each frame's box route: 'D' full-frame detection, 'B' the box
    projected by the previous pose."""
    cls = module.FeatureObjectDetector
    det, prev = cls.detect_bbox, cls.previous_pose_detect

    def detect_bbox(self, *a, **k):
        log.append("D")
        return det(self, *a, **k)

    def previous_pose_detect(self, *a, **k):
        log.append("B")
        return prev(self, *a, **k)

    monkeypatch.setattr(cls, "detect_bbox", detect_bbox)
    monkeypatch.setattr(cls, "previous_pose_detect", previous_pose_detect)


@pytest.mark.parametrize("tracking", [False, True])
def test_demo_matches_jax(world, tracking, tmp_path, capsys, monkeypatch):
    monkeypatch.setattr(demo, "frame_draws", _jax_frame_draws)
    monkeypatch.setattr(port_fd, "gumbel_draws", _jax_gumbel)
    boxes = {"jax": [], "port": []}
    _routes(monkeypatch, jax_fd, boxes["jax"])
    _routes(monkeypatch, port_fd, boxes["port"])
    args = ["demo", f"data_dir={world['seq']}", f"anno_dir={world['anno']}", "shape3d=200",
            "n_ref_views=4", "matcher=nn", "max_keypoints=40", "crop_size=64",
            "redetect_inliers=4", f"use_tracking={str(tracking).lower()}",
            f"weights.superpoint={world['sp']}", "make_video=true"]
    out = {"jax": tmp_path / "jax", "port": tmp_path / "port"}
    assert jax_main(args + [f"out_dir={out['jax']}"]) == 0
    capsys.readouterr()
    assert port_main(args + [f"out_dir={out['port']}", "device=cpu"]) == 0
    printed = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    a, b = (json.load(open(out[k] / "results.json")) for k in ("jax", "port"))
    assert a.keys() == b.keys() and a["summary"].keys() == b["summary"].keys() == printed.keys()
    for k in ("num_frames", "n_detect", "n_box_track", "n_matcher", "n_flow_track"):
        assert b["summary"][k] == a["summary"][k], k
    assert b["summary"]["stage_ms"].keys() == a["summary"]["stage_ms"].keys()
    assert boxes["port"] == boxes["jax"]
    assert [f["tracked"] for f in b["frames"]] == [f["tracked"] for f in a["frames"]]
    assert [f["conf"] for f in b["frames"]] == [f["conf"] for f in a["frames"]]
    for fa, fb in zip(a["frames"], b["frames"]):
        assert fa.keys() == fb.keys()
        if fa["pose"] is not None:
            np.testing.assert_allclose(fb["pose"], fa["pose"],
                                       atol=TRACKED_POSE_ABS if fa["tracked"] else POSE_ABS,
                                       err_msg=f"frame {fa['frame']}")
    s = b["summary"]
    assert s["num_frames"] == 10 and s["n_matcher"] + s["n_flow_track"] == 10
    if tracking:
        assert s["n_flow_track"] >= 3 and "track" in s["stage_ms"], s
    else:
        assert s["n_matcher"] == 10 and s["n_flow_track"] == 0
    assert (out["port"] / "frames" / "9.png").exists()
    assert s["video"] and (out["port"] / "demo.mp4").exists()


def test_frame_draws_are_seeded_by_frame():
    a, b = demo.frame_draws(3, 16, "matcher"), demo.frame_draws(3, 16, "track")
    assert a.shape == (1, 16, 3) and torch.equal(a, b)
    assert not torch.equal(a, demo.frame_draws(4, 16, "matcher"))


def test_demo_raises_without_cuda(world):
    if torch.cuda.is_available():
        pytest.skip("this machine has CUDA: the no-CUDA error cannot be shown here")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        port_main(["demo", f"data_dir={world['seq']}"])
