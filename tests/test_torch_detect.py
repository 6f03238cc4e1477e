"""The port's `detect` command and its modules against the JAX package's, on
the CPU.

- `geometry.transforms`: the affine, box and K_crop helpers, and
  `crop_img_affine` (gray and 3-channel, boxes reaching past the image)
  within 1e-5.
- `ransac_similarity` with JAX's Gumbel draws injected (one key a view, as
  the JAX detector splits them): the same inliers, parameters within 1e-4.
- `detect` on tests/test_cli.py::build_sequence with JAX-written weights,
  `detector_matcher=nn` (4 frames, 4 reference views) and `superglue` (128
  keypoints, 2 frames, 2 reference views: JAX's own SuperGlue detect test
  is marked slow), each package in its own copy of the sequence, the
  port's Gumbel draws replaced by JAX's: the same boxes within 1e-3 px
  (each package's `crop` records them), crops within one grey level,
  K_crop within 1e-4.
"""

import json
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_cli import build_sequence

import onepose_tpu.detector.feature_detector as jax_fd
from onepose_tpu.__main__ import main as jax_main
from onepose_tpu.cli.common import load_superglue_params as jax_load_superglue
from onepose_tpu.geometry import similarity as jax_similarity
from onepose_tpu.geometry import transforms as jax_tf
from onepose_tpu.models.superglue import SuperGlue as JaxSuperGlue
from onepose_tpu.models.superpoint import SuperPoint as JaxSuperPoint
from onepose_tpu.utils.checkpoint import save_checkpoint as jax_save_checkpoint
from onepose_tpu_torch.__main__ import main as port_main
from onepose_tpu_torch.cli.detect_cmd import clamp_box
from onepose_tpu_torch.detector import feature_detector as port_fd
from onepose_tpu_torch.detector.feature_detector import select_reference_views
from onepose_tpu_torch.geometry import transforms
from onepose_tpu_torch.geometry.similarity import ransac_similarity

torch.set_num_threads(2)


# --- transforms --------------------------------------------------------------


@pytest.mark.parametrize("rot,shift,inv", [(0.0, (0.0, 0.0), False), (0.0, (0.0, 0.0), True),
                                           (30.0, (0.1, -0.2), False), (-15.0, (0.0, 0.3), True)])
def test_affine_helpers_match_jax(rot, shift, inv):
    for center, scale, size in (((60.5, 40.0), (80.0, 50.0), (64, 48)), ((10, 20), 33.0, (32, 32))):
        got = transforms.get_affine_transform(center, scale, rot, size, shift, inv)
        want = jax_tf.get_affine_transform(center, scale, rot, size, shift, inv)
        assert got.dtype == want.dtype == np.float32
        np.testing.assert_allclose(got, want, atol=1e-5)
    box = [12.5, 30.0, 140.25, 99.0]
    for a, b in zip(transforms.bbox_center_scale(box), jax_tf.bbox_center_scale(box)):
        np.testing.assert_array_equal(a, b)
    K = np.array([[500.0, 0, 320], [0, 510.0, 240], [0, 0, 1]])
    for k in (K, np.concatenate([K, np.zeros((3, 1))], 1)):
        for a, b in zip(transforms.get_K_crop_resize(box, k, (64, 96)),
                        jax_tf.get_K_crop_resize(box, k, (64, 96))):
            np.testing.assert_allclose(a, b, atol=1e-5)


@pytest.mark.parametrize("channels", [None, 3])
def test_crop_img_affine_matches_jax(channels):
    """Bilinear warp with the JAX package's own sampling: boxes inside the
    image, reaching past its edges (zero border) and rotated."""
    rng = np.random.default_rng(0)
    shape = (70, 90) if channels is None else (70, 90, channels)
    img = rng.random(shape).astype(np.float32)
    for center, scale, rot, out in (((45, 35), (40, 40), 0.0, (32, 32)),
                                    ((5, 60), (50, 30), 0.0, (24, 40)),
                                    ((80, 10), (30, 30), 25.0, (33, 33))):
        A = transforms.get_affine_transform(center, scale, rot, (out[1], out[0]), inv=True)
        got = transforms.crop_img_affine(torch.from_numpy(img), A, out)
        want = jax_tf.crop_img_affine(jnp.asarray(img), jnp.asarray(A), out)
        assert tuple(got.shape) == tuple(want.shape)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)
        assert (got.numpy() == 0).any() == (np.asarray(want) == 0).any()


# --- ransac_similarity -------------------------------------------------------


def _similarity_problem(rng, V, n, outliers=0.3):
    src = rng.random((V, n, 2)).astype(np.float32) * 200
    ang = rng.uniform(-1, 1, V)
    s = rng.uniform(0.5, 2.0, V)
    alpha = s * np.exp(1j * ang)
    beta = rng.normal(size=V) * 30 + 1j * rng.normal(size=V) * 30
    z = (src[..., 0] + 1j * src[..., 1]) * alpha[:, None] + beta[:, None]
    dst = np.stack([z.real, z.imag], -1) + rng.normal(size=(V, n, 2)) * 0.5
    bad = rng.random((V, n)) < outliers
    dst[bad] = rng.random((bad.sum(), 2)) * 300
    mask = rng.random((V, n)) < 0.85
    mask[-1, 1:] = False  # one view with a single valid point
    return src, dst.astype(np.float32), mask


def test_ransac_similarity_matches_jax_with_injected_draws():
    rng = np.random.default_rng(1)
    V, n, H = 4, 50, 64
    src, dst, mask = _similarity_problem(rng, V, n)
    keys = jax.random.split(jax.random.PRNGKey(3), V)
    want = jax.vmap(lambda k, a, b, m: jax_similarity.ransac_similarity(k, a, b, m, n_hyp=H))(
        keys, jnp.asarray(src), jnp.asarray(dst), jnp.asarray(mask))
    gumbel = np.stack([np.asarray(jax.random.gumbel(k, (H, n))) for k in keys])
    got = ransac_similarity(torch.from_numpy(src), torch.from_numpy(dst), torch.from_numpy(mask),
                            n_hyp=H, gumbel=torch.from_numpy(gumbel))
    np.testing.assert_array_equal(got["inliers"].numpy(), np.asarray(want["inliers"]))
    np.testing.assert_array_equal(got["num_inliers"].numpy(), np.asarray(want["num_inliers"]))
    np.testing.assert_array_equal(got["ok"].numpy(), np.asarray(want["ok"]))
    ok = got["ok"].numpy()
    assert ok[:-1].all() and not ok[-1]
    scale = np.abs(np.asarray(want["params"])).max(-1, keepdims=True)
    np.testing.assert_allclose(got["params"].numpy()[ok] / scale[ok],
                               np.asarray(want["params"])[ok] / scale[ok], atol=1e-4)
    np.testing.assert_allclose(got["A"].numpy()[ok], np.asarray(want["A"])[ok], rtol=1e-4,
                               atol=1e-3)
    assert np.isfinite(got["params"].numpy()).all()
    # Drawn from a generator: deterministic in its seed.
    g = lambda: torch.Generator().manual_seed(0)  # noqa: E731
    a = ransac_similarity(*(torch.from_numpy(x) for x in (src, dst, mask)), n_hyp=H, generator=g())
    b = ransac_similarity(*(torch.from_numpy(x) for x in (src, dst, mask)), n_hyp=H, generator=g())
    assert torch.equal(a["params"], b["params"]) and torch.equal(a["inliers"], b["inliers"])


def test_detector_helpers():
    assert select_reference_views(10, 4).tolist() == jax_fd.select_reference_views(10, 4).tolist()
    assert select_reference_views(3, 15).tolist() == [0, 1, 2]
    np.testing.assert_array_equal(clamp_box(np.array([-5.0, 3.0, 700.0, 90.0]), 100, 640),
                                  [0, 3.0, 639, 90.0])
    np.testing.assert_array_equal(clamp_box(np.array([10.0, 10.0, 20.0, 90.0]), 100, 640),
                                  [0, 0, 639, 99])
    K = np.array([[200.0, 0, 64], [0, 200.0, 64], [0, 0, 1]], np.float32)
    pose = np.eye(4)
    pose[2, 3] = 0.8
    corners = np.array([[x, y, z] for x in (-0.1, 0.1) for y in (-0.1, 0.1) for z in (-0.1, 0.1)])
    got = port_fd.FeatureObjectDetector(None, None).previous_pose_detect(K, pose, corners)
    want = jax_fd.FeatureObjectDetector(None, None).previous_pose_detect(K, pose, corners)
    np.testing.assert_allclose(got, want, atol=1e-4)


# --- the command ---------------------------------------------------------


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    root = tmp_path_factory.mktemp("detect")
    seq = build_sequence(root, np.random.default_rng(2), n_frames=4, img=128, n_pts=60)
    sp = JaxSuperPoint().init(jax.random.PRNGKey(0), jnp.zeros((1, 64, 64, 1)))
    sg = jax_load_superglue(JaxSuperGlue(), None)
    return {"root": root, "seq": seq,
            "sp": jax_save_checkpoint(str(root / "ckpt_sp"), sp, 0),
            "sg": jax_save_checkpoint(str(root / "ckpt_sg"), sg, 0)}


def _jax_gumbel(shape, generator=None, device=None):
    """The draws of JAX's detect_bbox: PRNGKey(0) split one key a view."""
    V, H, n = shape
    keys = jax.random.split(jax.random.PRNGKey(0), V)
    return torch.from_numpy(np.stack([np.asarray(jax.random.gumbel(k, (H, n))) for k in keys]))


def _recording(monkeypatch, module, boxes):
    crop = module.FeatureObjectDetector.crop

    def recorded(self, image, bbox, K):
        boxes.append(np.asarray(bbox, np.float64))
        return crop(self, image, bbox, K)

    monkeypatch.setattr(module.FeatureObjectDetector, "crop", recorded)


@pytest.mark.parametrize("kind", ["nn", "superglue"])
def test_detect_matches_jax(world, kind, tmp_path, capsys, monkeypatch):
    cv2 = pytest.importorskip("cv2")
    args = [f"db_dir={world['seq']}", f"weights.superpoint={world['sp']}",
            f"detector_matcher={kind}", "crop_size=64"]
    if kind == "nn":
        args += ["max_keypoints=256", "n_ref_views=4"]
        frames = 4
    else:
        args += ["max_keypoints=128", "n_ref_views=2", f"weights.superglue={world['sg']}"]
        frames = 2
    seqs = {}
    for pkg in ("jax", "port"):
        seqs[pkg] = tmp_path / pkg / "seq"
        shutil.copytree(world["seq"], seqs[pkg])
        for f in range(frames, 4):
            (seqs[pkg] / "color_full" / f"{f}.png").unlink()
    monkeypatch.setattr(port_fd, "gumbel_draws", _jax_gumbel)
    boxes = {"jax": [], "port": []}
    _recording(monkeypatch, jax_fd, boxes["jax"])
    _recording(monkeypatch, port_fd, boxes["port"])
    assert jax_main(["detect", f"query_dir={seqs['jax']}", *args]) == 0
    want = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert port_main(["detect", f"query_dir={seqs['port']}", *args, "device=cpu"]) == 0
    got = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert got["num_frames"] == want["num_frames"] == frames
    assert got["num_detected"] == want["num_detected"]
    assert len(boxes["port"]) == len(boxes["jax"]) == frames
    np.testing.assert_allclose(np.stack(boxes["port"]), np.stack(boxes["jax"]), atol=1e-3)
    for f in range(frames):
        a = cv2.imread(str(seqs["port"] / "color_det" / f"{f}.png"), cv2.IMREAD_GRAYSCALE)
        b = cv2.imread(str(seqs["jax"] / "color_det" / f"{f}.png"), cv2.IMREAD_GRAYSCALE)
        assert a.shape == b.shape == (64, 64)
        assert np.abs(a.astype(int) - b.astype(int)).max() <= 1
        ka = np.loadtxt(seqs["port"] / "intrin_det" / f"{f}.txt")
        kb = np.loadtxt(seqs["jax"] / "intrin_det" / f"{f}.txt")
        np.testing.assert_allclose(ka, kb, rtol=1e-4, atol=1e-4)


def test_detect_raises_without_cuda(world):
    if torch.cuda.is_available():
        pytest.skip("this machine has CUDA: the no-CUDA error cannot be shown here")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        port_main(["detect", f"db_dir={world['seq']}", f"query_dir={world['seq']}"])
