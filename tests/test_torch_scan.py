"""The port's capture preprocessing (`data/scan_parser.py`, the `parse-scan`,
`video2img` and `merge-anno` commands) against the JAX package's, on the CPU.

- `parse_scan` on the synthetic capture of tests/test_data.py:257-288 (4
  frames of an .m4v that cv2 writes, ARposes, Box.txt, intrinsics), with
  the box projecting inside the frame: the same layout and files; the
  text files (poses, intrinsics, crop->full transforms, reprojected
  boxes, corners, K) within 1e-6, the crops and full frames within one
  grey level (cv2 warps the same affine, which each package computes in
  float64 and rounds to float32);
- the parse helpers (intrinsics, box, ARKit poses) within 1e-12;
- `video2img` with a downsample rate: the same frames;
- `merge-anno` with `coco_out`: the same merged index and COCO JSON.
"""

import json
import os

import cv2
import numpy as np
import pytest
import torch

from onepose_tpu.__main__ import main as jax_main
from onepose_tpu.data import scan_parser as jax_scan
from onepose_tpu_torch.__main__ import main as port_main
from onepose_tpu_torch.data import scan_parser

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def capture(tmp_path_factory):
    """tests/test_data.py:257-288's capture: object at the origin, the
    camera 0.5 m in front; 4 frames of 128 x 128 noise in Frames.m4v."""
    cap = tmp_path_factory.mktemp("cap")
    rng = np.random.default_rng(6)
    (cap / "intrinsics.txt").write_text("0,0.0,100,100,64,64\n1,0.1,102,98,63,65\n")
    (cap / "Box.txt").write_text("h\n0,0,0,0.2,0.2,0.2,1,0,0,0\n")
    with open(cap / "ARposes.txt", "w") as f:
        for i in range(4):
            f.write(f"{i * 0.1},{0.01 * i},0,0.5,1,0,0,0\n")
    writer = cv2.VideoWriter(str(cap / "Frames.m4v"), cv2.VideoWriter_fourcc(*"mp4v"), 10,
                             (128, 128))
    if not writer.isOpened():
        pytest.skip("no mp4 codec available")
    for _ in range(4):
        writer.write((rng.random((128, 128, 3)) * 255).astype(np.uint8))
    writer.release()
    return cap


def _files(root):
    return sorted(os.path.relpath(os.path.join(d, f), root)
                  for d, _, fs in os.walk(root) for f in fs)


def test_parse_helpers_match_jax(capture):
    np.testing.assert_allclose(scan_parser.parse_intrinsics(str(capture / "intrinsics.txt")),
                               jax_scan.parse_intrinsics(str(capture / "intrinsics.txt")),
                               atol=1e-12)
    for a, b in zip(scan_parser.parse_box(str(capture / "Box.txt")),
                    jax_scan.parse_box(str(capture / "Box.txt"))):
        np.testing.assert_allclose(a, b, atol=1e-12)
    _, T_ow = jax_scan.parse_box(str(capture / "Box.txt"))
    got = scan_parser.parse_poses(str(capture / "ARposes.txt"), T_ow)
    want = jax_scan.parse_poses(str(capture / "ARposes.txt"), T_ow)
    assert got.keys() == want.keys() == {0, 1, 2, 3}
    for k in want:
        np.testing.assert_allclose(got[k], want[k], atol=1e-12)
    q = np.array([0.9, 0.1, -0.3, 0.2])
    q /= np.linalg.norm(q)
    np.testing.assert_allclose(scan_parser.quat_to_rotmat_np(q), jax_scan.quat_to_rotmat_np(q),
                               atol=1e-12)


def test_parse_scan_matches_jax(capture, tmp_path, capsys):
    outs = {"jax": tmp_path / "jax", "port": tmp_path / "port"}
    args = ["parse-scan", f"data_dir={capture}", "crop_size=64"]
    assert jax_main(args + [f"out_dir={outs['jax']}"]) == 0
    want = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert port_main(args + [f"out_dir={outs['port']}"]) == 0
    got = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert got == want == {"num_frames": 4, "num_video_frames": 4}
    files = _files(outs["jax"])
    assert _files(outs["port"]) == files
    assert {"color/0.png", "color_full/3.png", "M/1.txt", "box3d_corners.txt"} <= set(files)
    for f in files:
        a, b = outs["port"] / f, outs["jax"] / f
        if f.endswith(".png"):
            ia, ib = cv2.imread(str(a)), cv2.imread(str(b))
            assert ia.shape == ib.shape, f
            assert np.abs(ia.astype(int) - ib.astype(int)).max() <= 1, f
        elif f == "intrinsics.txt":
            assert a.read_text() == b.read_text()
        else:
            np.testing.assert_allclose(np.loadtxt(a), np.loadtxt(b), atol=1e-6, err_msg=f)
    assert cv2.imread(str(outs["port"] / "color" / "0.png")).shape[:2] == (64, 64)


def test_video2img_matches_jax(capture, tmp_path, capsys):
    video = capture / "Frames.m4v"
    for pkg, main in (("jax", jax_main), ("port", port_main)):
        assert main(["video2img", f"video_file={video}", f"out_dir={tmp_path / pkg}",
                     "downsample_rate=2"]) == 0
        assert json.loads(capsys.readouterr().out.strip()) == {"num_frames": 2}
    assert _files(tmp_path / "port") == _files(tmp_path / "jax") == ["0.png", "2.png"]
    for f in ("0.png", "2.png"):
        np.testing.assert_array_equal(cv2.imread(str(tmp_path / "port" / f)),
                                      cv2.imread(str(tmp_path / "jax" / f)))


def test_merge_anno_matches_jax(tmp_path, capsys):
    from onepose_tpu_torch.data.anno_io import write_anno_index

    idx = []
    for i, name in enumerate("ab"):
        p = tmp_path / f"{name}.json"
        write_anno_index(str(p), [{"anno_id": 1, "anno_file": f"{name}{j}.json",
                                   "img_file": f"{name}{j}.png", "idxs_file": f"{name}.npy"}
                                  for j in range(2 + i)])
        idx.append(str(p))
    for pkg, main in (("jax", jax_main), ("port", port_main)):
        assert main(["merge-anno", f"indices={','.join(idx)}", f"out={tmp_path / pkg}.json",
                     f"coco_out={tmp_path / pkg}_coco.json"]) == 0
        summary = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
        assert summary["num_annotations"] == 5
    for suffix in (".json", "_coco.json"):
        got = json.load(open(f"{tmp_path / 'port'}{suffix}"))
        want = json.load(open(f"{tmp_path / 'jax'}{suffix}"))
        assert got == want
    assert sorted(e["anno_id"] for e in json.load(open(f"{tmp_path / 'port'}.json"))) == [
        1, 2, 3, 4, 5]
