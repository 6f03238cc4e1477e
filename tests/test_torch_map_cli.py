"""The port's `map` command against the JAX package's, on the CPU.

`python -m onepose_tpu map` and `python -m onepose_tpu_torch map
device=cpu` run on the same synthetic sequence (tests/test_cli.py::
build_sequence: 6 frames of 96 px, `max_keypoints=128`, `num_covis=3`,
`max_points3d=200`, as TestMapResume runs it) with the same weights: a
SuperPoint (and SuperGlue) checkpoint that the JAX package wrote. Three
cases: (i) both read one feature cache that JAX wrote (`redo=false`);
(ii) both extract from the images; (iii) `matcher=superglue`, at
`match_threshold=0.0` (random weights clear no 0.7; every mutual maximum
counts, and epipolar verification keeps the consistent ones). In each:
idxs.npy and the assign matrices identical; 3D arrays, 2D annotations
and the PLY within 1e-5 (fp32 convolutions sum in another order; the
features themselves agree within 3e-7 here); anno_index.json equal up
to the output root; the stats.json counts identical. Then the command's
behaviour (roster, box inside the sequence, resume, npz annotations,
every command of the JAX package registered, no CUDA, no h5py) on the
port alone.
"""

import glob
import importlib.util
import json
import os.path as osp
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_cli import build_sequence

from onepose_tpu.__main__ import main as jax_main
from onepose_tpu.cli.common import extract_sequence_features as jax_extract
from onepose_tpu.cli.common import load_superglue_params as jax_load_superglue
from onepose_tpu.models.superglue import SuperGlue as JaxSuperGlue
from onepose_tpu.models.superpoint import SuperPoint as JaxSuperPoint
from onepose_tpu.utils.checkpoint import save_checkpoint as jax_save_checkpoint
from onepose_tpu_torch.__main__ import build_parser
from onepose_tpu_torch.__main__ import main as port_main
from onepose_tpu_torch.cli import common
from onepose_tpu_torch.data.anno_io import load_anno2d
from onepose_tpu_torch.models import bridge
from onepose_tpu_torch.models.superglue import SuperGlue
from onepose_tpu_torch.models.superpoint import SuperPoint

torch.set_num_threads(2)

SMALL = ["max_keypoints=128", "num_covis=3", "max_points3d=200"]
COUNTS = ("num_frames", "num_pairs", "num_tracks", "num_points3d", "track_length_threshold",
          "num_observations")
ATOL = 1e-5


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """The sequence, the JAX-written checkpoints, and a cache of runs: each
    (package, case) runs once for the module."""
    root = tmp_path_factory.mktemp("map_cli")
    seq = build_sequence(root, np.random.default_rng(3), n_frames=6, img=96, n_pts=40)
    sp = JaxSuperPoint().init(jax.random.PRNGKey(5), jnp.zeros((1, 64, 64, 1)))
    sg = jax_load_superglue(JaxSuperGlue(), None)
    return {"root": root, "seq": seq, "sp": sp,
            "sp_ckpt": jax_save_checkpoint(str(root / "ckpt_sp"), sp, 0),
            "sg_ckpt": jax_save_checkpoint(str(root / "ckpt_sg"), sg, 0), "runs": {}}


def _args(world, case):
    args = [f"data_dir={world['seq']}", f"weights.superpoint={world['sp_ckpt']}", *SMALL]
    if case == "iii":
        args += ["matcher=superglue", f"weights.superglue={world['sg_ckpt']}",
                 "match_threshold=0.0"]
    return args


def _run(world, pkg, case):
    """Run `map` once for (pkg, case); returns its output directory."""
    key = (pkg, case)
    if key in world["runs"]:
        return world["runs"][key]
    out = world["root"] / f"{pkg}_{case}"
    args = ["map", f"out_dir={out}", *_args(world, case)]
    if case == "i":  # both resume from the feature cache of JAX's run (ii)
        out.mkdir()
        shutil.copy(_run(world, "jax", "ii") / "feats-superpoint.h5", out)
        args.append("redo=false")
    if pkg == "jax":
        assert jax_main(args) == 0
    else:
        assert port_main(args + ["device=cpu"]) == 0
    world["runs"][key] = out
    return out


def _ply(path):
    lines = open(path).read().splitlines()
    return lines[:lines.index("end_header") + 1], np.loadtxt(lines[lines.index("end_header") + 1:],
                                                            ndmin=2)


def _compare_maps(port, want):
    np.testing.assert_array_equal(np.load(port / "anno" / "idxs.npy"),
                                  np.load(want / "anno" / "idxs.npy"))
    for f in ("anno_3d_average.npz", "anno_3d_collect.npz"):
        a, b = np.load(port / "anno" / f), np.load(want / "anno" / f)
        assert a.files == b.files
        for k in b.files:
            assert a[k].shape == b[k].shape and a[k].dtype == b[k].dtype, (f, k)
            np.testing.assert_allclose(a[k], b[k], atol=ATOL, err_msg=f"{f}:{k}")
    index = json.load(open(port / "anno" / "anno_index.json"))
    index_want = json.load(open(want / "anno" / "anno_index.json"))
    assert len(index) == len(index_want) > 0
    for e, w in zip(index, index_want):
        for k in ("anno_file", "anno3d_dir"):
            e[k], w[k] = osp.relpath(e[k], str(port)), osp.relpath(w[k], str(want))
        assert e == w
        a, b = load_anno2d(str(port / e["anno_file"])), load_anno2d(str(want / w["anno_file"]))
        np.testing.assert_array_equal(a["assign_matrix"], b["assign_matrix"])
        for k in ("keypoints2d", "descriptors2d", "scores2d"):
            np.testing.assert_allclose(a[k], b[k], atol=ATOL, err_msg=k)
    stats, stats_want = (json.load(open(d / "stats.json")) for d in (port, want))
    assert stats.keys() == stats_want.keys()
    assert stats["stage_s"].keys() == stats_want["stage_s"].keys()
    assert "sfm_core" in stats["stage_s"]
    for k in COUNTS:
        assert stats[k] == stats_want[k], k
    for k in ("mean_track_length", "mean_reproj_error_px"):
        assert abs(stats[k] - stats_want[k]) <= ATOL, k
    (head, xyz), (head_want, xyz_want) = _ply(port / "points.ply"), _ply(want / "points.ply")
    assert head == head_want
    np.testing.assert_allclose(xyz, xyz_want, atol=ATOL)
    return stats


@pytest.mark.parametrize("case", ["i", "ii", "iii"])
def test_map_matches_jax(world, case):
    port, want = _run(world, "port", case), _run(world, "jax", case)
    stats = _compare_maps(port, want)
    assert stats["num_points3d"] > 10, stats
    h5py = pytest.importorskip("h5py")
    with h5py.File(port / "matches.h5") as a, h5py.File(want / "matches.h5") as b:
        assert set(a) == set(b)
        for k in b:
            np.testing.assert_array_equal(a[k]["matches0"][()], b[k]["matches0"][()])
    if case == "i":  # both read the cache: neither extracted
        for d in (port, want):
            assert "extract_features" not in json.load(open(d / "stats.json"))["stage_s"]


def test_port_cache_resumes_in_jax(world):
    """A feature cache the port wrote seeds JAX's run (and its fingerprint
    is JAX's), so both directions of the cache hand-over hold."""
    from onepose_tpu.sfm.cache import read_fingerprint

    port, want = _run(world, "port", "ii"), _run(world, "jax", "ii")
    assert read_fingerprint(str(port / "feats-superpoint.h5")) == read_fingerprint(
        str(want / "feats-superpoint.h5"))
    out = world["root"] / "jax_from_port"
    out.mkdir()
    shutil.copy(port / "feats-superpoint.h5", out)
    assert jax_main(["map", f"out_dir={out}", "redo=false", *_args(world, "ii")]) == 0
    assert "extract_features" not in json.load(open(out / "stats.json"))["stage_s"]
    _compare_maps(out, _run(world, "jax", "i"))


def test_extract_sequence_features_matches_jax(tmp_path):
    """10 frames (the last batch of 8 padded with its first frame) through
    both extractors with one JAX-written checkpoint: keypoints and masks
    identical, descriptors and scores within 1e-5."""
    seq = build_sequence(tmp_path, np.random.default_rng(0), n_frames=10, img=128, n_pts=60)
    params = JaxSuperPoint().init(jax.random.PRNGKey(1), jnp.zeros((1, 64, 64, 1)))
    path = jax_save_checkpoint(str(tmp_path / "ckpt"), params, 0)
    want = jax_extract(seq, params, JaxSuperPoint(), max_keypoints=160)
    model = SuperPoint()
    got = common.extract_sequence_features(seq, common.load_superpoint_params(model, path), model,
                                           max_keypoints=160, device="cpu")
    assert got.keys() == want.keys()
    for k in ("keypoints", "mask", "K", "poses"):
        assert got[k].dtype == want[k].dtype, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    for k in ("descriptors", "scores"):
        np.testing.assert_allclose(got[k], want[k], atol=1e-5, err_msg=k)
    assert got["image_paths"] == want["image_paths"] and got["image_hw"] == want["image_hw"]
    assert got["mask"].sum() > 100
    # A mesh of one rank (one process): the same features (several ranks:
    # tests/test_torch_parallel_serving.py).
    from onepose_tpu_torch.parallel.mesh import make_mesh

    meshed = common.extract_sequence_features(seq, common.load_superpoint_params(model, path),
                                              model, max_keypoints=160, batch=3,
                                              mesh=make_mesh(device="cpu"), device="cpu")
    for k in ("keypoints", "mask", "descriptors", "scores"):
        np.testing.assert_array_equal(meshed[k], got[k], err_msg=k)


def test_load_params(world, tmp_path):
    """A msgpack checkpoint gives the bridge's state_dict; weights=None the
    seeded random init (the same twice, another seed differs, the caller's
    module untouched); a PyTorch weight file (any of the four suffixes) in
    the reference's layout gives the state_dict of its conversion."""
    from test_torch_convert import superglue_sd

    from onepose_tpu.models.convert import superglue_from_torch

    model = SuperPoint()
    before = {k: v.clone() for k, v in model.state_dict().items()}
    sd = common.load_superpoint_params(model, world["sp_ckpt"])
    want = bridge.superpoint_state_dict(jax.tree.map(np.asarray, world["sp"]))
    assert sd.keys() == want.keys()
    for k in want:
        torch.testing.assert_close(sd[k], want[k], rtol=0, atol=0)
    a, b = common.load_superpoint_params(model, None), common.load_superpoint_params(model, None)
    c = common.load_superpoint_params(model, None, seed=1)
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert not torch.equal(a["conv1a.weight"], c["conv1a.weight"])
    assert all(torch.equal(before[k], v) for k, v in model.state_dict().items())
    sg = SuperGlue()
    sg.load_state_dict(common.load_superglue_params(sg, world["sg_ckpt"]))
    sg.load_state_dict(common.load_superglue_params(sg, None))
    # The reference's SuperPoint names and layout are this module's own.
    for ext in (".pth", ".pt", ".tar", ".ckpt"):
        torch.save(want, tmp_path / f"w{ext}")
        got = common.load_superpoint_params(model, str(tmp_path / f"w{ext}"))
        assert got.keys() == want.keys()
        assert all(torch.equal(got[k], want[k]) for k in want)
    ref = superglue_sd()
    torch.save(ref, tmp_path / "sg.pth")
    got = common.load_superglue_params(sg, str(tmp_path / "sg.pth"))
    want = bridge.superglue_state_dict(superglue_from_torch(ref))
    assert got.keys() == want.keys()
    assert all(torch.equal(got[k], want[k]) for k in want)
    sg.load_state_dict(got)


# --- the command's behaviour (tests/test_cli.py, on the port) -------------


def _last_json(capsys):
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])


def test_map_roster(tmp_path, capsys):
    """Comma-separated data_dirs map each object into its own directory
    and print one summary (tests/test_cli.py:318); a compilation cache key
    is accepted and ignored."""
    rng = np.random.default_rng(7)
    seq_a = build_sequence(tmp_path / "a", rng, n_frames=6, img=96, n_pts=30)
    seq_b = build_sequence(tmp_path / "b", rng, n_frames=6, img=96, n_pts=30)
    out_root = tmp_path / "maps"
    assert port_main(["map", f"data_dir={seq_a},{seq_b}", f"out_dir={out_root}", *SMALL,
                      "device=cpu", "compilation_cache_dir=/nonexistent"]) == 0
    summary = _last_json(capsys)
    assert summary["num_objects"] == 2 and summary["total_points3d"] > 0
    for name, stats in summary["objects"].items():
        assert stats["num_points3d"] > 0, (name, stats)
        assert (out_root / name / "anno" / "anno_index.json").exists(), name


def test_box_in_sequence_dir(tmp_path, capsys):
    """The box corners inside the sequence directory (parse-scan's layout)
    are used when the object root has none (tests/test_cli.py:353); the
    settings come from a --config file."""
    seq = build_sequence(tmp_path, np.random.default_rng(9), n_frames=6, img=96, n_pts=30)
    shutil.move(osp.join(osp.dirname(seq), "box3d_corners.txt"),
                osp.join(seq, "box3d_corners.txt"))
    cfg = tmp_path / "map.yaml"
    cfg.write_text("max_keypoints: 128\nnum_covis: 3\nmax_points3d: 200\ndevice: cpu\n")
    assert port_main(["map", "--config", str(cfg), f"data_dir={seq}",
                      f"out_dir={tmp_path / 'out'}"]) == 0
    assert _last_json(capsys)["num_points3d"] > 0


def test_resume_skips_existing(tmp_path, capsys):
    """redo=false skips a completed map (tests/test_cli.py:630)."""
    seq = build_sequence(tmp_path, np.random.default_rng(3), n_frames=6, img=96, n_pts=40)
    args = ["map", f"data_dir={seq}", f"out_dir={tmp_path / 'out'}", *SMALL, "device=cpu"]
    assert port_main(args) == 0
    first = _last_json(capsys)
    assert port_main(args + ["redo=false"]) == 0
    second = _last_json(capsys)
    assert second.get("skipped_existing") is True
    assert second["num_points3d"] == first["num_points3d"]


def test_npz_annotations(tmp_path, capsys):
    """anno_format=npz writes binary per-image annotations and no json
    (tests/test_cli.py:552)."""
    seq = build_sequence(tmp_path, np.random.default_rng(9), n_frames=6, img=96, n_pts=40)
    out = tmp_path / "out"
    assert port_main(["map", f"data_dir={seq}", f"out_dir={out}", *SMALL, "device=cpu",
                      "anno_format=npz"]) == 0
    capsys.readouterr()
    npzs = glob.glob(str(out / "anno" / "*.npz"))
    npzs = [p for p in npzs if not osp.basename(p).startswith("anno_3d")]
    jsons = [p for p in glob.glob(str(out / "anno" / "*.json"))
             if not p.endswith("anno_index.json")]
    assert npzs and not jsons
    a = load_anno2d(npzs[0])
    assert a["descriptors2d"].shape[1] == 256 and a["assign_matrix"].shape[0] == 2


def test_map_raises_without_cuda(world):
    """The command runs on the card unless device=cpu is given: without
    CUDA it raises before any work."""
    if torch.cuda.is_available():
        pytest.skip("this machine has CUDA: the no-CUDA error cannot be shown here")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        port_main(["map", f"data_dir={world['seq']}", *SMALL])


def test_cache_without_h5py_raises(world, tmp_path, monkeypatch):
    """cache=true needs h5py: without it the command raises naming h5py and
    cache=false (it does not skip the cache quietly); cache=false runs."""
    real = importlib.util.find_spec
    monkeypatch.setattr(importlib.util, "find_spec",
                        lambda name, *a: None if name == "h5py" else real(name, *a))
    args = ["map", f"data_dir={world['seq']}", *SMALL, "device=cpu"]
    with pytest.raises(ImportError, match="h5py.*cache=false"):
        port_main(args + [f"out_dir={tmp_path / 'a'}"])
    assert port_main(args + [f"out_dir={tmp_path / 'b'}", "cache=false"]) == 0
    assert not (tmp_path / "b" / "feats-superpoint.h5").exists()
    assert (tmp_path / "b" / "stats.json").exists()


def _jax_commands() -> list:
    """The JAX package's commands, from its parser's usage line."""
    import contextlib
    import io
    import re

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf), pytest.raises(SystemExit):
        jax_main(["--help"])
    return re.search(r"\{([a-z0-9,-]+)\}", buf.getvalue()).group(1).split(",")


JAX_COMMANDS = ("map", "infer", "train", "parse-scan", "video2img", "demo", "detect",
                "merge-anno", "convert")


def test_jax_package_has_nine_commands():
    assert sorted(_jax_commands()) == sorted(JAX_COMMANDS)


@pytest.mark.parametrize("command", JAX_COMMANDS)
def test_every_command_is_registered(command, capsys):
    """Each command of onepose_tpu/__main__.py is registered in the port and
    answers --help with 0."""
    sub = next(a for a in build_parser()._actions if a.dest == "command")
    assert command in sub.choices
    with pytest.raises(SystemExit) as exit_:
        port_main([command, "--help"])
    assert exit_.value.code == 0
    assert "--config" in capsys.readouterr().out