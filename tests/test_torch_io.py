"""Parity of the port's I/O modules with the JAX package's on the CPU:
config, checkpoints (the port's own msgpack codec against flax's),
paths and the image decoder, COLMAP model files and database, padding,
annotation files, the HDF5 caches, `resolve_sfm_mesh` and `StageTimer`.

Both packages get the same numpy inputs from a seed. Files must be equal
byte for byte where both write one; arrays read back must be equal (no
tolerance: nothing here computes).
"""

import os.path as osp
import re
import sqlite3
import types

import flax.serialization as flax_serialization
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from onepose_tpu import config as jax_config
from onepose_tpu.cli.common import load_superglue_params as jax_load_superglue
from onepose_tpu.data import anno_io as jax_anno_io
from onepose_tpu.data import colmap_database as jax_colmap_db
from onepose_tpu.data import colmap_io as jax_colmap_io
from onepose_tpu.data import padding as jax_padding
from onepose_tpu.data import paths as jax_paths
from onepose_tpu.models.superglue import SuperGlue as JaxSuperGlue
from onepose_tpu.models.superpoint import SuperPoint as JaxSuperPoint
from onepose_tpu.sfm import cache as jax_cache
from onepose_tpu.utils import checkpoint as jax_checkpoint
from onepose_tpu.utils import profiling as jax_profiling
from onepose_tpu_torch import config, native
from onepose_tpu_torch.data import anno_io, colmap_database, colmap_io, padding, paths
from onepose_tpu_torch.native import frame_loader
from onepose_tpu_torch.parallel import sfm_parallel
from onepose_tpu_torch.sfm import cache
from onepose_tpu_torch.utils import checkpoint, profiling

torch.set_num_threads(2)


def _leaves(tree, prefix=""):
    """{path: leaf} of a nested mapping."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_leaves(v, f"{prefix}{k}/"))
        else:
            out[f"{prefix}{k}"] = v
    return out


def _assert_trees_equal(got, want):
    got, want = _leaves(got), _leaves(jax.tree.map(np.asarray, want))
    assert got.keys() == want.keys()
    for k, w in want.items():
        g = np.asarray(got[k])
        assert g.dtype == w.dtype and g.shape == w.shape, k
        np.testing.assert_array_equal(g, w, err_msg=k)


# --- config ----------------------------------------------------------------


DEFAULTS = {"a": 1, "nested": {"x": "y", "keep": True}, "weights": {"sp": None}}


@pytest.mark.parametrize("overrides", [
    [],
    ["a=5", "nested.x=z", "new.k=[1,2]", "weights.sp=/w/sp.msgpack", "flag=true", "f=0.7"],
    ["s=not json", "n=null", "nested.deep.er={\"q\": 1}"],
])
@pytest.mark.parametrize("with_file", [False, True])
def test_config_matches_jax(tmp_path, overrides, with_file):
    cfg_file = None
    if with_file:
        cfg_file = tmp_path / "c.yaml"
        cfg_file.write_text("a: 7\nnested:\n  x: file\nmatcher: superglue\n")
        cfg_file = str(cfg_file)
    want = jax_config.load_config(DEFAULTS, cfg_file, overrides)
    got = config.load_config(DEFAULTS, cfg_file, overrides)
    assert got == want
    assert DEFAULTS["a"] == 1  # the defaults are not touched
    assert config.format_config_tree(got) == jax_config.format_config_tree(want)
    for key in ("nested.x", "new.k", "missing.key"):
        assert config.get_by_dotted(got, key, "d") == jax_config.get_by_dotted(want, key, "d")
    a = config.snapshot_config(got, str(tmp_path / "port"))
    b = jax_config.snapshot_config(want, str(tmp_path / "jax"))
    assert open(a).read() == open(b).read()
    with pytest.raises(ValueError, match="KEY=VALUE"):
        config.load_config(DEFAULTS, None, ["novalue"])


# --- checkpoints -----------------------------------------------------------


def _jax_params(kind):
    if kind == "superpoint":
        return JaxSuperPoint().init(jax.random.PRNGKey(0), jnp.zeros((1, 64, 64, 1)))
    return jax_load_superglue(JaxSuperGlue(num_layers=2), None)


@pytest.mark.parametrize("kind", ["superpoint", "superglue"])
def test_checkpoint_reads_jax_and_jax_reads_port(tmp_path, kind):
    """A JAX-written checkpoint reads back to equal arrays; the port's
    checkpoint of the same tree is the same bytes, and JAX's loader reads
    it back to equal arrays."""
    params = _jax_params(kind)
    path = jax_checkpoint.save_checkpoint(str(tmp_path / "jax"), params, 3)
    got = checkpoint.load_checkpoint(path)
    _assert_trees_equal(got, params)
    checkpoint.load_checkpoint(path, target=jax.tree.map(np.asarray, params))  # keys, shapes

    mine = checkpoint.save_checkpoint(str(tmp_path / "port"), got, 3)
    assert open(mine, "rb").read() == open(path, "rb").read()
    back = jax_checkpoint.load_checkpoint(mine, params)
    _assert_trees_equal(jax.tree.map(np.asarray, back), params)


def test_checkpoint_chunked_arrays(tmp_path, monkeypatch):
    """Arrays above MAX_CHUNK_SIZE are chunked maps both ways, byte for byte."""
    monkeypatch.setattr(flax_serialization, "MAX_CHUNK_SIZE", 64)
    monkeypatch.setattr(checkpoint, "MAX_CHUNK_SIZE", 64)
    rng = np.random.default_rng(0)
    tree = {"w": rng.standard_normal((7, 9)).astype(np.float32),
            "small": np.arange(4, dtype=np.int64), "nested": {"b": rng.random(50) < 0.5}}
    want = flax_serialization.to_bytes(tree)
    assert checkpoint.msgpack_serialize(tree) == want
    assert b"__msgpack_chunked_array__" in want
    got = checkpoint.msgpack_restore(want)
    _assert_trees_equal(got, tree)
    path = checkpoint.save_checkpoint(str(tmp_path), tree, 0)
    _assert_trees_equal(jax.tree.map(np.asarray, jax_checkpoint.load_checkpoint(path, tree)), tree)


def test_checkpoint_scalars_and_containers():
    """Python and numpy scalars, None, strings, lists and tuples (stored as
    index-keyed maps), torch tensors (stored as numpy): the JAX package's
    bytes, and each package reads the other's (bfloat16 arrays widen to
    float32, as numpy has no bfloat16)."""
    tree = {"step": 12, "neg": -200, "big": 2**40, "f": 2.5, "np": np.float32(1.5),
            "none": None, "s": "x" * 40, "flag": True, "l": [np.arange(3), (np.ones(2),)],
            "e": np.zeros((0, 3), np.float32)}
    want = flax_serialization.to_bytes(tree)
    assert checkpoint.msgpack_serialize(tree) == want
    got = checkpoint.msgpack_restore(want)
    assert got["step"] == 12 and got["big"] == 2**40 and got["none"] is None
    assert isinstance(got["np"], np.float32) and got["np"] == np.float32(1.5)
    np.testing.assert_array_equal(got["l"]["1"]["0"], np.ones(2))
    t = {"w": torch.arange(6, dtype=torch.float32).reshape(2, 3)}
    assert checkpoint.msgpack_serialize(t) == flax_serialization.to_bytes({"w": t["w"].numpy()})
    mine = checkpoint.msgpack_restore(flax_serialization.to_bytes(
        {"h": jnp.asarray([1.0, -2.5], jnp.bfloat16)}))
    np.testing.assert_array_equal(mine["h"], np.array([1.0, -2.5], np.float32))


def test_checkpoint_target_mismatch_raises(tmp_path):
    tree = {"a": {"w": np.zeros((2, 3))}, "b": np.ones(4)}
    path = checkpoint.save_checkpoint(str(tmp_path), tree, 0)
    checkpoint.load_checkpoint(path, tree)
    with pytest.raises(ValueError, match="missing"):
        checkpoint.load_checkpoint(path, {**tree, "c": np.ones(1)})
    with pytest.raises(ValueError, match="shape"):
        checkpoint.load_checkpoint(path, {"a": {"w": np.zeros((3, 2))}, "b": np.ones(4)})
    with pytest.raises(ValueError, match="truncated"):
        checkpoint.msgpack_restore(open(path, "rb").read()[:-3])


def test_checkpoint_steps_and_pruning_match_jax(tmp_path):
    tree = {"w": np.ones(3, np.float32)}
    for step in (1, 5, 12, 30):
        checkpoint.save_checkpoint(str(tmp_path / "port"), tree, step, keep=2)
        jax_checkpoint.save_checkpoint(str(tmp_path / "jax"), tree, step, keep=2)
    a = checkpoint.latest_checkpoint(str(tmp_path / "port"))
    b = jax_checkpoint.latest_checkpoint(str(tmp_path / "jax"))
    assert osp.basename(a) == osp.basename(b) == "ckpt_30.msgpack"
    assert sorted(p.name for p in (tmp_path / "port").iterdir()) == sorted(
        p.name for p in (tmp_path / "jax").iterdir())
    assert checkpoint.checkpoint_step(a) == jax_checkpoint.checkpoint_step(b) == 30
    assert checkpoint.latest_checkpoint(str(tmp_path / "none")) is None


# --- paths and the decoder -------------------------------------------------


def _write_images(tmp_path, rng):
    cv2 = pytest.importorskip("cv2")
    files = {}
    gray = (rng.random((37, 53)) * 255).astype(np.uint8)
    color = (rng.random((24, 40, 3)) * 255).astype(np.uint8)
    for name, img in (("gray.png", gray), ("color.png", color), ("gray.jpg", gray),
                      ("color.jpg", color)):
        cv2.imwrite(str(tmp_path / name), img)
        files[name] = str(tmp_path / name)
    return files


@pytest.mark.parametrize("name", ["gray.png", "color.png", "gray.jpg", "color.jpg"])
def test_load_gray_matches_jax(tmp_path, name):
    """cv2-written PNG and JPEG files decode to exactly JAX's load_gray."""
    f = _write_images(tmp_path, np.random.default_rng(0))[name]
    want = jax_paths.load_gray(f)
    got = paths.load_gray(f)
    assert got.dtype == np.float32 and got.shape == want.shape
    np.testing.assert_array_equal(got, want)
    if frame_loader.native_available():
        np.testing.assert_array_equal(frame_loader.read_gray(f), got)


def test_native_decoder_builds_and_reports(tmp_path):
    """With the codecs present the library carries the decoder and
    backend() says so; a file that does not decode gives None (load_gray
    then tries cv2, which raises for a missing file)."""
    assert native.backend() in ("g++ with codecs", "g++", "python")
    assert frame_loader.native_available() == (native.backend() == "g++ with codecs")
    if frame_loader.native_available():
        assert native.library_path(codecs=True).exists()
        assert native.backend() == "g++ with codecs"
    bad = tmp_path / "bad.png"
    bad.write_bytes(b"\x89PNG not an image")
    assert frame_loader.read_gray(str(bad)) is None
    with pytest.raises(FileNotFoundError):
        paths.load_gray(str(tmp_path / "missing.png"))


def test_path_helpers_match_jax(tmp_path):
    seq = tmp_path / "obj" / "seq"
    (seq / "color").mkdir(parents=True)
    (seq / "color_det").mkdir()
    for n in ("10", "2", "1", "b", "a"):
        (seq / "color" / f"{n}.png").write_bytes(b"")
        (seq / "color_det" / f"{n}.png").write_bytes(b"")
    for det in ("GT_box", "feature_matching"):
        got = paths.list_color_images(str(seq), det)
        assert got == jax_paths.list_color_images(str(seq), det)
        for p in got:
            for fn in ("gt_pose_path_by_color", "intrin_path_by_color", "full_img_path_by_color"):
                assert getattr(paths, fn)(p, det) == getattr(jax_paths, fn)(p, det)
    assert [osp.basename(p) for p in paths.list_color_images(str(seq))] == [
        "1.png", "2.png", "10.png", "a.png", "b.png"]
    for fn in ("color_dir", "intrin_dir", "gt_pose_dir", "intrin_full_path", "box3d_path",
               "anno_dir"):
        assert getattr(paths, fn)(str(seq)) == getattr(jax_paths, fn)(str(seq))


# --- COLMAP ----------------------------------------------------------------


def _colmap_model(mod, rng):
    cams = {1: mod.Camera(1, "PINHOLE", 640, 480, np.array([500.0, 501.0, 320.0, 240.0])),
            2: mod.Camera(2, "SIMPLE_RADIAL", 320, 240, rng.random(4))}
    imgs = {}
    for i in (1, 2, 3):
        n = int(rng.integers(0, 6))
        imgs[i] = mod.Image(i, rng.random(4), rng.random(3), 1 + i % 2, f"frame_{i}.png",
                            rng.random((n, 2)) * 100, rng.integers(-1, 5, n))
    pts = {}
    for p in (0, 7, 9):
        t = int(rng.integers(0, 4))
        pts[p] = mod.Point3D(p, rng.random(3), rng.integers(0, 255, 3), float(rng.random()),
                             rng.integers(1, 4, t), rng.integers(0, 6, t))
    return cams, imgs, pts


def _same_model(a, b):
    for x, y in zip(a, b):
        assert x.keys() == y.keys()
        for k in x:
            for f, v in vars(x[k]).items():
                w = getattr(y[k], f)
                if isinstance(v, np.ndarray):
                    np.testing.assert_array_equal(v, w, err_msg=f)
                else:
                    assert v == w, f


def test_colmap_model_cross_read_write(tmp_path):
    rng = np.random.default_rng(4)
    for writer, reader, wmod in ((colmap_io, jax_colmap_io, colmap_io),
                                 (jax_colmap_io, colmap_io, jax_colmap_io)):
        d = tmp_path / writer.__name__.replace(".", "_")
        model = _colmap_model(wmod, rng)
        writer.write_model(str(d), *model)
        _same_model(reader.read_model(str(d)), writer.read_model(str(d)))
        _same_model(reader.read_model(str(d)), model)
    a, b = tmp_path / "a", tmp_path / "b"
    model = _colmap_model(colmap_io, np.random.default_rng(5))
    colmap_io.write_model(str(a), *model)
    jax_colmap_io.write_model(str(b), *model)
    for f in ("cameras.bin", "images.bin", "points3D.bin"):
        assert (a / f).read_bytes() == (b / f).read_bytes(), f
    assert np.array_equal(model[0][1].K, np.array([[500.0, 0, 320], [0, 501, 240], [0, 0, 1]]))


@pytest.mark.parametrize("rgb", [False, True])
def test_export_ply_identical_bytes(tmp_path, rgb):
    rng = np.random.default_rng(6)
    xyz = rng.standard_normal((25, 3)).astype(np.float32)
    col = rng.integers(0, 255, (25, 3)) if rgb else None
    colmap_io.export_ply(str(tmp_path / "a.ply"), xyz, col)
    jax_colmap_io.export_ply(str(tmp_path / "b.ply"), xyz, col)
    assert (tmp_path / "a.ply").read_bytes() == (tmp_path / "b.ply").read_bytes()


def test_colmap_database_rows_match_jax(tmp_path):
    rng = np.random.default_rng(7)
    F, N = 4, 12
    feats = {"image_paths": [f"/seq/color/{i}.png" for i in range(F)],
             "K": np.tile(np.array([[400.0, 0, 64], [0, 410.0, 60], [0, 0, 1]]), (F, 1, 1)),
             "keypoints": rng.random((F, N, 2)).astype(np.float32) * 100,
             "mask": rng.random((F, N)) < 0.7}
    pair_matches = {(0, 1): rng.integers(0, N, (5, 2)), (2, 1): rng.integers(0, N, (3, 2)),
                    (3, 0): np.zeros((0, 2), np.int64)}
    desc = rng.integers(0, 255, (3, 8))
    rows = {}
    for name, mod in (("port", colmap_database), ("jax", jax_colmap_db)):
        path = str(tmp_path / f"{name}.db")
        assert mod.export_sequence_to_db(path, feats, pair_matches, (120, 128)) == F
        with mod.ColmapDatabase(path) as db:
            db.add_descriptors(1, desc)
            kp = db.read_keypoints(2)
            m = db.read_matches(1, 3)
            m_rev = db.read_matches(3, 1)
        conn = sqlite3.connect(path)
        rows[name] = {t: conn.execute(f"SELECT * FROM {t}").fetchall() for t in (
            "cameras", "images", "keypoints", "descriptors", "matches", "two_view_geometries")}
        rows[name, "read"] = (kp, m, m_rev)
        conn.close()
    assert rows["port"] == rows["jax"]
    for x, y in zip(rows["port", "read"], rows["jax", "read"]):
        np.testing.assert_array_equal(x, y)
    for a, b in ((3, 9), (9, 3), (1, 2**20)):
        pid = colmap_database.pair_id_from_images(a, b)
        assert pid == jax_colmap_db.pair_id_from_images(a, b)
        assert colmap_database.images_from_pair_id(pid) == jax_colmap_db.images_from_pair_id(pid)


# --- padding and annotations -----------------------------------------------


@pytest.mark.parametrize("n,target", [(5, 12), (12, 12), (20, 8)])
def test_padding_matches_jax(n, target):
    rng = np.random.default_rng(n)
    kp, desc, sc = rng.random((n, 2)) * 50, rng.random((n, 16)), rng.random(n)
    for fn, args in (("pad_keypoints2d", (kp, desc, sc, 60, 80, target)),
                     ("pad_points3d", (rng.random((n, 3)), desc, sc, target))):
        got = getattr(padding, fn)(*args, rng=np.random.default_rng(1))
        want = getattr(jax_padding, fn)(*args, rng=np.random.default_rng(1))
        assert got.keys() == want.keys()
        for k in want:
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    am = np.stack([rng.integers(0, 15, 9), rng.integers(0, 15, 9)])
    np.testing.assert_array_equal(padding.assign_to_conf_matrix(am, n, 10, 14, 11),
                                  jax_padding.assign_to_conf_matrix(am, n, 10, 14, 11))


def _mapping_result(rng, P=30, C=32, leaves=5):
    """A MappingResult's fields that the annotation files read: points,
    averaged descriptors (a padded [P + 6, C] tensor in the port, an array
    in JAX), per-observation descriptors and scores, leaf counts."""
    idxs = rng.integers(1, 2 * leaves, P)
    K = int(idxs.sum())
    desc_avg = rng.standard_normal((P + 6, C)).astype(np.float32)
    fields = dict(points_xyz=rng.random((P, 3)).astype(np.float32),
                  scores_avg=rng.random(P).astype(np.float32),
                  desc_concat=rng.standard_normal((K, C)).astype(np.float32),
                  scores_concat=rng.random(K).astype(np.float32), idxs=idxs)
    port = types.SimpleNamespace(annotation=types.SimpleNamespace(
        desc3d=torch.from_numpy(desc_avg)), **fields)
    jax_r = types.SimpleNamespace(annotation=types.SimpleNamespace(
        desc3d=jnp.asarray(desc_avg)), **fields)
    return port, jax_r


def test_annotation_files_match_jax(tmp_path):
    port, jax_r = _mapping_result(np.random.default_rng(8))
    anno_io.save_annotation_npz(port, str(tmp_path / "port"))
    jax_anno_io.save_annotation_npz(jax_r, str(tmp_path / "jax"))
    for f in ("anno_3d_average.npz", "anno_3d_collect.npz", "idxs.npy"):
        a, b = np.load(tmp_path / "port" / f), np.load(tmp_path / "jax" / f)
        if f.endswith(".npy"):
            np.testing.assert_array_equal(a, b)
        else:
            assert a.files == b.files
            for k in a.files:
                np.testing.assert_array_equal(a[k], b[k], err_msg=f"{f}:{k}")
    got = anno_io.load_annotation_npz(str(tmp_path / "jax"))
    want = jax_anno_io.load_annotation_npz(str(tmp_path / "port"))
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


@pytest.mark.parametrize("shape3d,num_leaf", [(40, 8), (20, 4)])
def test_annotation_from_npz_dir_matches_jax(tmp_path, shape3d, num_leaf):
    """The same seed gives the same padded points and leaves (the numpy
    draws of pad_points3d and build_leaf_slots in the same order), as CPU
    tensors; and device="cuda" raises without CUDA."""
    port, _ = _mapping_result(np.random.default_rng(9))
    anno_io.save_annotation_npz(port, str(tmp_path))
    got = anno_io.annotation_from_npz_dir(str(tmp_path), num_leaf, shape3d, seed=3, device="cpu")
    want = jax_anno_io.annotation_from_npz_dir(str(tmp_path), num_leaf, shape3d, seed=3)
    for k in ("points3d", "desc3d", "leaf_desc", "mask3d", "leaf_mask"):
        g, w = getattr(got, k), np.asarray(getattr(want, k))
        assert g.device.type == "cpu" and g.numpy().dtype == w.dtype, k
        np.testing.assert_array_equal(g.numpy(), w, err_msg=k)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            anno_io.annotation_from_npz_dir(str(tmp_path))


@pytest.mark.parametrize("fmt", ["json", "npz"])
def test_anno2d_files_match_jax(tmp_path, fmt):
    rng = np.random.default_rng(10)
    n = 17
    args = (rng.random((n, 2)).astype(np.float32) * 90, rng.random((n, 32)).astype(np.float32),
            rng.random(n).astype(np.float32), np.stack([rng.permutation(n)[:6],
                                                        rng.integers(0, 40, 6)]))
    save = "save_anno2d" if fmt == "json" else "save_anno2d_npz"
    a, b = str(tmp_path / f"p.{fmt}"), str(tmp_path / f"j.{fmt}")
    getattr(anno_io, save)(a, *args)
    getattr(jax_anno_io, save)(b, *args)
    if fmt == "json":
        assert open(a).read() == open(b).read()
    got, want = anno_io.load_anno2d(b), jax_anno_io.load_anno2d(a)
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def test_anno_index_merge_and_coco_match_jax(tmp_path):
    idx = []
    for i, mod in enumerate((anno_io, jax_anno_io)):
        p = str(tmp_path / f"idx{i}.json")
        mod.write_anno_index(p, [{"anno_id": 1, "anno_file": f"{i}a.json", "img_file": "x.png"},
                                 {"anno_id": 2, "anno_file": f"{i}b.json", "img_file": "y.png",
                                  "idxs_file": "i.npy"}])
        idx.append(p)
    outs = {}
    for name, mod in (("port", anno_io), ("jax", jax_anno_io)):
        merged = str(tmp_path / name / "merged.json")
        n = mod.merge_anno_indices(idx, merged)
        coco = mod.export_coco_anno(merged, str(tmp_path / name / "coco.json"))
        outs[name] = (n, open(merged).read(), coco, open(tmp_path / name / "coco.json").read())
    assert outs["port"] == outs["jax"]
    assert anno_io.read_anno_index(idx[1]) == jax_anno_io.read_anno_index(idx[1])
    assert open(idx[0]).read() == open(idx[1]).read().replace('"1a', '"0a').replace('"1b', '"0b')


# --- HDF5 caches -----------------------------------------------------------


@pytest.fixture(autouse=False)
def h5():
    return pytest.importorskip("h5py")


def _features(rng, F=4, N=10, C=16):
    mask = rng.random((F, N)) < 0.7
    return (rng.random((F, N, 2)).astype(np.float32) * 50,
            rng.standard_normal((F, N, C)).astype(np.float32),
            rng.random((F, N)).astype(np.float32), mask)


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_feature_cache_cross_read(h5, tmp_path, writer):
    rng = np.random.default_rng(11)
    names = ["0.png", "1.png", "2.png", "3.png"]
    kp, desc, sc, mask = _features(rng)
    path = str(tmp_path / "feats.h5")
    w, r = (cache, jax_cache) if writer == "port" else (jax_cache, cache)
    w.save_features_h5(path, names, kp, desc, sc, mask, (48, 64), fingerprint="fp-1")
    assert r.read_fingerprint(path) == cache.read_fingerprint(path) == "fp-1"
    got = r.load_features_h5(path, names[::-1], pad_to=12)
    want = w.load_features_h5(path, names[::-1], pad_to=12)
    for k in ("keypoints", "descriptors", "scores", "mask"):
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    assert got["image_hw"] == want["image_hw"] == (48, 64)
    assert got["image_names"] == want["image_names"]
    with pytest.raises(KeyError):
        r.load_features_h5(path, ["9.png"])


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_match_cache_cross_read(h5, tmp_path, writer):
    rng = np.random.default_rng(12)
    names = ["a", "b", "c", "d"]
    pairs = np.array([[0, 1], [1, 2], [2, 1], [3, 0]])
    m0 = np.where(rng.random((4, 9)) < 0.6, rng.integers(0, 9, (4, 9)), -1)
    path = str(tmp_path / "matches.h5")
    w, r = (cache, jax_cache) if writer == "port" else (jax_cache, cache)
    w.save_matches_h5(path, pairs, names, m0, rng.random((4, 9)), mask=rng.random((4, 9)) < 0.9)
    query = np.array([[1, 0], [0, 1], [2, 1], [0, 3]])
    np.testing.assert_array_equal(r.load_matches_h5(path, query, names, 9),
                                  w.load_matches_h5(path, query, names, 9))
    with pytest.raises(KeyError):
        r.load_matches_h5(path, np.array([[0, 2]]), names, 9)
    assert cache.names_to_pair("x/a.png", "b.png") == jax_cache.names_to_pair("x/a.png", "b.png")


def _fake_matcher(calls, N):
    def matcher(pairs):
        calls.append(np.asarray(pairs).copy())
        out = np.full((len(pairs), N), -1, np.int64)
        out[:, 0] = pairs[:, 1] % N
        return out
    return matcher


def test_cached_pair_matcher_resumes(h5, tmp_path):
    """tests/test_sfm_cache.py's resume case for the port: cached pairs are
    read, only new ones computed, and an all-cached call never matches."""
    N, names, calls = 5, ["a", "b", "c", "d"], []
    path = str(tmp_path / "matches.h5")
    cm = cache.CachedPairMatcher(_fake_matcher(calls, N), path, names, N)
    p1 = np.array([[0, 1], [1, 2]])
    r1 = cm(p1)
    assert len(calls) == 1 and len(calls[0]) == 2
    p2 = np.array([[0, 1], [2, 3]])
    r2 = cm(p2)
    assert len(calls) == 2
    np.testing.assert_array_equal(calls[1], np.array([[2, 3]]))
    np.testing.assert_array_equal(r2[0], r1[0])

    def exploding(pairs):
        raise AssertionError("should not be called")

    r3 = cache.CachedPairMatcher(exploding, path, names, N)(np.concatenate([p1, p2[1:]]))
    np.testing.assert_array_equal(r3[:2], r1)


def test_cached_pair_matcher_fingerprint(h5, tmp_path):
    N, names, calls = 4, ["a", "b"], []
    path = str(tmp_path / "matches.h5")
    pairs = np.array([[0, 1]])
    matcher = _fake_matcher(calls, N)
    cache.CachedPairMatcher(matcher, path, names, N, fingerprint="v1")(pairs)
    assert cache.read_fingerprint(path) == "v1" and len(calls) == 1
    cache.CachedPairMatcher(matcher, path, names, N, fingerprint="v1")(pairs)
    assert len(calls) == 1
    cache.CachedPairMatcher(matcher, path, names, N, fingerprint="v2")(pairs)
    assert len(calls) == 2 and cache.read_fingerprint(path) == "v2"


def test_jax_written_match_cache_resumes_in_the_port(h5, tmp_path):
    """A cache JAX's CachedPairMatcher wrote (with a fingerprint) is read by
    the port's under the same fingerprint: the same rows, no matcher call;
    the port's additions are read back by JAX's."""
    N, names = 6, ["a", "b", "c", "d"]
    path = str(tmp_path / "matches.h5")
    jax_calls, calls = [], []
    pairs = np.array([[0, 1], [1, 2], [0, 3]])
    want = jax_cache.CachedPairMatcher(_fake_matcher(jax_calls, N), path, names, N,
                                       fingerprint="fp")(pairs)
    got = cache.CachedPairMatcher(_fake_matcher(calls, N), path, names, N,
                                  fingerprint="fp")(pairs[::-1])
    assert calls == []
    np.testing.assert_array_equal(got, want[::-1])
    more = cache.CachedPairMatcher(_fake_matcher(calls, N), path, names, N,
                                   fingerprint="fp")(np.array([[2, 3]]))
    assert len(calls) == 1
    back = jax_cache.CachedPairMatcher(_fake_matcher(jax_calls, N), path, names, N,
                                       fingerprint="fp")(np.array([[2, 3]]))
    assert len(jax_calls) == 1
    np.testing.assert_array_equal(back, more)


# --- mesh resolution, stage timer ------------------------------------------


def test_resolve_sfm_mesh(monkeypatch):
    """Resolved over the ranks as JAX resolves over its devices: no mesh
    for False / None / 0 / 1, nor for True or an int in a world of one
    rank (an int above the world is capped); over 4 ranks, True and an int
    of 4 or more give a data mesh of all 4, and a count between 1 and 4
    raises (a mesh must span every rank). Over real ranks:
    tests/test_torch_parallel.py::test_resolve_sfm_mesh_over_ranks."""
    made = []
    monkeypatch.setattr(sfm_parallel, "make_mesh", lambda **kw: made.append(kw) or kw)
    monkeypatch.setattr(sfm_parallel.comm, "get_world_size", lambda: 1)
    for v in (False, None, 0, True, 1, 4):
        assert sfm_parallel.resolve_sfm_mesh(v) is None
    monkeypatch.setattr(sfm_parallel.comm, "get_world_size", lambda: 4)
    assert sfm_parallel.resolve_sfm_mesh(1) is None
    for v in (True, 4, 9):
        assert sfm_parallel.resolve_sfm_mesh(v, device="cpu") == {
            "n_data": 4, "n_points": 1, "device": "cpu"}
    assert len(made) == 3
    for v in (2, 3):
        with pytest.raises(ValueError, match="span every rank"):
            sfm_parallel.resolve_sfm_mesh(v)


def test_stage_timer_report_matches_jax():
    timers = (profiling.StageTimer(), jax_profiling.StageTimer())
    for t in timers:
        for name in ("a", "b", "a"):
            with t.stage(name):
                pass
    got, want = (t.report() for t in timers)
    assert got.keys() == want.keys() == {"a", "b"}
    for k in want:
        assert got[k].keys() == want[k].keys()
        assert got[k]["count"] == want[k]["count"]
    assert re.sub(r"[\d.]+ms", "", timers[0].pretty()) == re.sub(r"[\d.]+ms", "",
                                                                  timers[1].pretty())
    assert set(timers[0].report(reset=True)) == {"a", "b"} and timers[0].report() == {}
