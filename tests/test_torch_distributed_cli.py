"""`map`, `infer` and `train` over 2 gloo ranks on the CPU (`torchrun
--nproc-per-node 2 -m onepose_tpu_torch ... device=cpu`), against the same
commands in one process and, for `train`, against the JAX package.

- `map` of a roster of two objects (6 textured frames each, 256
  keypoints, global BA, the HDF5 caches on): with `data_parallel` off
  each rank maps its share of the roster, and the artifacts equal one
  process's; with it on both ranks walk the roster over a mesh of both
  (extraction and matching split, BA's points split, rank 0 writes), and
  the artifacts equal one process's but for BA's rounding (points within
  1e-4).
- `infer` of that roster with nn: with `data_parallel` off each rank
  evaluates one sequence and the recalls combine exactly; with it on
  every batch of 4 is served 2 frames a rank; both give one process's
  metrics, and eval_out holds every sequence and ALL.
- `train` resumed from JAX's one-epoch checkpoint for one epoch at batch 2
  (one item a rank): the loss history within 1e-5 relative of the
  one-process port's and 1e-4 of JAX's (ROADMAP A11's criterion).
- The guards of the multi-host faults the port does not copy: a
  `data_parallel` count between 1 and the world raises; a batch that the
  world does not divide raises.
"""

import glob
import json
import os
import os.path as osp
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_cli import build_textured_sequence
from test_torch_train import write_annotations

from onepose_tpu.__main__ import main as jax_main
from onepose_tpu.models.superpoint import SuperPoint as JaxSuperPoint
from onepose_tpu.utils.checkpoint import save_checkpoint as jax_save_checkpoint
from onepose_tpu_torch.__main__ import main as port_main
from torch_ranks import spawn_command

torch.set_num_threads(2)

RANKS = 2
MAP_ARGS = ["max_keypoints=256", "num_covis=4", "max_points3d=300", "device=cpu",
            "global_ba=true", "global_ba_iters=3"]
TRAIN_SMALL = ["shape2d=32", "shape3d=48", "num_leaf=4", "batch_size=2", "num_workers=0",
               "tensorboard=false", "code_snapshot=false", "device=cpu"]


def _last_json(text: str) -> dict:
    return json.loads(text.strip().splitlines()[-1])


@pytest.fixture(scope="module")
def roster(tmp_path_factory):
    """Two textured sequences, a JAX SuperPoint checkpoint, and the roster
    mapped by one process (caches on)."""
    root = tmp_path_factory.mktemp("dcli")
    sp = JaxSuperPoint().init(jax.random.PRNGKey(0), jnp.zeros((1, 64, 64, 1)))
    sp_ckpt = jax_save_checkpoint(str(root / "sp"), sp, 0)
    seqs = []
    for i, name in enumerate(("a", "b")):
        seq, _ = build_textured_sequence(root / name, np.random.default_rng(30 + i), n_frames=6)
        renamed = osp.join(osp.dirname(seq), f"seq_{name}")
        os.rename(seq, renamed)
        seqs.append(renamed)
    args = ["map", f"data_dir={','.join(seqs)}", f"weights.superpoint={sp_ckpt}", *MAP_ARGS]
    assert port_main(args + [f"out_dir={root / 'one'}"]) == 0
    return {"root": root, "seqs": seqs, "sp": sp_ckpt, "map_args": args}


def _map_files(out_dir) -> dict:
    files = sorted(glob.glob(osp.join(str(out_dir), "*", "anno", "*")))
    assert files, out_dir
    return {osp.relpath(f, str(out_dir)): f for f in files}


@pytest.mark.parametrize("data_parallel", [False, True])
def test_map_over_ranks_matches_one_process(roster, data_parallel):
    out = roster["root"] / f"ranks_dp{int(data_parallel)}"
    logs = spawn_command(roster["map_args"] + [f"out_dir={out}",
                                               f"data_parallel={str(data_parallel).lower()}"],
                         RANKS, roster["root"] / f"map_logs_{int(data_parallel)}")
    summaries = [_last_json(s) for s in logs]
    one, got = _map_files(roster["root"] / "one"), _map_files(out)
    assert got.keys() == one.keys()
    for rel, path in one.items():
        if path.endswith(".npz"):
            a, b = np.load(path), np.load(got[rel])
            assert a.files == b.files, rel
            for k in a.files:
                if data_parallel and a[k].dtype.kind == "f":
                    np.testing.assert_allclose(b[k], a[k], atol=1e-4, err_msg=f"{rel} {k}")
                else:
                    np.testing.assert_array_equal(b[k], a[k], err_msg=f"{rel} {k}")
        elif path.endswith(".npy"):
            np.testing.assert_array_equal(np.load(got[rel]), np.load(path), err_msg=rel)
        elif rel.endswith("anno_index.json"):
            a, b = json.load(open(path)), json.load(open(got[rel]))
            assert [e["img_file"] for e in a] == [e["img_file"] for e in b]
    one_stats = {osp.basename(osp.dirname(p)): json.load(open(p))
                 for p in glob.glob(str(roster["root"] / "one" / "*" / "stats.json"))}
    got_stats = {osp.basename(osp.dirname(p)): json.load(open(p))
                 for p in glob.glob(str(out / "*" / "stats.json"))}
    assert got_stats.keys() == one_stats.keys() and len(one_stats) == 2
    for name, s in one_stats.items():
        assert got_stats[name]["num_points3d"] == s["num_points3d"] > 0
        assert got_stats[name]["num_pairs"] == s["num_pairs"]
    if data_parallel:
        # Every rank walked the whole roster.
        assert [s["num_objects"] for s in summaries] == [2, 2]
        assert (out / next(iter(got_stats)) / "feats-superpoint.h5").exists()
    else:
        assert sorted(s["num_objects"] for s in summaries) == [1, 1]


@pytest.fixture(scope="module")
def infer_one(roster):
    """infer over the roster in one process."""
    out = roster["root"] / "eval_one"
    args = ["infer", f"data_dir={','.join(roster['seqs'])}", "matcher=nn", "max_keypoints=256",
            "shape3d=300", "batch=4", f"weights.superpoint={roster['sp']}", "device=cpu"]
    # infer reads each sequence's map from <object>/outputs/anno.
    for seq in roster["seqs"]:
        src = [d for d in glob.glob(str(roster["root"] / "one" / "*"))
               if osp.basename(d).endswith(osp.basename(seq))]
        assert len(src) == 1, src
        dst = osp.join(osp.dirname(seq), "outputs")
        if not osp.exists(dst):
            shutil.copytree(src[0], dst)
    import contextlib
    import io

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        assert port_main(args + [f"eval_out={out}"]) == 0
    return {"args": args, "metrics": _last_json(buf.getvalue()), "eval": out}


@pytest.mark.parametrize("data_parallel", [False, True])
def test_infer_over_ranks_matches_one_process(roster, infer_one, data_parallel):
    out = roster["root"] / f"eval_dp{int(data_parallel)}"
    logs = spawn_command(infer_one["args"] + [f"eval_out={out}",
                                              f"data_parallel={str(data_parallel).lower()}"],
                         RANKS, roster["root"] / f"infer_logs_{int(data_parallel)}")
    want = infer_one["metrics"]
    assert want["num_frames"] == 12
    for text in logs:
        got = _last_json(text)
        for k in ("cmd1", "cmd3", "cmd5", "num_frames"):
            assert got[k] == pytest.approx(want[k], abs=1e-9), k
        if data_parallel:  # every rank evaluated every sequence
            assert got["per_seq"].keys() == want["per_seq"].keys()
            for name, m in want["per_seq"].items():
                assert got["per_seq"][name] == pytest.approx(m, abs=1e-9), name
    for f in ("ALL.txt", "seq_a.txt", "seq_b.txt"):
        assert (out / f).read_text() == (infer_one["eval"] / f).read_text(), f


def test_data_parallel_between_one_and_world_raises(roster):
    """ADVICE.md's first multi-host fault: a mesh that leaves ranks out.
    Over 3 ranks, data_parallel=2 raises on every rank before any work."""
    with pytest.raises(AssertionError, match="must span every rank"):
        spawn_command(["infer", f"data_dir={roster['seqs'][0]}", "matcher=nn",
                       "data_parallel=2", "device=cpu",
                       f"weights.superpoint={roster['sp']}"], 3, roster["root"] / "dp_logs",
                      timeout=120)


@pytest.fixture(scope="module")
def train_runs(tmp_path_factory):
    """JAX's ckpt_0 (one epoch), resumed for one epoch by JAX, by the port in
    one process and by the port over 2 ranks."""
    root = tmp_path_factory.mktemp("dtrain")
    index = write_annotations(root, np.random.default_rng(0), frames=6)
    first = root / "first"
    jax_small = [a for a in TRAIN_SMALL if a != "device=cpu"]
    assert jax_main(["train", f"anno_index={index}", f"run_dir={first}", "max_epochs=1",
                     *jax_small]) == 0
    runs = {}
    for name in ("jax", "one", "ranks"):
        run_dir = root / name
        shutil.copytree(first / "ckpt", run_dir / "ckpt")
        args = ["train", f"anno_index={index}", f"run_dir={run_dir}", "max_epochs=2"]
        if name == "jax":
            assert jax_main(args + jax_small) == 0
        elif name == "one":
            assert port_main(args + TRAIN_SMALL) == 0
        else:
            spawn_command(args + TRAIN_SMALL, RANKS, root / "logs")
        runs[name] = [json.loads(line) for line in (run_dir / "metrics.jsonl").read_text()
                      .splitlines()]
    return {"root": root, "index": index, "runs": runs}


@pytest.mark.parametrize("against,rel", [("one", 1e-5), ("jax", 1e-4)])
def test_train_over_ranks_matches(train_runs, against, rel):
    got, want = train_runs["runs"]["ranks"], train_runs["runs"][against]
    assert [sorted(r) for r in got] == [sorted(r) for r in want]
    assert any("train_loss" in r for r in got)
    for a, b in zip(want, got):
        for k in ("loss", "grad_norm", "train_loss"):
            if k in a:
                np.testing.assert_allclose(b[k], a[k], rtol=rel, err_msg=k)
        for k in ("epoch", "step", "precision", "recall"):
            assert a.get(k) == b.get(k), k


def test_train_over_ranks_writes_one_checkpoint_an_epoch(train_runs):
    ckpts = sorted(osp.basename(p) for p in
                   glob.glob(str(train_runs["root"] / "ranks" / "ckpt" / "ckpt_*.msgpack")))
    assert ckpts == ["ckpt_0.msgpack", "ckpt_1.msgpack"]


def test_train_batch_that_does_not_divide_the_world_raises(train_runs):
    """ADVICE.md's second multi-host fault: a batch of 3 over 2 ranks
    raises on every rank (the JAX package shrinks its mesh instead)."""
    args = ["train", f"anno_index={train_runs['index']}",
            f"run_dir={train_runs['root'] / 'odd'}", "max_epochs=1",
            *[a if a != "batch_size=2" else "batch_size=3" for a in TRAIN_SMALL]]
    with pytest.raises(AssertionError, match="must divide over the 2 ranks"):
        spawn_command(args, RANKS, train_runs["root"] / "odd_logs", timeout=120)
