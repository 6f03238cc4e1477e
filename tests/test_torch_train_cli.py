"""The port's `train` command against the JAX package's, on the CPU.

A small map's annotations (tests/test_torch_train.py::write_annotations: 6
frames, 40 points, 256-d descriptors) train the shipped matcher (4 blocks,
d_model 256) at shape2d 32, shape3d 48, 4 leaves, batch 2 and the default
accumulate 2, with num_workers=0 (a thread pool takes the dataset's one
generator in a racy order, in both packages). JAX's command writes ckpt_0;
each package resumes it for one epoch: train_loss agrees to 1e-4
relative, the checkpoints cross (JAX's load_checkpoint restores the
port's, and both packages' infer load its parameters). Then the command's
own behaviour: its artifacts, a fresh run, no CUDA, several processes.
"""

import json
import shutil

import jax
import numpy as np
import pytest
import torch
from flax import serialization
from test_torch_train import write_annotations

from onepose_tpu.__main__ import main as jax_main
from onepose_tpu.cli.common import load_matcher_params as jax_load_matcher
from onepose_tpu.models.gats_spg import GATsSPG as JaxGATsSPG
from onepose_tpu.train.train_step import TrainConfig as JaxTrainConfig
from onepose_tpu.train.train_step import create_train_state as jax_create_state
from onepose_tpu.utils import checkpoint as jax_ckpt
from onepose_tpu_torch.__main__ import build_parser
from onepose_tpu_torch.__main__ import main as port_main
from onepose_tpu_torch.cli import common
from onepose_tpu_torch.models import bridge
from onepose_tpu_torch.models.gats_spg import GATsSPG
from onepose_tpu_torch.utils import checkpoint as port_ckpt

torch.set_num_threads(2)

SMALL = ["shape2d=32", "shape3d=48", "num_leaf=4", "batch_size=2", "num_workers=0",
         "tensorboard=false", "code_snapshot=false"]
LOSS_REL = 1e-4
PARAM_ABS = 5 * 3e-3  # 3 updates of lr 1e-3 (Adam's sign flips, module docstring)


def _summary(capsys) -> dict:
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """The annotations, JAX's ckpt_0 (one epoch) and each package's resumed
    run to two epochs, each run once for the module."""
    root = tmp_path_factory.mktemp("train_cli")
    index = write_annotations(root, np.random.default_rng(0), frames=6)
    first = root / "first"
    assert jax_main(["train", f"anno_index={index}", f"run_dir={first}", "max_epochs=1",
                     *SMALL]) == 0
    runs = {}
    for pkg, main, extra in (("jax", jax_main, []), ("port", port_main, ["device=cpu"])):
        run_dir = root / pkg
        shutil.copytree(first / "ckpt", run_dir / "ckpt")
        assert main(["train", f"anno_index={index}", f"run_dir={run_dir}", "max_epochs=2",
                     *SMALL, *extra]) == 0
        runs[pkg] = run_dir
    return {"root": root, "index": index, "first": first, "runs": runs}


def _metrics(run_dir):
    return [json.loads(line) for line in (run_dir / "metrics.jsonl").read_text().splitlines()]


def test_resumed_epoch_matches_jax(world):
    """Each package resumes JAX's ckpt_0 and trains epoch 1: the same
    records (train_loss to 1e-4 relative, per-step losses and grad norms),
    parameters within a few lr, and the counts of the train state."""
    jm, pm = _metrics(world["runs"]["jax"]), _metrics(world["runs"]["port"])
    assert [sorted(r) for r in jm] == [sorted(r) for r in pm]
    for a, b in zip(jm, pm):
        for k in ("loss", "grad_norm", "train_loss"):
            if k in a:
                np.testing.assert_allclose(b[k], a[k], rtol=LOSS_REL, err_msg=k)
        for k in ("epoch", "step", "precision", "recall"):
            assert a.get(k) == b.get(k), k
    jt = port_ckpt.load_checkpoint(str(world["runs"]["jax"] / "ckpt" / "ckpt_1.msgpack"))
    pt = port_ckpt.load_checkpoint(str(world["runs"]["port"] / "ckpt" / "ckpt_1.msgpack"))
    assert jax.tree.structure(jt) == jax.tree.structure(pt)
    for k in ("step",):
        assert int(jt[k]) == int(pt[k]) == 6
    o_j, o_p = jt["opt_state"], pt["opt_state"]
    for k in ("mini_step", "gradient_step"):
        assert int(o_j[k]) == int(o_p[k]), k
    diff = max(float(np.abs(a - b).max()) for a, b in zip(jax.tree.leaves(jt["params"]),
                                                          jax.tree.leaves(pt["params"])))
    assert diff < PARAM_ABS, diff


def test_port_checkpoint_restores_in_jax_and_both_infers(world):
    """JAX's load_checkpoint takes the port's ckpt_1 into its train state;
    both packages' infer load its parameters (load_matcher_params)."""
    path = str(world["runs"]["port"] / "ckpt" / "ckpt_1.msgpack")
    state = jax_create_state(jax.random.PRNGKey(0), JaxGATsSPG(fused_match=False),
                             JaxTrainConfig(accumulate=2), {
                                 "desc2d": np.zeros((1, 4, 256), np.float32),
                                 "desc3d": np.zeros((1, 5, 256), np.float32),
                                 "leaf_desc": np.zeros((1, 5, 2, 256), np.float32)})
    restored = jax_ckpt.load_checkpoint(path, state)
    stored = port_ckpt.load_checkpoint(path)
    got = jax.tree.map(np.asarray, serialization.to_state_dict(restored))
    for a, b in zip(jax.tree.leaves(got), jax.tree.leaves(stored)):
        np.testing.assert_array_equal(a, b)
    jax_params = jax.tree.map(np.asarray, jax_load_matcher(JaxGATsSPG(), path))
    port_sd = common.load_matcher_params(GATsSPG(), path)
    for k, v in bridge.gats_spg_state_dict(jax_params).items():
        assert torch.equal(port_sd[k], v), k
    assert torch.equal(port_sd["gats_0.W"], torch.from_numpy(stored["params"]["params"]
                                                              ["gats_0"]["W"]))


def test_fresh_run_artifacts(world, capsys):
    """A run from nothing: the summary line, one checkpoint an epoch with
    the train state's keys, metrics.jsonl, best_metrics.json, the best
    checkpoint and the code snapshot; train_loss falls on a planted map."""
    run_dir = world["root"] / "fresh"
    args = [a for a in SMALL if not a.startswith("code_snapshot")]
    assert port_main(["train", f"anno_index={world['index']}", f"run_dir={run_dir}",
                      "max_epochs=2", "device=cpu", "lr=3e-3", *args]) == 0
    summary = _summary(capsys)
    assert summary["epoch"] == 1 and summary["optimized_metric"] == "train_loss"
    assert summary["optimized_metric_value"] == summary["train_loss"]
    hist = [r for r in _metrics(run_dir) if "train_loss" in r]
    assert hist[1]["train_loss"] < hist[0]["train_loss"]
    for name in ("ckpt/ckpt_0.msgpack", "ckpt/ckpt_1.msgpack", "ckpt/best.msgpack",
                 "ckpt/best.json", "best_metrics.json", "code_snapshot.zip"):
        assert (run_dir / name).is_file(), name
    tree = port_ckpt.load_checkpoint(str(run_dir / "ckpt" / "ckpt_1.msgpack"))
    assert set(tree) == {"step", "params", "opt_state"}
    assert set(tree["opt_state"]) == {"mini_step", "gradient_step", "inner_opt_state",
                                      "acc_grads", "skip_state"}
    assert tree["step"].dtype == np.int32 and int(tree["step"]) == 6


def test_train_without_cuda_raises(world, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("this machine has CUDA: the no-CUDA error cannot be shown here")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        port_main(["train", f"anno_index={world['index']}", f"run_dir={tmp_path}", *SMALL])
    assert not (tmp_path / "ckpt").exists()


def test_train_over_several_processes_raises(world, tmp_path, monkeypatch):
    """Over 2 processes a batch that does not divide over them raises before
    any step (the JAX package shrinks its mesh instead, ADVICE.md); data
    parallelism over real ranks: tests/test_torch_distributed_cli.py."""
    monkeypatch.setattr(torch.distributed, "is_initialized", lambda: True)
    monkeypatch.setattr(torch.distributed, "get_world_size", lambda: 2)
    monkeypatch.setattr(torch.distributed, "get_rank", lambda: 0)
    with pytest.raises(ValueError, match="must divide over the 2 ranks"):
        port_main(["train", f"anno_index={world['index']}", f"run_dir={tmp_path}",
                   "device=cpu", *[a if a != "batch_size=2" else "batch_size=3" for a in SMALL]])
    assert not (tmp_path / "ckpt").exists()


def test_train_is_registered():
    sub = next(a for a in build_parser()._actions if a.dest == "command")
    assert "train" in sub.choices
