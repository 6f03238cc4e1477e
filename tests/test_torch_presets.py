"""The six shipped presets (`configs/*.yaml`) on the port against the JAX
package, on the CPU.

- Each preset, given as `--config configs/<file>.yaml` to its command,
  resolves through the port's `__main__.build_parser` and
  `config.load_config` to JAX's `load_config(<command>.DEFAULTS, preset,
  [])`, key for key, apart from the port's added `device`.
- `infer --config configs/infer_gt_box.yaml` runs end to end in both
  packages on one small rendered sequence (tests/test_cli.py::
  build_sequence, as tests/test_torch_infer.py's image route) mapped by
  JAX `map`, with paths, weights and a small-size override on top: the
  same keypoints, matches and poses, read from each command's `dump_vis3d`
  output, and the same metrics (recalls exactly, mean errors within 1e-3
  as tests/test_torch_infer.py holds them). On build_textured_sequence's
  images the two packages' keypoints differed in 3 of 1000 slots and the
  poses then parted, so that sequence is not used.
  Random matcher weights clear no 0.2: both matchers take
  `match_threshold` 0.0 (every mutual maximum counts, as chip_smoke.py
  runs them) and JAX's fuses its dual-softmax head (the port's kernel tie
  rule, ROADMAP C watch item 4), as tests/test_torch_infer.py does; the
  port draws JAX's RANSAC keys.
- chip_smoke.py runs every preset under `configs/` through its command, so
  a preset added later cannot go unchecked on the card.
"""

import functools
import glob
import importlib
import json
import os.path as osp
import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_cli import build_sequence

from onepose_tpu.__main__ import main as jax_main
from onepose_tpu.config import load_config as jax_load_config
from onepose_tpu.models.gats_spg import GATsSPG as JaxGATsSPG
from onepose_tpu.models.superpoint import SuperPoint as JaxSuperPoint
from onepose_tpu.utils.checkpoint import save_checkpoint as jax_save_checkpoint
from onepose_tpu_torch.__main__ import build_parser
from onepose_tpu_torch.__main__ import main as port_main
from onepose_tpu_torch.config import load_config

torch.set_num_threads(2)

ROOT = Path(__file__).resolve().parents[1]
CONFIGS = ROOT / "configs"
# The command each preset is written for (its header names the reference
# experiment) and the JAX module that holds the command's DEFAULTS.
PRESET_COMMANDS = {"map": "map", "detect": "detect", "infer_gt_box": "infer",
                   "infer_detect_box": "infer", "demo": "demo", "train_gats_spg": "train"}
JAX_MODULES = {"map": "map_object", "detect": "detect_cmd", "infer": "infer", "demo": "demo",
               "train": "train_cmd"}


def _last_json(capsys):
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])


def test_every_preset_has_a_command():
    assert {p.stem for p in CONFIGS.glob("*.yaml")} == set(PRESET_COMMANDS)


@pytest.mark.parametrize("preset", sorted(PRESET_COMMANDS))
def test_preset_resolves_as_in_jax(preset):
    command = PRESET_COMMANDS[preset]
    path = str(CONFIGS / f"{preset}.yaml")
    args = build_parser().parse_args([command, "--config", path])
    got = load_config(args._defaults, args.config, args.overrides)
    jax_defaults = importlib.import_module(f"onepose_tpu.cli.{JAX_MODULES[command]}").DEFAULTS
    want = jax_load_config(jax_defaults, path, [])
    assert got.pop("device") == "cuda"
    assert got == want
    # Every key the file sets reached the config (a preset key the command
    # does not know would be carried along silently in both packages).
    assert set(jax_load_config({}, path, [])) <= set(want)


def _serve_with_jax_keys(pipe, batch_start, K, anno, images=None, feats=None):
    """The port's `infer._serve` with JAX's RANSAC draws:
    uniform(key_b, (hypotheses, 3)) for key_b in split(PRNGKey(start), B)."""
    from onepose_tpu_torch.utils.precision import fp32_matmuls

    keys = jax.random.split(jax.random.PRNGKey(batch_start), K.shape[0])
    draws = torch.from_numpy(np.stack(
        [np.asarray(jax.random.uniform(k, (pipe.ransac_hypotheses, 3))) for k in keys]))
    with fp32_matmuls():
        assert feats is None
        return pipe(torch.from_numpy(images)[..., None], torch.from_numpy(K), anno, draws=draws)


def _vis_frames(dump_dir):
    """Per frame of a dump_vis3d directory: (keypoints, matched 3D points, pose)."""
    out = {}
    for d in glob.glob(osp.join(dump_dir, "*")):
        cam = json.load(open(osp.join(d, "camera.json")))
        out[int(osp.basename(d))] = (np.asarray(cam["kpts2d"]), np.asarray(cam["matched_pts3d"]),
                                     np.asarray(cam["pose_w2c"]))
    return out


def test_infer_gt_box_preset_matches_jax(tmp_path, capsys, monkeypatch):
    import onepose_tpu.cli.common as jax_common
    import onepose_tpu_torch.cli.infer as port_infer
    import onepose_tpu_torch.models.gats_spg as port_gats_spg

    n_frames = 8  # the preset's batch: one batch
    seq = build_sequence(tmp_path, np.random.default_rng(4), n_frames=n_frames, img=96, n_pts=40)
    sp = JaxSuperPoint().init(jax.random.PRNGKey(0), jnp.zeros((1, 64, 64, 1)))
    gm = JaxGATsSPG().init(jax.random.PRNGKey(7), jnp.zeros((1, 8, 256)), jnp.zeros((1, 6, 256)),
                           jnp.zeros((1, 6, 4, 256)))
    sp_ckpt = jax_save_checkpoint(str(tmp_path / "sp"), sp, 0)
    gm_ckpt = jax_save_checkpoint(str(tmp_path / "gm"), gm, 0)
    out_dir = tmp_path / "obj" / "outputs"
    assert jax_main(["map", f"data_dir={seq}", f"out_dir={out_dir}", "max_keypoints=256",
                     "num_covis=4", "max_points3d=300", f"weights.superpoint={sp_ckpt}"]) == 0
    capsys.readouterr()

    monkeypatch.setattr(jax_common, "GATsSPG", functools.partial(
        JaxGATsSPG, fused_match=True, gats_use_pallas=True, match_threshold=0.0))
    monkeypatch.setattr(port_gats_spg, "GATsSPG", functools.partial(
        port_gats_spg.GATsSPG, match_threshold=0.0))
    monkeypatch.setattr(port_infer, "_serve", _serve_with_jax_keys)
    argv = ["infer", "--config", str(CONFIGS / "infer_gt_box.yaml"), f"data_dir={seq}",
            f"anno_dir={out_dir / 'anno'}", f"weights.superpoint={sp_ckpt}",
            f"weights.matcher={gm_ckpt}", "shape3d=128"]
    assert jax_main([*argv, f"dump_vis3d={tmp_path / 'jax_vis'}"]) == 0
    want = _last_json(capsys)
    assert port_main([*argv, f"dump_vis3d={tmp_path / 'port_vis'}", "device=cpu"]) == 0
    got = _last_json(capsys)

    assert got.keys() == want.keys() and got["num_frames"] == want["num_frames"] == n_frames
    a, b = _vis_frames(str(tmp_path / "port_vis")), _vis_frames(str(tmp_path / "jax_vis"))
    assert sorted(a) == sorted(b) == list(range(n_frames))
    n_matched = 0
    for f in range(n_frames):
        np.testing.assert_array_equal(a[f][0], b[f][0])
        np.testing.assert_array_equal(a[f][1], b[f][1])
        np.testing.assert_allclose(a[f][2], b[f][2], atol=1e-3)
        n_matched += len(a[f][1])
    assert n_matched > 0
    for k in ("cmd1", "cmd3", "cmd5"):
        assert got[k] == want[k], (k, got, want)
    for k in ("mean_trans_cm", "mean_rot_deg"):
        assert np.isfinite(want[k]) and got[k] == pytest.approx(want[k], abs=1e-3), k


def test_chip_smoke_runs_every_preset():
    """Every `configs/*.yaml` is the --config of some chip_smoke run, with
    the command it is written for (`_preset_argv(command, preset, ...)`)."""
    text = (ROOT / "chip_smoke.py").read_text()
    runs = set(re.findall(r'_preset_argv\(\s*"([\w-]+)",\s*"(\w+)"', text))
    want = {(PRESET_COMMANDS[p.stem], p.stem) for p in CONFIGS.glob("*.yaml")}
    assert want <= runs, sorted(want - runs)
    assert "def _preset_argv(" in text and '"--config"' in text
