"""The port's weight conversion (`models/convert.py`, the `convert` command,
and the PyTorch weight files `cli/common.py` reads) against the JAX
package's, on the CPU.

There are no released weights in the repo and nothing may be fetched, so
each test writes reference-layout state_dicts from a seed: the key names
and shapes `onepose_tpu/models/convert.py` reads (SuperPoint's twelve
convs; SuperGlue's keypoint encoder with BatchNorm and 9 x 2 attention
layers; GATsSPG's 4 x [GATs, self, cross] layers with InstanceNorm, its
unused encoders and bin_score, as a Lightning checkpoint with
'matcher.'-prefixed keys and a hyper-parameter object that only
weights_only=False unpickles). Held exactly (both convert with the same
numpy operations):
- the port's trees equal JAX's leaf for leaf, for all three models;
- the port's `convert` file loads in both packages, and JAX's in the
  port, to the same trees;
- a weight file given straight to the CLI loaders gives the same port
  state_dict as its converted msgpack, and that state_dict loads into the
  port's model.
"""

import argparse

import jax
import numpy as np
import pytest
import torch

from onepose_tpu.__main__ import main as jax_main
from onepose_tpu.cli import common as jax_common
from onepose_tpu.models import convert as jax_convert
from onepose_tpu.models.gats_spg import GATsSPG as JaxGATsSPG
from onepose_tpu.models.superglue import SuperGlue as JaxSuperGlue
from onepose_tpu.models.superpoint import SuperPoint as JaxSuperPoint
from onepose_tpu_torch.__main__ import main as port_main
from onepose_tpu_torch.cli import common
from onepose_tpu_torch.models import bridge, convert
from onepose_tpu_torch.models.gats_spg import GATsSPG
from onepose_tpu_torch.models.superglue import SuperGlue
from onepose_tpu_torch.models.superpoint import SuperPoint

torch.set_num_threads(2)

D = 256


class _SD(dict):
    """A reference-layout state_dict of seeded tensors."""

    def __init__(self, seed):
        super().__init__()
        self.rng = np.random.default_rng(seed)

    def t(self, name, *shape, positive=False):
        x = self.rng.normal(size=shape).astype(np.float32)
        self[name] = torch.from_numpy(np.abs(x) + 0.5 if positive else x)

    def conv(self, name, out, inp, *k):
        self.t(f"{name}.weight", out, inp, *k)
        self.t(f"{name}.bias", out)

    def bn(self, name, c):
        self.t(f"{name}.weight", c)
        self.t(f"{name}.bias", c)
        self.t(f"{name}.running_mean", c)
        self.t(f"{name}.running_var", c, positive=True)
        self[f"{name}.num_batches_tracked"] = torch.tensor(7)

    def attention_layer(self, prefix, batch_norm):
        for i in range(3):
            self.conv(f"{prefix}.attn.proj.{i}", D, D, 1)
        self.conv(f"{prefix}.attn.merge", D, D, 1)
        self.conv(f"{prefix}.mlp.0", 2 * D, 2 * D, 1)
        if batch_norm:
            self.bn(f"{prefix}.mlp.1", 2 * D)
        self.conv(f"{prefix}.mlp.3", D, 2 * D, 1)


def superpoint_sd(seed=0):
    sd = _SD(seed)
    for name, out, inp in (("conv1a", 64, 1), ("conv1b", 64, 64), ("conv2a", 64, 64),
                           ("conv2b", 64, 64), ("conv3a", 128, 64), ("conv3b", 128, 128),
                           ("conv4a", 128, 128), ("conv4b", 128, 128), ("convPa", 256, 128),
                           ("convDa", 256, 128)):
        sd.conv(name, out, inp, 3, 3)
    sd.conv("convPb", 65, 256, 1, 1)
    sd.conv("convDb", 256, 256, 1, 1)
    return dict(sd)


def superglue_sd(seed=1):
    sd = _SD(seed)
    chans = [3, 32, 64, 128, 256, D]
    for i in range(5):
        sd.conv(f"kenc.encoder.{3 * i}", chans[i + 1], chans[i], 1)
        if i < 4:
            sd.bn(f"kenc.encoder.{3 * i + 1}", chans[i + 1])
    for layer in range(18):
        sd.attention_layer(f"gnn.layers.{layer}", batch_norm=True)
    sd.conv("final_proj", D, D, 1)
    sd["bin_score"] = torch.tensor(1.25)
    return dict(sd)


def gats_spg_sd(seed=2, prefix="matcher."):
    sd = _SD(seed)
    for blk in range(4):
        sd.t(f"gnn.layers.{3 * blk}.W", D, D)
        sd.t(f"gnn.layers.{3 * blk}.a", 2 * D, 1)
        sd.attention_layer(f"gnn.layers.{3 * blk + 1}", batch_norm=False)
        sd.attention_layer(f"gnn.layers.{3 * blk + 2}", batch_norm=False)
    sd.conv("final_proj", D, D, 1)
    sd.conv("kenc_2d.encoder.0", 32, 3, 1)  # unused by the matcher: ignored
    sd["bin_score"] = torch.tensor(1.0)
    return {prefix + k: v for k, v in sd.items()}


MODELS = {
    "superpoint": (superpoint_sd, SuperPoint, common.load_superpoint_params,
                   jax_common.load_superpoint_params, JaxSuperPoint, bridge.superpoint_state_dict),
    "superglue": (superglue_sd, SuperGlue, common.load_superglue_params,
                  jax_common.load_superglue_params, JaxSuperGlue, bridge.superglue_state_dict),
    "gats_spg": (gats_spg_sd, GATsSPG, common.load_matcher_params,
                 jax_common.load_matcher_params, JaxGATsSPG, bridge.gats_spg_state_dict),
}


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}/"))
        else:
            out[prefix + k] = np.asarray(v)
    return out


def _assert_trees_equal(got, want):
    got, want = _flat(got), _flat(jax.tree.map(np.asarray, want))
    assert got.keys() == want.keys()
    for k in want:
        assert got[k].shape == want[k].shape and got[k].dtype == want[k].dtype, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def _assert_state_dicts_equal(got, want):
    assert got.keys() == want.keys()
    for k in want:
        torch.testing.assert_close(got[k], want[k], rtol=0, atol=0)


@pytest.mark.parametrize("model", sorted(MODELS))
def test_converters_match_jax(model):
    sd = MODELS[model][0]()
    want = getattr(jax_convert, f"{model}_from_torch")(sd)
    _assert_trees_equal(convert.CONVERTERS[model](sd), want)


def test_helpers_match_jax():
    sd = superglue_sd()
    for name in ("kenc.encoder.1", "gnn.layers.0.mlp.1"):
        for a, b in zip(convert._fold_bn(sd, name), jax_convert._fold_bn(sd, name)):
            np.testing.assert_array_equal(a, b)
    for d, h in ((256, 4), (64, 2)):
        np.testing.assert_array_equal(convert._head_perm(d, h), jax_convert._head_perm(d, h))


@pytest.mark.parametrize("model", sorted(MODELS))
def test_convert_command_matches_jax(model, tmp_path, capsys):
    make, Model, load, jax_load, JaxModel, to_sd = MODELS[model]
    sd = make()
    src = tmp_path / ("w.ckpt" if model == "gats_spg" else "w.pth")
    if model == "gats_spg":  # a Lightning checkpoint
        torch.save({"state_dict": sd, "epoch": 3,
                    "hyper_parameters": argparse.Namespace(lr=1e-3)}, src)
    else:
        torch.save(sd, src)
    want = getattr(jax_convert, f"{model}_from_torch")(
        {k.removeprefix("matcher."): v for k, v in sd.items()})

    out = tmp_path / "port.msgpack"
    assert port_main(["convert", f"model={model}", f"weights={src}", f"out={out}"]) == 0
    assert f"'out': '{out}'" in capsys.readouterr().out
    jax_out = tmp_path / "jax.msgpack"
    assert jax_main(["convert", f"model={model}", f"weights={src}", f"out={jax_out}"]) == 0
    capsys.readouterr()

    # The port's file in JAX, and both files in the port.
    _assert_trees_equal(jax.tree.map(np.asarray, jax_load(JaxModel(), str(out))), want)
    port_model = Model()
    want_sd = to_sd(jax.tree.map(np.asarray, want))
    for path in (out, jax_out):
        _assert_state_dicts_equal(load(port_model, str(path)), want_sd)
    # The weight file straight into the CLI loaders: the same state_dict.
    from_file = load(port_model, str(src))
    _assert_state_dicts_equal(from_file, want_sd)
    port_model.load_state_dict(from_file)


def test_default_output_path(tmp_path, capsys):
    src = tmp_path / "superpoint_v1.pth"
    torch.save(superpoint_sd(), src)
    assert port_main(["convert", "model=superpoint", f"weights={src}"]) == 0
    assert (tmp_path / "superpoint_v1.msgpack").exists()
    n = sum(v.numel() for v in superpoint_sd().values())
    assert f"'n_params': {n}" in capsys.readouterr().out
