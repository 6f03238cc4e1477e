"""`convert` command: PyTorch checkpoints -> msgpack checkpoints.

Port of onepose_tpu/cli/convert_cmd.py. Users of the reference arrive with
its released PyTorch weights (superpoint_v1.pth, SuperGlue indoor /
outdoor .pth, a GATsSPG Lightning .ckpt). This converts one file once,
offline, into the JAX package's parameter tree (`models.convert`: conv
and dense transposes, folded BatchNorm, head-major attention channels)
and writes it with `utils.checkpoint.msgpack_serialize`, so both
packages read the result. Host work only (numpy): it runs on no device.
The file is read with weights_only=False, as the JAX command reads it
(Lightning checkpoints hold objects that are not tensors): convert only
files you trust.
"""

from __future__ import annotations

import os
import os.path as osp

DEFAULTS = {
    "model": None,  # 'superpoint' | 'superglue' | 'gats_spg'
    "weights": None,  # input PyTorch .pth / .ckpt path
    "out": None,  # output .msgpack path (default: beside the input)
}


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    elif hasattr(tree, "size"):
        yield tree


def run(cfg: dict) -> dict:
    from onepose_tpu_torch.models import convert as C
    from onepose_tpu_torch.utils.checkpoint import msgpack_serialize

    model = cfg["model"]
    weights = cfg["weights"]
    assert model in C.CONVERTERS, model
    assert weights, "convert: weights is required"

    sd = C.load_torch_state_dict(weights)
    # Lightning checkpoints prefix the matcher module.
    stripped = {}
    for k, v in sd.items():
        for pref in ("matcher.", "model.", "module."):
            if k.startswith(pref):
                k = k[len(pref):]
        stripped[k] = v
    params = C.CONVERTERS[model](stripped)

    out = cfg["out"] or osp.splitext(weights)[0] + ".msgpack"
    os.makedirs(osp.dirname(osp.abspath(out)), exist_ok=True)
    with open(out, "wb") as f:
        f.write(msgpack_serialize(params))
    result = {"model": model, "out": out, "n_params": int(sum(p.size for p in _leaves(params)))}
    print(result)
    return result


def add_parser(subparsers):
    p = subparsers.add_parser("convert", help="convert PyTorch weights to msgpack checkpoints")
    p.add_argument("--config", default=None)
    p.add_argument("overrides", nargs="*")
    p.set_defaults(_defaults=DEFAULTS, _run=run)
