"""Shared CLI plumbing: model weights and feature extraction over sequences.

Port of the part of onepose_tpu/cli/common.py that `map` runs:
`load_superpoint_params`, `load_superglue_params` (the JAX `map`'s inline
SuperGlue loading) and `extract_sequence_features`. The port's "params"
are a module's state_dict:
- `weights=None` gives a deterministic random init: the module's Linear
  and Conv layers drawn again by PyTorch's default initialisers under
  `torch.manual_seed(seed)` (inside `fork_rng`, so the caller's generator
  is untouched), the other parameters at their constructor values. It is
  the port's own init and not the JAX package's `PRNGKey(0)` one: to give
  both packages the same weights, load one checkpoint into both;
- a msgpack checkpoint (the JAX package's format, `utils.checkpoint`) is
  read and turned into a state_dict by `models.bridge`;
- PyTorch weight files (.pth, .tar, .pt, .ckpt) raise: converting them is
  the `convert` command (ROADMAP A15).
"""

from __future__ import annotations

import copy
from typing import Optional

import numpy as np
import torch

from onepose_tpu_torch._device import resolve_device
from onepose_tpu_torch.data import paths as path_utils
from onepose_tpu_torch.models import bridge
from onepose_tpu_torch.models.superpoint import extract_keypoints
from onepose_tpu_torch.utils.checkpoint import load_checkpoint
from onepose_tpu_torch.utils.precision import fp32_matmuls

TORCH_WEIGHTS = (".pth", ".tar", ".pt", ".ckpt")


def _random_init(model: torch.nn.Module, seed: int) -> dict[str, torch.Tensor]:
    """State dict of a copy of `model` with every layer that has an
    initialiser drawn again under `seed`."""
    fresh = copy.deepcopy(model).cpu()
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(seed)
        for m in fresh.modules():
            if m is not fresh and hasattr(m, "reset_parameters"):
                m.reset_parameters()
    return fresh.state_dict()


def _load(model: torch.nn.Module, weights: Optional[str], seed: int, to_state_dict):
    if weights is None:
        return _random_init(model, seed)
    if weights.endswith(TORCH_WEIGHTS):
        raise NotImplementedError(
            f"{weights}: PyTorch weight files need the `convert` command, not ported yet "
            "(ROADMAP A15); pass a msgpack checkpoint")
    return to_state_dict(load_checkpoint(weights))


def load_superpoint_params(model, weights: Optional[str], seed: int = 0) -> dict:
    """SuperPoint state_dict from a msgpack checkpoint, or the seeded random
    init when weights is None."""
    return _load(model, weights, seed, bridge.superpoint_state_dict)


def load_superglue_params(model, weights: Optional[str], seed: int = 0) -> dict:
    """SuperGlue state_dict from a msgpack checkpoint, or the seeded random
    init when weights is None."""
    return _load(model, weights, seed, bridge.superglue_state_dict)


def extract_sequence_features(
    seq_root: str,
    sp_params: dict,
    model,
    max_keypoints: int = 1024,
    keypoint_threshold: float = 0.005,
    det_type: str = "GT_box",
    batch: int = 8,
    mesh=None,
    device: str | torch.device = "cuda",
) -> dict:
    """Run SuperPoint over a sequence directory; returns stacked numpy
    arrays keypoints [F, N, 2], descriptors [F, N, C], scores [F, N],
    mask [F, N], K [F, 3, 3], poses [F, 4, 4], image_paths and image_hw.

    `sp_params` is loaded into `model`, which moves to `device`. Frames go
    to the device a batch at a time; the last batch is padded to `batch`
    by repeating its first frame, as in the JAX package, and the padded
    rows are dropped. The forward runs in full fp32 (TF32 off), as the JAX
    package computes it. `mesh` (from `parallel.sfm_parallel.
    resolve_sfm_mesh`) is None on one card; a mesh raises until ROADMAP A14."""
    if mesh is not None:
        raise NotImplementedError("feature extraction over a device mesh is not ported yet "
                                  "(ROADMAP A14): pass mesh=None")
    dev = resolve_device(device)
    img_paths = path_utils.list_color_images(seq_root, det_type)
    if not img_paths:
        raise FileNotFoundError(f"no images under {seq_root}")
    model.load_state_dict(sp_params)
    model.to(dev).eval()

    imgs, Ks, poses = [], [], []
    for p in img_paths:
        img, K, pose = path_utils.load_frame(p, det_type)
        imgs.append(img)
        Ks.append(K)
        poses.append(pose)

    h, w = imgs[0].shape
    outs = []
    with torch.inference_mode(), fp32_matmuls():
        for s in range(0, len(imgs), batch):
            chunk = imgs[s:s + batch]
            n_real = len(chunk)
            if n_real < batch:
                chunk = chunk + [chunk[0]] * (batch - n_real)
            x = torch.from_numpy(np.stack(chunk)[..., None]).to(dev)
            dense = model(x)
            out = extract_keypoints(dense["score_map"], dense["descriptor_map"],
                                    max_keypoints=max_keypoints,
                                    keypoint_threshold=keypoint_threshold)
            outs.append({k: v[:n_real].cpu().numpy() for k, v in out.items()})
    stacked = {k: np.concatenate([o[k] for o in outs], axis=0) for k in outs[0]}
    return {
        "keypoints": stacked["keypoints"],
        "descriptors": stacked["descriptors"],
        "scores": stacked["scores"],
        "mask": stacked["mask"],
        "K": np.stack(Ks),
        "poses": np.stack(poses),
        "image_paths": img_paths,
        "image_hw": (h, w),
    }
