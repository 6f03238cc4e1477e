"""Shared CLI plumbing: model weights, matchers, feature extraction over
sequences and the feature detector.

Port of onepose_tpu/cli/common.py: `load_superpoint_params`,
`load_superglue_params`, `load_matcher_params`, `build_matcher`,
`extract_sequence_features` and `build_feature_detector`; and, with no
JAX counterpart, `load_lightglue_params` for `map`'s LightGlue. The JAX
package's persistent compilation cache has no counterpart (nothing is
compiled per call here). The port's "params" are a module's state_dict:
- `weights=None` gives a deterministic random init: the module's Linear
  and Conv layers drawn again by PyTorch's default initialisers under
  `torch.manual_seed(seed)` (inside `fork_rng`, so the caller's generator
  is untouched), the other parameters at their constructor values. It is
  the port's own init and not the JAX package's `PRNGKey(0)` one: to give
  both packages the same weights, load one checkpoint into both;
- a msgpack checkpoint (the JAX package's format, `utils.checkpoint`) is
  read and turned into a state_dict by `models.bridge`; for the matcher
  either bare params or a train loop's `{step, params, opt_state}`;
- a PyTorch weight file (.pth, .tar, .pt, .ckpt: the reference's released
  weights, or a Lightning checkpoint's "state_dict") goes through
  `models.convert` to the JAX package's tree, then the same bridge, as the
  JAX loaders convert it. The `convert` command writes that tree as a
  msgpack checkpoint once, ahead of time.
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


def sequence_dirs(raw, command: str) -> list:
    """The sequences of a `data_dir` value: one directory, a comma-separated
    list, or glob patterns (a pattern that matches nothing is kept as it
    is)."""
    from glob import glob

    seq_dirs = []
    for d in str(raw).split(","):
        d = d.strip()
        if not d:
            continue
        hits = sorted(glob(d)) if any(c in d for c in "*?[") else [d]
        seq_dirs.extend(hits or [d])
    assert seq_dirs, f"{command}: no sequences match {raw!r}"
    return seq_dirs


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


def _load(model: torch.nn.Module, weights: Optional[str], seed: int, to_state_dict,
          kind: str):
    if weights is None:
        return _random_init(model, seed)
    if weights.endswith(TORCH_WEIGHTS):
        from onepose_tpu_torch.models import convert

        return to_state_dict(convert.CONVERTERS[kind](convert.load_torch_state_dict(weights)))
    return to_state_dict(load_checkpoint(weights))


def load_superpoint_params(model, weights: Optional[str], seed: int = 0) -> dict:
    """SuperPoint state_dict from a msgpack checkpoint or a PyTorch weight
    file, or the seeded random init when weights is None."""
    return _load(model, weights, seed, bridge.superpoint_state_dict, "superpoint")


def load_superglue_params(model, weights: Optional[str], seed: int = 0) -> dict:
    """SuperGlue state_dict from a msgpack checkpoint or a PyTorch weight
    file, or the seeded random init when weights is None."""
    return _load(model, weights, seed, bridge.superglue_state_dict, "superglue")


def load_lightglue_params(model, weights: Optional[str], seed: int = 0) -> dict:
    """LightGlue state_dict from upstream's PyTorch weight file
    (`superpoint_lightglue.pth`, through `models.convert.
    lightglue_from_torch`), or the seeded random init when weights is None.
    The JAX package has no LightGlue, so there is no msgpack form."""
    if weights is None:
        return _random_init(model, seed)
    if not weights.endswith(TORCH_WEIGHTS):
        raise ValueError(f"LightGlue weights must be a PyTorch weight file {TORCH_WEIGHTS}, "
                         f"got {weights!r}")
    from onepose_tpu_torch.models import convert

    sd = convert.lightglue_from_torch(convert.load_torch_state_dict(weights))
    return {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in sd.items()}


def load_matcher_params(model, weights: Optional[str], seed: int = 0) -> dict:
    """GATsSPG state_dict from a msgpack checkpoint (bare params, or a train
    loop's TrainState {step, params, opt_state}) or a PyTorch weight file
    (a Lightning checkpoint's prefixes stripped), or the seeded random init
    when weights is None."""

    def from_tree(raw):
        if isinstance(raw, dict) and {"step", "params", "opt_state"} <= set(raw):
            raw = raw["params"]
        return bridge.gats_spg_state_dict(raw)

    return _load(model, weights, seed, from_tree, "gats_spg")


def build_matcher(cfg: dict):
    """The 2D-3D matcher of cfg["matcher"] and its state_dict:
    - "gats" (default): GATsSPG, fp32, with the GATs leaf-attention and
      dual-softmax kernels (each wrapper runs its plain version on a CPU
      tensor), weights from cfg["weights"]["matcher"];
    - "nn": the descriptor mutual-NN matcher (no weights).
    Returns (matcher, params)."""
    from onepose_tpu_torch.models.gats_spg import GATsSPG
    from onepose_tpu_torch.models.nn_matcher import NNMatcher2D3D

    kind = cfg.get("matcher", "gats")
    if kind == "nn":
        return NNMatcher2D3D(distance_thresh=cfg.get("nn_distance_thresh", 0.7)), {}
    assert kind == "gats", f"unknown matcher {kind!r}"
    matcher = GATsSPG(gats_kernel=True, fused_match=True)
    return matcher, load_matcher_params(matcher, cfg["weights"]["matcher"])


def build_feature_detector(
    db_seq_root: str,
    sp_params: dict,
    sp_model,
    n_ref_views: int = 15,
    max_keypoints: int = 1024,
    crop_size: int = 512,
    distance_thresh: float = 0.7,
    match_kind: str = "nn",
    sg_weights: Optional[str] = None,
    device: str | torch.device = "cuda",
):
    """A FeatureObjectDetector whose reference DB is the SuperPoint features
    of views sampled from a mapping sequence, on `device`.

    match_kind: "nn" (batched mutual-NN, no weights) or "superglue" (all V
    views matched against the full query frame in one batched SuperGlue
    forward, each side with its own image size; weights from sg_weights,
    or, as in the JAX package, a silent seeded random init without them:
    ROADMAP C watch item 5). Returns (detector, db_feats)."""
    from onepose_tpu_torch.detector.feature_detector import (
        FeatureObjectDetector,
        ReferenceDB,
        select_reference_views,
    )
    from onepose_tpu_torch.models.nn_matcher import mutual_nn_match

    dev = resolve_device(device)
    db_feats = extract_sequence_features(db_seq_root, sp_params, sp_model,
                                         max_keypoints=max_keypoints, device=dev)
    view_idx = select_reference_views(len(db_feats["image_paths"]), n_ref_views)
    on_dev = lambda k: torch.from_numpy(db_feats[k][view_idx]).to(dev)  # noqa: E731
    db = ReferenceDB(
        keypoints=on_dev("keypoints"),
        descriptors=on_dev("descriptors"),
        scores=on_dev("scores"),
        mask=on_dev("mask"),
        sizes_hw=np.tile(db_feats["image_hw"], (len(view_idx), 1)),
    )

    def bc(x, V):
        x = torch.as_tensor(x, device=dev)
        return x[None].expand((V,) + x.shape)

    if match_kind == "superglue":
        from onepose_tpu_torch.models.superglue import SuperGlue

        sg = SuperGlue()
        sg.load_state_dict(load_superglue_params(sg, sg_weights))
        sg.to(dev).eval()
        db_hw = torch.as_tensor(np.asarray(db.sizes_hw, np.float32), device=dev)  # [V, 2]

        def match_fn(db_, query):
            V = db_.descriptors.shape[0]
            q_hw = torch.as_tensor(np.asarray(query.get("image_hw", db_feats["image_hw"]),
                                              np.float32), device=dev)
            with torch.inference_mode(), fp32_matmuls():
                return sg(db_.keypoints, bc(query["keypoints"], V), db_.descriptors,
                          bc(query["descriptors"], V), db_.scores, bc(query["scores"], V),
                          db_hw, q_hw[None].expand(V, 2), db_.mask,
                          bc(query["mask"], V))["matches0"]
    else:
        assert match_kind == "nn", f"unknown detector matcher {match_kind!r}"

        def match_fn(db_, query):
            V = db_.descriptors.shape[0]
            with fp32_matmuls():
                return mutual_nn_match(db_.descriptors, bc(query["descriptors"], V), db_.mask,
                                       bc(query["mask"], V),
                                       distance_thresh=distance_thresh)["matches0"]

    return FeatureObjectDetector(db, match_fn, crop_size=crop_size), db_feats


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
    package computes it. With a `mesh` (`parallel.sfm_parallel.
    resolve_sfm_mesh`), the batch is rounded up to divide its data axis,
    each rank runs SuperPoint on its share of every batch, and the features
    are all-gathered: every rank returns the whole sequence's."""
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

    if mesh is not None:
        from onepose_tpu_torch.parallel.mesh import DATA_AXIS, batch_sharding, gather, shard

        n_data = mesh.axis_size(DATA_AXIS)
        batch = -(-batch // n_data) * n_data

    h, w = imgs[0].shape
    outs = []
    with torch.inference_mode(), fp32_matmuls():
        for s in range(0, len(imgs), batch):
            chunk = imgs[s:s + batch]
            n_real = len(chunk)
            if n_real < batch:
                chunk = chunk + [chunk[0]] * (batch - n_real)
            x = torch.from_numpy(np.stack(chunk)[..., None]).to(dev)
            if mesh is not None:
                x = shard(mesh, x, batch_sharding(mesh, x.dim()))
            dense = model(x)
            out = extract_keypoints(dense["score_map"], dense["descriptor_map"],
                                    max_keypoints=max_keypoints,
                                    keypoint_threshold=keypoint_threshold)
            if mesh is not None:
                out = {k: gather(mesh, v, batch_sharding(mesh, v.dim())) for k, v in out.items()}
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
