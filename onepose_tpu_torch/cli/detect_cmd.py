"""`detect` command: feature-matching object detection before `infer`.

Port of onepose_tpu/cli/detect_cmd.py: build a reference-view feature DB
from the mapping sequence, detect the object's box in every full query
frame (`color_full/`), and write the crop_size x crop_size crops to
`color_det/` and each crop's intrinsics to `intrin_det/`, the inputs that
`infer det_type=feature_matching` reads. The same config keys, one more:
`device` ("cuda" unless the caller names "cpu").

SuperPoint runs on each full frame, batch 1, in fp32 with the NMS kernel
(K1); the DB views go through `cli.common.extract_sequence_features` in
batches of 8. `detector_matcher=superglue` matches the DB crops against
the full frame in one batched SuperGlue forward, whose Sinkhorn takes the
resident kernel (K6) where the coupling fits. The box is clamped to the
frame and falls back to the whole frame below 16 px, as in JAX.
"""

from __future__ import annotations

import json
import os
import os.path as osp

import numpy as np
import torch

from onepose_tpu_torch._device import resolve_device

DEFAULTS = {
    "db_dir": None,  # mapping sequence root (crops; reference-view DB)
    "query_dir": None,  # query sequence root with color_full/
    "weights": {"superpoint": None, "superglue": None},
    "max_keypoints": 1000,
    "n_ref_views": 15,
    "crop_size": 512,
    # 'nn' (weight-free mutual-NN) | 'superglue' (the reference's detector
    # matcher).
    "detector_matcher": "nn",
    # Where detection runs: "cuda" (raises without CUDA) or "cpu".
    "device": "cuda",
}


def read_full_intrinsics(query_dir: str) -> np.ndarray:
    """K [3, 3] float32 from the sequence's intrinsics.txt (fx, fy, cx, cy)."""
    from onepose_tpu_torch.data import paths as path_utils

    vals = {}
    with open(path_utils.intrin_full_path(query_dir)) as f:
        for line in f:
            if ":" in line:
                k, v = line.split(":")
                vals[k.strip()] = float(v)
    return np.array([[vals["fx"], 0, vals["cx"]], [0, vals["fy"], vals["cy"]], [0, 0, 1]],
                    np.float32)


def clamp_box(bbox: np.ndarray, h: int, w: int) -> np.ndarray:
    """The box clamped to the frame; the whole frame where a side of the
    clamped box is below 16 px."""
    bbox = np.array([max(bbox[0], 0), max(bbox[1], 0), min(bbox[2], w - 1), min(bbox[3], h - 1)])
    if bbox[2] - bbox[0] < 16 or bbox[3] - bbox[1] < 16:
        bbox = np.array([0, 0, w - 1, h - 1])
    return bbox


def run(cfg: dict) -> dict:
    from glob import glob

    import cv2

    from onepose_tpu_torch.cli.common import build_feature_detector, load_superpoint_params
    from onepose_tpu_torch.models.superpoint import SuperPoint, extract_keypoints
    from onepose_tpu_torch.native.frame_loader import FrameLoader
    from onepose_tpu_torch.utils.precision import fp32_matmuls

    dev = resolve_device(cfg["device"])  # no CUDA and no device=cpu: raise before any work
    db_dir = cfg["db_dir"]
    query_dir = cfg["query_dir"]
    assert db_dir and query_dir, "detect: db_dir and query_dir are required"

    sp = SuperPoint(nms_kernel=True)
    sp_params = load_superpoint_params(sp, cfg["weights"]["superpoint"])
    detector, _ = build_feature_detector(
        db_dir, sp_params, sp,
        n_ref_views=cfg["n_ref_views"],
        max_keypoints=cfg["max_keypoints"],
        crop_size=cfg["crop_size"],
        match_kind=cfg["detector_matcher"],
        sg_weights=cfg["weights"].get("superglue"),
        device=dev,
    )  # loads sp_params into sp and moves it to dev

    full_dir = osp.join(query_dir, "color_full")

    def frame_key(p):
        stem = osp.splitext(osp.basename(p))[0]
        return int(stem) if stem.isdigit() else 0

    frame_paths = sorted(glob(osp.join(full_dir, "*.png")), key=frame_key)
    assert frame_paths, f"no frames in {full_dir}"
    K_full = read_full_intrinsics(query_dir)

    color_det = osp.join(query_dir, "color_det")
    intrin_det = osp.join(query_dir, "intrin_det")
    os.makedirs(color_det, exist_ok=True)
    os.makedirs(intrin_det, exist_ok=True)

    n_ok = 0
    for fi, gray in FrameLoader(frame_paths, queue_cap=4):
        fp = frame_paths[fi]
        if gray is None:
            raise FileNotFoundError(fp)
        image = torch.from_numpy(gray).to(dev)
        with torch.inference_mode(), fp32_matmuls():
            dense = sp(image[None, ..., None])
            qf = extract_keypoints(dense["score_map"], dense["descriptor_map"],
                                   max_keypoints=cfg["max_keypoints"])
        det = detector.detect_bbox({
            "keypoints": qf["keypoints"][0],
            "descriptors": qf["descriptors"][0],
            "scores": qf["scores"][0],
            "mask": qf["mask"][0],
            "image_hw": gray.shape,
        })
        h, w = gray.shape
        bbox = clamp_box(det["bbox"], h, w)
        crop, K_crop = detector.crop(image, bbox, K_full)

        name = osp.splitext(osp.basename(fp))[0]
        cv2.imwrite(osp.join(color_det, f"{name}.png"),
                    (crop.cpu().numpy() * 255).astype(np.uint8))
        np.savetxt(osp.join(intrin_det, f"{name}.txt"), np.asarray(K_crop))
        n_ok += int(det["ok"])

    summary = {
        "num_frames": len(frame_paths),
        "num_detected": n_ok,
        "color_det": color_det,
        "intrin_det": intrin_det,
    }
    print(json.dumps(summary))
    return summary


def add_parser(subparsers):
    p = subparsers.add_parser("detect", help="feature-matching 2D detection preprocessing")
    p.add_argument("--config", default=None)
    p.add_argument("overrides", nargs="*")
    p.set_defaults(_defaults=DEFAULTS, _run=run)
