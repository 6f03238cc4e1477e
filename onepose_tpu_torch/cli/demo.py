"""`demo` command: full-image video inference with detection and tracking.

Port of onepose_tpu/cli/demo.py (the reference's `inference_demo.py
+experiment=test_demo`): the same config keys and `results.json`, one
more key, `device` ("cuda" unless the caller names "cpu"). Per frame of
`<data_dir>/color_full`:
- on the first frame, and after a frame whose confidence (matcher
  inliers, or the tracker's tracked points) fell below `redetect_inliers`:
  SuperPoint on the full frame and feature-matching detection against a
  reference-view DB of the sequence's crops (`color/`); otherwise the
  annotated 3D box projected by the previous pose;
- the box clamped to the frame and squared into a `crop_size` crop with
  its K_crop;
- without tracking: the crop through `PosePipeline` (SuperPoint with the
  NMS kernel K1, GATsSPG with the leaf-attention K2 and dual-softmax K3
  kernels, RANSAC-PnP) every frame. With `use_tracking=true`: the pipeline
  runs on the first frame, every `kf_interval` frames and after a
  confidence drop, and (re-)seeds the BATracker (`initialize`, or
  `update_kf` and a re-seed where that rejects the pose); the frames
  between run SuperPoint on the crop and `BATracker.track`;
- a demo image with the box reprojected by the pose, then a video of them.
The box parse falls back from the object root to the sequence directory,
and K to the first DB crop's without `intrinsics.txt`, as in JAX.

The RANSAC draws of frame fi come from `frame_draws`, a CPU generator
seeded with fi (JAX keys a matcher frame with PRNGKey(fi) split once, and
a tracked frame with PRNGKey(fi)); a test replaces the function with
JAX's draws. Each stage of the timer waits for the card at its ends, so
`stage_ms` are each stage's own time. Full fp32, TF32 off, as `infer`.
"""

from __future__ import annotations

import json
import os
import os.path as osp

import numpy as np
import torch

from onepose_tpu_torch._device import resolve_device

DEFAULTS = {
    "data_dir": None,  # sequence root with color_full/, intrinsics.txt
    "anno_dir": None,
    "box_path": None,  # defaults to <data_dir>/../box3d_corners.txt
    "weights": {"superpoint": None, "matcher": None, "superglue": None},
    "matcher": "gats",  # 'gats' (learned) | 'nn' (descriptor mutual-NN)
    # 2D-detector DB matcher: 'nn' (weight-free mutual-NN) | 'superglue'
    # (the reference's detector matcher, weights from weights.superglue).
    "detector_matcher": "nn",
    "nn_distance_thresh": 0.7,
    "max_keypoints": 1000,
    "shape3d": 2000,
    "num_leaf": 8,
    "n_ref_views": 8,
    "redetect_inliers": 8,
    "crop_size": 512,
    "use_tracking": False,
    "kf_interval": 5,  # matcher/keyframe cadence (reference track_interval)
    "out_dir": "runs/demo",
    "make_video": True,
    # Where the demo runs: "cuda" (raises without CUDA) or "cpu".
    "device": "cuda",
}


def frame_draws(fi: int, n_hyp: int, route: str) -> torch.Tensor:
    """The RANSAC uniforms [1, n_hyp, 3] of frame fi on `route` ("matcher":
    the pipeline's PnP, "track": the tracker's flow PnP), from a CPU
    generator seeded with fi."""
    assert route in ("matcher", "track"), route
    return torch.rand((1, n_hyp, 3), generator=torch.Generator().manual_seed(fi))


def _features(sp, image: torch.Tensor, max_keypoints: int) -> dict:
    """SuperPoint on one [H, W] image and its keypoints: [1, N, ...]."""
    from onepose_tpu_torch.models.superpoint import extract_keypoints
    from onepose_tpu_torch.utils.precision import fp32_matmuls

    with torch.inference_mode(), fp32_matmuls():
        dense = sp(image[None, ..., None])
        return extract_keypoints(dense["score_map"], dense["descriptor_map"],
                                 max_keypoints=max_keypoints)


def _box_corners(cfg: dict, data_dir: str) -> np.ndarray:
    from onepose_tpu_torch.data import paths as path_utils

    box_path = cfg["box_path"]
    if not box_path:
        # The object-root convention first; parse-scan writes the corners
        # inside the sequence directory itself.
        for cand in (osp.dirname(data_dir), data_dir):
            box_path = path_utils.box3d_path(cand)
            if osp.exists(box_path):
                break
    return np.loadtxt(box_path)


def run(cfg: dict) -> dict:
    from glob import glob

    from onepose_tpu_torch.cli.common import build_feature_detector
    from onepose_tpu_torch.cli.detect_cmd import clamp_box, read_full_intrinsics
    from onepose_tpu_torch.cli.infer import build_pipeline
    from onepose_tpu_torch.data import paths as path_utils
    from onepose_tpu_torch.data.anno_io import annotation_from_npz_dir
    from onepose_tpu_torch.native.frame_loader import FrameLoader
    from onepose_tpu_torch.utils.precision import fp32_matmuls
    from onepose_tpu_torch.utils.profiling import StageTimer
    from onepose_tpu_torch.utils.vis import make_video, save_demo_image

    dev = resolve_device(cfg["device"])  # no CUDA and no device=cpu: raise before any work
    data_dir = cfg["data_dir"]
    assert data_dir, "demo: data_dir is required"
    anno_dir = cfg["anno_dir"] or osp.join(osp.dirname(data_dir), "outputs", "anno")
    box_corners = _box_corners(cfg, data_dir)
    anno = annotation_from_npz_dir(anno_dir, num_leaf=cfg["num_leaf"], shape3d=cfg["shape3d"],
                                   device=dev)

    pipe = build_pipeline(cfg, dev)
    sp = pipe.superpoint
    # Reference-view DB from the mapping sequence (crops).
    detector, db_feats = build_feature_detector(
        data_dir, sp.state_dict(), sp,
        n_ref_views=cfg["n_ref_views"],
        max_keypoints=cfg["max_keypoints"],
        crop_size=cfg["crop_size"],
        match_kind=cfg["detector_matcher"],
        sg_weights=cfg["weights"].get("superglue"),
        device=dev,
    )

    # Full frames + original intrinsics.
    full_dir = osp.join(data_dir, "color_full")

    def frame_key(p):
        stem = osp.splitext(osp.basename(p))[0]
        return int(stem) if stem.isdigit() else 0

    frame_paths = sorted(glob(osp.join(full_dir, "*.png")), key=frame_key)
    assert frame_paths, f"no frames in {full_dir}"
    if osp.exists(path_utils.intrin_full_path(data_dir)):
        K_full = read_full_intrinsics(data_dir)
    else:
        # Fall back to the first crop K (detector-style demos).
        K_full = db_feats["K"][0]

    tracker = None
    if cfg["use_tracking"]:
        from onepose_tpu_torch.tracker import BATracker, TrackerConfig

        tracker = BATracker(TrackerConfig(n_kpts=cfg["max_keypoints"],
                                          kf_interval=cfg["kf_interval"]), device=dev)
    tracker_ready = False

    timer = StageTimer(sync=dev.type == "cuda")
    img_out = osp.join(cfg["out_dir"], "frames")
    os.makedirs(img_out, exist_ok=True)
    prev_pose = None
    prev_conf = 0  # matcher inliers or tracker n_tracked of the last frame
    n_detect, n_box_track, n_matcher, n_flow = 0, 0, 0, 0
    results = []

    for fi, gray in FrameLoader(frame_paths, queue_cap=4):
        if gray is None:
            raise FileNotFoundError(frame_paths[fi])
        image = torch.from_numpy(gray).to(dev)

        if prev_pose is None or prev_conf < cfg["redetect_inliers"]:
            with timer.stage("detect"):
                qf = _features(sp, image, cfg["max_keypoints"])
                det = detector.detect_bbox({
                    "keypoints": qf["keypoints"][0],
                    "descriptors": qf["descriptors"][0],
                    "scores": qf["scores"][0],
                    "mask": qf["mask"][0],
                    "image_hw": gray.shape,
                })
            bbox = det["bbox"]
            n_detect += 1
        else:
            bbox = detector.previous_pose_detect(K_full, prev_pose, box_corners)
            n_box_track += 1

        h, w = gray.shape
        crop, K_crop = detector.crop(image, clamp_box(bbox, h, w), K_full)
        K_crop = np.asarray(K_crop, np.float32)

        # The full matcher pipeline runs every frame without tracking; with
        # tracking only on keyframe cadence, on the first frame, and after
        # a confidence drop (reference inference_demo.py:264-267).
        run_matcher = (tracker is None or not tracker_ready or fi % cfg["kf_interval"] == 0
                       or prev_conf < cfg["redetect_inliers"])

        if run_matcher:
            with timer.stage("matcher_pipeline"), fp32_matmuls():
                out = pipe(crop[None, ..., None], K_crop[None], anno,
                           draws=frame_draws(fi, pipe.ransac_hypotheses, "matcher"))
            n_matcher += 1
            pose = out["pose"][0].cpu().numpy()
            inliers = int(out["num_inliers"][0])
            conf = inliers

            if tracker is not None and inliers >= cfg["redetect_inliers"]:
                # Keypoint 3D ids: PnP-inlier matcher correspondences only
                # (reference kf_dict construction, inference_demo.py:265-291).
                matches0 = out["matches0"][0].cpu().numpy()
                inl = out["inliers"][0].cpu().numpy().astype(bool)
                p3d_ids = np.where((matches0 >= 0) & inl, matches0, -1)
                kf_args = (crop, out["keypoints"][0], out["descriptors"][0],
                           out["kpt_mask"][0], p3d_ids)
                if not tracker_ready:
                    tracker.initialize(*kf_args, anno.points3d, pose, K_crop)
                    tracker_ready = True
                elif not tracker.update_kf(*kf_args, pose, K_crop):
                    # Tracker drifted away from the (confident) matcher
                    # pose: re-seed rather than keep a bad window.
                    tracker.initialize(*kf_args, anno.points3d, pose, K_crop)
        else:
            with timer.stage("superpoint"):
                qf = _features(sp, crop, cfg["max_keypoints"])
            with timer.stage("track"):
                tr = tracker.track(crop, qf["keypoints"][0], qf["descriptors"][0],
                                   qf["mask"][0], K_crop,
                                   draws=frame_draws(fi, tracker.cfg.ransac_hyp, "track"))
            n_flow += 1
            pose = tr["pose"]
            conf = int(tr["n_tracked"])

        prev_conf = conf
        finite = bool(np.isfinite(pose).all())
        prev_pose = pose if finite else None

        save_demo_image((gray * 255).astype(np.uint8), K_full, pose, box_corners,
                        osp.join(img_out, f"{fi}.png"))
        results.append({
            "frame": fi,
            "conf": conf,
            "pose": pose.tolist() if finite else None,
            "tracked": not run_matcher,
        })

    video_path = None
    if cfg["make_video"]:
        video_path = make_video(img_out, osp.join(cfg["out_dir"], "demo.mp4"))
    stage_report = timer.report()
    summary = {
        "num_frames": len(frame_paths),
        "n_detect": n_detect,
        "n_box_track": n_box_track,
        "n_matcher": n_matcher,
        "n_flow_track": n_flow,
        "stage_ms": {k: round(v["mean_ms"], 2) for k, v in stage_report.items()},
        # Medians leave out the first calls (kernel builds, cuDNN tuning).
        "stage_p50_ms": {k: round(v["p50_ms"], 2) for k, v in stage_report.items()},
        "video": video_path,
    }
    with open(osp.join(cfg["out_dir"], "results.json"), "w") as f:
        json.dump({"summary": summary, "frames": results}, f)
    print(json.dumps(summary))
    return summary


def add_parser(subparsers):
    p = subparsers.add_parser("demo", help="full-image video inference with detection")
    p.add_argument("--config", default=None)
    p.add_argument("overrides", nargs="*")
    p.set_defaults(_defaults=DEFAULTS, _run=run)
