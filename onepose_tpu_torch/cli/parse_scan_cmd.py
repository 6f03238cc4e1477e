"""`parse-scan` / `video2img` commands: capture preprocessing.

Port of onepose_tpu/cli/parse_scan_cmd.py (the reference's
parse_scanned_data.py and video2img.py), on `data.scan_parser`. Host work
only (numpy and cv2): they run on no device.
"""

from __future__ import annotations

import json

PARSE_DEFAULTS = {
    "data_dir": None,
    "out_dir": None,
    "downsample_rate": 1,
    "crop_size": 512,
}

VIDEO_DEFAULTS = {
    "video_file": None,
    "out_dir": None,
    "downsample_rate": 1,
}


def run_parse(cfg: dict) -> dict:
    from onepose_tpu_torch.data.scan_parser import parse_scan

    assert cfg["data_dir"], "parse-scan: data_dir is required"
    out = parse_scan(cfg["data_dir"], cfg["out_dir"], downsample_rate=cfg["downsample_rate"],
                     crop_size=cfg["crop_size"])
    summary = {k: v for k, v in out.items() if k in ("num_frames", "num_video_frames")}
    print(json.dumps(summary))
    return summary


def run_video(cfg: dict) -> dict:
    from onepose_tpu_torch.data.scan_parser import video_to_images

    assert cfg["video_file"] and cfg["out_dir"], "video2img: video_file and out_dir are required"
    n = video_to_images(cfg["video_file"], cfg["out_dir"], cfg["downsample_rate"])
    print(json.dumps({"num_frames": n}))
    return {"num_frames": n}


def add_parser(subparsers):
    p = subparsers.add_parser("parse-scan", help="parse an ARKit capture")
    p.add_argument("--config", default=None)
    p.add_argument("overrides", nargs="*")
    p.set_defaults(_defaults=PARSE_DEFAULTS, _run=run_parse)

    v = subparsers.add_parser("video2img", help="extract video frames")
    v.add_argument("--config", default=None)
    v.add_argument("overrides", nargs="*")
    v.set_defaults(_defaults=VIDEO_DEFAULTS, _run=run_video)
