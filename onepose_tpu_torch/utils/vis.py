"""Visualization: reprojection overlays, 3D box drawing, match plots,
per-frame 3D dumps, demo video assembly.

Port of onepose_tpu/utils/vis.py, whole (numpy on the host; cv2 imported
inside the functions that draw): reproject 3D points / box corners by a
pose, draw the 12 box edges, draw matching-keypoint pairs, write a frame's
point cloud, camera and matches (`dump_scene_3d`, the `infer dump_vis3d=`
output), assemble demo frames into a video.
"""

from __future__ import annotations

import os
import os.path as osp
from glob import glob

import numpy as np

BOX_EDGES = [
    (0, 1), (1, 2), (2, 3), (3, 0),
    (4, 5), (5, 6), (6, 7), (7, 4),
    (0, 4), (1, 5), (2, 6), (3, 7),
]


def reproject(K: np.ndarray, pose: np.ndarray, pts3d: np.ndarray) -> np.ndarray:
    """Project object-frame points by a 4x4 (or 3x4) pose
    (reference vis_utils.reproj :209-236)."""
    pose = np.asarray(pose)
    R, t = pose[:3, :3], pose[:3, 3]
    pc = np.asarray(pts3d) @ R.T + t
    uv = pc @ np.asarray(K).T
    return uv[:, :2] / uv[:, 2:3]


def draw_3d_box(
    image: np.ndarray,
    K: np.ndarray,
    pose: np.ndarray,
    box_corners: np.ndarray,
    color=(0, 255, 0),
    thickness: int = 2,
) -> np.ndarray:
    """Draw the reprojected 3D box wireframe (vis_utils.py:239-261)."""
    import cv2

    img = np.ascontiguousarray(image.copy())
    uv = reproject(K, pose, box_corners).astype(int)
    for a, b in BOX_EDGES:
        cv2.line(img, tuple(uv[a]), tuple(uv[b]), color, thickness)
    return img


def draw_keypoints(
    image: np.ndarray, kpts: np.ndarray, color=(0, 0, 255), radius: int = 2
) -> np.ndarray:
    import cv2

    img = np.ascontiguousarray(image.copy())
    for x, y in np.asarray(kpts, int):
        cv2.circle(img, (int(x), int(y)), radius, color, -1)
    return img


def draw_reprojection(
    image: np.ndarray,
    K: np.ndarray,
    pose: np.ndarray,
    pts3d: np.ndarray,
    kpts2d: np.ndarray | None = None,
) -> np.ndarray:
    """Reprojected model points (green) vs detected keypoints (red)."""
    img = draw_keypoints(
        image, reproject(K, pose, pts3d), color=(0, 255, 0)
    )
    if kpts2d is not None:
        img = draw_keypoints(img, kpts2d, color=(0, 0, 255))
    return img


def make_matching_plot(
    img0: np.ndarray,
    img1: np.ndarray,
    kpts0: np.ndarray,
    kpts1: np.ndarray,
    color=(0, 255, 255),
) -> np.ndarray:
    """Side-by-side match visualization (vis_utils.py:62-178)."""
    import cv2

    h0, w0 = img0.shape[:2]
    h1, w1 = img1.shape[:2]
    h = max(h0, h1)
    canvas = np.zeros((h, w0 + w1, 3), np.uint8)

    def to3(img):
        return (
            cv2.cvtColor(img, cv2.COLOR_GRAY2BGR)
            if img.ndim == 2
            else img
        )

    canvas[:h0, :w0] = to3(img0)
    canvas[:h1, w0:] = to3(img1)
    for (x0, y0), (x1, y1) in zip(
        np.asarray(kpts0, int), np.asarray(kpts1, int)
    ):
        cv2.line(canvas, (x0, y0), (x1 + w0, y1), color, 1)
        cv2.circle(canvas, (x0, y0), 2, color, -1)
        cv2.circle(canvas, (x1 + w0, y1), 2, color, -1)
    return canvas


def save_demo_image(
    image: np.ndarray,
    K: np.ndarray,
    pose: np.ndarray,
    box_corners: np.ndarray,
    out_path: str,
) -> str:
    import cv2

    os.makedirs(osp.dirname(out_path) or ".", exist_ok=True)
    img = draw_3d_box(image, K, pose, box_corners)
    cv2.imwrite(out_path, img)
    return out_path


def dump_scene_3d(
    out_dir: str,
    frame_name: str,
    points3d: np.ndarray,
    pose: np.ndarray,
    K: np.ndarray,
    kpts2d: np.ndarray | None = None,
    matched_pts3d: np.ndarray | None = None,
) -> str:
    """Per-frame 3D debugging dump (Wis3D-export parity,
    vis_utils.py:398-433): writes the object point cloud as PLY, the
    camera pose/intrinsics, and the matched 2D-3D correspondence rays as
    JSON under <out_dir>/<frame_name>/. Viewable with any point-cloud
    tool; no hosted viewer dependency."""
    import json

    frame_dir = osp.join(out_dir, frame_name)
    os.makedirs(frame_dir, exist_ok=True)

    pts = np.asarray(points3d, np.float32)
    ply = osp.join(frame_dir, "points.ply")
    with open(ply, "w") as f:
        f.write(
            "ply\nformat ascii 1.0\n"
            f"element vertex {len(pts)}\n"
            "property float x\nproperty float y\nproperty float z\n"
            "end_header\n"
        )
        for p in pts:
            f.write(f"{p[0]} {p[1]} {p[2]}\n")

    meta = {
        "pose_w2c": np.asarray(pose, np.float64).tolist(),
        "K": np.asarray(K, np.float64).tolist(),
    }
    if kpts2d is not None:
        meta["kpts2d"] = np.asarray(kpts2d, np.float64).tolist()
    if matched_pts3d is not None:
        meta["matched_pts3d"] = np.asarray(
            matched_pts3d, np.float64
        ).tolist()
    with open(osp.join(frame_dir, "camera.json"), "w") as f:
        json.dump(meta, f)
    return frame_dir


def make_video(image_dir: str, out_path: str, fps: int = 24) -> str:
    """Assemble numbered frames into a video (vis_utils.py:435-449)."""
    import cv2

    frames = sorted(
        glob(osp.join(image_dir, "*.png")),
        key=lambda p: int(osp.splitext(osp.basename(p))[0])
        if osp.splitext(osp.basename(p))[0].isdigit()
        else 0,
    )
    if not frames:
        raise ValueError(f"no frames in {image_dir}")
    first = cv2.imread(frames[0])
    h, w = first.shape[:2]
    writer = cv2.VideoWriter(
        out_path, cv2.VideoWriter_fourcc(*"mp4v"), fps, (w, h)
    )
    for p in frames:
        writer.write(cv2.imread(p))
    writer.release()
    return out_path
