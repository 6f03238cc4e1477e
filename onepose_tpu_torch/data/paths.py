"""OnePose dataset directory schema.

Port of onepose_tpu/data/paths.py, whole. Mirrors the reference convention
(src/utils/path_utils.py:5-20) with the upstream forward-slash layout:

data_root/<object>/
    box3d_corners.txt
    <seq>/
        intrinsics.txt      # original camera intrinsics
        color/              # object-crop images (png)
        color_full/         # full-resolution frames
        color_det/          # detector crops (optional)
        poses_ba/           # per-frame 4x4 T_oc (object->camera) txt
        intrin_ba/          # per-frame 3x3 K_crop txt
        intrin_det/         # per-frame detector K (optional)
        anno/               # anno_2d.json, anno_3d_average.npz,
                            # anno_3d_collect.npz, idxs.npy
"""

from __future__ import annotations

import os.path as osp
from glob import glob


def gt_pose_path_by_color(color_path: str, det_type: str = "GT_box") -> str:
    src = "/color/" if det_type == "GT_box" else "/color_det/"
    return color_path.replace(src, "/poses_ba/").rsplit(".", 1)[0] + ".txt"


def intrin_path_by_color(color_path: str, det_type: str = "GT_box") -> str:
    if det_type == "GT_box":
        return color_path.replace("/color/", "/intrin_ba/").rsplit(".", 1)[0] + ".txt"
    return color_path.replace("/color_det/", "/intrin_det/").rsplit(".", 1)[0] + ".txt"


def full_img_path_by_color(color_path: str, det_type: str = "GT_box") -> str:
    src = "/color/" if det_type == "GT_box" else "/color_det/"
    return color_path.replace(src, "/color_full/")


def color_dir(seq_root: str) -> str:
    return osp.join(seq_root, "color")


def intrin_dir(seq_root: str) -> str:
    return osp.join(seq_root, "intrin_ba")


def gt_pose_dir(seq_root: str) -> str:
    return osp.join(seq_root, "poses_ba")


def intrin_full_path(seq_root: str) -> str:
    return osp.join(seq_root, "intrinsics.txt")


def box3d_path(data_root: str) -> str:
    return osp.join(data_root, "box3d_corners.txt")


def anno_dir(outputs_dir: str) -> str:
    return osp.join(outputs_dir, "anno")


def list_color_images(seq_root: str, det_type: str = "GT_box") -> list[str]:
    sub = "color" if det_type == "GT_box" else "color_det"
    imgs = sorted(
        glob(osp.join(seq_root, sub, "*.png")),
        key=lambda p: _frame_key(p),
    )
    return imgs


def _frame_key(path: str):
    stem = osp.splitext(osp.basename(path))[0]
    try:
        return (0, int(stem))
    except ValueError:
        return (1, stem)


def load_gray(color_path: str):
    """Grayscale float32 [0, 1] image: the native decoder, else cv2."""
    import numpy as np

    from onepose_tpu_torch.native.frame_loader import read_gray

    img = read_gray(color_path)
    if img is None:
        import cv2

        raw = cv2.imread(color_path, cv2.IMREAD_GRAYSCALE)
        if raw is None:
            raise FileNotFoundError(color_path)
        img = raw.astype(np.float32) / 255.0
    return img


def load_frame(color_path: str, det_type: str = "GT_box"):
    """Load (gray image [H, W] float in [0,1], K [3,3], pose T_oc [4,4])."""
    import numpy as np

    img = load_gray(color_path)
    K = np.loadtxt(intrin_path_by_color(color_path, det_type))
    pose = np.loadtxt(gt_pose_path_by_color(color_path, det_type))
    return img, K.astype("float32"), pose.astype("float32")
