"""OnePose-Cap (ARKit) capture parser.

Behavioral spec from the reference parse_scanned_data.py:
- `intrinsics.txt` rows "frame, timestamp, fx, fy, cx, cy" -> averaged K
  (parse_scanned_data.py:280-289).
- `Box.txt` line 2: "px, py, pz, ex, ey, ez, qw, qx, qy, qz" -> 3D box
  half-extent corners (get_bbox3d :89-106) and the object->world transform
  T_ow (parse_box :108-141).
- `ARposes.txt` rows "timestamp, px, py, pz, qw, qx, qy, qz": camera pose;
  ARKit camera convention converted by R @ diag(1, -1, -1); stored pose is
  T_oc = inv(T_cw) @ T_ow mapping OBJECT coordinates to camera
  (data_process_anno :310-340).
- `Frames.m4v`: frames downsampled, cropped to the projected 3D box in two
  stages (box crop then square resize) with K updated through the same
  crop contract; crop->full transforms saved (parse_video :165-270).

Outputs the reference directory layout (color/, color_full/, poses_ba/,
intrin_ba/, M/, reproj_box/, box3d_corners.txt, intrinsics.txt) so data
prepared here feeds both packages and the reference.

Port of onepose_tpu/data/scan_parser.py, on the port's
`geometry.transforms`. Host work only (numpy and cv2): it runs on no
device.
"""

from __future__ import annotations

import os.path as osp
from pathlib import Path

import numpy as np

from onepose_tpu_torch.geometry.transforms import (
    get_affine_transform,
    get_K_crop_resize,
)


def quat_to_rotmat_np(q) -> np.ndarray:
    w, x, y, z = q
    return np.array(
        [
            [1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
            [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
            [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)],
        ]
    )


def parse_intrinsics(intrin_file: str) -> np.ndarray:
    with open(intrin_file) as f:
        lines = [
            l.strip() for l in f.readlines() if l.strip() and l[0] != "#"
        ]
    data = np.array([[float(e) for e in l.split(",")] for l in lines])
    fx, fy, cx, cy = data.mean(axis=0)[2:6]
    return np.array([[fx, 0, cx], [0, fy, cy], [0, 0, 1]])


def parse_box(box_file: str) -> tuple[np.ndarray, np.ndarray]:
    """Returns (box corners [8, 3] in object frame, T_ow [4, 4])."""
    with open(box_file) as f:
        lines = f.readlines()
    data = [float(e) for e in lines[1].strip().split(",")]
    px, py, pz = data[0:3]
    ex, ey, ez = data[3:6]
    quat = data[6:10]
    corners = (
        np.array(
            [
                [-ex, -ey, -ez], [ex, -ey, -ez], [ex, -ey, ez], [-ex, -ey, ez],
                [-ex, ey, -ez], [ex, ey, -ez], [ex, ey, ez], [-ex, ey, ez],
            ]
        )
        * 0.5
    )
    T_ow = np.eye(4)
    T_ow[:3, :3] = quat_to_rotmat_np(quat)
    T_ow[:3, 3] = [px, py, pz]
    return corners, T_ow


def parse_poses(pose_file: str, T_ow: np.ndarray) -> dict[int, np.ndarray]:
    """ARposes.txt -> {frame_index: T_oc [4, 4]} (all rows, undownsampled)."""
    out = {}
    index = 0
    with open(pose_file) as f:
        for line in f:
            line = line.strip()
            if not line or line[0] == "#":
                continue
            data = [float(e) for e in line.split(",")]
            position = data[1:4]
            quat = data[4:8]
            R = quat_to_rotmat_np(quat) @ np.diag([1.0, -1.0, -1.0])
            T_cw = np.eye(4)
            T_cw[:3, :3] = R
            T_cw[:3, 3] = position
            T_oc = np.linalg.inv(T_cw) @ T_ow
            out[index] = T_oc
            index += 1
    return out


def _crop_resize_cv(image, bbox, out_size):
    """Host-side crop+resize via cv2.warpAffine (the device's is
    geometry.transforms.crop_img_affine)."""
    import cv2

    center = ((bbox[0] + bbox[2]) / 2, (bbox[1] + bbox[3]) / 2)
    scale = (bbox[2] - bbox[0], bbox[3] - bbox[1])
    A = get_affine_transform(center, scale, 0, (out_size[1], out_size[0]))
    warped = cv2.warpAffine(
        image, A, (out_size[1], out_size[0]), flags=cv2.INTER_LINEAR
    )
    return warped, A


def project_box(K: np.ndarray, T_oc: np.ndarray, corners: np.ndarray):
    pc = corners @ T_oc[:3, :3].T + T_oc[:3, 3]
    uv = pc @ K.T
    return uv[:, :2] / uv[:, 2:3]


def parse_scan(
    data_dir: str,
    out_dir: str | None = None,
    downsample_rate: int = 1,
    crop_size: int = 512,
    box_margin_gate=(-1000, 3000),
) -> dict:
    """Parse one capture directory (Frames.m4v, ARposes.txt, Box.txt,
    intrinsics.txt) into the standard sequence layout. Returns summary."""
    import cv2

    out_dir = out_dir or data_dir
    K = parse_intrinsics(osp.join(data_dir, "intrinsics.txt"))
    corners, T_ow = parse_box(osp.join(data_dir, "Box.txt"))
    poses = parse_poses(osp.join(data_dir, "ARposes.txt"), T_ow)

    for sub in ("color", "color_full", "poses_ba", "intrin_ba", "M",
                "reproj_box"):
        Path(osp.join(out_dir, sub)).mkdir(parents=True, exist_ok=True)
    np.savetxt(osp.join(out_dir, "box3d_corners.txt"), corners)
    with open(osp.join(out_dir, "intrinsics.txt"), "w") as f:
        f.write(
            f"fx: {K[0, 0]}\nfy: {K[1, 1]}\ncx: {K[0, 2]}\ncy: {K[1, 2]}"
        )

    cap = cv2.VideoCapture(osp.join(data_dir, "Frames.m4v"))
    lo, hi = box_margin_gate
    n_out = 0
    index = 0
    while True:
        ret, image = cap.read()
        if not ret:
            break
        if index % downsample_rate == 0 and index in poses:
            T_oc = poses[index]
            uv = project_box(K, T_oc, corners)
            x0, y0 = uv.min(axis=0)
            x1, y1 = uv.max(axis=0)
            if x0 < lo or y0 < lo or x1 > hi or y1 > hi:
                index += 1
                continue
            # Two-stage crop with K updates (reference parse_video).
            box = np.array([x0, y0, x1, y1])
            stage1 = (int(y1 - y0), int(x1 - x0))
            K1, _ = get_K_crop_resize(box, K, stage1)
            img1, A1 = _crop_resize_cv(image, box, stage1)
            box2 = np.array([0, 0, x1 - x0, y1 - y0])
            K2, _ = get_K_crop_resize(box2, K1, (crop_size, crop_size))
            img2, A2 = _crop_resize_cv(
                img1, box2, (crop_size, crop_size)
            )
            A_full_to_crop = np.vstack([A2, [0, 0, 1]]) @ np.vstack(
                [A1, [0, 0, 1]]
            )
            np.savetxt(
                osp.join(out_dir, "M", f"{index}.txt"),
                np.linalg.inv(A_full_to_crop),
            )
            cv2.imwrite(osp.join(out_dir, "color", f"{index}.png"), img2)
            cv2.imwrite(
                osp.join(out_dir, "color_full", f"{index}.png"), image
            )
            np.savetxt(osp.join(out_dir, "poses_ba", f"{index}.txt"), T_oc)
            np.savetxt(osp.join(out_dir, "intrin_ba", f"{index}.txt"), K2)
            np.savetxt(
                osp.join(out_dir, "reproj_box", f"{index}.txt"),
                project_box(K2, T_oc, corners),
            )
            n_out += 1
        index += 1
    cap.release()
    return {
        "num_frames": n_out,
        "num_video_frames": index,
        "K": K,
        "box_corners": corners,
    }


def video_to_images(
    video_file: str, out_dir: str, downsample_rate: int = 1
) -> int:
    """Frames.m4v -> color_full/ pngs (reference video2img.py:11-31)."""
    import cv2

    Path(out_dir).mkdir(parents=True, exist_ok=True)
    cap = cv2.VideoCapture(video_file)
    index, n = 0, 0
    while True:
        ret, image = cap.read()
        if not ret:
            break
        if index % downsample_rate == 0:
            cv2.imwrite(osp.join(out_dir, f"{index}.png"), image)
            n += 1
        index += 1
    cap.release()
    return n
