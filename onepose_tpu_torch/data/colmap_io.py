"""COLMAP sparse-model binary I/O (cameras.bin / images.bin / points3D.bin).

Port of onepose_tpu/data/colmap_io.py, whole (numpy and the standard library).

Interop layer so maps built by COLMAP-based pipelines (like the reference,
src/sfm/triangulation.py) can be imported, and our maps exported for
COLMAP tooling. Implemented from the public COLMAP binary format
specification (colmap/src/colmap/scene/reconstruction_io.cc documentation):

cameras.bin:  u64 count; per camera: i32 id, i32 model_id, u64 width,
              u64 height, f64 params[n_params(model)]
images.bin:   u64 count; per image: i32 id, f64 qvec[4] (w,x,y,z),
              f64 tvec[3], i32 camera_id, name '\0'-terminated,
              u64 n_points2D, then per 2D point: f64 x, f64 y, i64 p3d_id
points3D.bin: u64 count; per point: i64 id, f64 xyz[3], u8 rgb[3],
              f64 error, u64 track_len, per element: i32 image_id,
              i32 point2D_idx
"""

from __future__ import annotations

import dataclasses
import os
import os.path as osp
import struct

import numpy as np

# model_id -> (name, num_params)
CAMERA_MODELS = {
    0: ("SIMPLE_PINHOLE", 3),
    1: ("PINHOLE", 4),
    2: ("SIMPLE_RADIAL", 4),
    3: ("RADIAL", 5),
    4: ("OPENCV", 8),
    5: ("OPENCV_FISHEYE", 8),
    6: ("FULL_OPENCV", 12),
    7: ("FOV", 5),
    8: ("SIMPLE_RADIAL_FISHEYE", 4),
    9: ("RADIAL_FISHEYE", 5),
    10: ("THIN_PRISM_FISHEYE", 12),
}
MODEL_NAME_TO_ID = {v[0]: k for k, v in CAMERA_MODELS.items()}


@dataclasses.dataclass
class Camera:
    id: int
    model: str
    width: int
    height: int
    params: np.ndarray  # PINHOLE: fx, fy, cx, cy

    @property
    def K(self) -> np.ndarray:
        if self.model == "PINHOLE":
            fx, fy, cx, cy = self.params
        elif self.model == "SIMPLE_PINHOLE":
            fx, cx, cy = self.params
            fy = fx
        else:
            raise ValueError(f"no closed-form K for model {self.model}")
        return np.array([[fx, 0, cx], [0, fy, cy], [0, 0, 1]])


@dataclasses.dataclass
class Image:
    id: int
    qvec: np.ndarray  # (w, x, y, z) world->cam
    tvec: np.ndarray
    camera_id: int
    name: str
    xys: np.ndarray  # [N, 2]
    point3D_ids: np.ndarray  # [N] (-1 = none)


@dataclasses.dataclass
class Point3D:
    id: int
    xyz: np.ndarray
    rgb: np.ndarray
    error: float
    image_ids: np.ndarray
    point2D_idxs: np.ndarray


def _read(f, fmt):
    size = struct.calcsize(fmt)
    return struct.unpack(fmt, f.read(size))


def read_cameras_bin(path: str) -> dict[int, Camera]:
    out = {}
    with open(path, "rb") as f:
        (n,) = _read(f, "<Q")
        for _ in range(n):
            cam_id, model_id, width, height = _read(f, "<iiQQ")
            name, n_params = CAMERA_MODELS[model_id]
            params = np.array(_read(f, f"<{n_params}d"))
            out[cam_id] = Camera(cam_id, name, width, height, params)
    return out


def write_cameras_bin(path: str, cameras: dict[int, Camera]) -> None:
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(cameras)))
        for cam in cameras.values():
            model_id = MODEL_NAME_TO_ID[cam.model]
            f.write(
                struct.pack(
                    "<iiQQ", cam.id, model_id, cam.width, cam.height
                )
            )
            f.write(
                struct.pack(
                    f"<{len(cam.params)}d", *np.asarray(cam.params, float)
                )
            )


def read_images_bin(path: str) -> dict[int, Image]:
    out = {}
    with open(path, "rb") as f:
        (n,) = _read(f, "<Q")
        for _ in range(n):
            (img_id,) = _read(f, "<i")
            qvec = np.array(_read(f, "<4d"))
            tvec = np.array(_read(f, "<3d"))
            (cam_id,) = _read(f, "<i")
            name = b""
            while True:
                c = f.read(1)
                if c == b"\x00":
                    break
                name += c
            (n_pts,) = _read(f, "<Q")
            xys = np.zeros((n_pts, 2))
            p3d = np.zeros(n_pts, np.int64)
            for i in range(n_pts):
                x, y = _read(f, "<2d")
                (pid,) = _read(f, "<q")
                xys[i] = (x, y)
                p3d[i] = pid
            out[img_id] = Image(
                img_id, qvec, tvec, cam_id, name.decode("utf-8"), xys, p3d
            )
    return out


def write_images_bin(path: str, images: dict[int, Image]) -> None:
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(images)))
        for im in images.values():
            f.write(struct.pack("<i", im.id))
            f.write(struct.pack("<4d", *np.asarray(im.qvec, float)))
            f.write(struct.pack("<3d", *np.asarray(im.tvec, float)))
            f.write(struct.pack("<i", im.camera_id))
            f.write(im.name.encode("utf-8") + b"\x00")
            n_pts = len(im.xys)
            f.write(struct.pack("<Q", n_pts))
            for (x, y), pid in zip(
                np.asarray(im.xys, float), np.asarray(im.point3D_ids)
            ):
                f.write(struct.pack("<2dq", x, y, int(pid)))


def read_points3d_bin(path: str) -> dict[int, Point3D]:
    out = {}
    with open(path, "rb") as f:
        (n,) = _read(f, "<Q")
        for _ in range(n):
            (pid,) = _read(f, "<q")
            xyz = np.array(_read(f, "<3d"))
            rgb = np.array(_read(f, "<3B"))
            (err,) = _read(f, "<d")
            (track_len,) = _read(f, "<Q")
            pairs = np.array(_read(f, f"<{2 * track_len}i")).reshape(-1, 2) if track_len else np.zeros((0, 2), int)
            out[pid] = Point3D(
                pid, xyz, rgb, err, pairs[:, 0].copy(), pairs[:, 1].copy()
            )
    return out


def write_points3d_bin(path: str, points: dict[int, Point3D]) -> None:
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(points)))
        for p in points.values():
            f.write(struct.pack("<q", p.id))
            f.write(struct.pack("<3d", *np.asarray(p.xyz, float)))
            f.write(struct.pack("<3B", *np.asarray(p.rgb, np.uint8)))
            f.write(struct.pack("<d", float(p.error)))
            f.write(struct.pack("<Q", len(p.image_ids)))
            for img_id, p2d in zip(p.image_ids, p.point2D_idxs):
                f.write(struct.pack("<2i", int(img_id), int(p2d)))


def read_model(model_dir: str):
    return (
        read_cameras_bin(osp.join(model_dir, "cameras.bin")),
        read_images_bin(osp.join(model_dir, "images.bin")),
        read_points3d_bin(osp.join(model_dir, "points3D.bin")),
    )


def write_model(model_dir: str, cameras, images, points) -> None:
    os.makedirs(model_dir, exist_ok=True)
    write_cameras_bin(osp.join(model_dir, "cameras.bin"), cameras)
    write_images_bin(osp.join(model_dir, "images.bin"), images)
    write_points3d_bin(osp.join(model_dir, "points3D.bin"), points)


def export_ply(path: str, xyz: np.ndarray, rgb: np.ndarray | None = None) -> None:
    """Minimal binary-less PLY export (reference model_converter parity)."""
    xyz = np.asarray(xyz)
    if rgb is None:
        rgb = np.full((len(xyz), 3), 128, np.uint8)
    with open(path, "w") as f:
        f.write(
            "ply\nformat ascii 1.0\n"
            f"element vertex {len(xyz)}\n"
            "property float x\nproperty float y\nproperty float z\n"
            "property uchar red\nproperty uchar green\nproperty uchar blue\n"
            "end_header\n"
        )
        for p, c in zip(xyz, rgb):
            f.write(
                f"{p[0]:.6f} {p[1]:.6f} {p[2]:.6f} "
                f"{int(c[0])} {int(c[1])} {int(c[2])}\n"
            )
