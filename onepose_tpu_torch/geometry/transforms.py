"""Crop-and-resize affine transforms and the intrinsics-update contract.

Port of onepose_tpu/geometry/transforms.py. Cropping an image to a box and
resizing it to a target shape is one affine map A (2x3); the cropped
camera has K_crop = homo(A) @ K. The host-side functions (numpy, float64
inside, float32 out, as in the JAX package) prepare parameters;
`crop_img_affine` is the warp on the image's device, with the JAX
package's own bilinear sample: floor, four clamped gathers, zero outside
the image (not `F.grid_sample`, whose border rules differ).
"""

from __future__ import annotations

import numpy as np
import torch


def get_affine_transform(
    center,
    scale,
    rot: float = 0.0,
    output_size=(512, 512),
    shift=(0.0, 0.0),
    inv: bool = False,
) -> np.ndarray:
    """2x3 affine taking a source box to an output image.

    `center` (source px) goes to the output centre, with uniform scale
    `output_size[0] / scale[0]` (only the box width sets it: boxes are
    squared before cropping) and rotation `rot` degrees. `shift` moves the
    source centre in units of `scale`; inv=True gives the output -> source
    map. output_size is (w, h)."""
    center = np.asarray(center, dtype=np.float64)
    scale = np.atleast_1d(np.asarray(scale, dtype=np.float64))
    shift = np.asarray(shift, dtype=np.float64)
    src_w = scale[0]
    dst_w, dst_h = float(output_size[0]), float(output_size[1])

    rot_rad = np.pi * rot / 180.0
    cs, sn = np.cos(rot_rad), np.sin(rot_rad)
    s = dst_w / src_w
    # The reference's 3-point construction reduces to a similarity: scale
    # s, rotation -rot (image coordinates, y down), centre -> centre.
    lin = s * np.array([[cs, sn], [-sn, cs]])
    src_center = center + (scale[0] if scale.size == 1 else scale[:2]) * shift
    dst_center = np.array([dst_w * 0.5, dst_h * 0.5])
    trans = np.zeros((2, 3), dtype=np.float64)
    trans[:, :2] = lin
    trans[:, 2] = dst_center - lin @ src_center
    if inv:
        lin_i = np.linalg.inv(lin)
        out = np.zeros((2, 3), dtype=np.float64)
        out[:, :2] = lin_i
        out[:, 2] = -lin_i @ trans[:, 2]
        return out.astype(np.float32)
    return trans.astype(np.float32)


def bbox_center_scale(box) -> tuple[np.ndarray, np.ndarray]:
    """[x0, y0, x1, y1] -> (center (2,), scale (2,))."""
    box = np.asarray(box, dtype=np.float64)
    center = np.array([(box[0] + box[2]) / 2.0, (box[1] + box[3]) / 2.0])
    scale = np.array([box[2] - box[0], box[3] - box[1]])
    return center, scale


def get_K_crop_resize(box, K_orig, resize_shape) -> tuple[np.ndarray, np.ndarray]:
    """Intrinsics of a crop to `box` ([x0, y0, x1, y1]) resized to
    `resize_shape` (h, w): (K_crop [3, 3], K_crop_homo [3, 4]) from K_orig
    [3, 3] or [3, 4]."""
    center, scale = bbox_center_scale(box)
    resize_h, resize_w = resize_shape
    trans = get_affine_transform(center, scale, 0.0, (resize_w, resize_h))
    trans_homo = np.concatenate([trans, np.array([[0, 0, 1]], dtype=np.float32)], axis=0)
    K_orig = np.asarray(K_orig, dtype=np.float64)
    if K_orig.shape == (3, 3):
        K_homo = np.concatenate([K_orig, np.zeros((3, 1))], axis=-1)
    else:
        K_homo = K_orig.copy()
    K_crop_homo = trans_homo @ K_homo
    return K_crop_homo[:3, :3].astype(np.float32), K_crop_homo.astype(np.float32)


def _bilinear_sample(img: torch.Tensor, xs: torch.Tensor, ys: torch.Tensor) -> torch.Tensor:
    """Bilinear sample of img [H, W(, C)] at float coordinates; zero outside."""
    H, W = img.shape[0], img.shape[1]
    x0 = torch.floor(xs)
    y0 = torch.floor(ys)
    wx = xs - x0
    wy = ys - y0
    x0i = x0.to(torch.int64)
    y0i = y0.to(torch.int64)

    def gather(yi, xi):
        valid = (xi >= 0) & (xi < W) & (yi >= 0) & (yi < H)
        v = img[yi.clamp(0, H - 1), xi.clamp(0, W - 1)]
        if img.dim() == 3:
            return torch.where(valid[..., None], v, 0.0)
        return torch.where(valid, v, 0.0)

    w00 = (1 - wx) * (1 - wy)
    w10 = wx * (1 - wy)
    w01 = (1 - wx) * wy
    w11 = wx * wy
    if img.dim() == 3:
        w00, w10, w01, w11 = (w[..., None] for w in (w00, w10, w01, w11))
    return (gather(y0i, x0i) * w00 + gather(y0i, x0i + 1) * w10
            + gather(y0i + 1, x0i) * w01 + gather(y0i + 1, x0i + 1) * w11)


def crop_img_affine(img: torch.Tensor, trans_inv, out_hw: tuple[int, int] = (512, 512)
                    ) -> torch.Tensor:
    """out(y, x) = img(trans_inv @ (x, y, 1)), bilinear, on img's device.

    `trans_inv` is the OUTPUT->SOURCE 2x3 affine (get_affine_transform with
    inv=True). Pixel centres at integer coordinates, cv2.warpAffine
    INTER_LINEAR semantics with a zero border; float32 arithmetic."""
    img = torch.as_tensor(img)
    A = torch.as_tensor(np.asarray(trans_inv, np.float32), device=img.device)
    out_h, out_w = out_hw
    ys, xs = torch.meshgrid(torch.arange(out_h, dtype=torch.float32, device=img.device),
                            torch.arange(out_w, dtype=torch.float32, device=img.device),
                            indexing="ij")
    src_x = A[0, 0] * xs + A[0, 1] * ys + A[0, 2]
    src_y = A[1, 0] * xs + A[1, 1] * ys + A[1, 2]
    return _bilinear_sample(img.float(), src_x, src_y)
