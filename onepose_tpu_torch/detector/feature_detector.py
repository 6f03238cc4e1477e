"""Feature-matching 2D object detector.

Port of onepose_tpu/detector/feature_detector.py:
- a database of SuperPoint features of n_ref_views reference frames
  sampled uniformly from the mapping images (`ReferenceDB`,
  `select_reference_views`);
- `detect_bbox`: the query matched against all V views in one batched
  call (`match_fn`), a similarity fitted per view by RANSAC (6 px,
  `geometry.similarity`, all views at once), the view's image corners
  mapped through it, the box of the view with the most inliers;
- `crop`: the square crop_size crop as one affine, with the K_crop
  intrinsics of the reference's two-stage crop;
- `previous_pose_detect`: the box of the annotated 3D corners projected by
  the previous pose.

Random draws: JAX splits `key` (PRNGKey(0) by default) into one key a view
for the Gumbel draws of `ransac_similarity`, the same draws for every
frame. The port takes them as `gumbel [V, n_hyp, N]`, or by default draws
them once from a CPU generator seeded 0 and keeps them on the device for
every frame, so the card and the CPU draw alike.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import numpy as np
import torch

from onepose_tpu_torch.geometry.projection import project_points
from onepose_tpu_torch.geometry.similarity import gumbel_draws, ransac_similarity
from onepose_tpu_torch.geometry.transforms import (
    crop_img_affine,
    get_affine_transform,
    get_K_crop_resize,
)


@dataclasses.dataclass
class ReferenceDB:
    """Stacked reference-view features: [V, N, ...] tensors + view sizes."""

    keypoints: torch.Tensor  # [V, N, 2]
    descriptors: torch.Tensor  # [V, N, C]
    scores: torch.Tensor  # [V, N]
    mask: torch.Tensor  # [V, N]
    sizes_hw: np.ndarray  # [V, 2] (h, w) per view


def select_reference_views(n_images: int, n_ref_views: int) -> np.ndarray:
    """Every len(images) // n_ref_views-th image, at most n_ref_views."""
    gap = max(n_images // n_ref_views, 1)
    return np.arange(0, n_images, gap)[:n_ref_views]


class FeatureObjectDetector:
    def __init__(
        self,
        db: ReferenceDB,
        match_fn: Callable,
        crop_size: int = 512,
        ransac_px: float = 6.0,
        n_hyp: int = 128,
    ):
        """match_fn(db: ReferenceDB, query_feats: dict) -> matches0 [V, N]
        (index into the query's keypoints, -1 unmatched), the query matched
        against every view at once."""
        self.db = db
        self.match_fn = match_fn
        self.crop_size = crop_size
        self.ransac_px = ransac_px
        self.n_hyp = n_hyp
        self._draws: Optional[torch.Tensor] = None  # the default draws, made once

    def default_draws(self, n: int) -> torch.Tensor:
        """[V, n_hyp, n] Gumbel draws of a CPU generator seeded 0, on the
        DB's device, made at the first call for n keypoint slots."""
        V = self.db.keypoints.shape[0]
        if self._draws is None or self._draws.shape != (V, self.n_hyp, n):
            g = torch.Generator().manual_seed(0)
            self._draws = gumbel_draws((V, self.n_hyp, n), g).to(self.db.keypoints.device)
        return self._draws

    def detect_bbox(self, query_feats: dict, gumbel: Optional[torch.Tensor] = None) -> dict:
        """The object box in the query image.

        query_feats: dict(keypoints [N, 2], descriptors [N, C], scores [N],
        mask [N], optionally image_hw); gumbel [V, n_hyp, N] draws or None
        (`default_draws`). Returns dict(bbox [4] x0 y0 x1 y1 (numpy
        float64), num_inliers, view, ok)."""
        dev = self.db.keypoints.device
        N = self.db.keypoints.shape[1]
        matches0 = self.match_fn(self.db, query_feats).to(dev)  # [V, N]
        q_kpts = torch.as_tensor(query_feats["keypoints"], device=dev).float()
        dst = q_kpts[matches0.clamp(min=0).long()]  # [V, N, 2]
        valid = (matches0 >= 0) & self.db.mask
        fit = ransac_similarity(self.db.keypoints, dst, valid, inlier_px=self.ransac_px,
                                n_hyp=self.n_hyp,
                                gumbel=self.default_draws(N) if gumbel is None else gumbel)

        counts = fit["num_inliers"].cpu().numpy()
        best = int(np.argmax(counts))
        A = fit["A"][best].cpu().numpy()  # [2, 3]
        h, w = self.db.sizes_hw[best]
        corners = np.array([[0, 0, 1], [w, 0, 1], [0, h, 1], [w, h, 1]], dtype=np.float64).T
        bbox_pts = (A @ corners).T  # [4, 2]
        lt = bbox_pts.min(axis=0)
        rb = bbox_pts.max(axis=0)
        return {
            "bbox": np.array([lt[0], lt[1], rb[0], rb[1]]),
            "num_inliers": int(counts[best]),
            "view": best,
            "ok": bool(counts[best] >= 6),
        }

    def previous_pose_detect(self, K: np.ndarray, prev_pose: np.ndarray,
                             box3d_corners: np.ndarray) -> np.ndarray:
        """Box of the annotated 3D corners projected by the previous pose."""
        pose = np.asarray(prev_pose)
        f32 = lambda x: torch.as_tensor(np.asarray(x, np.float32))[None]  # noqa: E731
        uv, _ = project_points(f32(box3d_corners), f32(K), f32(pose[:3, :3]), f32(pose[:3, 3]))
        uv = uv[0].numpy()
        lt = uv.min(axis=0)
        rb = uv.max(axis=0)
        return np.array([lt[0], lt[1], rb[0], rb[1]])

    def crop(self, image, bbox: np.ndarray, K: np.ndarray) -> tuple[torch.Tensor, np.ndarray]:
        """Square crop_size crop of image [H, W] (on its device) with the
        K_crop contract: the reference's two stages (crop to the box, then
        resize to square) as one affine, and K_crop of both applied in turn."""
        bbox = np.asarray(bbox, dtype=np.float64)
        size = (self.crop_size, self.crop_size)
        K1, _ = get_K_crop_resize(bbox, K, (int(bbox[3] - bbox[1]), int(bbox[2] - bbox[0])))
        bbox2 = [0, 0, bbox[2] - bbox[0], bbox[3] - bbox[1]]
        K2, _ = get_K_crop_resize(bbox2, K1, size)

        center = ((bbox[0] + bbox[2]) / 2, (bbox[1] + bbox[3]) / 2)
        scale1 = (bbox[2] - bbox[0], bbox[3] - bbox[1])
        A1_inv = get_affine_transform(
            center, scale1, 0, (int(bbox[2] - bbox[0]), int(bbox[3] - bbox[1])), inv=True)
        center2 = ((bbox2[0] + bbox2[2]) / 2, (bbox2[1] + bbox2[3]) / 2)
        A2_inv = get_affine_transform(
            center2, (bbox2[2] - bbox2[0], bbox2[3] - bbox2[1]), 0, size, inv=True)
        # Compose output->source: A1_inv o A2_inv.
        A2h = np.vstack([A2_inv, [0, 0, 1]])
        A1h = np.vstack([A1_inv, [0, 0, 1]])
        A_inv = (A1h @ A2h)[:2]
        crop = crop_img_affine(image, A_inv.astype(np.float32), size)
        return crop, K2
