"""End-to-end one-shot pose estimation on the card.

Port of onepose_tpu/runtime/pipeline.py (the serving program that
`bench.py` and `onepose_tpu infer` run). Per frame batch:

  images [B, H, W, 1] --SuperPoint--> dense score/descriptor maps
  --extract_keypoints--> K static keypoint slots + mask
  --GATsSPG vs ObjectAnnotation--> matches
  --gather--> 2D-3D correspondences --RANSAC-PnP + GN refine--> poses

`compute_dtype` defaults to bfloat16, the JAX package's serving default:
the convolutions and the matcher compute in bf16 while score ordering,
normalisations, the match head and RANSAC-PnP stay fp32. With
`kernels=True` (the default here; the JAX package ships its kernels
opt-in after TPU measurements that say nothing about this card) the
default modules launch the hand-written kernels of their dtype's path:
  bf16: NMS, VGG stage (SuperPoint); fused block, dual softmax (GATsSPG);
  fp32: NMS (SuperPoint); GATs leaf attention, dual softmax (GATsSPG).
`sharded` waits for the multi-device slice.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from onepose_tpu_torch._device import check_compute_dtype, resolve_device
from onepose_tpu_torch.geometry.ransac import ransac_pnp
from onepose_tpu_torch.models.gats_spg import GATsSPG
from onepose_tpu_torch.models.superpoint import SuperPoint, extract_keypoints

_ANNO_FIELDS = ("points3d", "desc3d", "leaf_desc", "mask3d", "leaf_mask")


@dataclasses.dataclass
class ObjectAnnotation:
    """One scanned object's point cloud with aggregated descriptors.

    points3d [N3, 3]; desc3d [N3, C]; leaf_desc [N3, L, C]; mask3d [N3];
    leaf_mask [N3, L]. With a leading batch axis (see stack_annotations)
    each frame of a batch is matched against its own object."""

    points3d: torch.Tensor
    desc3d: torch.Tensor
    leaf_desc: torch.Tensor
    mask3d: torch.Tensor
    leaf_mask: torch.Tensor

    @property
    def batched(self) -> bool:
        return self.mask3d.dim() == 2

    @property
    def n_points(self) -> int:
        return self.points3d.shape[-2]

    def to(self, device) -> "ObjectAnnotation":
        return ObjectAnnotation(
            **{k: torch.as_tensor(getattr(self, k), device=device) for k in _ANNO_FIELDS}
        )


def stack_annotations(annos: list) -> ObjectAnnotation:
    """Stack per-object annotations (same padded shapes) into a batched
    ObjectAnnotation: one object per frame of a serving batch."""
    return ObjectAnnotation(
        **{k: torch.stack([torch.as_tensor(getattr(a, k)) for a in annos]) for k in _ANNO_FIELDS}
    )


class PosePipeline:
    """Whole-frame pose estimation.

    Configuration (keypoint budget, hypothesis count, compute dtype,
    kernels) is bound at construction; modules are moved to `device` and
    put in eval mode. Explicitly passed superpoint / matcher modules are
    used as they are."""

    def __init__(
        self,
        superpoint: SuperPoint | None = None,
        matcher: GATsSPG | None = None,
        max_keypoints: int = 1000,
        keypoint_threshold: float = 0.005,
        border: int = 4,
        nms_radius: int = 4,
        ransac_hypotheses: int = 512,
        reproj_threshold: float = 5.0,
        compute_dtype: torch.dtype = torch.bfloat16,
        kernels: bool = True,
        device: str | torch.device = "cuda",
    ):
        self.device = resolve_device(device)
        bf16 = check_compute_dtype(compute_dtype) == torch.bfloat16
        self.superpoint = superpoint or SuperPoint(
            nms_radius=nms_radius, nms_kernel=kernels, vgg_kernel=kernels and bf16,
            dtype=compute_dtype,
        )
        self.matcher = matcher or GATsSPG(
            gats_kernel=kernels and not bf16, block_fused=kernels and bf16, fused_match=kernels,
            dtype=compute_dtype,
        )
        self.superpoint.to(self.device).eval()
        self.matcher.to(self.device).eval()
        self.max_keypoints = max_keypoints
        self.keypoint_threshold = keypoint_threshold
        self.border = border
        self.ransac_hypotheses = ransac_hypotheses
        self.reproj_threshold = reproj_threshold

    def _tensor(self, x) -> torch.Tensor:
        return torch.as_tensor(x, device=self.device)

    def _forward(self, images, K, anno, draws, generator) -> dict:
        dense = self.superpoint(images)
        feats = extract_keypoints(
            dense["score_map"],
            dense["descriptor_map"],
            max_keypoints=self.max_keypoints,
            keypoint_threshold=self.keypoint_threshold,
            border=self.border,
        )
        return self._match_solve(feats, K, anno, draws, generator)

    def _match_solve(self, feats, K, anno, draws, generator) -> dict:
        b = feats["keypoints"].shape[0]

        # A single-object annotation is broadcast over the frame batch once
        # (materialized: the GATs kernel reads contiguous leaves).
        def per_frame(x):
            return x if anno.batched else x[None].expand((b,) + x.shape).contiguous()

        match = self.matcher(
            feats["descriptors"],
            per_frame(anno.desc3d),
            per_frame(anno.leaf_desc),
            feats["mask"],
            per_frame(anno.mask3d),
            per_frame(anno.leaf_mask),
        )
        idx = match["matches0"].clamp(min=0).long()  # [B, N2]
        points3d = anno.points3d if anno.batched else anno.points3d[None].expand(b, -1, -1)
        pts3d = torch.gather(points3d, 1, idx[..., None].expand(-1, -1, 3))
        corr_mask = match["matches0"] >= 0

        pnp = ransac_pnp(
            feats["keypoints"], pts3d, K, corr_mask,
            draws=draws, generator=generator,
            n_hyp=self.ransac_hypotheses, reproj_threshold=self.reproj_threshold,
        )
        return {
            "pose": pnp["pose"],
            "num_inliers": pnp["num_inliers"],
            "pnp_ok": pnp["ok"],
            "inliers": pnp["inliers"],
            "keypoints": feats["keypoints"],
            "descriptors": feats["descriptors"],
            "kpt_mask": feats["mask"],
            "kpt_scores": feats["scores"],
            "matches0": match["matches0"],
            "matching_scores0": match["matching_scores0"],
            "num_matches": corr_mask.sum(-1),
        }

    @torch.inference_mode()
    def __call__(
        self,
        images,
        K,
        anno: ObjectAnnotation,
        draws: Optional[torch.Tensor] = None,
        generator: Optional[torch.Generator] = None,
    ) -> dict:
        """images [B, H, W, 1] grayscale in [0, 1]; K [B, 3, 3].

        draws [B, n_hyp, 3] uniform RANSAC draws, or None to draw them from
        `generator` (a default generator when None). Returns pose [B, 4, 4]
        (world->camera), inlier statistics, keypoints and matches."""
        return self._forward(
            self._tensor(images), self._tensor(K), anno.to(self.device), draws, generator
        )

    @torch.inference_mode()
    def from_features(
        self,
        feats: dict,
        K,
        anno: ObjectAnnotation,
        draws: Optional[torch.Tensor] = None,
        generator: Optional[torch.Generator] = None,
    ) -> dict:
        """Match -> RANSAC-PnP from precomputed features: feats =
        dict(keypoints [B, N, 2], descriptors [B, N, C], scores [B, N],
        mask [B, N])."""
        feats = {k: self._tensor(v) for k, v in feats.items()}
        return self._match_solve(feats, self._tensor(K), anno.to(self.device), draws, generator)
