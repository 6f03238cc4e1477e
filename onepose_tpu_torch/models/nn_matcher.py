"""Mutual nearest-neighbour descriptor matcher.

Port of onepose_tpu/models/nn_matcher.py: cosine-similarity mutual NN with
an optional ratio test and distance threshold, on static shapes with
masks. `NNMatcher2D3D` speaks the GATsSPG matcher's call protocol (desc2d,
desc3d, leaf_desc, masks) and matches 2D descriptors directly against the
3D points' descriptors, with no learned weights.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from onepose_tpu_torch.models.common import NEG_INF


def mutual_nn_match(
    desc0: torch.Tensor,
    desc1: torch.Tensor,
    mask0: Optional[torch.Tensor] = None,
    mask1: Optional[torch.Tensor] = None,
    ratio_thresh: Optional[float] = None,
    distance_thresh: Optional[float] = None,
) -> dict:
    """Match [..., N0, C] against [..., N1, C] L2-normalised descriptors.

    Returns matches0 [..., N0] (-1 unmatched), similarity0 and valid0.
    ratio_thresh: NN1 / NN2 test on cosine distance (1 - sim);
    distance_thresh: the largest cosine distance of a match. argmax takes
    the first index on ties."""
    sim = torch.einsum("...nc,...mc->...nm", desc0, desc1)
    if mask0 is not None:
        sim = sim.masked_fill(~mask0[..., :, None], NEG_INF)
    if mask1 is not None:
        sim = sim.masked_fill(~mask1[..., None, :], NEG_INF)
    idx0 = sim.argmax(dim=-1)
    idx1 = sim.argmax(dim=-2)
    best0 = sim.amax(dim=-1)
    arange0 = torch.arange(sim.shape[-2], device=sim.device)
    mutual = arange0 == torch.gather(idx1, -1, idx0)
    valid = mutual & (best0 > NEG_INF / 2)
    if ratio_thresh is not None:
        cols = torch.arange(sim.shape[-1], device=sim.device)
        top2 = sim.masked_fill(cols == idx0[..., None], NEG_INF).amax(dim=-1)
        valid = valid & ((1.0 - best0) / (1.0 - top2).clamp(min=1e-9) <= ratio_thresh)
    if distance_thresh is not None:
        valid = valid & ((1.0 - best0) <= distance_thresh)
    if mask0 is not None:
        valid = valid & mask0
    minus1 = torch.full((), -1, dtype=idx0.dtype, device=sim.device)
    return {
        "matches0": torch.where(valid, idx0, minus1).int(),
        "similarity0": torch.where(valid, best0, 0.0),
        "valid0": valid,
    }


def _l2_normalize(d: torch.Tensor) -> torch.Tensor:
    return d / torch.linalg.vector_norm(d, dim=-1, keepdim=True).clamp(min=1e-12)


class NNMatcher2D3D(nn.Module):
    """2D-3D mutual-NN matcher with the GATsSPG call protocol; leaf
    descriptors and leaf masks are ignored, conf_matrix is None."""

    def __init__(self, distance_thresh: float = 0.7):
        super().__init__()
        self.distance_thresh = distance_thresh

    def forward(
        self,
        desc2d: torch.Tensor,
        desc3d: torch.Tensor,
        leaf_desc: Optional[torch.Tensor] = None,
        mask2d: Optional[torch.Tensor] = None,
        mask3d: Optional[torch.Tensor] = None,
        leaf_mask: Optional[torch.Tensor] = None,
    ) -> dict:
        m = mutual_nn_match(_l2_normalize(desc2d), _l2_normalize(desc3d), mask2d, mask3d,
                            distance_thresh=self.distance_thresh)
        return {
            "matches0": m["matches0"],
            "matching_scores0": m["similarity0"],
            "valid0": m["valid0"],
            "conf_matrix": None,
        }
