"""Static-shape padding contracts (mask-aware).

Port of onepose_tpu/data/padding.py, whole (numpy and the standard library).

Behavioral spec from the reference (src/utils/data_utils.py:60-230), with
one deliberate upgrade: every padded tensor carries a validity MASK. The
reference pads 2D keypoints with random pixel positions (descriptor=1,
score=0) and 3D points with random xyz in [-0.5, 0.5) so padded slots look
like plausible-but-unmatchable data; we keep those fill values for
distribution parity with released checkpoints AND return the mask so
mask-aware consumers can ignore pads entirely.
"""

from __future__ import annotations

import numpy as np


def pad_keypoints2d(
    keypoints: np.ndarray,
    descriptors: np.ndarray,
    scores: np.ndarray,
    img_h: int,
    img_w: int,
    n_target: int,
    rng: np.random.Generator | None = None,
) -> dict:
    """Pad/truncate to n_target slots.

    keypoints [n, 2]; descriptors [n, C]; scores [n].
    Pads: random integer pixel coords, descriptor all-ones, score 0
    (data_utils.py:60-82 semantics).
    """
    if rng is None:
        rng = np.random.default_rng(0)
    n = len(keypoints)
    C = descriptors.shape[-1]
    out_kpts = np.zeros((n_target, 2), np.float32)
    out_desc = np.ones((n_target, C), np.float32)
    out_scores = np.zeros((n_target,), np.float32)
    mask = np.zeros((n_target,), bool)
    k = min(n, n_target)
    out_kpts[:k] = keypoints[:k]
    out_desc[:k] = descriptors[:k]
    out_scores[:k] = scores[:k]
    mask[:k] = True
    if k < n_target:
        out_kpts[k:, 0] = rng.integers(0, img_w, n_target - k)
        out_kpts[k:, 1] = rng.integers(0, img_h, n_target - k)
    return {
        "keypoints": out_kpts,
        "descriptors": out_desc,
        "scores": out_scores,
        "mask": mask,
        "num_valid": k,
    }


def pad_points3d(
    keypoints3d: np.ndarray,
    descriptors: np.ndarray,
    scores: np.ndarray,
    n_target: int,
    rng: np.random.Generator | None = None,
) -> dict:
    """Pad/truncate the 3D side: random xyz in [-0.5, 0.5), descriptor
    all-ones, score 0 (data_utils.py:120-160 semantics)."""
    if rng is None:
        rng = np.random.default_rng(0)
    n = len(keypoints3d)
    C = descriptors.shape[-1]
    out_xyz = np.zeros((n_target, 3), np.float32)
    out_desc = np.ones((n_target, C), np.float32)
    out_scores = np.zeros((n_target,), np.float32)
    mask = np.zeros((n_target,), bool)
    k = min(n, n_target)
    out_xyz[:k] = keypoints3d[:k]
    out_desc[:k] = descriptors[:k]
    out_scores[:k] = scores[:k]
    mask[:k] = True
    if k < n_target:
        out_xyz[k:] = rng.random((n_target - k, 3)) - 0.5
    return {
        "points3d": out_xyz,
        "descriptors": out_desc,
        "scores": out_scores,
        "mask": mask,
        "num_valid": k,
    }


def assign_to_conf_matrix(
    assign_matrix: np.ndarray,
    num_2d: int,
    num_3d: int,
    shape2d: int,
    shape3d: int,
) -> np.ndarray:
    """[2, K] index pairs -> dense GT confidence matrix [shape2d, shape3d].

    Matches reshape_assign_matrix (data_utils.py:208-230): pairs outside
    the static shapes are dropped; padded rows/cols are zero.
    """
    conf = np.zeros((shape2d, shape3d), np.float32)
    if assign_matrix.size:
        a = assign_matrix.astype(np.int64)
        valid = (
            (a[0] < min(num_2d, shape2d)) & (a[1] < min(num_3d, shape3d))
        )
        conf[a[0][valid], a[1][valid]] = 1.0
    return conf
