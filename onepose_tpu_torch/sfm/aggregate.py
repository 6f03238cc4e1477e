"""Per-3D-point descriptor aggregation and training annotations.

Port of onepose_tpu/sfm/aggregate.py, the same code.

Behavioral specs from the reference
(src/sfm/postprocess/feature_process.py):
- For each surviving (merged) 3D point, gather the descriptors/scores of ALL
  its 2D track observations across the group's pre-merge points
  (feature_process.py:165-188): the "collect" annotation, with per-point
  leaf counts `idxs`; their mean is the "average" annotation
  (feature_process.py:297-305).
- Leaf slots: fixed fan-out `num_leaf` per point via random subset (count >
  L) or dustbin padding (descriptor = 1, score = 0) + shuffle
  (src/utils/data_utils.py:163-205).
- Per-image assign matrix: greedy 1-to-1 2D<->3D assignment
  (feature_process.py:197-230).

All functions are host-side numpy producing device-ready arrays (this is
data preparation, not the hot path).
"""

from __future__ import annotations

import numpy as np

from onepose_tpu_torch.sfm.tracks import Tracks


def aggregate_point_features(
    tracks: Tracks,
    obs_inlier: np.ndarray,
    track_ok: np.ndarray,
    groups: dict,
    descriptors: np.ndarray,
    scores: np.ndarray,
) -> dict:
    """Gather per-merged-point 2D features.

    Args:
      tracks: padded track layout ([T, L] obs arrays).
      obs_inlier: [T, L] observation gate from triangulation.
      track_ok: [T] surviving-track mask (pre-merge).
      groups: {new_point_id: array of track ids} from merge_close_points.
      descriptors: [F, N, C] per-frame keypoint descriptors.
      scores: [F, N] per-frame keypoint scores.
    Returns dict with:
      desc_concat [M, C], scores_concat [M], idxs [P] leaf counts,
      desc_avg [P, C], scores_avg [P],
      frame_obs: {frame_idx: list of (kpt_idx, new_point_id)} for the
      training assign matrices.
    """
    obs_inlier = np.asarray(obs_inlier)
    track_ok = np.asarray(track_ok)
    desc_chunks, score_chunks, idxs = [], [], []
    desc_avg, score_avg = [], []
    frame_obs: dict[int, list] = {}

    for new_id in sorted(groups.keys()):
        track_ids = [t for t in np.atleast_1d(groups[new_id]) if track_ok[t]]
        d_list, s_list = [], []
        for t in track_ids:
            valid = obs_inlier[t]
            frames = tracks.obs_frame[t][valid]
            kpts = tracks.obs_kpt[t][valid]
            d_list.append(descriptors[frames, kpts])
            s_list.append(scores[frames, kpts])
            for f, k in zip(frames.tolist(), kpts.tolist()):
                frame_obs.setdefault(f, []).append((k, new_id))
        d = (
            np.concatenate(d_list, axis=0)
            if d_list
            else np.zeros((0, descriptors.shape[-1]), descriptors.dtype)
        )
        s = (
            np.concatenate(s_list, axis=0)
            if s_list
            else np.zeros((0,), scores.dtype)
        )
        desc_chunks.append(d)
        score_chunks.append(s)
        idxs.append(len(d))
        if len(d):
            desc_avg.append(d.mean(axis=0))
            score_avg.append(s.mean())
        else:
            desc_avg.append(np.ones(descriptors.shape[-1], descriptors.dtype))
            score_avg.append(np.zeros((), scores.dtype))

    return {
        "desc_concat": np.concatenate(desc_chunks, axis=0)
        if desc_chunks
        else np.zeros((0, descriptors.shape[-1]), descriptors.dtype),
        "scores_concat": np.concatenate(score_chunks, axis=0)
        if score_chunks
        else np.zeros((0,), scores.dtype),
        "idxs": np.asarray(idxs, np.int64),
        "desc_avg": np.stack(desc_avg)
        if desc_avg
        else np.zeros((0, descriptors.shape[-1]), descriptors.dtype),
        "scores_avg": np.asarray(score_avg, scores.dtype),
        "frame_obs": frame_obs,
    }


def build_leaf_slots(
    desc_concat: np.ndarray,
    scores_concat: np.ndarray,
    idxs: np.ndarray,
    num_leaf: int,
    rng: np.random.Generator | None = None,
) -> dict:
    """Fixed-fan-out leaf tensors from concatenated per-point features.

    Matches build_features3d_leaves (data_utils.py:163-205): per point,
    if its observation count < num_leaf, pad with the dustbin (descriptor
    all-ones, score 0) and shuffle; else take a random subset of num_leaf.
    Returns dict(leaf_desc [P, L, C], leaf_scores [P, L],
    leaf_mask [P, L] — True where the slot holds a real observation).
    """
    if rng is None:
        rng = np.random.default_rng(0)
    P = len(idxs)
    C = desc_concat.shape[-1]
    leaf_desc = np.ones((P, num_leaf, C), desc_concat.dtype)
    leaf_scores = np.zeros((P, num_leaf), scores_concat.dtype)
    leaf_mask = np.zeros((P, num_leaf), bool)
    upper = np.cumsum(idxs)
    lower = np.concatenate([[0], upper[:-1]])
    for p, (s, e) in enumerate(zip(lower, upper)):
        count = e - s
        if count >= num_leaf:
            sel = rng.permutation(np.arange(s, e))[:num_leaf]
            leaf_desc[p] = desc_concat[sel]
            leaf_scores[p] = scores_concat[sel]
            leaf_mask[p] = True
        else:
            slots = rng.permutation(num_leaf)
            real = slots[:count]
            sel = np.arange(s, e)
            leaf_desc[p, real] = desc_concat[sel]
            leaf_scores[p, real] = scores_concat[sel]
            leaf_mask[p, real] = True
    return {
        "leaf_desc": leaf_desc,
        "leaf_scores": leaf_scores,
        "leaf_mask": leaf_mask,
    }


def assign_matrix_for_frame(
    frame_obs: list,
    n_kpts: int,
    n_points: int,
) -> np.ndarray:
    """Greedy 1-to-1 assign matrix [2, K] for one image.

    frame_obs: list of (kpt_idx, point_id) correspondences in this frame.
    Matches get_assign_matrix (feature_process.py:197-230): each 2D keypoint
    and each 3D point is used at most once; later conflicts are dropped.
    """
    used2d = np.zeros(n_kpts, bool)
    used3d = np.zeros(n_points, bool)
    pairs = []
    for k, p in frame_obs:
        if k < 0 or k >= n_kpts or p < 0 or p >= n_points:
            continue
        if used2d[k] or used3d[p]:
            used2d[k] = True
            continue
        used2d[k] = True
        used3d[p] = True
        pairs.append((k, p))
    if not pairs:
        return np.zeros((2, 0), np.int64)
    return np.asarray(pairs, np.int64).T
