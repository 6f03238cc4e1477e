"""Covisibility pair selection from known GT poses (host numpy).

Port of onepose_tpu/sfm/covis.py, the same code.

Behavioral spec from the reference (src/sfm/pairs_from_poses.py:7-70):
camera-center distances + relative rotation angles over all mapping frames;
a pair is valid when the relative rotation exceeds 10 degrees; each frame
picks its nearest valid partners per sequence. (The reference's stride-2
argpartition slice at pairs_from_poses.py:62 reads as an indexing quirk and
halves the requested count; we implement the documented intent: the
`num_matched_per_seq` nearest valid partners.)
"""

from __future__ import annotations

import numpy as np


def covis_pairs_from_poses(
    poses: np.ndarray,
    seq_ids: np.ndarray | None = None,
    num_matched: int = 10,
    min_rotation_deg: float = 10.0,
    max_rotation_deg: float | None = None,
) -> np.ndarray:
    """Select covisible frame pairs.

    Args:
      poses: [N, 4, 4] world->camera poses (T_cw).
      seq_ids: [N] int sequence id per frame (None = single sequence).
      num_matched: pairs per frame (split across sequences like the
        reference when several mapping sequences exist).
      min_rotation_deg: minimum relative rotation for a valid pair.
      max_rotation_deg: optional maximum relative rotation.
    Returns:
      [P, 2] int array of (i, j) frame-index pairs, i != j, deduplicated
      as unordered pairs.
    """
    poses = np.asarray(poses)
    n = len(poses)
    R = poses[:, :3, :3]
    t = poses[:, :3, 3]
    centers = -np.einsum("nji,nj->ni", R, t)  # camera centers (R^T applied)

    dist = np.linalg.norm(
        centers[:, None, :] - centers[None, :, :], axis=-1
    )
    trace = np.einsum("nij,mij->nm", R, R)
    dR = np.degrees(np.arccos(np.clip((trace - 1.0) / 2.0, -1.0, 1.0)))

    valid = dR > min_rotation_deg
    if max_rotation_deg is not None:
        valid &= dR < max_rotation_deg
    np.fill_diagonal(valid, False)
    gated = np.where(valid, dist, np.inf)

    if seq_ids is None:
        seq_ids = np.zeros(n, dtype=int)
    seq_ids = np.asarray(seq_ids)
    uniq_seqs = np.unique(seq_ids)
    per_seq = max(num_matched // len(uniq_seqs), 1)

    pairs = set()
    for i in range(n):
        for s in uniq_seqs:
            ids = np.nonzero(seq_ids == s)[0]
            order = ids[np.argsort(gated[i, ids])]
            picked = order[np.isfinite(gated[i, order])][:per_seq]
            for j in picked:
                pairs.add((min(i, int(j)), max(i, int(j))))
    if not pairs:
        return np.zeros((0, 2), dtype=int)
    return np.asarray(sorted(pairs), dtype=int)
