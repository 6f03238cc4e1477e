"""Point-cloud filtering and merging after triangulation (host numpy).

Port of onepose_tpu/sfm/filtering.py, the same code; the distance-gated
union-find runs in the port's native core (`onepose_tpu_torch.native`).

Behavioral specs from the reference:
- Track-length threshold search: smallest track length keeping at most
  `max_points` points (src/sfm/postprocess/filter_tkl.py:36-53).
- 3D-box inside test by edge projection on the annotated bounding box
  (src/sfm/postprocess/filter_points.py:28-72): project p - c4 onto the
  three box edges (c5-c4, c0-c4, c7-c4), inside iff 0 < proj < |edge|^2.
- Merge points closer than 1 mm into their mean, recording the old->new id
  grouping (filter_points.py:86-117). Implemented with a grid hash +
  union-find instead of a dense O(N^2) pdist, same 1 mm semantics.
"""

from __future__ import annotations

import numpy as np

from onepose_tpu_torch import native


def track_length_for_max_points(
    track_lengths: np.ndarray, max_points: int
) -> int:
    """Smallest track-length threshold with <= max_points surviving."""
    lengths = np.asarray(track_lengths)
    if len(lengths) <= max_points:
        return int(lengths.min(initial=2))
    for thr in np.sort(np.unique(lengths)):
        if np.sum(lengths >= thr) <= max_points:
            return int(thr)
    return int(lengths.max()) + 1


def filter_points_by_box(
    points: np.ndarray, box_corners: np.ndarray
) -> np.ndarray:
    """Inside-box mask for [N, 3] points given [8, 3] corners.

    Corner layout follows the OnePose annotation convention (parse box:
    reference parse_scanned_data.py:89-141): edges from corner 4 to
    corners 5, 0 and 7 span the box.
    """
    c4 = box_corners[4]
    edges = np.stack(
        [box_corners[5] - c4, box_corners[0] - c4, box_corners[7] - c4]
    )  # [3, 3]
    rel = points - c4
    proj = rel @ edges.T  # [N, 3]
    upper = np.sum(edges * edges, axis=-1)  # [3]
    return np.all((proj > 0) & (proj < upper), axis=-1)


def merge_close_points(
    points: np.ndarray,
    point_ids: np.ndarray,
    dist_threshold: float = 1e-3,
) -> tuple[np.ndarray, dict]:
    """Merge points closer than dist_threshold; returns (merged_points,
    {new_id: array of old point_ids}).

    Grid-hash neighborhood search: points within the threshold always fall
    in the same or adjacent cells of a `dist_threshold`-sized grid.
    """
    points = np.asarray(points, dtype=np.float64)
    point_ids = np.asarray(point_ids)
    n = len(points)
    if n == 0:
        return points.astype(np.float32), {}

    cells = np.floor(points / dist_threshold).astype(np.int64)
    cell_map: dict[tuple, list] = {}
    for i, c in enumerate(map(tuple, cells)):
        cell_map.setdefault(c, []).append(i)

    # Candidate pairs: same or adjacent grid cells.
    offsets = np.array(
        [
            (dx, dy, dz)
            for dx in (-1, 0, 1)
            for dy in (-1, 0, 1)
            for dz in (-1, 0, 1)
        ]
    )
    cand_a, cand_b = [], []
    for c, idxs in cell_map.items():
        neigh = []
        for off in offsets:
            neigh.extend(cell_map.get(tuple(np.asarray(c) + off), []))
        for i in idxs:
            cand_a.extend([i] * len(neigh))
            cand_b.extend(neigh)
    cand_a = np.asarray(cand_a, np.int64)
    cand_b = np.asarray(cand_b, np.int64)

    # Distance-gated union-find (the C++ core, or its Python fallback).
    roots = native.merge_close(points, cand_a, cand_b, dist_threshold)
    merged_points = []
    groups: dict[int, np.ndarray] = {}
    for new_id, r in enumerate(np.unique(roots)):
        members = np.nonzero(roots == r)[0]
        merged_points.append(points[members].mean(axis=0))
        groups[new_id] = point_ids[members]
    return np.asarray(merged_points, dtype=np.float32), groups
