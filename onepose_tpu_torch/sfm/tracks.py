"""Track building from the two-view match graph.

Port of onepose_tpu/sfm/tracks.py, the same code; the union-find runs in
the port's own native core (`onepose_tpu_torch.native`).

Replaces the track-building half of COLMAP `point_triangulator`
(reference src/sfm/triangulation.py:122-148): verified matches between
image pairs are edges of a graph over (image, keypoint) nodes; connected
components are feature tracks. Host-side vectorized union-find (numpy) —
the graph is irregular and tiny next to the device work, so it stays on
CPU and emits PADDED track tensors the device consumes.

Consistency rule: a component containing two keypoints of the same image is
conflicting; the extra observations are dropped (first one kept), matching
COLMAP's conservative track handling.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from onepose_tpu_torch import native


@dataclasses.dataclass
class Tracks:
    """Padded track layout, device-ready.

    obs_frame: [T, L] frame index of each observation (-1 = pad)
    obs_kpt:   [T, L] keypoint index within the frame (-1 = pad)
    obs_mask:  [T, L] validity
    lengths:   [T] true track lengths
    """

    obs_frame: np.ndarray
    obs_kpt: np.ndarray
    obs_mask: np.ndarray
    lengths: np.ndarray

    @property
    def n_tracks(self) -> int:
        return self.obs_frame.shape[0]

    @property
    def max_len(self) -> int:
        return self.obs_frame.shape[1]


def _union_find(n: int, edges_a: np.ndarray, edges_b: np.ndarray) -> np.ndarray:
    """Union-find with path halving; returns root labels (the C++ core of
    `onepose_tpu_torch.native`, or its Python fallback without g++)."""
    return native.connected_components(n, edges_a, edges_b)


def build_tracks(
    pairs: np.ndarray,
    matches0: np.ndarray,
    n_frames: int,
    n_kpts: int,
    min_track_length: int = 2,
    max_track_length: int = 32,
) -> Tracks:
    """Connect verified pair matches into tracks.

    Args:
      pairs: [P, 2] frame-index pairs.
      matches0: [P, N] for each pair, the index of the matched keypoint in
        frame j for keypoint i of frame i (-1 = unmatched). Padded slots
        must be -1.
      n_frames / n_kpts: static layout of the (frame, keypoint) node grid.
      min_track_length: discard shorter tracks (>= 2 needed to triangulate).
      max_track_length: padded observation capacity per track; longer
        tracks keep their first max_track_length observations.
    """
    pairs = np.asarray(pairs)
    matches0 = np.asarray(matches0)
    edges_a, edges_b = [], []
    for p, (i, j) in enumerate(pairs):
        m = matches0[p]
        src = np.nonzero(m >= 0)[0]
        if len(src) == 0:
            continue
        edges_a.append(i * n_kpts + src)
        edges_b.append(j * n_kpts + m[src])
    if not edges_a:
        return Tracks(
            np.zeros((0, max_track_length), np.int32) - 1,
            np.zeros((0, max_track_length), np.int32) - 1,
            np.zeros((0, max_track_length), bool),
            np.zeros((0,), np.int32),
        )
    edges_a = np.concatenate(edges_a)
    edges_b = np.concatenate(edges_b)

    # Only touched nodes participate: compact them first.
    nodes, inv = np.unique(
        np.concatenate([edges_a, edges_b]), return_inverse=True
    )
    ea = inv[: len(edges_a)]
    eb = inv[len(edges_a):]
    roots = _union_find(len(nodes), ea, eb)

    # Group nodes by root.
    order = np.argsort(roots, kind="stable")
    sorted_roots = roots[order]
    sorted_nodes = nodes[order]
    boundaries = np.nonzero(
        np.diff(sorted_roots, prepend=sorted_roots[0] - 1)
    )[0]
    group_starts = boundaries
    group_ends = np.append(boundaries[1:], len(sorted_roots))

    obs_frame, obs_kpt, obs_mask, lengths = [], [], [], []
    for s, e in zip(group_starts.tolist(), group_ends.tolist()):
        comp = sorted_nodes[s:e]
        frames = comp // n_kpts
        kpts = comp % n_kpts
        # Conflict resolution: one observation per frame (keep first).
        uniq_frames, first_idx = np.unique(frames, return_index=True)
        if len(uniq_frames) < min_track_length:
            continue
        f = frames[first_idx][:max_track_length]
        k = kpts[first_idx][:max_track_length]
        n = len(f)
        pad = max_track_length - n
        obs_frame.append(np.pad(f, (0, pad), constant_values=-1))
        obs_kpt.append(np.pad(k, (0, pad), constant_values=-1))
        obs_mask.append(
            np.pad(np.ones(n, bool), (0, pad), constant_values=False)
        )
        lengths.append(n)

    if not obs_frame:
        return Tracks(
            np.zeros((0, max_track_length), np.int32) - 1,
            np.zeros((0, max_track_length), np.int32) - 1,
            np.zeros((0, max_track_length), bool),
            np.zeros((0,), np.int32),
        )
    return Tracks(
        np.stack(obs_frame).astype(np.int32),
        np.stack(obs_kpt).astype(np.int32),
        np.stack(obs_mask),
        np.asarray(lengths, np.int32),
    )
