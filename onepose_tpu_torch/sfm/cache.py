"""HDF5 feature / match caches, reference-layout compatible.

The reference SfM pipeline persists per-image SuperPoint features to
`feats-superpoint.h5` (src/sfm/extract_features.py:44-59: one group per
image path with datasets keypoints [N, 2], scores [N], descriptors [C, N],
image_size [2] = (h, w)) and pair matches to `matches-superglue.h5`
(src/sfm/match_features.py:45-85: one group per `names_to_pair(name0,
name1)` with matches0/matches1 int16 and matching_scores0/1 float16;
symmetric pairs deduplicated).

This module reads and writes those exact layouts so that
- feature/match caches produced by the reference tooling can seed our
  mapping pipeline without re-extraction, and
- our caches remain inspectable by reference-side scripts,
while converting to/from this framework's static padded [F, N, ...]
arrays + validity masks at the boundary (ragged on disk, static on device).

Port of onepose_tpu/sfm/cache.py, whole: the same layout and fingerprint
attribute, so either package resumes from the other's caches. `h5py` is
imported inside the functions only.
"""

from __future__ import annotations

import os
import os.path as osp
from typing import Optional, Sequence

import numpy as np


def names_to_pair(name0: str, name1: str) -> str:
    """Pair group key (reference match_features.py:20-21)."""
    return "_".join((name0.replace("/", "-"), name1.replace("/", "-")))


FINGERPRINT_ATTR = "onepose_fingerprint"


def read_fingerprint(path: str) -> Optional[str]:
    """Root-attribute fingerprint of the config/weights that produced a
    cache file; None for caches without one (e.g. reference-produced)."""
    import h5py

    with h5py.File(path, "r") as f:
        v = f.attrs.get(FINGERPRINT_ATTR)
    return None if v is None else str(v)


def save_features_h5(
    path: str,
    image_names: Sequence[str],
    keypoints: np.ndarray,
    descriptors: np.ndarray,
    scores: np.ndarray,
    mask: np.ndarray,
    image_hw: tuple[int, int],
    fingerprint: Optional[str] = None,
) -> str:
    """Write padded [F, N, ...] features as a ragged reference-layout cache.

    Only valid (masked-True) slots are persisted; descriptors are stored
    [C, N] per image like the reference extractor output. `fingerprint`
    (extraction config + weights hash) is stored as a root attribute so a
    later run with different parameters re-extracts instead of silently
    reusing stale features.
    """
    import h5py

    os.makedirs(osp.dirname(osp.abspath(path)), exist_ok=True)
    with h5py.File(path, "w") as f:
        if fingerprint is not None:
            f.attrs[FINGERPRINT_ATTR] = fingerprint
        for i, name in enumerate(image_names):
            m = mask[i].astype(bool)
            grp = f.create_group(name)
            grp.create_dataset(
                "keypoints", data=np.asarray(keypoints[i][m], np.float32)
            )
            grp.create_dataset(
                "scores", data=np.asarray(scores[i][m], np.float32)
            )
            grp.create_dataset(
                "descriptors",
                data=np.asarray(descriptors[i][m], np.float32).T,
            )
            grp.create_dataset(
                "image_size", data=np.asarray(image_hw, np.int64)
            )
    return path


def load_features_h5(
    path: str,
    image_names: Optional[Sequence[str]] = None,
    pad_to: Optional[int] = None,
) -> dict:
    """Load a reference-layout feature cache into static padded arrays.

    Returns dict(keypoints [F, N, 2], descriptors [F, N, C], scores [F, N],
    mask [F, N] bool, image_hw (h, w), image_names list). Descriptors are
    L2-normalized on disk already; they are transposed back to channel-last.
    """
    import h5py

    with h5py.File(path, "r") as f:
        # Group names may contain '/' (nested groups): walk leaves that
        # hold a 'keypoints' dataset.
        available = []

        def visit(key, item):
            if isinstance(item, h5py.Group) and "keypoints" in item:
                available.append(key)

        f.visititems(visit)
        available.sort()

        if image_names is not None:
            # Reference-produced caches key groups by the full relative
            # image path (extract_features.py:44-59) while callers here pass
            # basenames — fall back to a unique basename match so reference
            # caches can seed the pipeline without re-extraction.
            by_base: dict = {}
            for a in available:
                by_base.setdefault(osp.basename(a), []).append(a)
            names = []
            for name in image_names:
                if name in available:
                    names.append(name)
                    continue
                cands = by_base.get(osp.basename(name), [])
                if len(cands) != 1:
                    raise KeyError(
                        f"image {name!r} not in cache {path} "
                        f"({len(cands)} basename candidates)"
                    )
                names.append(cands[0])
        else:
            names = available

        kps, descs, scs, hw = [], [], [], None
        for name in names:
            grp = f[name]
            kps.append(np.asarray(grp["keypoints"], np.float32))
            descs.append(np.asarray(grp["descriptors"], np.float32).T)
            scs.append(np.asarray(grp["scores"], np.float32))
            if hw is None and "image_size" in grp:
                hw = tuple(int(v) for v in np.asarray(grp["image_size"]))

    n_max = pad_to or max((len(k) for k in kps), default=0)
    F = len(names)
    C = descs[0].shape[-1] if F else 256
    out = {
        "keypoints": np.zeros((F, n_max, 2), np.float32),
        "descriptors": np.ones((F, n_max, C), np.float32),
        "scores": np.zeros((F, n_max), np.float32),
        "mask": np.zeros((F, n_max), bool),
        "image_hw": hw,
        "image_names": names,
    }
    for i in range(F):
        n = min(len(kps[i]), n_max)
        out["keypoints"][i, :n] = kps[i][:n]
        out["descriptors"][i, :n] = descs[i][:n]
        out["scores"][i, :n] = scs[i][:n]
        out["mask"][i, :n] = True
    return out


def save_matches_h5(
    path: str,
    pairs: np.ndarray,
    image_names: Sequence[str],
    matches0: np.ndarray,
    matching_scores0: Optional[np.ndarray] = None,
    mask: Optional[np.ndarray] = None,
) -> str:
    """Write pair matches in the reference layout.

    pairs: [P, 2] frame indices into image_names; matches0: [P, N] int
    (-1 = unmatched, indices into the padded keypoint slots of frame j).
    matches1 is derived (inverse mapping) to satisfy readers that expect
    it. Symmetric duplicates are skipped like the reference
    (match_features.py:50-54).
    """
    import h5py

    os.makedirs(osp.dirname(osp.abspath(path)), exist_ok=True)
    seen = set()
    with h5py.File(path, "w") as f:
        for p, (i, j) in enumerate(np.asarray(pairs)):
            key = names_to_pair(image_names[i], image_names[j])
            if (i, j) in seen or (j, i) in seen or key in f:
                continue
            seen.add((int(i), int(j)))
            m0 = np.asarray(matches0[p], np.int64).copy()
            if mask is not None:
                m0[~mask[p].astype(bool)] = -1
            n1 = int(m0.max()) + 1 if (m0 >= 0).any() else 0
            m1 = np.full(max(n1, 1), -1, np.int64)
            src = np.nonzero(m0 >= 0)[0]
            m1[m0[src]] = src
            grp = f.create_group(key)
            grp.create_dataset("matches0", data=m0.astype(np.int16))
            grp.create_dataset("matches1", data=m1.astype(np.int16))
            if matching_scores0 is not None:
                s0 = np.asarray(matching_scores0[p], np.float16)
                grp.create_dataset("matching_scores0", data=s0)
    return path


def load_matches_h5(
    path: str,
    pairs: np.ndarray,
    image_names: Sequence[str],
    n_kpts: int,
) -> np.ndarray:
    """Load matches for the given pairs into a static [P, N] array.

    Pairs stored in either orientation are honored (the reverse orientation
    is inverted); missing pairs raise KeyError. int16 storage means slot
    indices are < 32768 — far above the keypoint budget.
    """
    import h5py

    P = len(pairs)
    out = np.full((P, n_kpts), -1, np.int64)
    with h5py.File(path, "r") as f:
        for p, (i, j) in enumerate(np.asarray(pairs)):
            fwd = names_to_pair(image_names[i], image_names[j])
            rev = names_to_pair(image_names[j], image_names[i])
            if fwd in f:
                m0 = np.asarray(f[fwd]["matches0"], np.int64)
                n = min(len(m0), n_kpts)
                out[p, :n] = m0[:n]
            elif rev in f:
                m0 = np.asarray(f[rev]["matches0"], np.int64)
                src = np.nonzero(m0 >= 0)[0]
                tgt = m0[src]
                keep = (tgt < n_kpts) & (src < n_kpts)
                out[p, tgt[keep]] = src[keep]
            else:
                raise KeyError(f"pair not in cache: {fwd}")
    out[out >= n_kpts] = -1
    return out


class CachedPairMatcher:
    """Wrap a `match_pair_fn` with a reference-layout HDF5 match cache.

    On call: pairs present in the cache are loaded; missing pairs are
    computed by the wrapped matcher and appended to the cache file. This is
    the resume affordance the reference gets from its
    `if pair in match_file: continue` loop (match_features.py:50-54).

    `fingerprint` ties the cache to the matcher config + upstream feature
    fingerprint: an existing cache with a different fingerprint is dropped
    (match indices would desync from re-extracted keypoints).
    """

    def __init__(
        self,
        match_pair_fn,
        cache_path,
        image_names,
        n_kpts,
        fingerprint: Optional[str] = None,
    ):
        self.fn = match_pair_fn
        self.path = cache_path
        self.names = list(image_names)
        self.n_kpts = n_kpts
        self.fingerprint = fingerprint
        if (
            fingerprint is not None
            and osp.exists(cache_path)
            and read_fingerprint(cache_path) != fingerprint
        ):
            os.remove(cache_path)

    def __call__(self, pairs: np.ndarray) -> np.ndarray:
        import h5py

        pairs = np.asarray(pairs)
        cached = np.zeros(len(pairs), bool)
        if osp.exists(self.path):
            with h5py.File(self.path, "r") as f:
                for p, (i, j) in enumerate(pairs):
                    cached[p] = (
                        names_to_pair(self.names[i], self.names[j]) in f
                        or names_to_pair(self.names[j], self.names[i]) in f
                    )
        out = np.full((len(pairs), self.n_kpts), -1, np.int64)
        if cached.any():
            out[cached] = load_matches_h5(
                self.path, pairs[cached], self.names, self.n_kpts
            )
        todo = ~cached
        if todo.any():
            fresh = np.asarray(self.fn(pairs[todo]))
            out[todo] = fresh
            mode = "a" if osp.exists(self.path) else "w"
            with h5py.File(self.path, mode) as f:
                if self.fingerprint is not None and mode == "w":
                    f.attrs[FINGERPRINT_ATTR] = self.fingerprint
                for p_local, (i, j) in enumerate(pairs[todo]):
                    key = names_to_pair(self.names[i], self.names[j])
                    rev = names_to_pair(self.names[j], self.names[i])
                    if key in f or rev in f:
                        continue
                    m0 = fresh[p_local].astype(np.int64)
                    n1 = int(m0.max()) + 1 if (m0 >= 0).any() else 0
                    m1 = np.full(max(n1, 1), -1, np.int64)
                    src = np.nonzero(m0 >= 0)[0]
                    m1[m0[src]] = src
                    grp = f.create_group(key)
                    grp.create_dataset("matches0", data=m0.astype(np.int16))
                    grp.create_dataset("matches1", data=m1.astype(np.int16))
        return out
