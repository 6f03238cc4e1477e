"""Batched pair matching for the `map` front end.

Port of onepose_tpu/parallel/sfm_parallel.py on one device. Pairs of frames
have no interaction, so matching runs over fixed-size chunks of pairs: the
sequence's features go to the device once (the frame axis padded to a
bucket of 32), each chunk of pairs is gathered on the device, and only the
pair indices go up and the [chunk, N] match rows come down. The last chunk
is padded by repeating its first pair, and its extra rows are dropped.

Both `make_*` functions return `match_pairs(pairs) -> np.ndarray [P, N]
int64` (-1 unmatched), the callable that the SfM mapping consumes. `mesh` other than
None raises: sharding the pair axis over several cards is a later item.
Entry points run on CUDA unless the caller passes device="cpu".
"""

from __future__ import annotations

import numpy as np
import torch

from onepose_tpu_torch._device import resolve_device
from onepose_tpu_torch.models.nn_matcher import mutual_nn_match

F_BUCKET = 32  # frame-axis padding quantum
# Device bytes of Sinkhorn couplings allowed in flight per chunk: each pair
# holds about 3 [N+1, N+1] fp32 couplings (4096 keypoints: 201 MB a pair,
# so chunks of 7).
HBM_GUARD_BYTES = 1.5e9


def _no_mesh(mesh) -> None:
    if mesh is not None:
        raise NotImplementedError("pair matching over a device mesh is not ported yet "
                                  "(ROADMAP A14): pass mesh=None")


def _pad_frames(x: np.ndarray) -> np.ndarray:
    """Pad axis 0 (frames) to the bucket; padded rows are never gathered."""
    pad = (-x.shape[0]) % F_BUCKET
    if pad == 0:
        return x
    return np.pad(x, [(0, pad)] + [(0, 0)] * (x.ndim - 1))


def _put(arrays: dict, device: torch.device) -> dict:
    return {k: torch.from_numpy(np.ascontiguousarray(_pad_frames(np.asarray(v)))).to(device)
            for k, v in arrays.items()}


def superglue_chunk(n_keypoints: int, pair_chunk: int) -> int:
    """`pair_chunk` capped by HBM_GUARD_BYTES of couplings in flight."""
    per_pair = 3 * 4 * (n_keypoints + 1) ** 2
    return min(pair_chunk, max(1, int(HBM_GUARD_BYTES // per_pair)))


def _run_chunked(fn, pairs: np.ndarray, chunk: int, device: torch.device) -> np.ndarray:
    """fn(ii, jj) -> [chunk, N] matches over the pair axis in fixed-size
    chunks, under torch.inference_mode()."""
    outs = []
    with torch.inference_mode():
        for s in range(0, len(pairs), chunk):
            sel = pairs[s:s + chunk]
            n = len(sel)
            if n < chunk:
                sel = np.concatenate([sel, np.tile(sel[:1], (chunk - n, 1))])
            idx = torch.from_numpy(np.ascontiguousarray(sel, dtype=np.int64)).to(device)
            outs.append(fn(idx[:, 0], idx[:, 1])[:n].cpu().numpy())
    return np.concatenate(outs, axis=0).astype(np.int64)


def make_nn_pair_matcher(
    descriptors: np.ndarray,
    mask: np.ndarray,
    distance_thresh: float = 0.7,
    mesh=None,
    pair_chunk: int = 16,
    device: str | torch.device = "cuda",
):
    """Batched mutual-NN pair matcher over [F, N, C] sequence features."""
    _no_mesh(mesh)
    dev = resolve_device(device)
    feats = _put({"desc": descriptors, "mask": mask}, dev)
    n_kpts = descriptors.shape[1]

    def match(ii, jj):
        d, m = feats["desc"], feats["mask"]
        return mutual_nn_match(d[ii], d[jj], m[ii], m[jj],
                               distance_thresh=distance_thresh)["matches0"]

    def match_pairs(pairs) -> np.ndarray:
        pairs = np.asarray(pairs)
        if len(pairs) == 0:
            return np.zeros((0, n_kpts), np.int64)
        return _run_chunked(match, pairs, pair_chunk, dev)

    return match_pairs


def make_superglue_pair_matcher(
    superglue,
    feats: dict,
    mesh=None,
    pair_chunk: int = 8,
    device: str | torch.device = "cuda",
):
    """Batched SuperGlue pair matcher over extracted sequence features.

    superglue: a `models.superglue.SuperGlue` holding its parameters (load
    them with `models.bridge.superglue_state_dict`); it is moved to the
    device. feats: keypoints [F, N, 2], descriptors [F, N, C], scores
    [F, N], mask [F, N] (numpy) and image_hw (h, w). The GNN and Sinkhorn
    run once per chunk of pairs, `pair_chunk` capped by HBM_GUARD_BYTES."""
    _no_mesh(mesh)
    dev = resolve_device(device)
    superglue.to(dev)
    arrays = _put({"kpts": feats["keypoints"], "desc": feats["descriptors"],
                   "scores": feats["scores"], "mask": feats["mask"]}, dev)
    hw = tuple(int(x) for x in feats["image_hw"])
    n_kpts = np.asarray(feats["keypoints"]).shape[1]
    chunk = superglue_chunk(n_kpts, pair_chunk)

    def match(ii, jj):
        k, d, s, m = (arrays[x] for x in ("kpts", "desc", "scores", "mask"))
        return superglue(k[ii], k[jj], d[ii], d[jj], s[ii], s[jj], hw, hw, m[ii],
                         m[jj])["matches0"]

    def match_pairs(pairs) -> np.ndarray:
        pairs = np.asarray(pairs)
        if len(pairs) == 0:
            return np.zeros((0, n_kpts), np.int64)
        return _run_chunked(match, pairs, chunk, dev)

    match_pairs.chunk = chunk
    return match_pairs
