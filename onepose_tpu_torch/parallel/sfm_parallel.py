"""Batched pair matching for the `map` front end.

Port of onepose_tpu/parallel/sfm_parallel.py on one device. Pairs of frames
have no interaction, so matching runs over fixed-size chunks of pairs: the
sequence's features go to the device once (the frame axis padded to a
bucket of 32), each chunk of pairs is gathered on the device, and only the
pair indices go up and the [chunk, N] match rows come down. The last chunk
is padded by repeating its first pair, and its extra rows are dropped.

Each `make_*` function returns `match_pairs(pairs) -> np.ndarray [P, N]
int64` (-1 unmatched), the callable that the SfM mapping consumes. With a
`mesh` (`parallel.mesh`; `resolve_sfm_mesh` turns the `data_parallel`
config value into one over the ranks), every rank holds the features and
walks the same chunks; a chunk (rounded up to divide the data axis) is
split over the data axis, each rank matches its pairs (K6 or K7 on the
card, for SuperGlue), and the match rows are all-gathered, so every rank
returns every row.
Entry points run on CUDA unless the caller passes device="cpu".
"""

from __future__ import annotations

import numpy as np
import torch

from onepose_tpu_torch._device import resolve_device
from onepose_tpu_torch.models.nn_matcher import mutual_nn_match
from onepose_tpu_torch.parallel.mesh import DATA_AXIS, batch_sharding, gather, make_mesh, shard
from onepose_tpu_torch.utils import comm

F_BUCKET = 32  # frame-axis padding quantum
# Device bytes of Sinkhorn couplings allowed in flight per chunk: each pair
# holds about 3 [N+1, N+1] fp32 couplings (4096 keypoints: 201 MB a pair,
# so chunks of 7).
HBM_GUARD_BYTES = 1.5e9
# LightGlue's assignment holds three [N+1, N+1] fp32 buffers a pair at once
# (the scores and the two log-softmaxes that sum into them).
LIGHTGLUE_ASSIGN_BUFFERS = 3


def resolve_sfm_mesh(data_parallel, device: str | torch.device = "cuda"):
    """The SfM front end's mesh for the `data_parallel` config value, over
    the ranks of the process group as the JAX package resolves it over its
    devices: False / None -> none; True -> every rank; an int -> that many,
    clamped to [1, world]. One rank gives no mesh. A count between 1 and
    the world raises: a mesh must hold every rank (a rank left out would
    walk the roster alone and wait on collectives that never come)."""
    if not data_parallel:
        return None
    world = comm.get_world_size()
    n = world if data_parallel is True else int(data_parallel)
    n = max(1, min(n, world))
    if n == 1:
        return None
    if n != world:
        raise ValueError(f"data_parallel={data_parallel!r} would build a mesh of {n} of the "
                         f"{world} ranks: a mesh must span every rank (pass true or {world})")
    return make_mesh(n_data=n, n_points=1, device=device)


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


def lightglue_chunk(n_keypoints: int, pair_chunk: int) -> int:
    """`pair_chunk` capped by HBM_GUARD_BYTES of LightGlue's assignment
    buffers in flight (4096 keypoints: 201 MB a pair, so chunks of 7)."""
    per_pair = LIGHTGLUE_ASSIGN_BUFFERS * 4 * (n_keypoints + 1) ** 2
    return min(pair_chunk, max(1, int(HBM_GUARD_BYTES // per_pair)))


def _chunk_size(pair_chunk: int, mesh) -> int:
    """The chunk rounded up so that it divides the data axis."""
    if mesh is None:
        return pair_chunk
    n = mesh.axis_size(DATA_AXIS)
    return max(pair_chunk, -(-pair_chunk // n) * n)


def _run_chunked(fn, pairs: np.ndarray, chunk: int, device: torch.device,
                 mesh=None) -> np.ndarray:
    """fn(ii, jj) -> [chunk, N] matches over the pair axis in fixed-size
    chunks, under torch.inference_mode(); with a mesh, each rank runs its
    share of a chunk and the rows are all-gathered."""
    outs = []
    with torch.inference_mode():
        for s in range(0, len(pairs), chunk):
            sel = pairs[s:s + chunk]
            n = len(sel)
            if n < chunk:
                sel = np.concatenate([sel, np.tile(sel[:1], (chunk - n, 1))])
            idx = torch.from_numpy(np.ascontiguousarray(sel, dtype=np.int64)).to(device)
            if mesh is None:
                rows = fn(idx[:, 0], idx[:, 1])
            else:
                spec = batch_sharding(mesh, 2)
                idx = shard(mesh, idx, spec)
                rows = gather(mesh, fn(idx[:, 0], idx[:, 1]), spec)
            outs.append(rows[:n].cpu().numpy())
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
    dev = resolve_device(device)
    chunk = _chunk_size(pair_chunk, mesh)
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
        return _run_chunked(match, pairs, chunk, dev, mesh)

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
    run once per chunk of pairs, `pair_chunk` capped by HBM_GUARD_BYTES (per
    rank: a mesh's chunk holds that many pairs on each rank)."""
    dev = resolve_device(device)
    superglue.to(dev)
    arrays = _put({"kpts": feats["keypoints"], "desc": feats["descriptors"],
                   "scores": feats["scores"], "mask": feats["mask"]}, dev)
    hw = tuple(int(x) for x in feats["image_hw"])
    n_kpts = np.asarray(feats["keypoints"]).shape[1]
    n_data = 1 if mesh is None else mesh.axis_size(DATA_AXIS)
    chunk = _chunk_size(min(pair_chunk, superglue_chunk(n_kpts, pair_chunk) * n_data), mesh)

    def match(ii, jj):
        k, d, s, m = (arrays[x] for x in ("kpts", "desc", "scores", "mask"))
        return superglue(k[ii], k[jj], d[ii], d[jj], s[ii], s[jj], hw, hw, m[ii],
                         m[jj])["matches0"]

    def match_pairs(pairs) -> np.ndarray:
        pairs = np.asarray(pairs)
        if len(pairs) == 0:
            return np.zeros((0, n_kpts), np.int64)
        return _run_chunked(match, pairs, chunk, dev, mesh)

    match_pairs.chunk = chunk
    return match_pairs


def make_lightglue_pair_matcher(
    lightglue,
    feats: dict,
    mesh=None,
    pair_chunk: int = 8,
    device: str | torch.device = "cuda",
):
    """Batched LightGlue pair matcher over extracted sequence features.

    lightglue: a `models.lightglue.LightGlue` holding its parameters
    (`cli.common.load_lightglue_params`); it is moved to the device.
    feats as `make_superglue_pair_matcher`'s (scores unused). A chunk's
    pairs run together, each stopping and pruning on its own
    (`LightGlue.forward`), `pair_chunk` capped by `lightglue_chunk` (per
    rank over a mesh)."""
    dev = resolve_device(device)
    lightglue.to(dev)
    arrays = _put({"kpts": feats["keypoints"], "desc": feats["descriptors"],
                   "mask": feats["mask"]}, dev)
    h, w = (int(x) for x in feats["image_hw"])
    n_kpts = np.asarray(feats["keypoints"]).shape[1]
    n_data = 1 if mesh is None else mesh.axis_size(DATA_AXIS)
    chunk = _chunk_size(min(pair_chunk, lightglue_chunk(n_kpts, pair_chunk) * n_data), mesh)

    def match(ii, jj):
        k, d, m = (arrays[x] for x in ("kpts", "desc", "mask"))
        return lightglue(k[ii], k[jj], d[ii], d[jj], m[ii], m[jj], (w, h), (w, h))["matches0"]

    def match_pairs(pairs) -> np.ndarray:
        pairs = np.asarray(pairs)
        if len(pairs) == 0:
            return np.zeros((0, n_kpts), np.int64)
        return _run_chunked(match, pairs, chunk, dev, mesh)

    match_pairs.chunk = chunk
    return match_pairs
