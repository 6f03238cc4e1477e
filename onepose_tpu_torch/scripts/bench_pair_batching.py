"""The batched SfM pair matchers against the serial per-pair loop on the card.

Port of `scripts/bench_pair_batching.py`. The reference matches
covisibility pairs one at a time (src/sfm/match_features.py:45-85);
`parallel/sfm_parallel.py` stacks pairs into fixed chunks. At the demo's
keypoint budget (N 1024 keypoints, P 64 pairs over F 16 frames of
256-d descriptors, 512 x 512 images, the JAX script's default_rng(0)
features and pair roster):
- mutual-NN: the serial loop of `mutual_nn_match` against
  `make_nn_pair_matcher` at chunks 8, 16 and 32;
- SuperGlue (fp32, random weights from seed 0, match_threshold 0: with
  random weights no match clears the shipped 0.2, and the equality below
  would hold vacuously): the serial loop, one pair a call, against
  `make_superglue_pair_matcher` at chunks 4 and 8 (2 and 4 from N 4096).
  Its log_sinkhorn runs K6 (K7 above the resident kernel's width) once a
  call: P launches serially, one a chunk batched.
Each matcher runs once on the first 8 pairs (a warm-up), then on all P
pairs, timed by the host clock (the rows come back to the host, which
waits for the card); the kernel launches of that run are counted. The
batched matches must equal the serial ones, as the JAX script asserts.

Prints the JAX script's lines, the card's name and power limit, and last
{"pair_batching": {"card", "n_kpts", "n_pairs", "rows"}}.

    python -m onepose_tpu_torch.scripts.bench_pair_batching [n_kpts] [n_pairs]
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np
import torch

from onepose_tpu_torch._device import resolve_device
from onepose_tpu_torch.models.nn_matcher import mutual_nn_match
from onepose_tpu_torch.models.superglue import SuperGlue
from onepose_tpu_torch.ops.kernels import launch_counts, reset_launches
from onepose_tpu_torch.parallel.sfm_parallel import (
    make_nn_pair_matcher,
    make_superglue_pair_matcher,
)
from onepose_tpu_torch.utils.profiling import card_line

F, C = 16, 256  # frames, descriptor dim
HW = (512, 512)
DISTANCE_THRESH = 0.7
MATCH_THRESHOLD = 0.0


def make_features(n: int, n_pairs: int, frames: int = F, c: int = C) -> tuple:
    """(feats, pairs): the JAX script's features (default_rng(0), in its
    order) and its pair roster (i % F, (i + 1 + i // F) % F)."""
    rng = np.random.default_rng(0)
    desc = rng.normal(size=(frames, n, c)).astype(np.float32)
    desc /= np.linalg.norm(desc, axis=-1, keepdims=True)
    feats = {
        "keypoints": rng.uniform(0, 511, size=(frames, n, 2)).astype(np.float32),
        "descriptors": desc,
        "scores": rng.random((frames, n)).astype(np.float32),
        "mask": np.ones((frames, n), bool),
        "image_hw": HW,
    }
    pairs = np.asarray([(i % frames, (i + 1 + i // frames) % frames) for i in range(n_pairs)])
    return feats, pairs


def nn_serial(feats: dict, device):
    """The per-pair loop of mutual_nn_match: match(pairs) -> [P, N]."""
    desc = torch.from_numpy(feats["descriptors"]).to(device)
    mask = torch.from_numpy(feats["mask"]).to(device)

    def match(pairs):
        with torch.inference_mode():
            return np.stack([mutual_nn_match(desc[i], desc[j], mask[i], mask[j],
                                             distance_thresh=DISTANCE_THRESH)["matches0"]
                             .cpu().numpy() for i, j in pairs]).astype(np.int64)

    return match


def superglue_serial(sg: SuperGlue, feats: dict, device):
    """The per-pair loop of SuperGlue, one pair a call: match(pairs) -> [P, N]."""
    k, d, s, m = (torch.from_numpy(np.asarray(feats[x])).to(device)
                  for x in ("keypoints", "descriptors", "scores", "mask"))
    sg.to(device).eval()

    def match(pairs):
        with torch.inference_mode():
            return np.stack([sg(k[i:i + 1], k[j:j + 1], d[i:i + 1], d[j:j + 1], s[i:i + 1],
                                s[j:j + 1], HW, HW, m[i:i + 1], m[j:j + 1])["matches0"][0]
                             .cpu().numpy() for i, j in pairs]).astype(np.int64)

    return match


def make_matchers(feats: dict, device) -> list:
    """(label, match, reference label or None) of every row, in the JAX
    script's order."""
    n = feats["descriptors"].shape[1]
    torch.manual_seed(0)
    sg = SuperGlue(match_threshold=MATCH_THRESHOLD)
    rows = [("NN serial (per-pair dispatch)", nn_serial(feats, device), None)]
    rows += [(f"NN batched chunk={c}", make_nn_pair_matcher(
        feats["descriptors"], feats["mask"], DISTANCE_THRESH, pair_chunk=c, device=device),
        "NN serial (per-pair dispatch)") for c in (8, 16, 32)]
    rows.append(("SuperGlue serial (per-pair)", superglue_serial(sg, feats, device), None))
    rows += [(f"SuperGlue batched chunk={c}", make_superglue_pair_matcher(
        sg, feats, pair_chunk=c, device=device), "SuperGlue serial (per-pair)")
        for c in ((2, 4) if n >= 4096 else (4, 8))]
    return rows


def timed(match, pairs) -> tuple:
    """(rows [P, N], seconds, launches): a warm-up on the first 8 pairs,
    then every pair, its kernel launches counted."""
    match(pairs[:8])
    torch.cuda.synchronize()
    reset_launches()
    t0 = time.perf_counter()
    out = match(pairs)
    dt = time.perf_counter() - t0
    return out, dt, {k: v for k, v in launch_counts().items() if v}


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("n_kpts", nargs="?", type=int, default=1024)
    parser.add_argument("n_pairs", nargs="?", type=int, default=64)
    args = parser.parse_args(argv)
    dev = resolve_device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    feats, pairs = make_features(args.n_kpts, args.n_pairs)
    card = card_line()
    print(f"card: {card}; N={args.n_kpts} P={args.n_pairs} F={F} C={C}; fp32, TF32 off; "
          f"SuperGlue match_threshold {MATCH_THRESHOLD}", flush=True)
    rows, outs = [], {}
    for label, match, ref in make_matchers(feats, dev):
        out, dt, launches = timed(match, pairs)
        outs[label] = out
        equal = None if ref is None else bool((out == outs[ref]).all())
        rows.append({"label": label, "ms_per_pair": dt * 1e3 / len(pairs),
                     "pairs_per_s": len(pairs) / dt, "launches": launches,
                     "matches": int((out >= 0).sum()), "equal_to_serial": equal})
        print(f"{label:34s} {dt * 1e3 / len(pairs):8.2f} ms/pair ({len(pairs) / dt:7.1f} "
              f"pairs/s)  launches {launches}  {rows[-1]['matches']} matches"
              + ("" if ref is None else f"  equal to serial: {equal}"), flush=True)
        if equal is False:
            rows_off = int((out != outs[ref]).any(axis=1).sum())
            raise SystemExit(f"bench_pair_batching: {label} differs from {ref} on {rows_off} "
                             f"of {len(pairs)} pairs")
    print(json.dumps({"pair_batching": {"card": card, "n_kpts": args.n_kpts,
                                        "n_pairs": args.n_pairs, "rows": rows}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
