"""Mapping cells: the port's SuperGlue over a scan's covisible pairs, in
the chunks the port's pair matcher runs.

Set-up asks the port's chunking (`superglue_chunk`) how many pairs a
chunk holds at the configuration's keypoints and pair budget, makes the
weights and the scan on the card from the seed
(`judges.superglue_pairs.weights_for`, `scenes.scan`: the frames'
features come from the reference SuperPoint, so the matcher's inputs are
the benchmark's own), builds SuperGlue as the configuration states it,
and warms up the chunk shape. The window calls `SuperGlue.forward` on the
chunks in order, cycling through the pair list, indexing the features as
`make_superglue_pair_matcher` does, and brings each chunk's matches0 to
the host; it ends with the first chunk to end after `seconds`. The rate
counts the real pairs (not a last chunk's padding) over the whole window.
`forward` is timed, not `match_pairs`, because it returns the
log-assignment the judge compares.

With trace, the window is `harness.traced_window`'s: `profile_calls`
chunks traced on the card alone, as many on the card and the host, then
`seconds` of chunks with CUDA-event spans around `SuperGlue.similarity`
(the GNN) and the superglue module's `log_sinkhorn`, wrapped for this
run only.

`CONTROLS` and `FAULTS` are for `calibrate.py` alone: the control takes
the program's place in the judged outputs, and a fault breaks the timed
path underneath while the window runs.
"""

from __future__ import annotations

import contextlib
import itertools
import random
import time

import torch

from portbench import counts, harness, scenes, weights
from portbench.judges import superglue_pairs as judge
from portbench.reference import nets

# The control: the reference with TF32 products, the next precision below fp32.
CONTROLS = {"tf32": nets.tf32_round}


@contextlib.contextmanager
def _half_iterations(sg):
    """K7 stopped after half of the configuration's Sinkhorn iterations."""
    full = sg.sinkhorn_iterations
    sg.sinkhorn_iterations = full // 2
    try:
        yield
    finally:
        sg.sinkhorn_iterations = full


@contextlib.contextmanager
def _last_layer_dropped(sg):
    """The GNN's last cross layer adds nothing (its message is zero)."""
    h = getattr(sg, f"cross_{sg.num_layers - 1}").register_forward_hook(
        lambda mod, args, out: torch.zeros_like(out))
    try:
        yield
    finally:
        h.remove()


FAULTS = {"sinkhorn_half_iterations": _half_iterations,
          "gnn_last_cross_layer_dropped": _last_layer_dropped}


def _chunk(cfg: dict) -> int:
    """Pairs a chunk, as the port's pair matcher cuts them."""
    from onepose_tpu_torch.parallel.sfm_parallel import superglue_chunk

    return superglue_chunk(cfg["max_keypoints"], cfg["pair_chunk_asked"])


def _program(cfg: dict, w: dict, device):
    from onepose_tpu_torch.models.superglue import SuperGlue

    sg = SuperGlue(d_model=cfg["d_model"], num_heads=cfg["num_heads"],
                   num_layers=cfg["num_layers"], keypoint_encoder=tuple(cfg["keypoint_encoder"]),
                   sinkhorn_iterations=cfg["sinkhorn_iterations"],
                   match_threshold=cfg["match_threshold"], dtype=getattr(torch, cfg["dtype"]))
    sg.load_state_dict(w)
    return sg.to(device).eval()


def _work(cfg: dict, scan: dict, chunk: int) -> dict:
    """Counts of one chunk at the scan's mean valid keypoints a frame."""
    n = float(scan["feats"]["mask"].float().sum(-1).mean())
    gnn = counts.superglue_gnn(chunk, n, n, cfg["d_model"], cfg["num_heads"], cfg["num_layers"],
                               tuple(cfg["keypoint_encoder"]))
    sk = counts.sinkhorn(chunk, n, n, cfg["sinkhorn_iterations"])
    return {"call": gnn + sk, "gnn": gnn, "sinkhorn_stream": sk}


def run(cell: harness.Cell, device, t0: float, control=None, fault=None) -> dict:
    cfg, tr = cell.cfg, cell.traffic
    chunk = _chunk(cfg)
    with harness.matmul_precision(torch, False):
        sp = weights.superpoint(cfg, scenes.sub_seed(cell.seed, "superpoint"), device)
        scan = scenes.scan(sp, cfg, tr, cell.seed, device, chunk)
        w = judge.weights_for(cfg, cell.seed, device)
    del sp
    sg = _program(cfg, w, device)
    del w
    broken = contextlib.ExitStack()
    if fault is not None:
        broken.enter_context(fault(sg))
    f, hw, chunks = scan["feats"], scan["image_hw"], scan["chunks"]
    k, d, s, m = (f[x] for x in ("keypoints", "descriptors", "scores", "mask"))

    count, pairs = itertools.count(), [0]

    def step():
        j = next(count) % len(chunks)
        ii, jj, real = chunks[j]
        with torch.inference_mode():
            out = sg(k[ii], k[jj], d[ii], d[jj], s[ii], s[jj], hw, hw, m[ii], m[jj])
        out["matches0"].cpu()
        pairs[0] += real
        reservoir.offer((j, out))

    reservoir = harness.Reservoir(0, random.Random(0))  # keeps no warm-up output
    for _ in range(2):
        step()
    harness.sync(torch, device)
    reservoir = harness.Reservoir(tr["sample_calls"], random.Random(scenes.sub_seed(cell.seed,
                                                                                    "sample")))
    pairs[0] = 0
    setup_s = time.perf_counter() - t0
    result = {}
    if not cell.trace:
        _, window = harness.closed_loop(step, cell.seconds)
        result["metrics"] = {"map_pairs_per_s": (pairs[0] / window, "pairs/s"),
                             "setup_s": (setup_s, "s")}
    else:
        from onepose_tpu_torch.models import superglue as sg_mod

        spans = harness.Spans(torch)
        sink = sg_mod.log_sinkhorn
        sg.similarity = spans.mark("gnn", sg.similarity)
        sg_mod.log_sinkhorn = spans.mark("sinkhorn", sink)
        try:
            result["trace"], result["breakdown"], _ = harness.traced_window(
                torch, step, tr["profile_calls"], cell.seconds, spans, ("gnn", "sinkhorn"),
                lambda: _work(cfg, scan, chunk))
        finally:
            sg_mod.log_sinkhorn = sink
            del sg.similarity
    broken.close()
    result["attempted"] = pairs[0]
    result["failed"] = 0
    result["memory_peak"] = harness.peak_memory(torch, device)

    items = reservoir.items
    del sg
    if device.type == "cuda":
        torch.cuda.empty_cache()
    w = judge.weights_for(cfg, cell.seed, device)
    with harness.matmul_precision(torch, False):
        if control is not None:
            items = [(ci, judge.control_outputs(cfg, w, f, hw, chunks[ci], control))
                     for ci, _ in items]
        read, stats = judge.judge(cfg, scan, items, w)
    result["readings"] = read
    result["stats"] = {**stats, "pair_chunk": chunk, "pairs_in_scan": len(scan["pairs"]),
                       "keypoints_mean": float(m.float().sum(-1).mean())}
    return result
