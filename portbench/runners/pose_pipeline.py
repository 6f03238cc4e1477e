"""Serving cells: the port's `PosePipeline` over frame batches, in a
closed loop of one client.

Set-up makes the weights and the traffic on the card from the seed
(`judges.pose_pipeline.weights_for`, `scenes.serve_pool`), builds the
pipeline as the configuration states it, loads the weights and warms up
every batch of the pool (the only shapes the window uses). The window
calls `PosePipeline.__call__` on the pool's batches in turn; each call is
timed from its launch until its pose and inlier counts are on the host,
as `infer` takes them. The window ends with the first call to end after
`seconds`; the rate counts every frame of every call over the whole
window. A reservoir keeps a sample of the calls' outputs, with the
matcher blocks' outputs (x2, x3) that the call hands to the head, for
the judge.

With trace, the window is `harness.traced_window`'s: `profile_calls`
calls traced on the card alone, as many on the card and the host, then
`seconds` of calls with CUDA-event spans around SuperPoint and the
matcher (forward hooks), and around `extract_keypoints` and `ransac_pnp`
(the pipeline module's attributes, wrapped for this run only).

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

from portbench import counts, harness, scenes
from portbench.judges import pose_pipeline as judge
from portbench.reference import nets

# The control: the reference at the next precision below the configuration's.
CONTROLS = {"fp8": nets.fp8_round}


@contextlib.contextmanager
def _k4_fault(pipe, kind: str):
    """K4 (`fused_gats_block`) broken in the matcher: "skip" hands the last
    block's inputs on unchanged, "half" halves every block's update."""
    from onepose_tpu_torch.models import gats_spg

    real, calls, n = gats_spg.fused_gats_block, itertools.count(), pipe.matcher.num_blocks

    def broken(x2, x3, *a, **k):
        y2, y3 = real(x2, x3, *a, **k)
        last = next(calls) % n == n - 1
        if kind == "skip" and last:
            return x2.to(y2.dtype), x3.to(y3.dtype)
        if kind == "half":
            return ((x2 + 0.5 * (y2.float() - x2)).to(y2.dtype),
                    (x3 + 0.5 * (y3.float() - x3)).to(y3.dtype))
        return y2, y3

    gats_spg.fused_gats_block = broken
    try:
        yield
    finally:
        gats_spg.fused_gats_block = real


FAULTS = {"k4_last_block_skipped": lambda pipe: _k4_fault(pipe, "skip"),
          "k4_update_halved": lambda pipe: _k4_fault(pipe, "half")}


def _program(cfg: dict, sp: dict, gs: dict, device):
    from onepose_tpu_torch.runtime.pipeline import PosePipeline

    pipe = PosePipeline(
        max_keypoints=cfg["max_keypoints"], keypoint_threshold=cfg["keypoint_threshold"],
        border=cfg["border"], nms_radius=cfg["nms_radius"],
        ransac_hypotheses=cfg["ransac_hypotheses"], reproj_threshold=cfg["reproj_threshold"],
        compute_dtype=getattr(torch, cfg["dtype"]), kernels=cfg["kernels"], device=device)
    m = pipe.matcher
    shipped = (m.num_blocks, m.num_heads, m.scale_factor, m.match_threshold)
    if shipped != (cfg["num_blocks"], cfg["num_heads"], cfg["scale_factor"],
                   cfg["match_threshold"]):
        raise RuntimeError(f"the pipeline's matcher {shipped} is not the configuration's")
    pipe.superpoint.load_state_dict(sp)
    pipe.matcher.load_state_dict(gs)
    return pipe


def _work(cfg: dict, tr: dict, stats: dict, n2: float) -> dict:
    """Counts of one call at the traffic's valid sizes."""
    b, img = tr["batch"], cfg["image_size"]
    n3 = sum(stats["valid_points"]) / len(stats["valid_points"])
    leaves = sum(stats["valid_leaves"]) / max(sum(stats["valid_points"]), 1)
    flops, n_bytes = counts.pose_pipeline(b, img, img, cfg["max_keypoints"], n3, leaves,
                                          cfg["d_model"], cfg["num_heads"], cfg["num_blocks"],
                                          cfg["ransac_hypotheses"])
    return {"call": counts.Work(flops, 0, n_bytes),
            "vgg_stage": counts.vgg_stages(b, img, img),
            "gats_block": counts.gats_blocks(b, n2, n3, leaves, cfg["d_model"],
                                             cfg["num_heads"], cfg["num_blocks"])}


def run(cell: harness.Cell, device, t0: float, control=None, fault=None) -> dict:
    """One run of the cell; see the module's docstring. Returns the
    harness's fields: attempted, failed, metrics or trace, checks, memory."""
    cfg, tr = cell.cfg, cell.traffic
    with harness.matmul_precision(torch, False):
        sp, gs = judge.weights_for(cfg, cell.seed, device)
        scene = scenes.serve_pool(sp, cfg, tr, cell.seed, device)
    pool = scene["batches"]
    pipe = _program(cfg, sp, gs, device)
    del sp, gs
    from onepose_tpu_torch.runtime import pipeline as rt

    annos = [rt.ObjectAnnotation(**b["anno"]) for b in pool]
    captured = {}
    gnn = pipe.matcher._gnn

    def keep_gnn(*a, **k):
        captured["x"] = gnn(*a, **k)
        return captured["x"]

    pipe.matcher._gnn = keep_gnn
    broken = contextlib.ExitStack()
    if fault is not None:
        broken.enter_context(fault(pipe))

    count = itertools.count()

    def step():
        i = next(count)
        b = pool[i % len(pool)]
        out = pipe(b["images"], b["K"], annos[i % len(pool)], draws=b["draws"])
        out["pose"].cpu(), out["num_inliers"].cpu()
        reservoir.offer((i % len(pool), out, captured["x"]))

    reservoir = harness.Reservoir(0, random.Random(0))  # keeps no warm-up output
    for _ in range(len(pool) + 1):  # every batch of the pool, then one more
        step()
    harness.sync(torch, device)
    reservoir = harness.Reservoir(tr["sample_calls"], random.Random(scenes.sub_seed(cell.seed,
                                                                                    "sample")))
    setup_s = time.perf_counter() - t0
    result = {}
    if not cell.trace:
        lat, window = harness.closed_loop(step, cell.seconds)
        result["metrics"] = {
            "serve_frames_per_s": (len(lat) * tr["batch"] / window, "frames/s"),
            "serve_call_p95_ms": (harness.percentile(lat, 95) * 1e3, "ms"),
            "setup_s": (setup_s, "s")}
        result["attempted"] = len(lat)
    else:
        spans = harness.Spans(torch)
        hooks = spans.hooks("superpoint", pipe.superpoint) + spans.hooks("matcher", pipe.matcher)
        ext, pnp = rt.extract_keypoints, rt.ransac_pnp
        rt.extract_keypoints = spans.mark("extract", ext)
        rt.ransac_pnp = spans.mark("ransac", pnp, host=True)

        def work():
            n2 = float(reservoir.items[0][1]["kpt_mask"].float().sum(-1).mean())
            return _work(cfg, tr, scene["stats"], n2)

        try:
            result["trace"], result["breakdown"], result["attempted"] = harness.traced_window(
                torch, step, tr["profile_calls"], cell.seconds, spans, ("extract", "ransac"),
                work)
        finally:
            rt.extract_keypoints, rt.ransac_pnp = ext, pnp
            for h in hooks:
                h.remove()
    broken.close()
    result["failed"] = 0
    result["memory_peak"] = harness.peak_memory(torch, device)

    items = reservoir.items
    del pipe, annos, captured
    if device.type == "cuda":
        torch.cuda.empty_cache()
    with harness.matmul_precision(torch, False):
        sp, gs = judge.weights_for(cfg, cell.seed, device)
        if control is not None:
            items = [(pi, *judge.control_outputs(cfg, sp, gs, pool[pi], control))
                     for pi, _, _ in items]
        read, stats = judge.judge(cfg, pool, items, sp, gs)
    result["readings"], result["stats"] = read, {**stats, **scene["stats"]}
    return result

