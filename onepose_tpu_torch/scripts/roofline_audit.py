"""Roofline audit of the port's serving pipeline on the card.

Port of `scripts/roofline_audit.py`. For each stage of a `PosePipeline`
call at production shapes (bench's inputs and pipeline, batch 8): the
operations and bytes counted from shapes (`utils.costs`, the stand-in
for XLA's cost_analysis), the measured steady-state time, the bound
t >= max(flops / peak, bytes / bandwidth) and which of the two sets it,
and the resulting MFU and bandwidth utilisation. The peaks are the H100
SXM's published dense rates at 700 W (989 TFLOP/s bf16, 3.35 TB/s);
the card's power limit is printed beside the table. MFU is against the
bf16 peak for every stage: the fp32 geometry stages understate theirs by
this convention.

Each stage's inputs are produced once by the stages upstream. A stage is
timed by CUDA events over TIMED_CALLS dependent calls after a warm-up:
each call's first input is perturbed by 1e-12 x the last output's sum, so
the card can neither skip nor overlap a call. A row measured faster than
its bound fails the run: the count would be wrong.

Prints a markdown table, the stage-sum line and, with --sweep, the whole
call at batches 8, 16, 32 and 64 (which also covers
`scripts/bench_batch_sweep.py`); the last line is one JSON object
{"roofline": {"card", "rows", "stage_sum_ms", "stage_sum_bound_ms",
"mfu", "sweep"}}.

    python -m onepose_tpu_torch.scripts.roofline_audit [--sweep]
"""

from __future__ import annotations

import argparse
import json
import sys

import numpy as np
import torch

from onepose_tpu_torch import bench
from onepose_tpu_torch._device import resolve_device
from onepose_tpu_torch.geometry.ransac import ransac_pnp
from onepose_tpu_torch.models.superpoint import extract_keypoints
from onepose_tpu_torch.runtime.pipeline import PosePipeline
from onepose_tpu_torch.utils import costs
from onepose_tpu_torch.utils.profiling import card_line

TIMED_CALLS = 30
SWEEP = (8, 16, 32, 64)
SWEEP_CALLS = 20
FULL_POWER_W = 700.0  # the power limit the published peaks assume
ROW_KEYS = ("stage", "gflop", "mb", "ms", "bound_ms", "bound_by", "mfu", "bw_util")


def build_stages(pipe: PosePipeline, images, K, anno, generator) -> dict:
    """name -> (fn, args, (flops, bytes)) for the four stages of a call and
    the whole call ("fused_pipeline"); each stage's args are produced once
    by the stages upstream."""
    b, h, w = images.shape[:3]
    n3, n_leaf, c = anno.leaf_desc.shape
    sp, matcher, n_kpts = pipe.superpoint, pipe.matcher, pipe.max_keypoints
    kp = dict(max_keypoints=n_kpts, keypoint_threshold=pipe.keypoint_threshold,
              border=pipe.border)
    dt, heads, blocks, n_hyp = sp.dtype, matcher.num_heads, matcher.num_blocks, \
        pipe.ransac_hypotheses

    def per_frame(x):
        return x[None].expand((b,) + x.shape).contiguous()

    with torch.inference_mode():
        dense = sp(images)
        feats = extract_keypoints(dense["score_map"], dense["descriptor_map"], **kp)
        desc3d, leaves, mask3d, leaf_mask = (per_frame(getattr(anno, k)) for k in (
            "desc3d", "leaf_desc", "mask3d", "leaf_mask"))
        m0 = matcher(feats["descriptors"], desc3d, leaves, feats["mask"], mask3d,
                     leaf_mask)["matches0"]
        idx = m0.clamp(min=0).long()[..., None].expand(-1, -1, 3)
        pts3d = torch.gather(per_frame(anno.points3d), 1, idx)
        corr = m0 >= 0

    return {
        "superpoint_dense": (lambda im: sp(im)["score_map"], (images,),
                             costs.superpoint_dense(b, h, w, dt, c)),
        "extract_keypoints": (lambda sm, dm: extract_keypoints(sm, dm, **kp)["keypoints"],
                              (dense["score_map"], dense["descriptor_map"]),
                              costs.extract_keypoints(b, h, w, n_kpts, c)),
        "gats_spg_matcher": (
            lambda d2, d3, lv: matcher(d2, d3, lv, feats["mask"], mask3d, leaf_mask)["matches0"],
            (feats["descriptors"], desc3d, leaves),
            costs.gats_spg_matcher(b, n_kpts, n3, n_leaf, c, heads, blocks, dt)),
        "ransac_pnp": (
            lambda k2, p3: ransac_pnp(k2, p3, K, corr, generator=generator, n_hyp=n_hyp,
                                      reproj_threshold=pipe.reproj_threshold)["pose"],
            (feats["keypoints"], pts3d), costs.ransac_pnp(b, n_kpts, n_hyp)),
        "fused_pipeline": (lambda im: pipe(im, K, anno, generator=generator)["pose"], (images,),
                           costs.pose_pipeline(b, h, w, n_kpts, n3, n_leaf, c, heads, blocks,
                                               n_hyp, dt)),
    }


def chain(fn, args, calls: int) -> torch.Tensor:
    """`calls` dependent calls of fn: each call's first argument perturbed
    by 1e-12 x (1e-20 x the sum of the output before)."""
    eps = torch.zeros((), device=args[0].device)
    with torch.inference_mode():
        for _ in range(calls):
            out = fn(args[0] + eps.to(args[0].dtype) * 1e-12, *args[1:])
            eps = out.sum().float() * 1e-20
    return eps


def time_stage(fn, args, calls: int = TIMED_CALLS) -> float:
    """Seconds a call on the card: CUDA events over `calls` dependent calls
    after a warm-up call."""
    chain(fn, args, 1)
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    chain(fn, args, calls)
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / 1e3 / calls


def row(stage: str, cost: tuple, seconds: float | None = None) -> dict:
    """One row of the table: the counts, the bound and what sets it; the
    measured ms, MFU and bandwidth utilisation only when timed."""
    flops, n_bytes = cost
    t_bound, by = costs.bound(flops, n_bytes)
    timed = seconds is not None
    return {"stage": stage, "gflop": flops / 1e9, "mb": n_bytes / 1e6,
            "ms": seconds * 1e3 if timed else None, "bound_ms": t_bound * 1e3, "bound_by": by,
            "mfu": flops / seconds / costs.PEAK_BF16_FLOPS if timed else None,
            "bw_util": n_bytes / seconds / costs.PEAK_BYTES_PER_S if timed else None}


def summary(card: str, rows: list, sweep: list) -> dict:
    """The last line's object. stage_sum_* add the four stages (not the
    whole call); mfu is the whole call's."""
    parts = [r for r in rows if r["stage"] != "fused_pipeline"]
    fused = next(r for r in rows if r["stage"] == "fused_pipeline")
    timed = all(r["ms"] is not None for r in parts)
    return {"roofline": {
        "card": card, "rows": rows,
        "stage_sum_ms": sum(r["ms"] for r in parts) if timed else None,
        "stage_sum_bound_ms": sum(r["bound_ms"] for r in parts),
        "mfu": fused["mfu"], "sweep": sweep}}


def power_limit_w(card: str) -> float:
    """The watts of nvidia-smi's "name, power.limit" line."""
    return float(card.rsplit(",", 1)[1].split()[0])


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--sweep", action="store_true",
                        help="also time the whole call at batches " + ", ".join(map(str, SWEEP)))
    args = parser.parse_args(argv)
    dev = resolve_device("cuda")
    torch.manual_seed(0)
    pipe = PosePipeline(max_keypoints=bench.N_KPTS, device=dev)
    images, K, anno = bench.make_inputs(device=dev)
    gen = torch.Generator(device=dev).manual_seed(0)
    card = card_line()
    watts = power_limit_w(card)

    print(f"batch={bench.BATCH} img={bench.IMG} n_kpts={bench.N_KPTS} n3={bench.N_POINTS3D} "
          f"leaf={bench.NUM_LEAF}; {pipe.superpoint.dtype}, kernels on; {TIMED_CALLS} dependent "
          f"calls a stage (CUDA events)")
    print(f"card: {card}; peaks {costs.PEAK_BF16_FLOPS / 1e12:.0f} TFLOP/s bf16, "
          f"{costs.PEAK_BYTES_PER_S / 1e12:.2f} TB/s (H100 SXM, dense)"
          + (f"; the peaks assume {FULL_POWER_W:.0f} W, this card is limited to {watts:.2f} W"
             if watts < FULL_POWER_W else ""))
    print("| stage | GFLOP | MB | measured ms | bound ms | x-of-bound | MFU | BW util |")
    print("|---|---|---|---|---|---|---|---|")
    rows = []
    for name, (fn, fargs, cost) in build_stages(pipe, images, K, anno, gen).items():
        r = row(name, cost, time_stage(fn, fargs))
        rows.append(r)
        print(f"| {name} | {r['gflop']:.2f} | {r['mb']:.1f} | {r['ms']:.3f} "
              f"| {r['bound_ms']:.4f} ({r['bound_by']}) | {r['ms'] / r['bound_ms']:.1f}x "
              f"| {100 * r['mfu']:.2f}% | {100 * r['bw_util']:.2f}% |", flush=True)
    out = summary(card, rows, [])["roofline"]
    b = bench.BATCH
    print(f"stage-sum: measured {out['stage_sum_ms']:.2f} ms ({b / out['stage_sum_ms'] * 1e3:.0f} "
          f"fps), roofline bound {out['stage_sum_bound_ms']:.3f} ms "
          f"({b / out['stage_sum_bound_ms'] * 1e3:.0f} fps speed-of-light); whole call MFU "
          f"{100 * out['mfu']:.2f}%", flush=True)
    under = [r["stage"] for r in rows if r["ms"] < r["bound_ms"]]
    if under:
        raise SystemExit(f"roofline_audit: {under} measured below the bound: the count is wrong")

    sweep = []
    if args.sweep:
        print("\nbatch sweep (the whole call):")
        print("| batch | ms/batch | frames/s | ms/frame |")
        print("|---|---|---|---|")
        rng = np.random.default_rng(1)
        for bsz in SWEEP:
            im = torch.from_numpy(rng.random((bsz, bench.IMG, bench.IMG, 1), np.float32)).to(dev)
            Kb = K[:1].expand(bsz, 3, 3).contiguous()
            t = time_stage(lambda x: pipe(x, Kb, anno, generator=gen)["pose"], (im,),
                           SWEEP_CALLS)
            sweep.append({"batch": bsz, "ms": t * 1e3, "frames_per_s": bsz / t,
                          "ms_per_frame": t * 1e3 / bsz})
            print(f"| {bsz} | {t * 1e3:.2f} | {bsz / t:.1f} | {t * 1e3 / bsz:.3f} |", flush=True)
            del im
    print(json.dumps(summary(card, rows, sweep)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
