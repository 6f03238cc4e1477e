"""A/B bench on the card: the matcher's mixed-precision attention against pinned fp32.

Port of `scripts/bench_mixed_attention.py`. In the bf16 serving matcher
the attention's q, k and v are upcast to fp32 before the attention
einsums (`models/common.py`'s MultiHeadAttention); `mixed_attention=True`
keeps those operands bf16 with fp32 accumulation, while the elu + 1
feature map and the linear attention's normaliser stay fp32. It needs
the unfused blocks (`models/gats_spg.py`), so both sides here run
GATsSPG(dtype=bf16, mixed_attention=False / True) without K4, with the
fused dual-softmax head (K3), behind the serving SuperPoint (bf16, K1 and
K5).

The whole pipeline at bench.py's shapes and inputs (`bench.make_inputs`:
batch 8, 512 x 512, 1000 keypoints, 2000 x 8 points, 512 hypotheses),
weights from seed 0, the same for both sides: frames/s of ITERS dependent
calls (bench.py's chain, RANSAC draws from a CUDA generator) by the host
clock, after a warm-up call; then one call of each on identical inputs
and injected draws: the matches' agreement and the largest pose
difference. The JAX script's decision rule is printed, not applied: flip
the serving default only if frames/s improves and the matches agree on
more than 99.9%.

Prints the JAX script's lines, the card's name and power limit, and last
{"mixed_attention": {"card", "rows", "speedup", "match_agreement",
"max_pose_delta", "flip"}}.

    python -m onepose_tpu_torch.scripts.bench_mixed_attention
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import torch

from onepose_tpu_torch import bench
from onepose_tpu_torch._device import resolve_device
from onepose_tpu_torch.models.gats_spg import GATsSPG
from onepose_tpu_torch.ops.kernels import launch_counts, reset_launches
from onepose_tpu_torch.runtime.pipeline import PosePipeline
from onepose_tpu_torch.utils.profiling import card_line

ITERS = 30
AGREE = 0.999  # the JAX script's decision rule


def make_pipelines(device, max_keypoints: int = bench.N_KPTS) -> dict:
    """{mixed: PosePipeline} for mixed False and True: the serving SuperPoint
    and GATsSPG(dtype=bf16, mixed_attention=mixed, fused_match=True), one
    set of weights from seed 0."""
    torch.manual_seed(0)
    pipes = {}
    for mixed in (False, True):
        matcher = GATsSPG(dtype=torch.bfloat16, mixed_attention=mixed, fused_match=True)
        pipes[mixed] = PosePipeline(matcher=matcher, max_keypoints=max_keypoints, device=device)
    pipes[True].superpoint.load_state_dict(pipes[False].superpoint.state_dict())
    pipes[True].matcher.load_state_dict(pipes[False].matcher.state_dict())
    return pipes


def compare(a: dict, b: dict) -> tuple:
    """(matches0 agreement, largest pose difference) of two outputs."""
    agree = float((a["matches0"] == b["matches0"]).float().mean())
    return agree, float((a["pose"] - b["pose"]).abs().max())


def main(argv=None) -> int:
    argparse.ArgumentParser(description=__doc__.splitlines()[0]).parse_args(argv)
    dev = resolve_device("cuda")
    images, K, anno = bench.make_inputs(device=dev)
    pipes = make_pipelines(dev)
    gen = torch.Generator(device=dev).manual_seed(0)
    card = card_line()
    print(f"card: {card}; batch={bench.BATCH} img={bench.IMG} n_kpts={bench.N_KPTS} "
          f"n3={bench.N_POINTS3D} leaf={bench.NUM_LEAF}; {ITERS} dependent calls a side (host "
          f"clock)", flush=True)
    rows = {}
    for mixed, pipe in pipes.items():
        x, _ = bench.dependent_calls(pipe, images, images, K, anno, gen, 1)
        torch.cuda.synchronize()
        reset_launches()
        x, _ = bench.dependent_calls(pipe, x, images, K, anno, gen, 1)
        torch.cuda.synchronize()
        launches = {k: v for k, v in launch_counts().items() if v}
        t0 = time.perf_counter()
        bench.dependent_calls(pipe, x, images, K, anno, gen, ITERS)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        fps = bench.BATCH * ITERS / dt
        rows[mixed] = {"mixed": mixed, "frames_per_s": fps, "ms_per_call": dt / ITERS * 1e3,
                       "launches": launches}
        print(f"mixed={mixed}:  {fps:7.1f} fps  ({dt / ITERS * 1e3:.2f} ms/batch-{bench.BATCH})"
              f"  launches {launches}", flush=True)
    draws = torch.rand((images.shape[0], pipes[False].ransac_hypotheses, 3), generator=gen,
                       device=dev)
    outs = {m: p(images, K, anno, draws=draws) for m, p in pipes.items()}
    agree, dpose = compare(outs[False], outs[True])
    speedup = rows[True]["frames_per_s"] / rows[False]["frames_per_s"]
    flip = speedup > 1.0 and agree > AGREE
    print(f"speedup {speedup:.3f}x   match agreement {agree:.5f}   max pose delta "
          f"{dpose:.2e}", flush=True)
    print(f"decision rule (flip the serving default only if frames/s improves and matches "
          f"agree > {AGREE:.1%}): {'would flip' if flip else 'keep'}; no default is changed "
          f"here", flush=True)
    print(json.dumps({"mixed_attention": {
        "card": card, "rows": list(rows.values()), "speedup": speedup,
        "match_agreement": agree, "max_pose_delta": dpose, "flip": flip}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
