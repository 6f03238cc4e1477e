"""Where SuperPoint's time goes on the card: the encoder, the whole dense forward and NMS apart.

Port of `scripts/profile_superpoint_parts.py`, at [8, 512, 512, 1] (the
image from default_rng(0), random weights from seed 0), each part with
its kernel on and off:
- the encoder alone (bf16): K5's four fused stages, or the plain convs;
- the whole dense forward (bf16; score and descriptor maps): K5 and K1,
  or neither;
- simple_nms at radius 4 on an fp32 [8, 512, 512] score map: K1, or the
  plain max-pool NMS;
- the whole dense forward in fp32: K1, or the plain NMS (K5 computes bf16
  taps, so the fp32 forward keeps the plain convs, as the serving fp32
  path does).
Each row is timed by CUDA events over ITERS dependent calls after a
warm-up (each call's input perturbed by one element of the last output,
as the JAX script reads one), and the kernel launches of one call are
counted.

Prints the JAX script's lines, the card's name and power limit, and last
{"superpoint_parts": {"card", "rows"}}.

    python -m onepose_tpu_torch.scripts.profile_superpoint_parts
"""

from __future__ import annotations

import argparse
import json
import sys

import numpy as np
import torch

from onepose_tpu_torch._device import resolve_device
from onepose_tpu_torch.models.superpoint import SuperPoint
from onepose_tpu_torch.ops.kernels import launch_counts, reset_launches
from onepose_tpu_torch.ops.kernels.score_path import nms, simple_nms
from onepose_tpu_torch.scripts.profile_sp_layers import first
from onepose_tpu_torch.scripts.roofline_audit import chain, time_stage
from onepose_tpu_torch.utils.profiling import card_line

B, IMG = 8, 512
ITERS = 30
NMS_RADIUS = 4


def make_inputs(b: int = B, img: int = IMG, device="cuda") -> tuple:
    """(images [B, H, W, 1], scores [B, H, W]): the JAX script's draws
    from default_rng(0), in its order."""
    rng = np.random.default_rng(0)
    dev = resolve_device(device)
    images = torch.from_numpy(rng.random((b, img, img, 1), np.float32)).to(dev)
    scores = torch.from_numpy(rng.random((b, img, img), np.float32)).to(dev)
    return images, scores


def build_parts(images, scores) -> list:
    """(label, fn, input) of every row, kernel on before kernel off."""
    dev = images.device

    def sp(dtype, kernels: bool, vgg: bool):
        torch.manual_seed(0)
        return SuperPoint(nms_kernel=kernels, vgg_kernel=kernels and vgg, dtype=dtype).to(
            dev).eval()

    rows = []
    for on in (True, False):
        tag = "K5" if on else "plain convs"
        enc = sp(torch.bfloat16, on, True)
        rows.append((f"encoder only (bf16, {tag})", lambda x, m=enc: first(m._encoder(x)),
                     images))
    for on in (True, False):
        tag = "K5 + K1" if on else "plain"
        full = sp(torch.bfloat16, on, True)
        rows.append((f"full dense fwd (bf16, {tag})", lambda x, m=full: _dense(m(x)), images))
    rows.append(("simple_nms r=4 (fp32, K1)", lambda s: first(nms(s, NMS_RADIUS)), scores))
    rows.append(("simple_nms r=4 (fp32, plain)", lambda s: first(simple_nms(s, NMS_RADIUS)),
                 scores))
    for on in (True, False):
        tag = "K1" if on else "plain"
        full = sp(torch.float32, on, False)
        rows.append((f"full dense fwd (fp32, {tag})", lambda x, m=full: _dense(m(x)), images))
    return rows


def _dense(out: dict) -> torch.Tensor:
    """Both maps in one tensor's sum (the chain's next perturbation)."""
    return out["score_map"][:, 0, 0] + out["descriptor_map"][:, 0, 0, 0]


def main(argv=None) -> int:
    argparse.ArgumentParser(description=__doc__.splitlines()[0]).parse_args(argv)
    dev = resolve_device("cuda")
    images, scores = make_inputs(device=dev)
    card = card_line()
    print(f"card: {card}; [{B}, {IMG}, {IMG}, 1]; {ITERS} dependent calls a row (CUDA events); "
          f"PyTorch's TF32 defaults, as the serving path runs", flush=True)
    rows = []
    for label, fn, x in build_parts(images, scores):
        chain(fn, (x,), 1)
        torch.cuda.synchronize()
        reset_launches()
        chain(fn, (x,), 1)
        torch.cuda.synchronize()
        launches = {k: v for k, v in launch_counts().items() if v}
        ms = time_stage(fn, (x,), ITERS) * 1e3
        rows.append({"part": label, "ms": ms, "launches": launches})
        print(f"{label + ':':34s} {ms:7.3f} ms/iter  launches {launches}", flush=True)
    print(json.dumps({"superpoint_parts": {"card": card, "rows": rows}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
