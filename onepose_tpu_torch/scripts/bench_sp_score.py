"""SuperPoint's score path (softmax -> depth-to-space -> NMS) in several forms, on the card.

Port of `scripts/bench_sp_score.py`, at its shapes (B 8, 64 x 64 cells of
a 512 x 512 image, NMS radius 4), its draws from default_rng(0) (bf16
logits [8, 64, 64, 65], then an fp32 score map [8, 512, 512]) and its
ITERS of 50. The forms are `models.superpoint_variants`':
- the softmax: "dim1" (SuperPoint's), "channels_last", "manual",
  "pad128" (the JAX script's v0, chan-first, manual and pad128);
- the whole path: plain (SuperPoint's default), plain with K1 (its
  `nms_kernel`), and each with the stream synchronized between
  depth-to-space and NMS. That sync stands for the JAX script's
  optimization barrier, which makes XLA materialise the depth-to-space
  before NMS; in eager PyTorch the depth-to-space is always
  materialised, so the barrier has no meaning, and the nearest thing is
  the host waiting for the card there. K1's entry takes the [B, H, W]
  score map, not the 65-channel logits, so no form fuses the softmax and
  depth-to-space in front of it: plain with K1 is the last form;
- NMS alone on the fp32 map: separable (SuperPoint's), one 2-D window a
  pool (the JAX script's nms_2d_window), K1.
The JAX script's path with a bf16 NMS is left out: rounding the scores to
bf16 makes ties, so it keeps other maxima.

Each form is held against its section's first form (the softmax forms
within 1e-6, the path and NMS forms exactly) and timed by CUDA events:
three warm-up calls, then WINDOWS windows of ITERS calls; the median window and
the spread. Prints a line a form, the card's name and power limit, and
last {"bench_sp_score": {"card", "rows"}}; exits 1 if a form is out of
its tolerance or did not launch its kernel.

    python -m onepose_tpu_torch.scripts.bench_sp_score [--device cpu] [--batch B] [--img N]
"""

from __future__ import annotations

import argparse
import sys

import numpy as np
import torch

from onepose_tpu_torch._device import resolve_device
from onepose_tpu_torch.models import superpoint_variants as V
from onepose_tpu_torch.scripts._forms import Form, card, report, run_forms

B, IMG = 8, 512
ITERS, WINDOWS = 50, 5
NMS_RADIUS = 4


def make_inputs(b: int = B, img: int = IMG, device="cuda") -> tuple:
    """(bf16 logits [B, 65, H/8, W/8], fp32 scores [B, H, W]): the JAX
    script's draws from default_rng(0), the logits laid out NCHW as
    SuperPoint's head gives them."""
    rng = np.random.default_rng(0)
    dev = resolve_device(device)
    h = img // 8
    logits = torch.from_numpy(rng.normal(size=(b, h, h, 65)).astype(np.float32))
    scores = torch.from_numpy(rng.random((b, img, img)).astype(np.float32))
    return (logits.to(dev, torch.bfloat16).permute(0, 3, 1, 2).contiguous(), scores.to(dev))


PATHS = (  # label, nms form, sync
    ("plain", "separable", False),
    ("plain + K1", "k1", False),
    ("plain, sync before NMS", "separable", True),
    ("plain + K1, sync before NMS", "k1", True),
)


def build_forms(logits: torch.Tensor, scores: torch.Tensor) -> list:
    forms = []
    for i, form in enumerate(V.SOFTMAX_FORMS):
        forms.append(Form("softmax", form, lambda form=form: V.softmax(logits, form),
                          ref=V.SOFTMAX_FORMS[0] if i else None,
                          tols={"out": (V.SOFTMAX_ABS, False)} if i else {}))
    exact = {"out": (0.0, False)}
    for i, (label, nms_form, sync) in enumerate(PATHS):
        forms.append(Form("path", label, lambda n=nms_form, s=sync: V.score_path(
            logits, NMS_RADIUS, nms_form=n, sync=s), ref=PATHS[0][0] if i else None,
            tols=exact if i else {}, kernels={"nms": 1} if nms_form == "k1" else {}))
    for i, form in enumerate(V.NMS_FORMS):
        forms.append(Form("nms", form, lambda form=form: V.nms(scores, NMS_RADIUS, form),
                          ref=V.NMS_FORMS[0] if i else None, tols=exact if i else {},
                          kernels={"nms": 1} if form == "k1" else {}))
    return forms


def run(device, b: int = B, img: int = IMG, iters: int = ITERS, windows: int = WINDOWS) -> dict:
    dev = resolve_device(device)
    rows = run_forms(build_forms(*make_inputs(b, img, dev)), dev, iters, windows)
    return {"card": card(dev), "shape": [b, img // 8, img // 8, 65], "iters": iters,
            "windows": windows, "rows": rows}


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--device", default="cuda")
    parser.add_argument("--batch", type=int, default=B)
    parser.add_argument("--img", type=int, default=IMG)
    parser.add_argument("--iters", type=int, default=ITERS)
    parser.add_argument("--windows", type=int, default=WINDOWS)
    a = parser.parse_args(argv)
    dev = resolve_device(a.device)
    print(f"card: {card(dev)}; logits [{a.batch}, {a.img // 8}, {a.img // 8}, 65], NMS radius "
          f"{NMS_RADIUS}; {a.windows} windows of {a.iters} calls a form", flush=True)
    return report("bench_sp_score", run(dev, a.batch, a.img, a.iters, a.windows))


if __name__ == "__main__":
    sys.exit(main())
