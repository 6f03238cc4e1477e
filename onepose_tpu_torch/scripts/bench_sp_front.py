"""SuperPoint's input conv and score path, each in several forms, on the card.

Port of `scripts/bench_sp_front.py`, at its shapes (B 8, 512 x 512
images, 64 x 64 cells) and with its draws from default_rng(0): the image,
the input conv's weight (scale 0.3) and bias, bf16 logits [8, 64, 64, 65],
an fp32 score map [8, 512, 512] and probabilities [8, 64, 64, 64]. The
forms are `models.superpoint_variants`'; the rest of SuperPoint's weights
come from seed 0. Sections:
- conv1a, bf16 (1 -> 64, bias, ReLU): "cudnn" (SuperPoint's), "pad8",
  "im2col" (the JAX script's im2col-9 matmul);
- stage1, bf16 (conv1a, conv1b, pool): the three conv1a forms, and "k5",
  the input conv folded into the VGG-stage kernel's first stage (K5 takes
  the single-channel input as it stands);
- score path: the softmax alone, then with depth-to-space, then with NMS
  at radius 4 (separable, and K1);
- NMS alone on the fp32 map (separable, K1);
- depth-to-space alone (permute, pixel_shuffle, conv_transpose).
The JAX script's NMS on a bf16 map is left out: rounding the scores to
bf16 makes ties, so it keeps other maxima (it is not a form of the same
computation).

Each form is held against its section's first form within the tolerance
`models.superpoint_variants` states, and timed by CUDA events: three
warm-up calls, then WINDOWS windows of ITERS calls; the median window and the
spread. TF32 is off. Prints a line a form, the card's name and power
limit, and last {"bench_sp_front": {"card", "rows"}}; exits 1 if a form
is out of its tolerance or did not launch its kernel.

    python -m onepose_tpu_torch.scripts.bench_sp_front [--device cpu] [--batch B] [--img N]
"""

from __future__ import annotations

import argparse
import sys

import numpy as np
import torch

from onepose_tpu_torch._device import resolve_device
from onepose_tpu_torch.models import superpoint_variants as V
from onepose_tpu_torch.models.superpoint import SuperPoint
from onepose_tpu_torch.scripts._forms import Form, card, report, run_forms

B, IMG = 8, 512
ITERS, WINDOWS = 50, 5
NMS_RADIUS = 4


def make_inputs(b: int = B, img: int = IMG, device="cuda") -> dict:
    """The JAX script's draws from default_rng(0), in its order; logits and
    probabilities NCHW, as SuperPoint's head gives them."""
    rng = np.random.default_rng(0)
    dev = resolve_device(device)
    h = img // 8

    def t(x, dtype=torch.float32):
        return torch.from_numpy(np.asarray(x, np.float32)).to(dev, dtype)

    image = t(rng.random((b, img, img, 1)))
    w = t(rng.normal(scale=0.3, size=(3, 3, 1, 64)))
    bias = t(rng.normal(size=(64,)))
    logits = t(rng.normal(size=(b, h, h, 65)), torch.bfloat16)
    scores = t(rng.random((b, img, img)))
    probs = t(rng.random((b, h, h, 64)))
    return dict(image=image, w=w, bias=bias,
                logits=logits.permute(0, 3, 1, 2).contiguous(), scores=scores,
                probs=probs.permute(0, 3, 1, 2).contiguous())


def make_superpoint(inputs: dict) -> SuperPoint:
    """A bf16 SuperPoint from seed 0 with the script's input conv."""
    torch.manual_seed(0)
    sp = SuperPoint(dtype=torch.bfloat16).to(inputs["image"].device).eval()
    with torch.no_grad():
        sp.conv1a.weight.copy_(inputs["w"].permute(3, 2, 0, 1))
        sp.conv1a.bias.copy_(inputs["bias"])
    return sp


def build_forms(inputs: dict, sp: SuperPoint) -> list:
    image, logits, scores, probs = (inputs[k] for k in ("image", "logits", "scores", "probs"))
    enc_tol = {"out": V.encoder_tolerance(sp.dtype)}
    forms = []
    for section, fn, names in (("conv1a", V.conv1a, V.CONV1A_FORMS),
                               ("stage1", V.stage1, V.STAGE1_FORMS)):
        for i, form in enumerate(names):
            forms.append(Form(section, form, lambda fn=fn, form=form: fn(sp, image, form),
                              ref=names[0] if i else None, tols=enc_tol if i else {},
                              kernels={"vgg_stage": 1} if form == "k5" else {}))
    r = NMS_RADIUS
    exact = {"out": (0.0, False)}
    forms += [
        Form("score path", "softmax", lambda: V.softmax(logits)),
        Form("score path", "softmax + d2s", lambda: V.depth_to_space(V.softmax(logits))),
        Form("score path", "softmax + d2s + NMS (separable)", lambda: V.score_path(logits, r)),
        Form("score path", "softmax + d2s + NMS (K1)",
             lambda: V.score_path(logits, r, nms_form="k1"),
             ref="softmax + d2s + NMS (separable)", tols=exact, kernels={"nms": 1}),
        Form("nms", "separable", lambda: V.nms(scores, r)),
        Form("nms", "k1", lambda: V.nms(scores, r, "k1"), ref="separable", tols=exact,
             kernels={"nms": 1}),
    ]
    for i, form in enumerate(V.D2S_FORMS):
        forms.append(Form("depth_to_space", form, lambda form=form: V.depth_to_space(probs, form),
                          ref=V.D2S_FORMS[0] if i else None,
                          tols={"out": V.d2s_tolerance(form)} if i else {}))
    return forms


def run(device, b: int = B, img: int = IMG, iters: int = ITERS, windows: int = WINDOWS) -> dict:
    dev = resolve_device(device)
    inputs = make_inputs(b, img, dev)
    rows = run_forms(build_forms(inputs, make_superpoint(inputs)), dev, iters, windows)
    return {"card": card(dev), "shape": [b, img, img, 1], "iters": iters, "windows": windows,
            "rows": rows}


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--device", default="cuda")
    parser.add_argument("--batch", type=int, default=B)
    parser.add_argument("--img", type=int, default=IMG)
    parser.add_argument("--iters", type=int, default=ITERS)
    parser.add_argument("--windows", type=int, default=WINDOWS)
    a = parser.parse_args(argv)
    dev = resolve_device(a.device)
    print(f"card: {card(dev)}; [{a.batch}, {a.img}, {a.img}, 1]; {a.windows} windows of "
          f"{a.iters} calls a form, TF32 off", flush=True)
    return report("bench_sp_front", run(dev, a.batch, a.img, a.iters, a.windows))


if __name__ == "__main__":
    sys.exit(main())
