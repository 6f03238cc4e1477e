"""SuperPoint's whole dense forward with each front-end form, on the card.

Port of `scripts/bench_sp_variants.py`, at its shapes (B 8, 512 x 512) and
its image from default_rng(0); SuperPoint's weights from seed 0. The JAX
script times its dense forward with (a) an optimization barrier between
depth-to-space and NMS and (b) an im2col-9 input conv. Here
`models.superpoint_variants.dense_forward` runs, in fp32 and in bf16,
every combination of
- the encoder: "cudnn" (SuperPoint's), "pad8" and "im2col" (those input
  convs, then the plain convs) and, in bf16 only (K5 computes bf16 taps),
  "k5": the four stages in the VGG-stage kernel (`vgg_kernel`);
- NMS: "separable" (the plain version) or "k1" (`nms_kernel`);
- sync: whether the stream is synchronized between depth-to-space and
  NMS. This stands for the barrier, which has no meaning in eager
  PyTorch: the depth-to-space is always materialised before NMS, so the
  nearest thing is the host waiting for the card there;
and each encoder and NMS once more with the softmax over the
channels-last view (the fastest softmax form of `bench_sp_score`).
The kernel flags off are cudnn + separable, on are k1 (fp32) and k5 + k1
(bf16), as `PosePipeline` sets them.

Each form is held against its dtype's default (cudnn, separable, the dim1
softmax, no sync): exactly (score map at radius 4 and descriptors) where
the encoder and the softmax are the default's, else at NMS radius 0
within `superpoint_variants.dense_tolerances` (NMS then picks among
near-ties, which a rounding difference flips). Timed by CUDA events:
three warm-up calls, then WINDOWS windows of ITERS calls (20: an fp32
forward with TF32 off takes about 27 ms on the card); the median window
and the spread. TF32 is off. Prints a line a form, the fastest form of
each dtype with the kernel flags off and with them on, the card's name
and power limit, and last {"bench_sp_variants": {"card", "rows",
"fastest"}}; exits 1 if a form is out of its tolerance or did not launch
its kernels.

    python -m onepose_tpu_torch.scripts.bench_sp_variants [--device cpu] [--batch B] [--img N]
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
ITERS, WINDOWS = 20, 5
DTYPES = {"fp32": torch.float32, "bf16": torch.bfloat16}


def make_image(b: int = B, img: int = IMG, device="cuda") -> torch.Tensor:
    rng = np.random.default_rng(0)
    return torch.from_numpy(rng.random((b, img, img, 1)).astype(np.float32)).to(
        resolve_device(device))


def make_superpoint(dtype: torch.dtype, device) -> SuperPoint:
    torch.manual_seed(0)
    return SuperPoint(dtype=dtype).to(device).eval()


def forms_of(dtype: torch.dtype) -> list:
    """(encoder, nms, softmax, sync) of every form of a dtype, the default first."""
    encoders = V.CONV1A_FORMS + (("k5",) if dtype == torch.bfloat16 else ())
    nms = ("separable", "k1")
    return ([(e, n, "dim1", s) for e in encoders for n in nms for s in (False, True)]
            + [(e, n, "channels_last", False) for e in encoders for n in nms])


def label(tag: str, encoder: str, nms: str, softmax: str, sync: bool) -> str:
    return (f"{tag} encoder={encoder} nms={nms}"
            + ("" if softmax == "dim1" else f" softmax={softmax}") + (" sync" if sync else ""))


def flags(dtype: torch.dtype, encoder: str, nms: str) -> str | None:
    """"on" for PosePipeline's kernel flags (K1 in fp32; K5 and K1 in bf16),
    "off" for none, None for a mix."""
    if nms == "k1" and (dtype == torch.float32 or encoder == "k5"):
        return "on"
    return "off" if nms != "k1" and encoder != "k5" else None


def build_forms(image: torch.Tensor, dtypes=DTYPES) -> list:
    forms = []
    for tag, dtype in dtypes.items():
        sp = make_superpoint(dtype, image.device)
        default = None
        for encoder, nms, softmax, sync in forms_of(dtype):
            kw = dict(encoder_form=encoder, nms_form=nms, sync=sync, softmax_form=softmax)

            def out(kw=kw, sp=sp):
                r4 = V.dense_forward(sp, image, **kw)
                raw = V.dense_forward(sp, image, radius=0, **kw)["score_map"]
                return {**r4, "raw_score_map": raw}

            if encoder == "cudnn" and softmax == "dim1":
                tols = {"score_map": (0.0, False), "descriptor_map": (0.0, False)}
            else:
                tols = V.dense_tolerances(dtype)
            kernels = {**({"vgg_stage": 4} if encoder == "k5" else {}),
                       **({"nms": 1} if nms == "k1" else {})}
            name = label(tag, encoder, nms, softmax, sync)
            forms.append(Form(tag, name, lambda kw=kw, sp=sp: V.dense_forward(sp, image, **kw),
                              ref=default, tols=tols if default else {}, out=out,
                              kernels=kernels))
            default = default or name
    return forms


def fastest(rows: list, dtypes=DTYPES) -> dict:
    """{dtype: {"off": label, "on": label}}: the fastest form with the
    kernel flags off and with them on."""
    best = {}
    for tag, dtype in dtypes.items():
        mine = [r for r in rows if r["section"] == tag]
        for r, (e, n, _, _) in zip(mine, forms_of(dtype)):
            f = flags(dtype, e, n)
            if f and (f not in best.setdefault(tag, {}) or r["ms"] < best[tag][f]["ms"]):
                best[tag][f] = r
    return {tag: {f: r["form"] for f, r in b.items()} for tag, b in best.items()}


def run(device, b: int = B, img: int = IMG, iters: int = ITERS, windows: int = WINDOWS) -> dict:
    dev = resolve_device(device)
    rows = run_forms(build_forms(make_image(b, img, dev)), dev, iters, windows)
    return {"card": card(dev), "shape": [b, img, img, 1], "iters": iters, "windows": windows,
            "rows": rows, "fastest": fastest(rows)}


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
    result = run(dev, a.batch, a.img, a.iters, a.windows)
    for tag, best in result["fastest"].items():
        print(f"fastest {tag}: kernel flags off {best['off']!r}, on {best['on']!r}", flush=True)
    return report("bench_sp_variants", result)


if __name__ == "__main__":
    sys.exit(main())
