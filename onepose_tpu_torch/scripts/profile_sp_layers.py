"""SuperPoint's dense forward layer by layer on the card, by prefix differencing.

Port of `scripts/profile_sp_layers.py`: time the prefix of the score path
that ends after each layer and report each layer's marginal ms in
context, at [8, 512, 512, 1] in bf16 (random weights from seed 0, the
image from default_rng(0)). A prefix runs SuperPoint's own modules and
arithmetic (`prefix_steps`), so the last one is `SuperPoint`'s score map;
the descriptor head is not on it, as in the JAX script. Two stacks:
- "layers": the plain convolutions (cuDNN), one row a layer: conv1a, ...,
  convPa, then convPb with the softmax, depth-to-space and NMS (K1);
- "stages": the encoder through K5, one row a fused stage (conv pair,
  ReLU, pool), then convPa and convPb+score (K1).
Each prefix is timed by CUDA events over ITERS dependent calls after a
warm-up (each call's image perturbed by one element of the last output:
reading the whole map would add a layer's worth of traffic). A layer's MFU
is its operations (`utils.costs`' convolution count) over its marginal
time at the H100's bf16 peak (`utils.costs.PEAK_BF16_FLOPS`, 989 TFLOP/s
at 700 W), with the card's power limit printed beside it.

Prints a table and last {"sp_layers": {"card", "rows", "launches"}}
(launches: the kernels launched in the whole run, K1 and K5).

    python -m onepose_tpu_torch.scripts.profile_sp_layers
"""

from __future__ import annotations

import argparse
import json
import sys

import numpy as np
import torch
import torch.nn.functional as F

from onepose_tpu_torch._device import resolve_device
from onepose_tpu_torch.models.superpoint import SuperPoint, depth_to_space, score_probs
from onepose_tpu_torch.ops.kernels import launch_counts, reset_launches
from onepose_tpu_torch.ops.kernels.vgg_stage import vgg_stage
from onepose_tpu_torch.scripts.roofline_audit import time_stage
from onepose_tpu_torch.utils import costs
from onepose_tpu_torch.utils.profiling import card_line

B, IMG = 8, 512
ITERS = 50


def make_image(b: int = B, img: int = IMG, device="cuda") -> torch.Tensor:
    rng = np.random.default_rng(0)
    return torch.from_numpy(rng.random((b, img, img, 1)).astype(np.float32)).to(
        resolve_device(device))


def _score(sp: SuperPoint, x: torch.Tensor) -> torch.Tensor:
    """convPb, the softmax without the dustbin, depth-to-space and NMS:
    SuperPoint.forward's score path on convPa's output."""
    return sp._nms(depth_to_space(score_probs(sp._conv(sp.convPb, x))))


def prefix_steps(sp: SuperPoint) -> list:
    """(name, fn) steps of the score path, each fn mapping the output of the
    step before (the first takes the image [B, H, W, 1]): the plain
    layers, or K5's stages when sp.vgg_kernel."""
    relu = F.relu

    def conv(c):
        return lambda x: relu(sp._conv(c, x))

    def pool(x):
        return F.max_pool2d(x, 2, 2)

    if not sp.vgg_kernel:
        steps = [("conv1a", lambda x: relu(sp._conv(sp.conv1a, x.to(sp.dtype).permute(0, 3, 1,
                                                                                      2))))]
        steps += [("conv1b", conv(sp.conv1b)), ("pool1", pool), ("conv2a", conv(sp.conv2a)),
                  ("conv2b", conv(sp.conv2b)), ("pool2", pool), ("conv3a", conv(sp.conv3a)),
                  ("conv3b", conv(sp.conv3b)), ("pool3", pool), ("conv4a", conv(sp.conv4a)),
                  ("conv4b", conv(sp.conv4b)), ("convPa", conv(sp.convPa))]
    else:
        def stage(i):
            a, b, pooled = sp._stages()[i]
            packed = sp.packed_stages()[i] if sp.conv1a.weight.is_cuda else None

            def hwio(c):
                return c.weight.permute(2, 3, 1, 0)

            return lambda x: vgg_stage(x, hwio(a), a.bias, hwio(b), b.bias, pooled,
                                       packed=packed)

        first = stage(0)
        steps = [("stage1 (K5)", lambda x: first(x.to(sp.dtype).float().contiguous()))]
        steps += [(f"stage{i + 1} (K5)", stage(i)) for i in range(1, 4)]
        steps.append(("convPa", lambda x: relu(sp._conv(sp.convPa,
                                                        x.permute(0, 3, 1, 2).to(sp.dtype)))))
    steps.append(("convPb+score(NMS)", lambda x: _score(sp, x)))
    return steps


def first(x: torch.Tensor) -> torch.Tensor:
    """x's first element (a view: nothing read beyond it)."""
    return x[(0,) * x.dim()]


def prefix(steps: list, n: int):
    """The first n steps as one function of the image."""
    def fn(image):
        x = image
        for _, step in steps[:n]:
            x = step(x)
        return x

    return fn


def layer_flops(b: int, h: int, w: int, vgg_kernel: bool) -> list:
    """Operations of each row of prefix_steps (pools and the score's
    softmax counted as 0), from `costs._conv`."""
    def conv(s, k, cin, cout):
        return costs._conv(b * (h >> s) * (w >> s), k, cin, cout)[0]

    enc = [conv(0, 3, 1, 64), conv(0, 3, 64, 64), 0, conv(1, 3, 64, 64), conv(1, 3, 64, 64), 0,
           conv(2, 3, 64, 128), conv(2, 3, 128, 128), 0, conv(3, 3, 128, 128),
           conv(3, 3, 128, 128)]
    if vgg_kernel:
        enc = [enc[0] + enc[1], enc[3] + enc[4], enc[6] + enc[7], enc[9] + enc[10]]
    return enc + [conv(3, 3, 128, 256), conv(3, 1, 256, 65)]


def make_superpoint(vgg_kernel: bool, device) -> SuperPoint:
    torch.manual_seed(0)
    return SuperPoint(nms_kernel=True, vgg_kernel=vgg_kernel, dtype=torch.bfloat16).to(
        device).eval()


def main(argv=None) -> int:
    argparse.ArgumentParser(description=__doc__.splitlines()[0]).parse_args(argv)
    dev = resolve_device("cuda")
    image = make_image(device=dev)
    card = card_line()
    print(f"card: {card}; [{B}, {IMG}, {IMG}, 1] bf16; {ITERS} dependent calls a prefix (CUDA "
          f"events); MFU against {costs.PEAK_BF16_FLOPS / 1e12:.0f} TFLOP/s bf16 (H100 SXM, "
          f"dense, 700 W)", flush=True)
    rows = []
    reset_launches()
    for stack, vgg in (("layers", False), ("stages", True)):
        steps = prefix_steps(make_superpoint(vgg, dev))
        flops = layer_flops(B, IMG, IMG, vgg)
        prev = 0.0
        for n, ((name, _), fl) in enumerate(zip(steps, flops), start=1):
            ms = time_stage(lambda im, p=prefix(steps, n): first(p(im)), (image,), ITERS) * 1e3
            marg = ms - prev
            mfu = fl / (marg * 1e-3) / costs.PEAK_BF16_FLOPS if marg > 0 else None
            rows.append({"stack": stack, "layer": name, "prefix_ms": ms, "marginal_ms": marg,
                         "gflop": fl / 1e9, "mfu": mfu})
            print(f"{stack:6s} {name:18s} prefix {ms:7.3f} ms   marginal {marg:7.3f} ms   "
                  f"{fl / 1e9:6.1f} GF  MFU "
                  + ("-" if mfu is None else f"{100 * mfu:5.1f}%"), flush=True)
            prev = ms
    launches = {k: v for k, v in launch_counts().items() if v}
    print(json.dumps({"sp_layers": {"card": card, "rows": rows, "launches": launches}}),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
