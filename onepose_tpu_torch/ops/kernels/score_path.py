"""SuperPoint NMS: the CUDA kernels `csrc/score_path.cu` and their plain version.

Replaces onepose_tpu/ops/pallas/score_path.py::simple_nms_pallas (public
`nms`). Bound on the H100: bytes, one read and one write of the [B, H, W]
map (8.4 MB each way at 8 x 512 x 512, about 5 us at 3.35 TB/s).

Two entries of one source, chosen by radius (a route by shape, as JAX's
kernel widens its pad lanes for a large radius):
- radius 0 .. FUSED_MAX_RADIUS: one launch; a block runs all five
  window-max passes of a 64 x 64 tile in shared memory with its 5r halo,
  by log-step window maxima and bit-packed masks;
- any larger radius: the five passes one launch each through device
  memory (`nms_large_launch`), with byte masks.
See the source for both designs.

`nms` launches a kernel on a CUDA tensor and runs `simple_nms` only on a
CPU tensor. When autograd records, it goes through `Nms`, the counterpart
of the JAX package's custom VJP (`nms` there, `_fwd` / `_bwd`): the
forward is the kernel (`simple_nms` on the CPU) on detached scores, the
backward `simple_nms`'s VJP, where(max_mask, g, 0), with the mask
recomputed from the saved scores by the plain version (a kept score of
exactly 0 looks like a suppressed one in the output, so the mask cannot be
read back from it). No kernel launches in the backward.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from onepose_tpu_torch.ops.kernels import _build
from onepose_tpu_torch.ops.kernels._build import SMEM_PER_BLOCK

launches = 0  # kernel launches since the last reset (ops.kernels.reset_launches)
FUSED_MAX_RADIUS = 9  # the 64 x 64 tile and its 5r halo fit shared memory up to here
LARGE_TILE = 32  # output tile side of the large-radius passes


def _max_pool(x: torch.Tensor, r: int) -> torch.Tensor:
    """Separable (2r+1)^2 window max over [B, H, W]; -inf outside."""
    win = 2 * r + 1
    x = F.max_pool2d(x[:, None], (win, 1), stride=1, padding=(r, 0))
    return F.max_pool2d(x, (1, win), stride=1, padding=(0, r))[:, 0]


def simple_nms(scores: torch.Tensor, nms_radius: int) -> torch.Tensor:
    """Iterative max-pool NMS on [B, H, W] score maps (plain PyTorch).

    Port of onepose_tpu/models/superpoint.py::simple_nms: two refinement
    rounds where suppressed neighbourhoods are zeroed and local maxima are
    recomputed."""
    return torch.where(nms_mask(scores, nms_radius), scores, torch.zeros_like(scores))


def nms_mask(scores: torch.Tensor, nms_radius: int) -> torch.Tensor:
    """The pixels `simple_nms` keeps, [B, H, W] bool."""
    if nms_radius < 0:
        raise ValueError("nms_radius must be >= 0")
    zeros = torch.zeros_like(scores)
    max_mask = scores == _max_pool(scores, nms_radius)
    for _ in range(2):
        supp_mask = _max_pool(max_mask.to(scores.dtype), nms_radius) > 0
        supp_scores = torch.where(supp_mask, zeros, scores)
        new_max_mask = supp_scores == _max_pool(supp_scores, nms_radius)
        max_mask = max_mask | (new_max_mask & ~supp_mask)
    return max_mask


def large_smem(h: int, w: int, radius: int) -> int:
    """Shared memory of a large-radius pass block: the row maxima of its 32
    columns over its rows and r above and below, clipped to the image (a
    radius wider than the image acts as one as wide as it)."""
    r = min(radius, max(h, w))
    return min(LARGE_TILE + 2 * r, h) * LARGE_TILE * 4


def nms(scores: torch.Tensor, nms_radius: int = 4) -> torch.Tensor:
    """simple_nms of [B, H, W] fp32 scores: a kernel on CUDA; through `Nms`
    when autograd records."""
    forward = simple_nms if scores.device.type == "cpu" else nms_kernel
    if torch.is_grad_enabled() and scores.requires_grad:
        return Nms.apply(scores, nms_radius, forward)
    return forward(scores, nms_radius)


class Nms(torch.autograd.Function):
    """NMS with a gradient: `forward` (the CUDA kernel on the card,
    `simple_nms` on the CPU) on detached scores; the backward is
    `simple_nms`'s VJP, bit for bit (onepose_tpu/ops/pallas/score_path.py::_bwd).

    apply(scores, nms_radius, forward) -> [B, H, W]."""

    @staticmethod
    def forward(ctx, scores, nms_radius, forward):
        ctx.save_for_backward(scores)
        ctx.nms_radius = nms_radius
        return forward(scores.detach(), nms_radius)

    @staticmethod
    def backward(ctx, g):
        (scores,) = ctx.saved_tensors
        return torch.where(nms_mask(scores, ctx.nms_radius), g, 0.0), None, None


def nms_kernel(scores: torch.Tensor, nms_radius: int = 4) -> torch.Tensor:
    """Launch the CUDA kernel (the fused entry up to FUSED_MAX_RADIUS, the
    large-radius one above) on simple_nms's input."""
    _build.require_cuda_input(scores, "nms scores", 3)
    if nms_radius < 0:
        raise ValueError("nms_radius must be >= 0")
    b, h, w = scores.shape
    out = torch.empty_like(scores)
    lib = _build.load("score_path")
    stream = _build.stream(scores.device)
    P = _build.ptr
    if nms_radius <= FUSED_MAX_RADIUS:
        err = lib.nms_launch(P(scores), P(out), b, h, w, nms_radius, stream)
    else:
        smem = large_smem(h, w, nms_radius)
        if smem > SMEM_PER_BLOCK:
            raise ValueError(f"nms: radius {nms_radius} over {h} rows needs {smem} bytes of "
                             f"shared memory a block, more than {SMEM_PER_BLOCK}")
        maxm = torch.empty((b, h, w), dtype=torch.uint8, device=scores.device)
        supp = torch.empty_like(maxm)
        err = lib.nms_large_launch(P(scores), P(out), P(maxm), P(supp), b, h, w, nms_radius,
                                   smem, stream)
    _build.check(lib, err, "nms kernel")
    global launches
    launches += 1
    return out
