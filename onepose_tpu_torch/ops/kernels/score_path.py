"""SuperPoint NMS: the CUDA kernel `csrc/score_path.cu` and its plain version.

Replaces onepose_tpu/ops/pallas/score_path.py::simple_nms_pallas (public
`nms`). Bound on the H100: bytes, one read and one write of the [B, H, W]
map (8.4 MB each way at 8 x 512 x 512, about 5 us at 3.35 TB/s). The
kernel runs all five window-max passes of an image tile in shared memory
with a 5r halo, in one launch; see the source for the design.

`nms` launches the kernel on a CUDA tensor and runs `simple_nms` only on a
CPU tensor. Forward-only: a CUDA input that requires grad raises.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from onepose_tpu_torch.ops.kernels import _build

launches = 0  # kernel launches since the last reset (ops.kernels.reset_launches)


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
    if nms_radius < 0:
        raise ValueError("nms_radius must be >= 0")
    zeros = torch.zeros_like(scores)
    max_mask = scores == _max_pool(scores, nms_radius)
    for _ in range(2):
        supp_mask = _max_pool(max_mask.to(scores.dtype), nms_radius) > 0
        supp_scores = torch.where(supp_mask, zeros, scores)
        new_max_mask = supp_scores == _max_pool(supp_scores, nms_radius)
        max_mask = max_mask | (new_max_mask & ~supp_mask)
    return torch.where(max_mask, scores, zeros)


def nms(scores: torch.Tensor, nms_radius: int = 4) -> torch.Tensor:
    """simple_nms of [B, H, W] fp32 scores: the kernel on CUDA."""
    if scores.device.type == "cpu":
        return simple_nms(scores, nms_radius)
    _build.require_cuda_input(scores, "nms scores", 3)
    if not 0 <= nms_radius <= 9:  # the tile + 5r halo must fit shared memory
        raise ValueError(f"nms kernel supports radius 0..9, got {nms_radius}")
    b, h, w = scores.shape
    out = torch.empty_like(scores)
    lib = _build.load("score_path")
    err = lib.nms_launch(
        _build.ptr(scores), _build.ptr(out), b, h, w, nms_radius,
        _build.stream(scores.device),
    )
    _build.check(lib, err, "nms kernel")
    global launches
    launches += 1
    return out
