"""SuperPoint keypoint detector + descriptor.

Port of onepose_tpu/models/superpoint.py: VGG-style encoder (64, 64, 128,
128 channels, three 2x2 max-pools -> stride 8), a 65-channel detector head
(softmax, dustbin dropped, 8x8 depth-to-space), max-pool NMS, and a
descriptor head L2-normalized per cell; then static-shape keypoint
extraction (`extract_keypoints`): threshold and border gate, two-stage
top-k, bilinear descriptor sampling.

The public layouts are the JAX package's: images [B, H, W, 1] and a
descriptor map [B, H/8, W/8, C]. Convolutions run NCHW inside through
`F.conv2d`, in `dtype` (float32 or bfloat16; parameters stay fp32): the
image is rounded to `dtype` first, the head outputs are promoted to fp32
before the softmax and the descriptor normalisation.

Kernel flags (the JAX package's `nms_pallas` and `use_pallas`):
- nms_kernel: NMS through the CUDA kernel (`ops.kernels.score_path`); the
  depth-to-space before it stays plain;
- vgg_kernel: the four encoder stages through the fused VGG-stage kernel
  (`ops.kernels.vgg_stage`), NHWC, bf16 taps with fp32 sums in any
  `dtype`, as the JAX package computes them; the heads stay plain. The
  kernel's packed weights are kept in a `PackCache` and packed again only
  when a conv parameter changes (`packed_stages`), an optimizer step
  included.

Under autograd both kernels run their forward and take the JAX package's
custom VJPs (`ops.kernels.score_path.Nms`, `ops.kernels.vgg_stage.VggStage`):
with nms_kernel, SuperPoint differentiates with respect to the image and
every parameter in either dtype; with vgg_kernel, stages 1 and 2 (fp32
input) differentiate, and the backward of the later stages, whose input is
the previous stage's bf16 output, raises `TypeError`, as `jax.grad`
through the JAX package's SuperPoint(use_pallas=True) does.

Top-k ties: `jax.lax.top_k` puts the lowest index first and `torch.topk`
does not promise any order, so every top-k here is a stable descending
sort (`topk_lowest_index`).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from onepose_tpu_torch._device import check_compute_dtype
from onepose_tpu_torch.ops.kernels._layout import PackCache
from onepose_tpu_torch.ops.kernels.score_path import nms, simple_nms
from onepose_tpu_torch.ops.kernels.vgg_stage import pack_stage_weights, vgg_stage

__all__ = [
    "SuperPoint",
    "depth_to_space",
    "extract_keypoints",
    "sample_descriptors",
    "score_probs",
    "simple_nms",
    "topk_lowest_index",
]


def topk_lowest_index(x: torch.Tensor, k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Top-k along the last axis with jax.lax.top_k's tie order (equal
    values: lowest index first)."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


class SuperPoint(nn.Module):
    """Dense forward: grayscale [B, H, W, 1] -> score map [B, H, W] (after
    NMS) and descriptor map [B, H/8, W/8, C]. H and W must be multiples of 8."""

    def __init__(
        self,
        descriptor_dim: int = 256,
        nms_radius: int = 4,
        nms_kernel: bool = False,
        dtype: torch.dtype = torch.float32,
        vgg_kernel: bool = False,
    ):
        super().__init__()
        self.dtype = check_compute_dtype(dtype)
        self.nms_radius = nms_radius
        self.nms_kernel = nms_kernel
        self.vgg_kernel = vgg_kernel
        conv = lambda cin, cout, k=3: nn.Conv2d(cin, cout, k, padding=k // 2)  # noqa: E731
        self.conv1a, self.conv1b = conv(1, 64), conv(64, 64)
        self.conv2a, self.conv2b = conv(64, 64), conv(64, 64)
        self.conv3a, self.conv3b = conv(64, 128), conv(128, 128)
        self.conv4a, self.conv4b = conv(128, 128), conv(128, 128)
        self.convPa, self.convPb = conv(128, 256), conv(256, 65, 1)
        self.convDa, self.convDb = conv(128, 256), conv(256, descriptor_dim, 1)
        self._packs = PackCache()

    def _stages(self):
        return (
            (self.conv1a, self.conv1b, True),
            (self.conv2a, self.conv2b, True),
            (self.conv3a, self.conv3b, True),
            (self.conv4a, self.conv4b, False),
        )

    def packed_stages(self) -> list:
        """The four stages' `pack_stage_weights`, from the cache."""

        def hwio(conv):
            return conv.weight.permute(2, 3, 1, 0)

        return [self._packs.get(i, (a.weight, a.bias, b.weight, b.bias),
                                lambda a=a, b=b: pack_stage_weights(hwio(a), a.bias, hwio(b),
                                                                    b.bias))
                for i, (a, b, _) in enumerate(self._stages())]

    def _conv(self, conv: nn.Conv2d, x: torch.Tensor) -> torch.Tensor:
        """The JAX package's nn.Conv(dtype=...): the product rounded to dtype, then the
        bias added in dtype."""
        d = self.dtype
        y = F.conv2d(x.to(d), conv.weight.to(d), padding=conv.padding)
        return y + conv.bias.to(d)[:, None, None]

    def _encoder(self, image: torch.Tensor) -> torch.Tensor:
        """[B, H, W, 1] -> the stride-8 feature map [B, 128, H/8, W/8] in dtype."""
        x = image.to(self.dtype)
        if self.vgg_kernel:
            x = self._kernel_stages(x.float().contiguous(), 4)  # NHWC through the fused stages
            return x.permute(0, 3, 1, 2).to(self.dtype)
        x = x.permute(0, 3, 1, 2)  # NHWC -> NCHW
        for a, b, pool in self._stages():
            x = self._stage(a, b, pool, x)
        return x

    def _kernel_stages(self, x: torch.Tensor, n: int) -> torch.Tensor:
        """The first n encoder stages through the fused VGG-stage kernel
        (`vgg_stage`) on NHWC x; NHWC out, fp32 after the first stage, bf16
        after the others."""
        packed = self.packed_stages() if x.device.type == "cuda" else [None] * 4

        def hwio(conv):
            return conv.weight.permute(2, 3, 1, 0)

        for (a, b, pool), p in zip(self._stages()[:n], packed):
            x = vgg_stage(x, hwio(a), a.bias, hwio(b), b.bias, pool, packed=p)
        return x

    def _stage(self, a: nn.Conv2d, b: nn.Conv2d, pool: bool, x: torch.Tensor) -> torch.Tensor:
        """One plain encoder stage on NCHW x: conv, ReLU, conv, ReLU [, 2 x 2 max-pool]."""
        x = F.relu(self._conv(b, F.relu(self._conv(a, x))))
        return F.max_pool2d(x, 2, 2) if pool else x

    def _logits(self, x: torch.Tensor) -> torch.Tensor:
        """The detector head on the encoder's output: [B, 65, h, w] in dtype."""
        return self._conv(self.convPb, F.relu(self._conv(self.convPa, x)))

    def _nms(self, scores: torch.Tensor) -> torch.Tensor:
        if self.nms_kernel:
            return nms(scores.contiguous(), self.nms_radius)
        return simple_nms(scores, self.nms_radius)

    def _descriptors(self, x: torch.Tensor) -> torch.Tensor:
        """The descriptor head, L2-normalized per cell: [B, h, w, C] fp32."""
        desc = self._conv(self.convDb, F.relu(self._conv(self.convDa, x))).float()
        desc = desc / torch.linalg.vector_norm(desc, dim=1, keepdim=True)
        return desc.permute(0, 2, 3, 1)

    def forward(self, image: torch.Tensor) -> dict:
        x = self._encoder(image)
        scores = self._nms(depth_to_space(score_probs(self._logits(x))))
        return {"score_map": scores, "descriptor_map": self._descriptors(x)}


def score_probs(logits: torch.Tensor) -> torch.Tensor:
    """The detector's softmax in fp32 over the 65 channels of [B, 65, h, w]
    logits, the dustbin dropped: [B, 64, h, w]."""
    return torch.softmax(logits.float(), dim=1)[:, :-1]


def depth_to_space(probs: torch.Tensor) -> torch.Tensor:
    """[B, 64, h, w] -> the full-resolution score map [B, 8h, 8w]: channel
    c = 8 * dy + dx goes to pixel (8y + dy, 8x + dx)."""
    b, _, h, w = probs.shape
    return probs.reshape(b, 8, 8, h, w).permute(0, 3, 1, 4, 2).reshape(b, h * 8, w * 8)


def sample_descriptors(
    keypoints: torch.Tensor, descriptor_map: torch.Tensor, stride: int = 8
) -> torch.Tensor:
    """Bilinear descriptor sampling at keypoint pixels, then L2 normalize.

    keypoints [B, K, 2] (x, y) full-resolution pixels; descriptor_map
    [B, h, w, C]. grid_sample(align_corners=True) semantics through the
    reference's normalization; out-of-range corners read zero."""
    b, hf, wf, c = descriptor_map.shape
    s = float(stride)
    kp = keypoints.to(descriptor_map.dtype) - s / 2 + 0.5
    denom = torch.tensor(
        [wf * s - s / 2 - 0.5, hf * s - s / 2 - 0.5],
        dtype=descriptor_map.dtype, device=descriptor_map.device,
    )
    grid = kp / denom * 2.0 - 1.0
    fx = (grid[..., 0] + 1.0) * 0.5 * (wf - 1)
    fy = (grid[..., 1] + 1.0) * 0.5 * (hf - 1)
    x0, y0 = torch.floor(fx), torch.floor(fy)
    wx, wy = (fx - x0)[..., None], (fy - y0)[..., None]
    x0i, y0i = x0.long(), y0.long()
    flat = descriptor_map.reshape(b, hf * wf, c)

    def gather(yi, xi):
        valid = (xi >= 0) & (xi < wf) & (yi >= 0) & (yi < hf)
        idx = yi.clamp(0, hf - 1) * wf + xi.clamp(0, wf - 1)  # [B, K]
        v = torch.gather(flat, 1, idx[..., None].expand(-1, -1, c))
        return v * valid[..., None].to(v.dtype)

    desc = (
        gather(y0i, x0i) * (1 - wx) * (1 - wy)
        + gather(y0i, x0i + 1) * wx * (1 - wy)
        + gather(y0i + 1, x0i) * (1 - wx) * wy
        + gather(y0i + 1, x0i + 1) * wx * wy
    )
    return desc / torch.linalg.vector_norm(desc, dim=-1, keepdim=True).clamp(min=1e-12)


def _two_stage_top_k(gated: torch.Tensor, k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Top-k over an NMS'd [B, H, W] map via per-block pre-selection: an
    8 x 16 block keeps its best 16 candidates, then the top k of those;
    the flat top-k where the shapes do not tile."""
    b, H, W = gated.shape
    HB, WB, CAND = 8, 16, 16
    if H % HB or W % WB or (H // HB) * (W // WB) * CAND < k:
        return topk_lowest_index(gated.reshape(b, H * W), k)
    nby, nbx = H // HB, W // WB
    blocks = (
        gated.reshape(b, nby, HB, nbx, WB).permute(0, 1, 3, 2, 4).reshape(b, nby * nbx, HB * WB)
    )
    vals, idx_in = topk_lowest_index(blocks, CAND)  # [B, NB, CAND]
    block_id = torch.arange(nby * nbx, device=gated.device)[None, :, None]
    by = (block_id // nbx) * HB + idx_in // WB
    bx = (block_id % nbx) * WB + idx_in % WB
    cand_flat = (by * W + bx).reshape(b, -1)
    top_scores, ci = topk_lowest_index(vals.reshape(b, -1), k)
    return top_scores, torch.gather(cand_flat, 1, ci)


def extract_keypoints(
    score_map: torch.Tensor,
    descriptor_map: torch.Tensor,
    max_keypoints: int = 1024,
    keypoint_threshold: float = 0.005,
    border: int = 4,
    stride: int = 8,
) -> dict:
    """Static-shape keypoint selection from an NMS'd score map.

    Returns dict(keypoints [B, K, 2] float (x, y), scores [B, K],
    descriptors [B, K, C], mask [B, K] bool); invalid slots are zero."""
    b, H, W = score_map.shape
    ys = torch.arange(H, device=score_map.device)[None, :, None]
    xs = torch.arange(W, device=score_map.device)[None, None, :]
    in_border = (ys >= border) & (ys < H - border) & (xs >= border) & (xs < W - border)
    gated = torch.where(in_border & (score_map > keypoint_threshold), score_map, 0.0)
    top_scores, top_idx = _two_stage_top_k(gated, max_keypoints)
    keypoints = torch.stack([(top_idx % W).float(), (top_idx // W).float()], dim=-1)
    mask = top_scores > keypoint_threshold
    descriptors = sample_descriptors(keypoints, descriptor_map, stride)
    return {
        "keypoints": torch.where(mask[..., None], keypoints, 0.0),
        "scores": torch.where(mask, top_scores, 0.0),
        "descriptors": descriptors * mask[..., None],
        "mask": mask,
    }
