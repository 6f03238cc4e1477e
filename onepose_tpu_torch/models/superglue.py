"""SuperGlue 2D-2D matcher with masked log-space Sinkhorn.

Port of onepose_tpu/models/superglue.py: keypoints normalised by image
size, a keypoint MLP encoder [3 -> 32 -> 64 -> 128 -> 256 -> 256] (folded
batch norm) added to the descriptors, `num_layers` (self, cross) pairs of
softmax attentional propagation (one layer serves both images), a final
projection, scores <d0, d1> / sqrt(d_model), log-space Sinkhorn with a
learned dustbin score, then mutual max and threshold.

Padded keypoints (mask False) carry no transport mass and take no part in
attention. Modules carry the JAX names (`kenc`, `self_{i}`, `cross_{i}`,
`final_proj`, the scalar `bin_score`), so `models.bridge.superglue_state_dict`
maps JAX parameters one to one.

dtype (float32, what `map` runs, or bfloat16) rounds the layers as
`models.common.Dense` does. The scores enter Sinkhorn in fp32 in every
dtype: the Sinkhorn kernels take fp32, where the JAX package's bf16 model
runs its scan in bf16.

Sinkhorn routing (`log_sinkhorn`): sinkhorn_kernel False runs the plain
scan on any device; None (the default) or True runs the resident kernel
(`ops.kernels.sinkhorn`, K6) when the coupling fits the card's shared
memory (`fits_smem`) and the streamed kernel (`ops.kernels.sinkhorn_stream`,
K7) above it, with a bf16-stored coupling when `stream_bf16` is set, on
the device's own SM count. Rows wider than K7's widest instantiation
(`sinkhorn.max_columns`) take the plain scan on any device when neither a
kernel (sinkhorn_kernel True) nor bf16 storage was asked for, as the JAX
package takes its scan above its guard only in its default mode; asked
for, they go to K7's wide entries (its cluster entry up to 8 x 14848
columns, its two-sweep entry above), as the JAX package runs its streamed
kernel there. Each wrapper runs its plain version for CPU tensors.

Attention routing (`attention_kernel`, each softmax `MultiHeadAttention`'s
flag, `models.common.softmax_attention_kernel`): None (the default) runs
the 36 attention calls of a 9-layer forward on K8
(`ops.kernels.flash_attention`) when the tensors are on CUDA, and the
plain route on the CPU; True asks for K8 (its plain version on the CPU),
False forces the plain route. The routes differ only where an image has
no valid keypoint (K8 zeroes the messages, the plain route averages v),
and every coupling of such a pair is NEG_INF or a dustbin, so the outputs
do not see the messages there.

`SuperGlue.forward`'s spans (`utils.profiling.span`): `superglue.gnn`
(`similarity`, holding its `attention.softmax` spans, 4 a layer),
`superglue.sinkhorn` (`log_sinkhorn`), `superglue.extract`
(`extract_matches`).
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from onepose_tpu_torch._device import check_compute_dtype
from onepose_tpu_torch.models.common import NEG_INF, AttentionalPropagation, Dense, PointMLP
from onepose_tpu_torch.ops.kernels import _build, sinkhorn, sinkhorn_stream
from onepose_tpu_torch.utils.profiling import span


def normalize_keypoints(kpts: torch.Tensor, image_hw) -> torch.Tensor:
    """Centre and scale keypoints by image size. kpts [B, N, 2] (x, y);
    image_hw an (h, w) tuple or a [B, 2] tensor of (h, w)."""
    if isinstance(image_hw, tuple):
        h, w = image_hw
        size = torch.tensor([w, h], dtype=kpts.dtype, device=kpts.device)[None, None, :]
    else:
        hw = image_hw.to(device=kpts.device, dtype=kpts.dtype)
        size = torch.flip(hw, dims=(-1,))[:, None, :]
    center = size / 2.0
    scaling = size.amax(dim=-1, keepdim=True) * 0.7
    return (kpts - center) / scaling


def sinkhorn_problem(
    scores: torch.Tensor,
    bin_score: torch.Tensor,
    mask0: Optional[torch.Tensor],
    mask1: Optional[torch.Tensor],
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """(couplings [B, M+1, N+1], log_mu [B, M+1], log_nu [B, N+1], norm [B])
    of the transport problem, fp32: the scores with a dustbin row and column
    (masked pairs NEG_INF), NEG_INF marginals for masked keypoints, each
    dustbin absorbing the other side's count. When both sides are fully
    masked the norm is clamped, so every output stays finite."""
    scores = scores.float()
    b, m, n = scores.shape
    dev = scores.device
    if mask0 is None:
        mask0 = torch.ones((b, m), dtype=torch.bool, device=dev)
    if mask1 is None:
        mask1 = torch.ones((b, n), dtype=torch.bool, device=dev)
    ms = mask0.sum(dim=-1).float()
    ns = mask1.sum(dim=-1).float()
    bin_score = bin_score.float()
    neg = torch.full((), NEG_INF, dtype=torch.float32, device=dev)
    scores = torch.where(mask0[:, :, None] & mask1[:, None, :], scores, neg)
    bins0 = torch.where(mask0, bin_score, neg)[:, :, None]
    bins1 = torch.where(mask1, bin_score, neg)[:, None, :]
    alpha = bin_score.expand(b, 1, 1)
    couplings = torch.cat([torch.cat([scores, bins0], dim=2), torch.cat([bins1, alpha], dim=2)],
                          dim=1).contiguous()
    norm = -torch.log(torch.clamp(ms + ns, min=1.0))
    log_mu = torch.cat([torch.where(mask0, norm[:, None], neg),
                        (torch.log(ns.clamp(min=1e-9)) + norm)[:, None]], dim=1)
    log_nu = torch.cat([torch.where(mask1, norm[:, None], neg),
                        (torch.log(ms.clamp(min=1e-9)) + norm)[:, None]], dim=1)
    return couplings, log_mu, log_nu, norm


def log_sinkhorn(
    scores: torch.Tensor,
    bin_score: torch.Tensor,
    mask0: Optional[torch.Tensor],
    mask1: Optional[torch.Tensor],
    iters: int,
    kernel: Optional[bool] = None,
    stream_bf16: bool = False,
) -> torch.Tensor:
    """Masked log-space Sinkhorn with a dustbin row and column, in fp32:
    scores [B, M, N] -> the [B, M+1, N+1] log-assignment scaled by (m + n)."""
    couplings, log_mu, log_nu, norm = sinkhorn_problem(scores, bin_score, mask0, mask1)
    m, n = couplings.shape[1:]
    # Rows wider than K7's widest instantiation take the scan by default, as
    # the JAX package's do above its guard; asked for a kernel (kernel True
    # or stream_bf16), they go to K7's wide entries.
    too_wide = n > sinkhorn.max_columns(_build.variants("sinkhorn_stream"))
    if kernel is False or (too_wide and kernel is None and not stream_bf16):
        u, v = sinkhorn.sinkhorn_potentials_plain(couplings, log_mu, log_nu, iters)
    elif sinkhorn.fits_smem(m, n, sms=_build.device_sms(couplings.device)):
        u, v = sinkhorn.sinkhorn_potentials(couplings, log_mu, log_nu, iters)
    else:
        u, v = sinkhorn_stream.sinkhorn_potentials_streamed(
            couplings, log_mu, log_nu, iters,
            coupling_dtype=torch.bfloat16 if stream_bf16 else None)
    z = couplings + u[:, :, None] + v[:, None, :]
    return z - norm[:, None, None]


def extract_matches(
    z: torch.Tensor,
    threshold: float,
    mask0: Optional[torch.Tensor] = None,
    mask1: Optional[torch.Tensor] = None,
) -> dict:
    """Mutual max + threshold from the [B, M+1, N+1] log-assignment; argmax
    takes the first index on ties, as jnp.argmax; -1 marks unmatched."""
    inner = z[:, :-1, :-1]
    b, m, n = inner.shape
    idx0 = inner.argmax(dim=2)
    idx1 = inner.argmax(dim=1)
    max0 = inner.amax(dim=2)
    mutual0 = torch.arange(m, device=z.device)[None, :] == torch.gather(idx1, 1, idx0)
    mutual1 = torch.arange(n, device=z.device)[None, :] == torch.gather(idx0, 1, idx1)
    mscores0 = torch.where(mutual0, torch.exp(max0), 0.0)
    mscores1 = torch.where(mutual1, torch.gather(mscores0, 1, idx1), 0.0)
    valid0 = mutual0 & (mscores0 > threshold)
    if mask0 is not None:
        valid0 = valid0 & mask0
    valid1 = mutual1 & torch.gather(valid0, 1, idx1)
    if mask1 is not None:
        valid1 = valid1 & mask1
    minus1 = torch.full((), -1, dtype=idx0.dtype, device=z.device)
    return {
        "matches0": torch.where(valid0, idx0, minus1).int(),
        "matches1": torch.where(valid1, idx1, minus1).int(),
        "matching_scores0": mscores0,
        "matching_scores1": mscores1,
        "valid0": valid0,
        "valid1": valid1,
        "log_assignment": z,
    }


class SuperGlue(nn.Module):
    def __init__(
        self,
        d_model: int = 256,
        num_heads: int = 4,
        num_layers: int = 9,
        keypoint_encoder: tuple = (32, 64, 128, 256),
        sinkhorn_iterations: int = 100,
        sinkhorn_kernel: Optional[bool] = None,
        sinkhorn_stream_bf16: bool = False,
        match_threshold: float = 0.2,
        dtype: torch.dtype = torch.float32,
        attention_kernel: Optional[bool] = None,
    ):
        super().__init__()
        self.dtype = check_compute_dtype(dtype)
        self.d_model = d_model
        self.num_layers = num_layers
        self.sinkhorn_iterations = sinkhorn_iterations
        self.sinkhorn_kernel = sinkhorn_kernel
        self.sinkhorn_stream_bf16 = sinkhorn_stream_bf16
        self.match_threshold = match_threshold
        self.kenc = PointMLP(3, list(keypoint_encoder) + [d_model], norm="batch", dtype=dtype)
        for i in range(num_layers):
            for kind in ("self", "cross"):
                self.add_module(f"{kind}_{i}", AttentionalPropagation(
                    d_model, num_heads, kind="softmax", norm="batch", dtype=dtype,
                    attention_kernel=attention_kernel))
        self.final_proj = Dense(d_model, d_model, dtype)
        self.bin_score = nn.Parameter(torch.tensor(1.0))

    def similarity(self, kpts0, kpts1, desc0, desc1, scores0, scores1, image_hw0, image_hw1,
                   mask0=None, mask1=None) -> torch.Tensor:
        """The GNN: keypoint encoding, the (self, cross) layers and the final
        projection, then the scores <m0, m1> / sqrt(d_model) [B, N0, N1]."""
        dt = self.dtype
        x0, x1 = desc0.to(dt), desc1.to(dt)
        k0 = normalize_keypoints(kpts0.to(dt), image_hw0)
        k1 = normalize_keypoints(kpts1.to(dt), image_hw1)
        x0 = x0 + self.kenc(torch.cat([k0, scores0[..., None].to(dt)], dim=-1))
        x1 = x1 + self.kenc(torch.cat([k1, scores1[..., None].to(dt)], dim=-1))
        for i in range(self.num_layers):
            self_layer = getattr(self, f"self_{i}")
            cross_layer = getattr(self, f"cross_{i}")
            x0 = x0 + self_layer(x0, x0, mask0, mask0)
            x1 = x1 + self_layer(x1, x1, mask1, mask1)
            delta0 = cross_layer(x0, x1, mask1, mask0)
            delta1 = cross_layer(x1, x0, mask0, mask1)
            x0, x1 = x0 + delta0, x1 + delta1
        m0, m1 = self.final_proj(x0), self.final_proj(x1)
        return torch.einsum("bnc,bmc->bnm", m0, m1) / float(self.d_model) ** 0.5

    def forward(
        self,
        kpts0: torch.Tensor,
        kpts1: torch.Tensor,
        desc0: torch.Tensor,
        desc1: torch.Tensor,
        scores0: torch.Tensor,
        scores1: torch.Tensor,
        image_hw0,
        image_hw1,
        mask0: Optional[torch.Tensor] = None,
        mask1: Optional[torch.Tensor] = None,
    ) -> dict:
        """kpts* [B, N, 2] (x, y) pixels; desc* [B, N, C]; scores* [B, N];
        image_hw* (h, w) or [B, 2]; mask* [B, N] validity. Returns
        matches0 / matches1 (-1 unmatched), matching_scores0 / 1, valid0 / 1
        and the log_assignment [B, N0+1, N1+1]."""
        with span("superglue.gnn"):
            sim = self.similarity(kpts0, kpts1, desc0, desc1, scores0, scores1, image_hw0,
                                  image_hw1, mask0, mask1)
        with span("superglue.sinkhorn"):
            z = log_sinkhorn(sim, self.bin_score.to(self.dtype), mask0, mask1,
                             self.sinkhorn_iterations, kernel=self.sinkhorn_kernel,
                             stream_bf16=self.sinkhorn_stream_bf16)
        with span("superglue.extract"):
            return extract_matches(z, self.match_threshold, mask0=mask0, mask1=mask1)
