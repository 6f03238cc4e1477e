"""GATsSPG: the one-shot 2D-3D matcher.

Port of onepose_tpu/models/gats_spg.py: `num_blocks` x [GATs, self, cross]
over d_model descriptors (one self layer and one cross layer per block,
shared by the 2D and 3D streams), then a shared final projection, L2
normalization, similarity / scale_factor, dual-softmax confidence and
mutual-max + threshold matching. The head runs in fp32.

dtype (float32 or bfloat16, the JAX package's serving default): x2, x3 and
the leaves are rounded to `dtype` on entry and after every fused block;
the layers compute in `dtype` (see models.common); final_proj runs in
`dtype`, the similarity head in fp32.

Kernel flags (names as in the JAX package's counterparts):
- gats_kernel: the GATs leaf-attention CUDA kernel (`ops.kernels.gats`),
  fp32 only;
- block_fused: each [GATs, self, cross] block through the fused block
  kernels (`ops.kernels.gats_block`), inference only; the modules keep
  their parameters, so state_dicts load alike. The packed block weights
  (and, on CUDA, their kernel layout) are kept in a `PackCache` and packed
  again only when a parameter of the block changes (`block_weights`);
  bf16 leaves go to the kernels as they are;
- mixed_attention: with bf16, the linear-attention contractions take bf16
  operands with fp32 sums (unfused blocks only);
- fused_match: the dual-softmax CUDA kernel (`ops.kernels.dual_softmax`).
  conf_matrix is then None (inference only) and ties follow the kernel:
  the largest index wins and matching scores are non-zero only for hits.
  With fused_match=False the head follows `match_from_conf` (first index).

Not ported yet (ROADMAP.md): the points-sharded mesh path.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from onepose_tpu_torch._device import check_compute_dtype
from onepose_tpu_torch.models.common import NEG_INF, AttentionalPropagation, Dense
from onepose_tpu_torch.models.gats import GraphAttentionLayer
from onepose_tpu_torch.ops.kernels._layout import PackCache
from onepose_tpu_torch.ops.kernels.dual_softmax import dual_softmax_match
from onepose_tpu_torch.ops.kernels.gats_block import (
    fused_gats_block,
    kernel_weights,
    pack_block_params,
)


def _l2_normalize(x: torch.Tensor) -> torch.Tensor:
    return x / torch.linalg.vector_norm(x, dim=-1, keepdim=True).clamp(min=1e-12)


class GATsSPG(nn.Module):
    def __init__(
        self,
        d_model: int = 256,
        num_heads: int = 4,
        num_blocks: int = 4,
        scale_factor: float = 0.07,
        match_threshold: float = 0.2,
        include_self: bool = True,
        additional: bool = False,
        with_linear_transform: bool = False,
        gats_kernel: bool = False,
        fused_match: bool = False,
        dtype: torch.dtype = torch.float32,
        block_fused: bool = False,
        mixed_attention: bool = False,
    ):
        super().__init__()
        self.dtype = check_compute_dtype(dtype)
        if block_fused and (not include_self or additional or with_linear_transform):
            raise ValueError("block_fused runs the shipped GATs configuration only")
        self.num_heads = num_heads
        self.block_fused = block_fused
        self.num_blocks = num_blocks
        self.scale_factor = scale_factor
        self.match_threshold = match_threshold
        self.fused_match = fused_match
        for blk in range(num_blocks):
            self.add_module(
                f"gats_{blk}",
                GraphAttentionLayer(
                    d_model, d_model,
                    include_self=include_self,
                    additional=additional,
                    with_linear_transform=with_linear_transform,
                    gats_kernel=gats_kernel,
                    dtype=dtype,
                ),
            )
            for kind in ("self", "cross"):
                self.add_module(f"{kind}_{blk}", AttentionalPropagation(
                    d_model, num_heads, norm="instance", dtype=dtype,
                    mixed_attention=mixed_attention,
                ))
        self.final_proj = Dense(d_model, d_model, dtype)
        self._packs = PackCache()

    def block_weights(self, blk: int) -> tuple:
        """Block blk's (pack_block_params, kernel_weights in the model's
        dtype or None off CUDA), from the cache."""
        layers = [getattr(self, f"{k}_{blk}") for k in ("gats", "self", "cross")]

        def pack():
            params = pack_block_params(*layers)
            return params, (kernel_weights(params, self.dtype) if params["wa"].is_cuda else None)

        return self._packs.get(blk, [p for m in layers for p in m.parameters()], pack)

    def forward(
        self,
        desc2d: torch.Tensor,
        desc3d: torch.Tensor,
        leaf_desc: torch.Tensor,
        mask2d: Optional[torch.Tensor] = None,
        mask3d: Optional[torch.Tensor] = None,
        leaf_mask: Optional[torch.Tensor] = None,
    ) -> dict:
        """desc2d [B, N2, C]; desc3d [B, N3, C]; leaf_desc [B, N3, L, C];
        masks True = real. Returns conf_matrix [B, N2, N3] (None when
        fused), matches0 [B, N2] (-1 unmatched), matching_scores0,
        matches1 [B, N3], matching_scores1, valid0, valid1."""
        if self.block_fused and torch.is_grad_enabled() and any(
                p.requires_grad for p in self.parameters()):
            raise RuntimeError("block_fused is inference-only, as in the JAX package: run "
                               "under torch.no_grad() / torch.inference_mode()")
        dt = self.dtype
        x2, x3, leaves = desc2d.to(dt), desc3d.to(dt), leaf_desc.to(dt)
        if self.block_fused:  # the block kernels read the leaves in dt (bf16 or fp32)
            leaves = leaves.contiguous()
        for blk in range(self.num_blocks):
            gats = getattr(self, f"gats_{blk}")
            self_layer = getattr(self, f"self_{blk}")
            cross_layer = getattr(self, f"cross_{blk}")
            if self.block_fused:
                params, packed = self.block_weights(blk)
                x2, x3 = fused_gats_block(
                    x2.float().contiguous(), x3.float().contiguous(), leaves, mask2d, mask3d,
                    leaf_mask, params, alpha=gats.alpha, num_heads=self.num_heads, dtype=dt,
                    packed=packed,
                )
                x2, x3 = x2.to(dt), x3.to(dt)
                continue
            x3 = gats(leaves, x3, leaf_mask)
            x2 = x2 + self_layer(x2, x2, mask2d, mask2d)
            x3 = x3 + self_layer(x3, x3, mask3d, mask3d)
            d2 = cross_layer(x2, x3, mask3d, mask2d)
            d3 = cross_layer(x3, x2, mask2d, mask3d)
            x2, x3 = x2 + d2, x3 + d3

        m2 = _l2_normalize(self.final_proj(x2).float())
        m3 = _l2_normalize(self.final_proj(x3).float())
        scores = torch.einsum("bnc,bmc->bnm", m2, m3) / self.scale_factor
        if mask2d is not None:
            scores = scores.masked_fill(~mask2d[:, :, None], NEG_INF)
        if mask3d is not None:
            scores = scores.masked_fill(~mask3d[:, None, :], NEG_INF)

        if self.fused_match:
            out = dual_softmax_match(scores.contiguous(), self.match_threshold)
            if mask2d is not None:
                out["matches0"] = torch.where(mask2d, out["matches0"], -1)
            if mask3d is not None:
                out["matches1"] = torch.where(mask3d, out["matches1"], -1)
            out["conf_matrix"] = None
            return out

        conf = torch.softmax(scores, dim=1) * torch.softmax(scores, dim=2)
        out = match_from_conf(conf, self.match_threshold, mask2d=mask2d, mask3d=mask3d)
        out["conf_matrix"] = conf
        return out


def match_from_conf(
    conf: torch.Tensor,
    threshold: float,
    mask2d: Optional[torch.Tensor] = None,
    mask3d: Optional[torch.Tensor] = None,
) -> dict:
    """Mutual-max + threshold matches from a confidence matrix; argmax
    takes the first index on ties; -1 marks unmatched slots."""
    b, n2, n3 = conf.shape
    idx0 = conf.argmax(dim=2)  # [B, N2] best 3D per 2D
    idx1 = conf.argmax(dim=1)  # [B, N3] best 2D per 3D
    max0 = conf.amax(dim=2)
    arange2 = torch.arange(n2, device=conf.device)[None, :]
    arange3 = torch.arange(n3, device=conf.device)[None, :]
    mutual0 = arange2 == torch.gather(idx1, 1, idx0)
    mutual1 = arange3 == torch.gather(idx0, 1, idx1)
    mscores0 = torch.where(mutual0, max0, 0.0)
    mscores1 = torch.where(mutual1, torch.gather(mscores0, 1, idx1), 0.0)
    valid0 = mutual0 & (mscores0 > threshold)
    if mask2d is not None:
        valid0 = valid0 & mask2d
    valid1 = mutual1 & torch.gather(valid0, 1, idx1)
    if mask3d is not None:
        valid1 = valid1 & mask3d
    minus1 = torch.full((), -1, dtype=idx0.dtype, device=conf.device)
    return {
        "matches0": torch.where(valid0, idx0, minus1).int(),
        "matches1": torch.where(valid1, idx1, minus1).int(),
        "matching_scores0": mscores0,
        "matching_scores1": mscores1,
        "valid0": valid0,
        "valid1": valid1,
    }
