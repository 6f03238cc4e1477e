"""Graph-attention (GATs) leaf aggregation layer.

Port of onepose_tpu/models/gats.py::GraphAttentionLayer with every option
flag. Each 3D point owns L 2D "leaf" descriptors; logits
e = LeakyReLU(a_l . W h_leaf + a_r . W h_3d) are softmaxed over (self +
leaves) and aggregate the RAW (or linearly transformed) descriptors.

In the shipped configuration (include_self, not additional, no linear
transform, concat/ELU, fp32) `gats_kernel=True` routes through the CUDA
leaf-attention kernel (`ops.kernels.gats`), with a gradient when autograd
records; every other configuration, and gats_kernel=False, runs the plain
path below. With dtype bf16, W and a are
cast to bf16 and the products run in bf16; the softmax runs in fp32 and
its weights are cast back to bf16 (JAX's `dtype=` semantics).
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from onepose_tpu_torch._device import check_compute_dtype
from onepose_tpu_torch.models.common import NEG_INF
from onepose_tpu_torch.ops.kernels.gats import gats_leaf_attention


class GraphAttentionLayer(nn.Module):
    def __init__(
        self,
        in_features: int = 256,
        out_features: int = 256,
        alpha: float = 0.2,
        include_self: bool = True,
        additional: bool = False,
        with_linear_transform: bool = False,
        concat: bool = True,
        gats_kernel: bool = False,
        dtype: torch.dtype = torch.float32,
    ):
        super().__init__()
        self.dtype = check_compute_dtype(dtype)
        self.out_features = out_features
        self.alpha = alpha
        self.include_self = include_self
        self.additional = additional
        self.with_linear_transform = with_linear_transform
        self.concat = concat
        self.gats_kernel = gats_kernel
        self.W = nn.Parameter(nn.init.xavier_normal_(torch.empty(in_features, out_features)))
        self.a = nn.Parameter(nn.init.xavier_normal_(torch.empty(2 * out_features, 1)))

    @property
    def shipped(self) -> bool:
        return (
            self.include_self
            and not self.additional
            and not self.with_linear_transform
            and self.concat
            and self.dtype == torch.float32
        )

    def forward(
        self,
        leaf_desc: torch.Tensor,
        desc3d: torch.Tensor,
        leaf_mask: Optional[torch.Tensor] = None,
    ) -> torch.Tensor:
        """leaf_desc [B, N3, L, C]; desc3d [B, N3, C]; leaf_mask [B, N3, L]
        (True = real observation). Returns the refreshed desc3d [B, N3, C]."""
        W, a = self.W.to(self.dtype), self.a.to(self.dtype)
        a_leaf = a[: self.out_features, 0]
        a_self = a[self.out_features :, 0]
        if self.gats_kernel and self.shipped:
            return gats_leaf_attention(
                leaf_desc.contiguous(), desc3d.contiguous(), leaf_mask, W,
                torch.stack([a_leaf, a_self]), self.alpha,
            )
        leaf_desc, desc3d = leaf_desc.to(self.dtype), desc3d.to(self.dtype)

        if self.with_linear_transform:
            wh_leaf = leaf_desc @ W
            wh_3d = desc3d @ W
            e_leaf = wh_leaf @ a_leaf
            e_3d = wh_3d @ a_self
        else:
            # X @ W only feeds the logits: reassociate to X @ (W @ a).
            e_leaf = leaf_desc @ (W @ a_leaf)
            e_3d = desc3d @ (W @ a_self)
            wh_leaf = wh_3d = None

        if self.include_self:
            # The self column reuses the right-hand score, so its logit is
            # 2 * e_3d after the broadcast add below (reference parity).
            logits = torch.cat([e_3d[..., None], e_leaf], dim=-1)
            values = (
                torch.cat([wh_3d[..., None, :], wh_leaf], dim=-2)
                if self.with_linear_transform
                else torch.cat([desc3d[..., None, :], leaf_desc], dim=-2)
            )
            full_mask = (
                None
                if leaf_mask is None
                else torch.cat([torch.ones_like(leaf_mask[..., :1]), leaf_mask], dim=-1)
            )
        else:
            logits = e_leaf
            values = wh_leaf if self.with_linear_transform else leaf_desc
            full_mask = leaf_mask

        logits = F.leaky_relu(logits + e_3d[..., None], self.alpha)
        if full_mask is not None:
            logits = logits.masked_fill(~full_mask, NEG_INF)
        attn = torch.softmax(logits.float(), dim=-1).to(self.dtype)
        h_prime = torch.einsum("bnl,bnlc->bnc", attn, values)

        if self.include_self:
            if self.additional:
                h_prime = h_prime + desc3d
        else:
            base = wh_3d if self.with_linear_transform else desc3d
            h_prime = h_prime / 2.0 + base

        if self.concat:
            h_prime = F.elu(h_prime)
        return h_prime
