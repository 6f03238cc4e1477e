"""Shared model building blocks: point-MLPs, masked linear and softmax attention.

Port of onepose_tpu/models/common.py for the GATsSPG and SuperGlue paths. Point sets are
channel-last [B, N, C] and masks are bool [B, N] with True = valid, as in
the JAX package. Linear layers carry the JAX module names (`dense_0`, `proj_q`,
`merge`, ...) so that `models.bridge` maps parameters one to one.

Compute dtype (`dtype`, float32 or bfloat16) follows the JAX modules' `dtype=`:
parameters stay fp32; a `Dense` casts its input, weight and bias to
`dtype` and returns `dtype`; instance-norm statistics and the attention
internals run in fp32. `mixed=True` with bf16 feeds the linear-attention
contractions bf16-rounded operands with fp32 sums (`mixed_einsum`), as
the JAX package does on an accelerator.

`masked_softmax_attention` (SuperGlue) is plain PyTorch, as the JAX
package leaves it to XLA. Its opt-in `use_flash=True` route goes where the
JAX package calls its library TPU flash kernel: to K8,
`ops.kernels.flash_attention` (hand-written forward, dK / dV and dQ
kernels on the card, their plain version on the CPU). A softmax
`MultiHeadAttention` takes that route by its `attention_kernel` flag
(`softmax_attention_kernel`): by default on CUDA tensors, so SuperGlue's
attention runs K8 on the card and the plain route on the CPU.

With a `mesh` (`parallel.mesh`), the attention of a sharded point set
runs the collectives of `parallel.sharded_attention` (`spmd="kv"`: keys
and values sharded; `"qkv"`: queries too), and the instance norm of a
sharded point set takes its statistics over every rank's points through
the points group (`x_sharded`): the JAX package's compiler inserts both
reductions itself.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from onepose_tpu_torch._device import check_compute_dtype
from onepose_tpu_torch.ops.kernels.flash_attention import flash_attention
from onepose_tpu_torch.utils.precision import mixed_einsum
from onepose_tpu_torch.utils.profiling import span

NEG_INF = -1e9


class Dense(nn.Linear):
    """nn.Linear computing in `dtype`, as the JAX package's
    nn.Dense(dtype=...): input, weight and bias cast to `dtype`, the
    product rounded to `dtype`, then the bias added in `dtype`. Parameters
    stay fp32, so state_dicts load alike in every dtype."""

    def __init__(self, in_features: int, out_features: int, dtype: torch.dtype = torch.float32):
        super().__init__(in_features, out_features)
        self.dtype = check_compute_dtype(dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        d = self.dtype
        return F.linear(x.to(d), self.weight.to(d)) + self.bias.to(d)


def masked_instance_norm(
    x: torch.Tensor, mask: Optional[torch.Tensor], eps: float = 1e-5, group=None
) -> torch.Tensor:
    """InstanceNorm over the point axis of [B, N, C] (no affine); biased
    variance, statistics in fp32. mask=None uses every point. With a
    process `group`, x is this rank's block of the points and the
    statistics are those of every rank's points (all-reduced sums)."""
    dtype = x.dtype
    x = x.float()
    if group is not None:
        from onepose_tpu_torch.utils.comm import all_reduce

        w = torch.ones_like(x[..., :1]) if mask is None else mask.to(x.dtype)[..., None]
        n = all_reduce(w.sum(dim=1, keepdim=True), group).clamp(min=1.0)
        mean = all_reduce((x * w).sum(dim=1, keepdim=True), group) / n
        var = all_reduce(((x - mean).square() * w).sum(dim=1, keepdim=True), group) / n
    elif mask is None:
        mean = x.mean(dim=1, keepdim=True)
        var = x.var(dim=1, keepdim=True, unbiased=False)
    else:
        w = mask.to(x.dtype)[..., None]
        n = w.sum(dim=1, keepdim=True).clamp(min=1.0)
        mean = (x * w).sum(dim=1, keepdim=True) / n
        var = ((x - mean).square() * w).sum(dim=1, keepdim=True) / n
    return ((x - mean) * torch.rsqrt(var + eps)).to(dtype)


class PointMLP(nn.Module):
    """Pointwise Linear + norm + ReLU stack over [B, N, C].

    norm: 'instance' (statistics over the N axis, no affine), 'batch'
    (folded batch norm: a learned per-channel affine) or 'none'; applied
    between layers, not after the last. instance_mask_aware=False (the
    default, reference parity) takes statistics over padded points too."""

    def __init__(
        self,
        in_features: int,
        features: Sequence[int],
        norm: str = "instance",
        instance_mask_aware: bool = False,
        dtype: torch.dtype = torch.float32,
    ):
        super().__init__()
        if norm not in ("instance", "batch", "none"):
            raise ValueError(f"unknown norm {norm!r}")
        self.norm = norm
        self.instance_mask_aware = instance_mask_aware
        self.n_layers = len(features)
        prev = in_features
        for i, feat in enumerate(features):
            self.add_module(f"dense_{i}", Dense(prev, feat, dtype))
            if norm == "batch" and i < self.n_layers - 1:
                self.register_parameter(f"bn_scale_{i}", nn.Parameter(torch.ones(feat)))
                self.register_parameter(f"bn_bias_{i}", nn.Parameter(torch.zeros(feat)))
            prev = feat

    def forward(self, x: torch.Tensor, mask: Optional[torch.Tensor] = None,
                group=None) -> torch.Tensor:
        """group: the points group when x is this rank's block of a sharded
        point set (instance-norm statistics over every rank's points)."""
        for i in range(self.n_layers):
            x = getattr(self, f"dense_{i}")(x)
            if i < self.n_layers - 1:
                if self.norm == "instance":
                    x = masked_instance_norm(x, mask if self.instance_mask_aware else None,
                                             group=group)
                elif self.norm == "batch":
                    scale, bias = getattr(self, f"bn_scale_{i}"), getattr(self, f"bn_bias_{i}")
                    x = x * scale.to(x.dtype) + bias.to(x.dtype)
                x = F.relu(x)
        return x


def masked_linear_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    kv_mask: Optional[torch.Tensor] = None,
    eps: float = 1e-6,
    compute_dtype: Optional[torch.dtype] = None,
) -> torch.Tensor:
    """Linear attention with the elu+1 feature map (fp32).

    q: [B, N, H, D]; k, v: [B, M, H, D]; kv_mask: [B, M]. Masked keys
    contribute nothing (phi(k) is zeroed); values are divided by M and the
    result multiplied back (the reference's value-length conditioning).

    compute_dtype bf16: v is rounded to bf16 and the two contractions take
    bf16-rounded operands with fp32 sums; phi and the normaliser z stay
    fp32. None or fp32: all fp32."""
    m = v.shape[1]
    if compute_dtype is not None and compute_dtype != torch.float32:
        cd = compute_dtype
        v = v.to(cd).float()
        phi_q = F.elu(q.float()) + 1.0
        phi_k = F.elu(k.float()) + 1.0
        if kv_mask is not None:
            phi_k = phi_k * kv_mask.to(phi_k.dtype)[:, :, None, None]
        kv = mixed_einsum("bmhd,bmhe->bhde", phi_k, v / m, dtype=cd)
        z = 1.0 / (torch.einsum("bnhd,bhd->bnh", phi_q, phi_k.sum(dim=1)) + eps)
        out = mixed_einsum("bnhd,bhde->bnhe", phi_q, kv, dtype=cd)
        return out * (z[..., None] * m)
    phi_q = F.elu(q) + 1.0
    phi_k = F.elu(k) + 1.0
    if kv_mask is not None:
        phi_k = phi_k * kv_mask.to(phi_k.dtype)[:, :, None, None]
    kv = torch.einsum("bmhd,bmhe->bhde", phi_k, v / m)
    z = 1.0 / (torch.einsum("bnhd,bhd->bnh", phi_q, phi_k.sum(dim=1)) + eps)
    return torch.einsum("bnhd,bhde,bnh->bnhe", phi_q, kv, z) * m


def _flash_softmax_attention(q, k, v, kv_mask, sm_scale):
    """Softmax attention through K8 (`ops.kernels.flash_attention`) with a
    key mask, fp32, in the [B, N|M, H, D] layout (nothing transposed).
    Rows whose keys are all masked are zeroed, as the JAX flash route does
    (the plain path returns the mean of v there), and so are their
    gradients. The head dimension is at most 128 or a multiple of 128, as
    JAX's flash route takes (`flash_attention.check_inputs`; ValueError
    otherwise)."""
    q, k, v = (x.float().contiguous() for x in (q, k, v))
    mask = None if kv_mask is None else kv_mask.contiguous()
    return flash_attention(q, k, v, mask, sm_scale)


def softmax_attention_kernel(kernel: Optional[bool], device: torch.device) -> bool:
    """Whether softmax attention takes K8 (`use_flash`). kernel True or
    False decides (True on a CPU tensor runs K8's plain version); None
    takes K8 on a CUDA device, else the plain route. The two routes differ
    only on an example whose keys are all masked: K8 zeroes its rows, the
    plain route averages v."""
    return kernel if kernel is not None else device.type == "cuda"


def masked_softmax_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    kv_mask: Optional[torch.Tensor] = None,
    compute_dtype: Optional[torch.dtype] = None,
    use_flash: Optional[bool] = None,
) -> torch.Tensor:
    """Multi-head scaled dot-product attention with key-side masking.

    q: [B, N, H, D]; k, v: [B, M, H, D]; kv_mask: [B, M] (True = valid).
    Returns [B, N, H, D]; masked keys get logits NEG_INF, so a row whose
    keys are all masked averages v uniformly. The softmax runs in fp32.

    compute_dtype bf16: q, k, v and the probabilities are rounded to bf16
    and both contractions sum in fp32 (JAX on an accelerator; JAX on the CPU
    keeps the probabilities fp32). None or fp32: all fp32.

    use_flash: the opt-in fused route (`_flash_softmax_attention`).

    Each call, by either route, is an `attention.softmax` span
    (`utils.profiling.span`)."""
    with span("attention.softmax"):
        d = q.shape[-1]
        if use_flash:
            return _flash_softmax_attention(q, k, v, kv_mask, sm_scale=1.0 / float(d) ** 0.5)
        if compute_dtype is not None and compute_dtype != torch.float32:
            cd = compute_dtype
            logits = mixed_einsum("bnhd,bmhd->bhnm", q, k, dtype=cd) / float(d) ** 0.5
            if kv_mask is not None:
                logits = logits.masked_fill(~kv_mask[:, None, None, :], NEG_INF)
            probs = torch.softmax(logits, dim=-1)
            return mixed_einsum("bhnm,bmhd->bnhd", probs, v, dtype=cd)
        logits = torch.einsum("bnhd,bmhd->bhnm", q, k) / float(d) ** 0.5
        if kv_mask is not None:
            logits = logits.masked_fill(~kv_mask[:, None, None, :], NEG_INF)
        return torch.einsum("bhnm,bmhd->bnhd", torch.softmax(logits, dim=-1), v)


class MultiHeadAttention(nn.Module):
    """Q/K/V projections + attention + output merge. kind: 'linear'
    (GATsSPG) or 'softmax' (SuperGlue). Channels are head-major
    (c = h * D + d), so the head split is a plain reshape. The projections
    and the merge compute in `dtype`, the attention in fp32 (with
    bf16-operand contractions when `mixed` and `dtype` is bf16).

    With `mesh`, forward's spmd="kv" or "qkv" says the source is this
    rank's block of a point set sharded over the points axis (and, for
    "qkv", x too): the attention then runs `parallel.sharded_attention`'s
    collectives, in fp32 (`mixed` has no effect there, as in the JAX
    package).

    attention_kernel (kind 'softmax' only, without a mesh): None (the
    default) runs K8 on CUDA and the plain route otherwise, True asks for
    K8, False forces the plain route (`softmax_attention_kernel`). K8 runs
    in fp32, so `mixed` has no effect on its route."""

    def __init__(
        self,
        num_heads: int,
        d_model: int,
        kind: str = "linear",
        dtype: torch.dtype = torch.float32,
        mixed: bool = False,
        mesh=None,
        attention_kernel: Optional[bool] = None,
    ):
        super().__init__()
        self.dtype = check_compute_dtype(dtype)
        self.mixed = mixed
        self.mesh = mesh
        self.attention_kernel = attention_kernel
        if kind not in ("linear", "softmax"):
            raise ValueError(f"unknown attention kind {kind!r}")
        self.kind = kind
        self.num_heads = num_heads
        self.d_model = d_model
        self.proj_q = Dense(d_model, d_model, dtype)
        self.proj_k = Dense(d_model, d_model, dtype)
        self.proj_v = Dense(d_model, d_model, dtype)
        self.merge = Dense(d_model, d_model, dtype)

    def forward(
        self,
        x: torch.Tensor,
        source: torch.Tensor,
        source_mask: Optional[torch.Tensor] = None,
        spmd: Optional[str] = None,
    ) -> torch.Tensor:
        b, n, _ = x.shape
        m = source.shape[1]
        hd = self.d_model // self.num_heads
        q = self.proj_q(x).reshape(b, n, self.num_heads, hd).float()
        k = self.proj_k(source).reshape(b, m, self.num_heads, hd).float()
        v = self.proj_v(source).reshape(b, m, self.num_heads, hd).float()
        if self.mesh is not None and spmd in ("kv", "qkv"):
            # Deferred: parallel.sharded_attention imports NEG_INF from here.
            from onepose_tpu_torch.parallel.mesh import POINTS_AXIS
            from onepose_tpu_torch.parallel.sharded_attention import (
                ring_softmax_attention,
                sharded_linear_attention,
            )

            mask = source_mask if source_mask is not None else torch.ones(
                (b, m), dtype=torch.bool, device=source.device)
            if self.kind == "softmax":
                out = ring_softmax_attention(self.mesh, q, k, v, mask)
            else:
                out = sharded_linear_attention(self.mesh, q, k, v, mask,
                                               v_length=m * self.mesh.axis_size(POINTS_AXIS))
        else:
            cd = self.dtype if self.mixed and self.dtype != torch.float32 else None
            if self.kind == "softmax":
                flash = softmax_attention_kernel(self.attention_kernel, q.device)
                out = masked_softmax_attention(q, k, v, source_mask, compute_dtype=cd,
                                               use_flash=flash)
            else:
                out = masked_linear_attention(q, k, v, source_mask, compute_dtype=cd)
        return self.merge(out.to(self.dtype).reshape(b, n, self.d_model))


class AttentionalPropagation(nn.Module):
    """One message-passing step: attend to source, MLP on [x, message].
    The residual add happens in the caller.

    With `mesh`: spmd as in MultiHeadAttention; x_sharded says x is this
    rank's block of the sharded point set (implied by spmd="qkv"), so the
    MLP's instance norm reduces its statistics over the points group.
    attention_kernel: MultiHeadAttention's."""

    def __init__(
        self,
        d_model: int,
        num_heads: int,
        kind: str = "linear",
        norm: str = "batch",
        dtype: torch.dtype = torch.float32,
        mixed_attention: bool = False,
        mesh=None,
        attention_kernel: Optional[bool] = None,
    ):
        super().__init__()
        self.mesh = mesh
        self.attn = MultiHeadAttention(num_heads, d_model, kind=kind, dtype=dtype,
                                       mixed=mixed_attention, mesh=mesh,
                                       attention_kernel=attention_kernel)
        self.mlp = PointMLP(2 * d_model, [2 * d_model, d_model], norm=norm, dtype=dtype)

    def forward(
        self,
        x: torch.Tensor,
        source: torch.Tensor,
        source_mask: Optional[torch.Tensor] = None,
        x_mask: Optional[torch.Tensor] = None,
        spmd: Optional[str] = None,
        x_sharded: bool = False,
    ) -> torch.Tensor:
        message = self.attn(x, source, source_mask, spmd=spmd)
        group = None
        if self.mesh is not None and (x_sharded or spmd == "qkv"):
            from onepose_tpu_torch.parallel.mesh import POINTS_AXIS

            group = self.mesh.group(POINTS_AXIS)
        return self.mlp(torch.cat([x, message], dim=-1), x_mask, group=group)
