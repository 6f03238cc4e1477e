"""GATs leaf attention: the CUDA kernel `csrc/gats.cu` and its plain version.

Replaces onepose_tpu/ops/pallas/gats.py::_gats_pallas_raw (public
`gats_leaf_attention`) for the shipped GATs configuration in fp32. Bound on
the H100: bytes, one read of the [B, N3, L, C] leaves (131 MB at 8 x 2000
x 8 x 256) plus d3 and the output, about 49 us at 3.35 TB/s. The wrapper
reassociates (X @ W) @ a into X @ (W @ a) with one [C] matvec per side, so
the kernel streams each point's 1 + L rows once (a warp per point) and runs
no C x C product; see the source for the design.

`gats_leaf_attention` launches the kernel on CUDA tensors and runs
`gats_leaf_attention_plain` only on CPU tensors. When autograd records, a
CUDA call goes through `GatsLeafAttention`, the counterpart of the JAX
package's custom VJP (`gats_leaf_attention` there, `_fwd` / `_bwd`): its
forward launches the kernel on detached inputs, its backward recomputes
the plain version under autograd (JAX recomputes through its XLA
reference, not a Pallas kernel) and returns the gradients of the leaves,
d3 and wa; none for the mask, as JAX's `_bwd` returns none for it. wa =
`leaf_logit_vectors(W, a2)` stays outside the Function, so autograd
carries d wa on to W and a2.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from onepose_tpu_torch.ops.kernels import _build

NEG_INF = -1e9
launches = 0  # kernel launches since the last reset (ops.kernels.reset_launches)


def leaf_logit_vectors(W: torch.Tensor, a2: torch.Tensor) -> torch.Tensor:
    """wa [2, C] = (W @ a_leaf, W @ a_self) from W [C, C], a2 [2, C]."""
    return torch.stack([W @ a2[0], W @ a2[1]])


def additive_mask(leaf_mask: Optional[torch.Tensor]) -> Optional[torch.Tensor]:
    """[..., L] bool validity -> fp32 additive mask (0 valid, NEG_INF not)."""
    if leaf_mask is None:
        return None
    zero = torch.zeros((), dtype=torch.float32, device=leaf_mask.device)
    return torch.where(leaf_mask, zero, NEG_INF)


def gats_leaf_attention_plain(
    leaf_desc: torch.Tensor,
    desc3d: torch.Tensor,
    mask_add: Optional[torch.Tensor],
    wa: torch.Tensor,
    alpha: float = 0.2,
) -> torch.Tensor:
    """The kernel's function in plain PyTorch: leaves [B, N3, L, C], d3
    [B, N3, C], additive mask [B, N3, L] or None, wa [2, C] -> [B, N3, C]."""
    e_leaf = leaf_desc @ wa[0]  # [B, N3, L]
    e3 = desc3d @ wa[1]  # [B, N3]
    l_leaf = F.leaky_relu(e_leaf + e3[..., None], alpha)
    if mask_add is not None:
        l_leaf = l_leaf + mask_add
    l_self = F.leaky_relu(2.0 * e3, alpha)[..., None]
    attn = torch.softmax(torch.cat([l_self, l_leaf], dim=-1), dim=-1)
    h = attn[..., :1] * desc3d + torch.einsum("bnl,bnlc->bnc", attn[..., 1:], leaf_desc)
    return F.elu(h)


def gats_leaf_attention(
    leaf_desc: torch.Tensor,
    desc3d: torch.Tensor,
    leaf_mask: Optional[torch.Tensor],
    W: torch.Tensor,
    a2: torch.Tensor,
    alpha: float = 0.2,
) -> torch.Tensor:
    """Fused leaf attention for [B, N3, L, C] leaves (shipped GATs config).

    leaf_mask: [B, N3, L] bool or None; W [C, C]; a2 [2, C] rows
    (a_leaf, a_self). Returns [B, N3, C] fp32."""
    wa = leaf_logit_vectors(W, a2)
    mask_add = additive_mask(leaf_mask)
    if leaf_desc.device.type == "cpu":
        return gats_leaf_attention_plain(leaf_desc, desc3d, mask_add, wa, alpha)
    if torch.is_grad_enabled() and any(t.requires_grad for t in (leaf_desc, desc3d, wa)):
        return GatsLeafAttention.apply(leaf_desc, desc3d, mask_add, wa, alpha, gats_kernel)
    return gats_kernel(leaf_desc, desc3d, mask_add, wa, alpha)


class GatsLeafAttention(torch.autograd.Function):
    """Leaf attention with a gradient: `forward` (the CUDA kernel on the
    card; the tests pass the plain version on the CPU) on detached inputs,
    the backward by autograd through `gats_leaf_attention_plain`.

    apply(leaf_desc, desc3d, mask_add, wa, alpha, forward) -> [B, N3, C]."""

    @staticmethod
    def forward(ctx, leaf_desc, desc3d, mask_add, wa, alpha, forward):
        ctx.save_for_backward(leaf_desc, desc3d, mask_add, wa)
        ctx.alpha = alpha
        return forward(leaf_desc.detach(), desc3d.detach(), mask_add, wa.detach(), alpha)

    @staticmethod
    def backward(ctx, g):
        leaf_desc, desc3d, mask_add, wa = ctx.saved_tensors
        want = ctx.needs_input_grad
        inputs = [t.detach().requires_grad_(want[i]) for i, t in ((0, leaf_desc), (1, desc3d),
                                                                  (3, wa))]
        with torch.enable_grad():
            out = gats_leaf_attention_plain(inputs[0], inputs[1], mask_add, inputs[2], ctx.alpha)
        wanted = [t for t in inputs if t.requires_grad]
        grads = iter(torch.autograd.grad(out, wanted, g))
        dl, dd, dwa = (next(grads) if t.requires_grad else None for t in inputs)
        return dl, dd, None, dwa, None, None


def gats_kernel(
    leaf_desc: torch.Tensor,
    desc3d: torch.Tensor,
    mask_add: Optional[torch.Tensor],
    wa: torch.Tensor,
    alpha: float = 0.2,
) -> torch.Tensor:
    """Launch the CUDA kernel on the plain version's inputs."""
    b, n3, L, c = leaf_desc.shape
    _build.require_cuda_input(leaf_desc, "gats leaves", 4)
    _build.require_cuda_input(desc3d, "gats desc3d", 3)
    _build.require_cuda_input(wa, "gats wa", 2)
    if mask_add is not None:
        _build.require_cuda_input(mask_add, "gats mask", 3)
        if mask_add.shape != (b, n3, L):
            raise ValueError(f"gats mask shape {tuple(mask_add.shape)} != {(b, n3, L)}")
    if desc3d.shape != (b, n3, c) or wa.shape != (2, c):
        raise ValueError("gats: desc3d must be [B, N3, C] and wa [2, C]")
    if c % 4 or c > 512:
        raise ValueError(f"gats kernel needs C % 4 == 0 and C <= 512, got C={c}")
    out = torch.empty_like(desc3d)
    lib = _build.load("gats")
    err = lib.gats_launch(
        _build.ptr(leaf_desc), _build.ptr(desc3d),
        None if mask_add is None else _build.ptr(mask_add),
        _build.ptr(wa), _build.ptr(out), b * n3, L, c, float(alpha),
        _build.stream(leaf_desc.device),
    )
    _build.check(lib, err, "gats kernel")
    global launches
    launches += 1
    return out
