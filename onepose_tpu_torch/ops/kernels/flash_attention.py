"""Flash attention with a key mask (K8): the CUDA kernels
`csrc/flash_attention.cu` and their plain version.

Replaces the library Pallas kernels that the JAX package's
onepose_tpu/models/common.py::_flash_softmax_attention (:119, the
`use_flash=True` route of `masked_softmax_attention`) reaches through
jax.experimental.pallas.ops.tpu.flash_attention: the forward
`_flash_attention_impl` (flash_attention.py:589) and the backward pair
`_flash_attention_bwd_dkv` (:941) and `_flash_attention_bwd_dq` (:1287),
which a custom VJP joins there and `FlashAttention` here. In the port,
every softmax `MultiHeadAttention` on CUDA (SuperGlue's 36 calls a
forward) takes this route by default
(`models.common.softmax_attention_kernel`), where JAX's `map` runs the
plain one. Heads: JAX's route takes D <= 128 or D a multiple of 128
(flash_attention.py:455-463), and so does this one (`check_inputs`; D =
160 raises). Every product of the kernels runs on the tensor cores in
3xTF32 (wgmma .tf32; an fp32 x is tf32(x) + tf32(x - tf32(x)), three
tf32 products for each fp32 one), so the bound on the H100 is 3 x the
operations at 495 TFLOP/s: 4 B H N M D flops forward (0.585 ms at [7,
4096, 4096, 4, 64] with 80% valid keys, SuperGlue's heads at 4096
keypoints in K7's chunks of 7 pairs), 10 B H N M D backward (1.462 ms).

The function, in JAX's [B, N, H, D] layout, fp32: scores (q . k) *
sm_scale, masked keys plus MASK_VALUE (-0.7 * FLT_MAX, the library's
DEFAULT_MASK_VALUE), softmax over the keys, times v; every row of an
example whose keys are all masked is exactly 0, and so are its gradients
(JAX zeroes those rows after its kernel).

The kernels, chosen by shape alone in the C entry points: heads of up to
64 channels run warp-specialised blocks whose two consumer warpgroups own
64 rows each; heads of 65 to 128 channels and of 256 run the wide
warp-specialised blocks, whose two consumers share 64 rows and split the
head's channels (a cluster of two blocks for 256), each score tile
computed once; the rest (D % 4 != 0, tensors not 16-byte aligned, D = 384
and wider) run one warpgroup a 64-channel slice, recomputing the scores
for each slice. A refused launch raises (`_build.check`); there is no
fallback.

`flash_attention` runs `flash_attention_plain` only on CPU tensors. On
CUDA tensors it launches the forward kernel, through `FlashAttention`
when autograd records: its forward saves the inputs, the output and each
row's log-sum-exp; its backward computes di = sum(o * do) in PyTorch (as
JAX does outside Pallas) and launches the dK / dV and the dQ kernels,
which recompute the weights from the log-sum-exp. `launches` counts the
forward kernel, `bwd_launches` each backward kernel (2 a backward).
"""

from __future__ import annotations

from typing import Optional

import torch

from onepose_tpu_torch.ops.kernels import _build

MASK_VALUE = -0.7 * float(torch.finfo(torch.float32).max)
# The kernels against the plain version on the card (fp32 sums in another
# order, the products in 3xTF32): the forward within CARD_FWD_ABS, each
# gradient within CARD_BWD_REL x its largest magnitude.
CARD_FWD_ABS, CARD_BWD_REL = 2e-5, 1e-4
TF32_OPS_PER_S = 495e12  # H100 SXM dense tf32 on the tensor cores: the kernels' bound
launches = 0  # forward kernel launches since the last reset (ops.kernels.reset_launches)
bwd_launches = 0  # backward kernel launches (dK / dV and dQ) since the last reset


def flash_attention_plain(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    kv_mask: Optional[torch.Tensor],
    sm_scale: float,
) -> torch.Tensor:
    """The kernels' function in plain PyTorch: a dense fp32 masked
    softmax, then the zero guard. q [B, N, H, D], k and v [B, M, H, D],
    kv_mask [B, M] bool (True = valid) or None -> [B, N, H, D]."""
    s = torch.einsum("bnhd,bmhd->bhnm", q, k) * sm_scale
    if kv_mask is not None:
        s = s + torch.where(kv_mask, 0.0, MASK_VALUE)[:, None, None, :]
    out = torch.einsum("bhnm,bmhd->bnhd", torch.softmax(s, dim=-1), v)
    if kv_mask is not None:
        out = torch.where(kv_mask.any(dim=1)[:, None, None, None], out, 0.0)
    return out


def check_inputs(q, k, v, kv_mask) -> None:
    """Raise ValueError unless q [B, N, H, D], k and v [B, M, H, D] with D
    <= 128 or a multiple of 128 (JAX's condition) and kv_mask [B, M] bool
    or None (on every device)."""
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError("flash_attention: q, k and v must be [B, N|M, H, D]")
    b, _, h, d = q.shape
    if k.shape != v.shape or k.shape[0] != b or k.shape[2:] != (h, d):
        raise ValueError(f"flash_attention: k {tuple(k.shape)} and v {tuple(v.shape)} do not "
                         f"match q {tuple(q.shape)}")
    if not (d <= 128 or d % 128 == 0):
        raise ValueError(f"flash_attention: head dimension {d} is neither <= 128 nor a multiple "
                         "of 128")
    if kv_mask is not None and (kv_mask.dtype != torch.bool
                                or tuple(kv_mask.shape) != (b, k.shape[1])):
        raise ValueError(f"flash_attention: kv_mask must be bool [{b}, {k.shape[1]}], got "
                         f"{kv_mask.dtype} {tuple(kv_mask.shape)}")


def flash_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    kv_mask: Optional[torch.Tensor],
    sm_scale: float,
) -> torch.Tensor:
    """Masked softmax attention, [B, N, H, D] fp32 (see the module)."""
    check_inputs(q, k, v, kv_mask)
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, kv_mask, sm_scale)
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        return FlashAttention.apply(q, k, v, kv_mask, sm_scale)
    return flash_attention_kernel(q.detach(), k.detach(), v.detach(), kv_mask, sm_scale)[0]


class FlashAttention(torch.autograd.Function):
    """Flash attention with a gradient: the forward kernel on detached
    inputs, the backward kernels from the saved log-sum-exp.

    apply(q, k, v, kv_mask, sm_scale) -> [B, N, H, D]."""

    @staticmethod
    def forward(ctx, q, k, v, kv_mask, sm_scale):
        o, lse = flash_attention_kernel(q.detach(), k.detach(), v.detach(), kv_mask, sm_scale)
        ctx.save_for_backward(q, k, v, kv_mask, o, lse)
        ctx.sm_scale = sm_scale
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, kv_mask, o, lse = ctx.saved_tensors
        do = do.contiguous()
        di = (o * do).sum(dim=-1)  # [B, N, H], outside the kernels as in JAX
        dq, dk, dv = flash_attention_bwd_kernel(q.detach(), k.detach(), v.detach(), kv_mask,
                                                do, lse, di, ctx.sm_scale)
        return dq, dk, dv, None, None


def _launch_args(q, k, v, kv_mask):
    """Check what the kernels take (contiguous fp32 CUDA tensors on one
    device, a contiguous bool mask) and return (B, N, M, H, D) and the
    mask's pointer or None."""
    check_inputs(q, k, v, kv_mask)
    for t, what in ((q, "q"), (k, "k"), (v, "v")):
        _build.require_cuda_input(t, f"flash_attention {what}", 4)
    if kv_mask is not None:
        _build.require_cuda_input(kv_mask, "flash_attention kv_mask", 2, torch.bool)
    if any(t is not None and t.device != q.device for t in (k, v, kv_mask)):
        raise ValueError("flash_attention: q, k, v and kv_mask must be on one device")
    b, n, h, d = q.shape
    return (b, n, k.shape[1], h, d), None if kv_mask is None else _build.ptr(kv_mask)


def flash_attention_kernel(q, k, v, kv_mask, sm_scale) -> tuple[torch.Tensor, torch.Tensor]:
    """Launch the forward kernel: (o [B, N, H, D], lse [B, N, H]); lse is
    +inf on the rows of an example with no valid key."""
    dims, mask = _launch_args(q, k, v, kv_mask)
    b, n, m, h, d = dims
    o = torch.empty_like(q)
    lse = torch.empty((b, n, h), dtype=torch.float32, device=q.device)
    lib = _build.load("flash_attention")
    err = lib.flash_attention_fwd_launch(
        _build.ptr(q), _build.ptr(k), _build.ptr(v), mask, _build.ptr(o), _build.ptr(lse),
        b, n, m, h, d, float(sm_scale), _build.stream(q.device))
    _build.check(lib, err, "flash_attention forward kernel")
    global launches
    launches += 1
    return o, lse


def flash_attention_bwd_kernel(q, k, v, kv_mask, do, lse, di, sm_scale):
    """Launch the dK / dV and the dQ kernels: (dq, dk, dv) from the
    forward's inputs, its lse, the output's gradient do and di = sum(o * do)."""
    dims, mask = _launch_args(q, k, v, kv_mask)
    b, n, m, h, d = dims
    _build.require_cuda_input(do, "flash_attention do", 4)
    _build.require_cuda_input(lse, "flash_attention lse", 3)
    _build.require_cuda_input(di, "flash_attention di", 3)
    if any(t.device != q.device for t in (do, lse, di)):
        raise ValueError("flash_attention backward: do, lse and di must be on q's device")
    if do.shape != q.shape or lse.shape != (b, n, h) or di.shape != (b, n, h):
        raise ValueError("flash_attention backward: do must be [B, N, H, D], lse and di [B, N, H]")
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    lib = _build.load("flash_attention")
    common = (_build.ptr(q), _build.ptr(k), _build.ptr(v), mask, _build.ptr(do),
              _build.ptr(lse), _build.ptr(di))
    stream = _build.stream(q.device)
    global bwd_launches
    err = lib.flash_attention_bwd_dkv_launch(*common, _build.ptr(dk), _build.ptr(dv), b, n, m, h,
                                             d, float(sm_scale), stream)
    _build.check(lib, err, "flash_attention dK / dV kernel")
    bwd_launches += 1
    err = lib.flash_attention_bwd_dq_launch(*common, _build.ptr(dq), b, n, m, h, d,
                                            float(sm_scale), stream)
    _build.check(lib, err, "flash_attention dQ kernel")
    bwd_launches += 1
    return dq, dk, dv
