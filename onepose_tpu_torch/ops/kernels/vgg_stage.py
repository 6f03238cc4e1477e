"""SuperPoint VGG stage: the CUDA kernel `csrc/vgg_stage.cu` and its plain version.

Replaces onepose_tpu/ops/pallas/vgg_stage.py::_vgg_stage_pallas (public
`vgg_stage`): conv3x3 -> ReLU -> conv3x3 -> ReLU [-> 2x2 max-pool] on NHWC
activations, with bf16 taps and fp32 sums. Bound on the H100: operations,
about 311 GFLOP for the four production stages of a batch of 8 at 512 x
512 (0.32 ms at 989 TFLOP/s of bf16). The kernel keeps each tile's conv1
output in shared memory and feeds it straight to conv2; both multi-channel
convs are implicit GEMMs on wgmma with the weights streamed into shared
memory by TMA bulk copies; see the source for the design.

Rounding points (the Pallas kernel's): the input is rounded to bf16;
each conv sums bf16 taps in fp32, adds the fp32 bias, applies ReLU and
rounds to bf16; the pool takes the max of bf16 values. The stage output
is fp32 for the single-channel image stage and bf16 for the others.

`vgg_stage` launches the kernel on a CUDA tensor and runs
`vgg_stage_plain` only on a CPU tensor. Forward-only: a CUDA input that
requires grad raises. `pack_stage_weights` lays the weights out for the
kernel; a caller that runs the same weights again passes its result as
`packed=` (SuperPoint keeps it in a `PackCache`).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from onepose_tpu_torch.ops.kernels import _build
from onepose_tpu_torch.ops.kernels._layout import swizzle128
from onepose_tpu_torch.utils.precision import fp32_matmuls, rounded

launches = 0  # kernel launches since the last reset (ops.kernels.reset_launches)
BF16 = torch.bfloat16


def _out_dtype(cin: int) -> torch.dtype:
    return torch.float32 if cin == 1 else BF16


def vgg_stage_plain(
    x: torch.Tensor,
    w1: torch.Tensor,
    b1: torch.Tensor,
    w2: torch.Tensor,
    b2: torch.Tensor,
    pool: bool = True,
) -> torch.Tensor:
    """The kernel's function in plain PyTorch: x [B, H, W, Cin], w1 / w2
    HWIO [3, 3, Cin, C1] / [3, 3, C1, C2], b1 [C1], b2 [C2] -> NHWC stage
    output. fp32 convolutions (TF32 off) of bf16-rounded tensors."""

    def conv_relu(h, w, b):
        y = F.conv2d(h, rounded(w, BF16).permute(3, 2, 0, 1), padding=1)
        return rounded(F.relu(y + b.float()[:, None, None]), BF16)

    with fp32_matmuls():
        h = rounded(x, BF16).permute(0, 3, 1, 2)
        z = conv_relu(conv_relu(h, w1, b1), w2, b2)
    if pool:
        z = F.max_pool2d(z, 2, 2)
    return z.permute(0, 2, 3, 1).contiguous().to(_out_dtype(x.shape[-1]))


def vgg_stage(
    x: torch.Tensor,
    w1: torch.Tensor,
    b1: torch.Tensor,
    w2: torch.Tensor,
    b2: torch.Tensor,
    pool: bool = True,
    packed: tuple | None = None,
) -> torch.Tensor:
    """One fused VGG stage (see the module docstring); the kernel on CUDA,
    with `packed` = pack_stage_weights(w1, b1, w2, b2) if given."""
    if x.device.type == "cpu":
        return vgg_stage_plain(x, w1, b1, w2, b2, pool)
    return vgg_stage_kernel(x, w1, b1, w2, b2, pool, packed)


def pack_conv_weight(w: torch.Tensor) -> torch.Tensor:
    """HWIO [3, 3, Cin, Cout] -> the kernel's [9 taps, Cout, Cin] bf16."""
    kh, kw, cin, cout = w.shape
    return w.permute(0, 1, 3, 2).reshape(kh * kw, cout, cin).to(BF16).contiguous()


def pack_stage_weights(w1: torch.Tensor, b1: torch.Tensor, w2: torch.Tensor,
                       b2: torch.Tensor) -> tuple:
    """HWIO weights and biases -> the kernel's (w1, b1, w2, b2): conv1's taps
    [9, C1] bf16 for a single-channel input, else both convs' taps as
    `swizzle128` chunks [9, ceil(Cin / 64), Cout, 64]; biases fp32."""
    with torch.no_grad():
        w1p, w2p = pack_conv_weight(w1.detach()), pack_conv_weight(w2.detach())
        w1p = w1p[..., 0].contiguous() if w1.shape[2] == 1 else swizzle128(w1p)
        return (w1p, b1.detach().float().contiguous(), swizzle128(w2p),
                b2.detach().float().contiguous())


TILE_W = 32  # the kernel's output tile width (before the pool)
SMEM_LIMIT = 232448  # shared memory a block may use on the H100


def tile_rows(cin: int, c1: int, c2: int) -> int:
    """The kernel's output tile height for these channels (csrc/vgg_stage.cu
    `Cfg::TH`): the largest of 16, 8, 4, 2 whose shared-memory layout fits
    (half the card's per-block limit for the image stage, which runs two
    blocks per SM), 0 if none does."""
    kp = -(-cin // 64) * 64
    single = cin == 1
    stages, limit = (2, SMEM_LIMIT // 2 - 1024) if single else (3, SMEM_LIMIT)
    for th in (16, 8, 4, 2):
        ring = stages * 128 * max(c1, c2) + 128
        tin = (th + 4) * (TILE_W + 4) * (4 if single else (kp + 8) * 2)
        t1 = (th + 2) * (TILE_W + 2) * (c1 + 8) * 2
        if ring + -(-tin // 16) * 16 + t1 + 1024 <= limit:
            return th
    return 0


def vgg_stage_kernel(
    x: torch.Tensor,
    w1: torch.Tensor,
    b1: torch.Tensor,
    w2: torch.Tensor,
    b2: torch.Tensor,
    pool: bool = True,
    packed: tuple | None = None,
) -> torch.Tensor:
    """Launch the CUDA kernel on the plain version's inputs (`packed`: their
    `pack_stage_weights`, packed here if None). The kernel
    reads a single-channel input as fp32 and rounds it to bf16 itself; a
    multi-channel input is rounded to bf16 here (the Pallas wrapper's
    `io_dtype` cast), which leaves the previous stage's output exact."""
    b, h, w, cin = x.shape
    c1, c2 = w1.shape[-1], w2.shape[-1]
    _build.require_inference("vgg_stage", x, w1, b1, w2, b2)
    x = x.to(_out_dtype(cin)).contiguous()
    _build.require_cuda_input(x, "vgg_stage x", 4, dtype=_out_dtype(cin))
    if w1.shape != (3, 3, cin, c1) or w2.shape != (3, 3, c1, c2):
        raise ValueError(f"vgg_stage: weights {tuple(w1.shape)}, {tuple(w2.shape)} do not "
                         f"chain from Cin={cin}")
    if pool and (h % 2 or w % 2):
        raise ValueError(f"vgg_stage kernel: the 2 x 2 pool needs even H and W, got {h} x {w}")
    if (cin != 1 and (cin % 16 or cin > 128)) or c1 not in (64, 128) or c2 not in (64, 128):
        raise ValueError(f"vgg_stage kernel: unsupported channels {cin} -> {c1} -> {c2}")
    w1p, b1f, w2p, b2f = pack_stage_weights(w1, b1, w2, b2) if packed is None else packed
    for t, what, nd in ((w1p, "w1", 2 if cin == 1 else 4), (w2p, "w2", 4)):
        _build.require_cuda_input(t, f"vgg_stage {what}", nd, dtype=BF16)
    for t, what in ((b1f, "b1"), (b2f, "b2")):
        _build.require_cuda_input(t, f"vgg_stage {what}", 1)
    out_hw = (h // 2, w // 2) if pool else (h, w)
    out = torch.empty((b, *out_hw, c2), dtype=_out_dtype(cin), device=x.device)
    lib = _build.load("vgg_stage")
    err = lib.vgg_stage_launch(
        _build.ptr(x), _build.ptr(w1p), _build.ptr(b1f), _build.ptr(w2p), _build.ptr(b2f),
        _build.ptr(out), b, h, w, cin, c1, c2, int(pool), _build.stream(x.device),
    )
    _build.check(lib, err, "vgg_stage kernel")
    global launches
    launches += 1
    return out
