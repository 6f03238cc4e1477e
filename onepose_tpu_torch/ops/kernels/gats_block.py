"""Fused GATsSPG block: the CUDA kernels `csrc/gats_block.cu` and the plain version.

Replaces onepose_tpu/ops/pallas/gats_block.py::fused_gats_block: one
[GATs, self, cross] matcher block per example,

  x3 <- elu(GATs leaf attention)                 (all fp32)
  x2 <- x2 + MLP([x2, selfattn(x2)]), x3 <- x3 + MLP([x3, selfattn(x3)])
  x2, x3 <- x2 + MLP([x2, cross(x2 <- x3)]), x3 + MLP([x3, cross(x3 <- x2)])

with shared self weights and shared cross weights. Masks m2 / m3 zero the
keys' feature map; the leaf mask is additive. The instance norm takes its
statistics over all N rows, padded ones included (reference parity).

Rounding points (the Pallas kernel's): every product rounds both operands
to `dtype` and sums in fp32; q, k, v, phi and the key sums stay fp32; kv is
rounded where it feeds the numerator; the per-head normaliser goes through
`dtype` as well (z_h = sum of rounded phi_q * s_k, then its rounded
reciprocal), unlike the XLA attention path, which keeps it in fp32.

Bound on the H100: operations, about 66 GFLOP per block at the production
shape (0.067 ms at 989 TFLOP/s of bf16). The kernel is a sequence of 37
hand-written launches (GATs, GEMMs on wgmma with TMA-fed weights in bf16,
kv moments, apply, instance-norm statistics); see the source for the
design. In bf16 the leaves may come as bf16 (the values the bf16 path
holds), and the attention output and message are stored in bf16 between
launches: their readers round them to bf16, so no rounding point moves.

`fused_gats_block` launches the kernels on CUDA tensors and runs
`fused_gats_block_plain` only on CPU tensors. Forward-only: a CUDA input
that requires grad raises. `kernel_weights` lays the packed parameters out
for the kernels; a caller that runs the same weights again passes its
result as `packed=` (GATsSPG keeps it in a `PackCache`), so that a
call holds only kernel launches.
"""

from __future__ import annotations

import ctypes
import math
from typing import Optional

import torch
import torch.nn.functional as F

from onepose_tpu_torch.ops.kernels import _build
from onepose_tpu_torch.ops.kernels._layout import swizzle128
from onepose_tpu_torch.ops.kernels.gats import (
    additive_mask,
    gats_leaf_attention_plain,
    leaf_logit_vectors,
)
from onepose_tpu_torch.utils.precision import fp32_matmuls, rounded

launches = 0  # kernel launches since the last reset (ops.kernels.reset_launches)
gemm_launches = 0  # launches of the block's GEMM alone (`gemm`, a timing yardstick)
EPS_ATTN = 1e-6
EPS_NORM = 1e-5
HEAD_DIM = 64  # the kernel's head width: C = 64 * num_heads
_ATTN = ("proj_q", "proj_k", "proj_v", "merge")
# The pointer table of gats_block_launch, in the source's `Ptr` order.
PTRS = (
    "x2", "x3", "leaves", "m2", "m3", "leafadd", "wa",
    "self_wqkv", "self_bqkv", "self_wm", "self_bm", "self_w0", "self_b0", "self_w1", "self_b1",
    "cross_wqkv", "cross_bqkv", "cross_wm", "cross_bm", "cross_w0", "cross_b0", "cross_w1",
    "cross_b1",
    "x2o", "x3o",
    "x3g", "x2s", "x3s", "qkv2", "qkv3", "att", "msg", "t", "kvpart", "kv", "skpart", "sk",
    "pmean", "pm2", "mean", "rstd",
)
STAT_ROWS = 128  # rows per partial instance-norm statistic (csrc: SROWS)
GEMM_N = 256  # the bf16 GEMM's tile width: C must be a multiple of it in bf16


def pack_block_params(gats_layer, self_layer, cross_layer) -> dict:
    """A block's modules (GraphAttentionLayer, AttentionalPropagation x 2)
    -> the packed parameters, in the JAX package's layout: wa [2, C];
    {self,cross}_w4 [4, C, C] ([in, out] kernels of q, k, v, merge), _b4
    [4, C], _w0 [2C, 2C], _b0 [2C], _w1 [2C, C], _b1 [C]. fp32, detached."""

    def f(t):
        return t.detach().float()

    C = gats_layer.W.shape[0]
    a = f(gats_layer.a)[:, 0]
    out = {"wa": leaf_logit_vectors(f(gats_layer.W), torch.stack([a[:C], a[C:]]))}
    for name, layer in (("self", self_layer), ("cross", cross_layer)):
        attn, mlp = layer.attn, layer.mlp
        out[f"{name}_w4"] = torch.stack([f(getattr(attn, k).weight).T for k in _ATTN])
        out[f"{name}_b4"] = torch.stack([f(getattr(attn, k).bias) for k in _ATTN])
        out[f"{name}_w0"] = f(mlp.dense_0.weight).T
        out[f"{name}_b0"] = f(mlp.dense_0.bias)
        out[f"{name}_w1"] = f(mlp.dense_1.weight).T
        out[f"{name}_b1"] = f(mlp.dense_1.bias)
    return out


def _elu(x: torch.Tensor) -> torch.Tensor:
    """The reference block's elu: exp(min(x, 0)) - 1 below zero."""
    return torch.where(x > 0, x, torch.exp(x.clamp(max=0.0)) - 1.0)


def fused_gats_block_plain(
    x2: torch.Tensor,
    x3: torch.Tensor,
    leaves: torch.Tensor,
    mask2: Optional[torch.Tensor],
    mask3: Optional[torch.Tensor],
    leaf_mask: Optional[torch.Tensor],
    params: dict,
    alpha: float = 0.2,
    num_heads: int = 4,
    dtype: torch.dtype = torch.bfloat16,
) -> tuple[torch.Tensor, torch.Tensor]:
    """The block's math in plain PyTorch with the kernel's rounding points;
    fp32 matmuls (TF32 off) of `dtype`-rounded operands. Returns (x2', x3')
    fp32."""
    B, N2, C = x2.shape
    N3 = x3.shape[1]
    H, D = num_heads, C // num_heads

    def r(t):
        return rounded(t, dtype)

    def dot(a, w):
        return r(a) @ r(w)

    def mask(m, n):
        return torch.ones((B, n, 1), device=x2.device) if m is None else m.float()[..., None]

    m2, m3 = mask(mask2, N2), mask(mask3, N3)

    def linear_attn(xq, xkv, mkv, w4, b4):
        n, m = xq.shape[1], xkv.shape[1]
        q = dot(xq, w4[0]) + b4[0]
        k = dot(xkv, w4[1]) + b4[1]
        v = dot(xkv, w4[2]) + b4[2]
        phi_q = _elu(q) + 1.0
        phi_k = (_elu(k) + 1.0) * mkv
        kv = torch.einsum("bmhd,bmhe->bhde", r(phi_k).reshape(B, m, H, D),
                          r(v).reshape(B, m, H, D))
        num = torch.einsum("bnhd,bhde->bnhe", r(phi_q).reshape(B, n, H, D), r(kv))
        s_k = phi_k.sum(dim=1, keepdim=True)  # [B, 1, C]
        z_h = r(phi_q * s_k).reshape(B, n, H, D).sum(-1)  # [B, N, H]
        z = r(1.0 / (z_h + EPS_ATTN))
        out = (num * z[..., None]).reshape(B, n, C)
        return dot(out, w4[3]) + b4[3]

    def mlp(x, msg, w0, b0, w1, b1):
        t = dot(x, w0[:C]) + dot(msg, w0[C:]) + b0
        mu = t.mean(dim=1, keepdim=True)
        var = (t - mu).square().mean(dim=1, keepdim=True)
        t = F.relu((t - mu) * torch.rsqrt(var + EPS_NORM))
        return dot(t, w1) + b1

    p = {k: v.float() for k, v in params.items()}
    with fp32_matmuls():
        x2, x3 = x2.float(), x3.float()
        x3 = gats_leaf_attention_plain(leaves.float(), x3, additive_mask(leaf_mask), p["wa"],
                                       alpha)
        for stream in ("x2", "x3"):
            x, m = (x2, m2) if stream == "x2" else (x3, m3)
            msg = linear_attn(x, x, m, p["self_w4"], p["self_b4"])
            x = x + mlp(x, msg, p["self_w0"], p["self_b0"], p["self_w1"], p["self_b1"])
            x2, x3 = (x, x3) if stream == "x2" else (x2, x)
        cross = [p[f"cross_{k}"] for k in ("w0", "b0", "w1", "b1")]
        d2 = mlp(x2, linear_attn(x2, x3, m3, p["cross_w4"], p["cross_b4"]), *cross)
        d3 = mlp(x3, linear_attn(x3, x2, m2, p["cross_w4"], p["cross_b4"]), *cross)
    return x2 + d2, x3 + d3


def fused_gats_block(
    x2: torch.Tensor,
    x3: torch.Tensor,
    leaves: torch.Tensor,
    mask2: Optional[torch.Tensor],
    mask3: Optional[torch.Tensor],
    leaf_mask: Optional[torch.Tensor],
    params: dict,
    alpha: float = 0.2,
    num_heads: int = 4,
    dtype: torch.dtype = torch.bfloat16,
    packed: Optional[dict] = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """One [GATs, self, cross] block: x2 [B, N2, C], x3 [B, N3, C], leaves
    [B, N3, L, C] (fp32, or bf16 in bf16), bool masks [B, N2] / [B, N3] /
    [B, N3, L] or None, params from `pack_block_params`; dtype float32 or
    bfloat16. Returns (x2', x3') fp32; the kernels on CUDA, with `packed`
    = kernel_weights(params, dtype) if given."""
    args = (x2, x3, leaves, mask2, mask3, leaf_mask, params, alpha, num_heads, dtype)
    if x2.device.type == "cpu":
        return fused_gats_block_plain(*args)
    return gats_block_kernel(*args, packed=packed)


def pack_gemm_weight(w: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """A GEMM's [K, N] weight as the kernels read it: bf16 `swizzle128`
    chunks [K / 64, N, 64] (the wgmma kernel's TMA tiles), or fp32 [N, K]."""
    if dtype == torch.bfloat16:
        return swizzle128(w.T)
    return w.T.float().contiguous()


def kernel_weights(params: dict, dtype: torch.dtype) -> dict:
    """The packed params as the kernels take them: each GEMM's weight by
    `pack_gemm_weight` (q, k and v side by side: N = 3C), biases and wa
    fp32."""
    with torch.no_grad():
        out = {"wa": params["wa"].float().contiguous()}
        for s in ("self", "cross"):
            w4, b4 = params[f"{s}_w4"], params[f"{s}_b4"]
            out[f"{s}_wqkv"] = pack_gemm_weight(torch.cat([w4[0], w4[1], w4[2]], dim=1), dtype)
            out[f"{s}_bqkv"] = torch.cat([b4[0], b4[1], b4[2]]).float().contiguous()
            out[f"{s}_wm"] = pack_gemm_weight(w4[3], dtype)
            out[f"{s}_bm"] = b4[3].float().contiguous()
            for k in ("w0", "w1"):
                out[f"{s}_{k}"] = pack_gemm_weight(params[f"{s}_{k}"], dtype)
            for k in ("b0", "b1"):
                out[f"{s}_{k}"] = params[f"{s}_{k}"].float().contiguous()
        return out


def gats_block_kernel(
    x2: torch.Tensor,
    x3: torch.Tensor,
    leaves: torch.Tensor,
    mask2: Optional[torch.Tensor],
    mask3: Optional[torch.Tensor],
    leaf_mask: Optional[torch.Tensor],
    params: dict,
    alpha: float = 0.2,
    num_heads: int = 4,
    dtype: torch.dtype = torch.bfloat16,
    packed: Optional[dict] = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Launch the CUDA kernels on the plain version's inputs (x2 and x3
    fp32; leaves fp32, or bf16 when dtype is bf16); `packed`: their
    `kernel_weights(params, dtype)`, packed here if None."""
    B, N2, C = x2.shape
    N3, L = leaves.shape[1], leaves.shape[2]
    _build.require_inference("gats_block", x2, x3, leaves, *params.values())
    if dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"gats_block kernel: dtype {dtype} is not float32 or bfloat16")
    if C != HEAD_DIM * num_heads or C > 512 or (dtype == torch.bfloat16 and C % GEMM_N):
        raise ValueError(f"gats_block kernel needs C = 64 * num_heads <= 512 (a multiple of "
                         f"{GEMM_N} in bf16), got C={C}, {num_heads} heads")
    leaves_bf16 = leaves.dtype == torch.bfloat16
    if leaves_bf16 and dtype != torch.bfloat16:
        raise ValueError("gats_block kernel: bf16 leaves need dtype bfloat16")
    if x3.shape != (B, N3, C) or leaves.shape != (B, N3, L, C) or min(N2, N3) == 0:
        raise ValueError("gats_block: x3 must be [B, N3, C] and leaves [B, N3, L, C], N2, N3 > 0")
    dev = x2.device

    def mask(m, n):
        return torch.ones((B, n), device=dev) if m is None else m.float().contiguous()

    kw = kernel_weights(params, dtype) if packed is None else packed
    t = {"x2": x2, "x3": x3, "leaves": leaves, "m2": mask(mask2, N2), "m3": mask(mask3, N3),
         "leafadd": additive_mask(leaf_mask), **kw}
    for name in ("x2", "x3", "leaves", "m2", "m3", "leafadd", "wa"):
        if t[name] is not None:
            _build.require_cuda_input(t[name], f"gats_block {name}", t[name].dim(),
                                      dtype=t[name].dtype if name == "leaves" else torch.float32)
    for name, v in t.items():
        if name.endswith(("_wqkv", "_wm", "_w0", "_w1")):
            _build.require_cuda_input(v, f"gats_block {name}", 3 if dtype == torch.bfloat16 else 2,
                                      dtype=dtype)
    n, chunks = max(N2, N3), -(-max(N2, N3) // 64)
    parts = -(-n // STAT_ROWS)

    # Outputs on their own; the scratch in one fp32 and one `dtype` buffer.
    t["x2o"], t["x3o"] = (torch.empty((B, n_, C), device=dev) for n_ in (N2, N3))
    scratch = {
        "x3g": (B, N3, C), "x2s": (B, N2, C), "x3s": (B, N3, C), "qkv2": (B * N2, 3 * C),
        "qkv3": (B * N3, 3 * C), "t": (B * n, 2 * C),
        "kvpart": (B, num_heads, chunks, HEAD_DIM, HEAD_DIM),
        "kv": (B, num_heads, HEAD_DIM, HEAD_DIM), "skpart": (B, chunks, C), "sk": (B, C),
        "pmean": (B, parts, 2 * C), "pm2": (B, parts, 2 * C), "mean": (B, 2 * C),
        "rstd": (B, 2 * C),
    }
    t.update(_carve(torch.empty(sum(math.prod(v) for v in scratch.values()), device=dev),
                    scratch))
    t.update(_carve(torch.empty(2 * B * n * C, device=dev, dtype=dtype),
                    {"att": (B * n, C), "msg": (B * n, C)}))
    lib = _build.load("gats_block")
    if lib.gats_block_num_ptrs() != len(PTRS):
        raise RuntimeError("gats_block: the pointer table differs from the CUDA source's")
    table = (ctypes.c_void_p * len(PTRS))(*[None if t[k] is None else t[k].data_ptr()
                                            for k in PTRS])
    err = lib.gats_block_launch(table, B, N2, N3, L, C, num_heads, float(alpha),
                                int(dtype == torch.bfloat16), int(leaves_bf16),
                                _build.stream(dev))
    _build.check(lib, err, "gats_block kernels")
    global launches
    launches += 1
    return t["x2o"], t["x3o"]


def _carve(buf: torch.Tensor, shapes: dict) -> dict:
    """Views of consecutive pieces of buf with the given shapes (every size
    here is a multiple of 64 elements, so each view stays 16-byte
    aligned)."""
    out, off = {}, 0
    for name, shape in shapes.items():
        n = math.prod(shape)
        out[name] = buf[off:off + n].view(shape)
        off += n
    return out


def gemm_plain(a: torch.Tensor, w: torch.Tensor, bias: torch.Tensor,
               dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    """a [M, K] @ w [K, N] + bias [N], operands rounded to dtype, fp32 sums."""
    with fp32_matmuls():
        return rounded(a, dtype) @ rounded(w, dtype) + bias.float()


def gemm(a: torch.Tensor, w: torch.Tensor, bias: torch.Tensor,
         dtype: torch.dtype = torch.bfloat16, packed: Optional[torch.Tensor] = None
         ) -> torch.Tensor:
    """The block's GEMM alone (the kernel on CUDA), for timing it against a
    library GEMM: a [M, K] fp32, w [K, N], bias [N]; bf16: N a multiple of
    256, K of 64; fp32: N of 64, K of 32. `packed`: pack_gemm_weight(w,
    dtype), packed here if None. Returns fp32 [M, N]."""
    if a.device.type == "cpu":
        return gemm_plain(a, w, bias, dtype)
    (m, k), n = a.shape, w.shape[1]
    bf16 = dtype == torch.bfloat16
    wt = pack_gemm_weight(w, dtype) if packed is None else packed
    b = bias.float().contiguous()
    _build.require_cuda_input(a, "gats_block gemm a", 2)
    _build.require_cuda_input(wt, "gats_block gemm w", 3 if bf16 else 2, dtype=dtype)
    if w.shape[0] != k or n % (GEMM_N if bf16 else 64) or k % (64 if bf16 else 32):
        raise ValueError(f"gats_block gemm: [{m}, {k}] x {tuple(w.shape)} does not tile")
    out = torch.empty((m, n), device=a.device)
    lib = _build.load("gats_block")
    err = lib.gats_block_gemm_launch(_build.ptr(a), _build.ptr(wt), _build.ptr(b),
                                     _build.ptr(out), m, n, k, int(dtype == torch.bfloat16),
                                     _build.stream(a.device))
    _build.check(lib, err, "gats_block gemm")
    global gemm_launches
    gemm_launches += 1
    return out
