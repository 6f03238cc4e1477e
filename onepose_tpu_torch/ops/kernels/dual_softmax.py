"""Dual-softmax match head: the CUDA kernel `csrc/dual_softmax.cu` and its
plain version.

Replaces onepose_tpu/ops/pallas/dual_softmax.py::dual_softmax_match. Bound
on the H100: bytes, one read of the [B, M, N] logits (64 MB at 8 x 1000 x
2000, about 19 us at 3.35 TB/s). The kernel makes four streaming passes
(row stats, column stats, column max of conf, then row max and the hits)
and never writes conf; see the source for the design.

Semantics follow the Pallas kernel, not `match_from_conf`: exact ties go
to the largest index, and matching_scores0/1 are non-zero only for hits.
The Pallas wrapper pads M and N with NEG_INF; the port does not, since a
padded slot never changes a valid output.

`dual_softmax_match` launches the kernel on a CUDA tensor and runs
`dual_softmax_match_plain` only on a CPU tensor. Forward-only.
"""

from __future__ import annotations

import torch

from onepose_tpu_torch.ops.kernels import _build

launches = 0  # kernel launches since the last reset (ops.kernels.reset_launches)


def _result(m0, sc0, m1, sc1) -> dict:
    return {
        "matches0": m0,
        "matches1": m1,
        "matching_scores0": sc0,
        "matching_scores1": sc1,
        "valid0": m0 >= 0,
        "valid1": m1 >= 0,
    }


def dual_softmax_match_plain(scores: torch.Tensor, threshold: float = 0.2) -> dict:
    """The kernel's function in plain PyTorch on [B, M, N] masked logits.
    Softmax denominators are summed in float64 and rounded once, as in the
    kernel, so neither depends on its summation order."""
    rmax = scores.amax(dim=2, keepdim=True)
    rsum = torch.exp(scores - rmax).sum(dim=2, keepdim=True, dtype=torch.float64).float()
    cmax = scores.amax(dim=1, keepdim=True)
    csum = torch.exp(scores - cmax).sum(dim=1, keepdim=True, dtype=torch.float64).float()
    conf = (torch.exp(scores - rmax) / rsum) * (torch.exp(scores - cmax) / csum)
    max0 = conf.amax(dim=2)  # [B, M]
    max1 = conf.amax(dim=1)  # [B, N]
    hit = (conf == max0[:, :, None]) & (conf == max1[:, None, :]) & (conf > threshold)
    m, n = scores.shape[1:]
    cols = torch.arange(n, device=scores.device, dtype=torch.int32)
    rows = torch.arange(m, device=scores.device, dtype=torch.int32)
    none = torch.full((), -1, dtype=torch.int32, device=scores.device)
    m0 = torch.where(hit, cols[None, None, :], none).amax(dim=2)
    m1 = torch.where(hit, rows[None, :, None], none).amax(dim=1)
    sc0 = torch.where(m0 >= 0, max0, 0.0)
    sc1 = torch.where(m1 >= 0, max1, 0.0)
    return _result(m0, sc0, m1, sc1)


def dual_softmax_match(scores: torch.Tensor, threshold: float = 0.2) -> dict:
    """scores: [B, M, N] fp32 similarity logits with masked slots already at
    NEG_INF. Returns matches0/1 (int32, -1 unmatched), matching_scores0/1
    and valid0/1, without materializing conf."""
    if scores.device.type == "cpu":
        return dual_softmax_match_plain(scores, threshold)
    _build.require_cuda_input(scores, "dual_softmax scores", 3)
    b, m, n = scores.shape
    f32 = dict(dtype=torch.float32, device=scores.device)
    i32 = dict(dtype=torch.int32, device=scores.device)
    rmax, rsum = torch.empty(b, m, **f32), torch.empty(b, m, **f32)
    cmax, csum, max1 = (torch.empty(b, n, **f32) for _ in range(3))
    m0, sc0 = torch.empty(b, m, **i32), torch.empty(b, m, **f32)
    m1, sc1 = torch.full((b, n), -1, **i32), torch.zeros(b, n, **f32)
    lib = _build.load("dual_softmax")
    p = _build.ptr
    err = lib.dual_softmax_launch(
        p(scores), b, m, n, float(threshold),
        p(rmax), p(rsum), p(cmax), p(csum), p(max1),
        p(m0), p(sc0), p(m1), p(sc1),
        _build.stream(scores.device),
    )
    _build.check(lib, err, "dual_softmax kernel")
    global launches
    launches += 1
    return _result(m0, sc0, m1, sc1)
