"""Dual-softmax match head: the CUDA kernel `csrc/dual_softmax.cu` and its
plain version.

Replaces onepose_tpu/ops/pallas/dual_softmax.py::dual_softmax_match. Bound
on the H100: bytes, one read of the [B, M, N] logits (64 MB at 8 x 1000 x
2000, about 19 us at 3.35 TB/s). The kernel is one cooperative launch (the
wrapper adds one memset of its scratch): frame groups of blocks, each
block holding a band of whole rows in shared memory, so each logit is read
from device memory once; the frame's blocks meet three times at an arrival
counter (column max; column sums; column max of conf), conf is computed
once per element and never written to device memory. `plan` fixes the
bands; see the source for the design.

Semantics follow the Pallas kernel, not `match_from_conf`: exact ties go
to the largest index, and matching_scores0/1 are non-zero only for hits.
The Pallas wrapper pads M and N with NEG_INF; the port does not, since a
padded slot never changes a valid output. The optional masks (True =
real) load a masked slot as NEG_INF, which is `masked_fill` followed by the
unmasked function; without masks the function is the Pallas contract.

The column sums are taken per band in float64, rounded once to fixed point
(2^shift, `fixed_shift`) and added as integers, so their value does not
depend on the order the bands finish in; the plain version sums in
float64 and rounds once, and the two round to the same float32 but in the
rare case where the float64 sums straddle a float32 rounding boundary.

`dual_softmax_match` launches the kernel on a CUDA tensor and runs
`dual_softmax_match_plain` only on a CPU tensor. Forward-only.
"""

from __future__ import annotations

from functools import lru_cache
from typing import NamedTuple, Optional

import torch

from onepose_tpu_torch.ops.kernels import _build
from onepose_tpu_torch.ops.kernels._build import SMEM_PER_BLOCK

launches = 0  # kernel launches since the last reset (ops.kernels.reset_launches)
NEG_INF = -1e9
# The planner's weight of a plan: rounds of frames x (rows of a band +
# ROUND_ROWS), the fixed cost of a frame's round (three barriers, the band
# load's latency) counted in rows. Fitted on the H100 to the three plans of
# [8, 1000, 2000] (PERF.md §6): t = rounds x (1.05e-3 rows + 2.98e-2) ms.
ROUND_ROWS = 28


def _result(m0, sc0, m1, sc1, v0=None, v1=None) -> dict:
    return {
        "matches0": m0,
        "matches1": m1,
        "matching_scores0": sc0,
        "matching_scores1": sc1,
        "valid0": m0 >= 0 if v0 is None else v0,
        "valid1": m1 >= 0 if v1 is None else v1,
    }


def apply_masks(scores: torch.Tensor, mask2d: Optional[torch.Tensor] = None,
                mask3d: Optional[torch.Tensor] = None) -> torch.Tensor:
    """scores with masked rows (mask2d [B, M] False) and columns (mask3d
    [B, N] False) set to NEG_INF, as GATsSPG's unfused head does."""
    if mask2d is not None:
        scores = scores.masked_fill(~mask2d[:, :, None], NEG_INF)
    if mask3d is not None:
        scores = scores.masked_fill(~mask3d[:, None, :], NEG_INF)
    return scores


def dual_softmax_match_plain(scores: torch.Tensor, threshold: float = 0.2,
                             mask2d: Optional[torch.Tensor] = None,
                             mask3d: Optional[torch.Tensor] = None) -> dict:
    """The kernel's function in plain PyTorch on [B, M, N] logits (masked
    first when masks are given). Softmax denominators are summed in float64
    and rounded once, as in the kernel, so neither depends on its summation
    order."""
    scores = apply_masks(scores, mask2d, mask3d)
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


class Plan(NamedTuple):
    rows: int  # rows of a band (the last band of a frame may hold fewer)
    bands: int  # bands (blocks) of a frame
    groups: int  # frames in flight: the grid is groups x bands blocks
    resident: bool  # the band is held in shared memory
    smem: int  # dynamic shared memory per block, bytes


def band_smem(rows: int, n: int, resident: bool) -> int:
    """Shared memory of a block: the band (if resident), the column max and
    sum [n], and five per-row arrays plus the row mask."""
    return (4 * rows * n if resident else 0) + 8 * n + 21 * rows


def resident_plans(b: int, m: int, n: int, sms: int = _build.SMS,
                   smem_per_block: int = SMEM_PER_BLOCK) -> list:
    """The plans that hold their bands in shared memory, one block an SM:
    for each count of frame groups, bands of m / (sms // groups) rows
    (rounded up), where they fit."""
    plans = []
    for groups in range(1, min(b, sms) + 1):
        rows = -(-m // (sms // groups))
        if band_smem(rows, n, True) <= smem_per_block:
            plans.append(Plan(rows, -(-m // rows), groups, True, band_smem(rows, n, True)))
    return plans


def plan_cost(p: Plan, b: int) -> int:
    """The planner's weight: rounds of frames x (rows + ROUND_ROWS)."""
    return -(-b // p.groups) * (p.rows + ROUND_ROWS)


@lru_cache(maxsize=64)  # the serving path asks for the same shape every call
def plan(b: int, m: int, n: int, sms: int = _build.SMS,
         smem_per_block: int = SMEM_PER_BLOCK) -> Plan:
    """The resident plan of least `plan_cost`; if no band fits, the widest
    group reads its rows from device memory in every sweep. [8, 1000, 2000]
    on 132 SMs: 3 groups of 44 bands of 23 rows."""
    plans = resident_plans(b, m, n, sms, smem_per_block)
    if plans:
        return min(plans, key=lambda p: plan_cost(p, b))
    rows = -(-m // min(sms, m))
    bands = -(-m // rows)
    smem = band_smem(rows, n, False)
    if smem > smem_per_block:
        raise ValueError(f"dual_softmax: {n} columns do not fit the kernel's shared memory")
    return Plan(rows, bands, max(1, min(b, sms // bands)), False, smem)


def fixed_shift(m: int) -> int:
    """Binary point of the fixed-point column sums: a column sums at most m
    terms of at most 1, so m * 2^shift stays below 2^62."""
    return 62 - m.bit_length()


def _check_mask(mask: Optional[torch.Tensor], shape: tuple, what: str):
    if mask is None:
        return None
    if mask.device.type != "cuda" or mask.dtype != torch.bool or tuple(mask.shape) != shape:
        raise ValueError(f"dual_softmax {what}: expected a CUDA bool tensor of shape {shape}, "
                         f"got {mask.dtype} {tuple(mask.shape)} on {mask.device}")
    if not mask.is_contiguous():
        raise ValueError(f"dual_softmax {what}: expected a contiguous tensor")
    return mask


def dual_softmax_match(scores: torch.Tensor, threshold: float = 0.2,
                       mask2d: Optional[torch.Tensor] = None,
                       mask3d: Optional[torch.Tensor] = None) -> dict:
    """scores: [B, M, N] fp32 similarity logits; mask2d [B, M] / mask3d
    [B, N] bool (True = real) or None (slots already at NEG_INF). Returns
    matches0/1 (int32, -1 unmatched), matching_scores0/1 and valid0/1,
    without materializing conf."""
    if scores.device.type == "cpu":
        return dual_softmax_match_plain(scores, threshold, mask2d, mask3d)
    return dual_softmax_kernel(scores, threshold, mask2d, mask3d)


def dual_softmax_kernel(scores: torch.Tensor, threshold: float = 0.2,
                        mask2d: Optional[torch.Tensor] = None,
                        mask3d: Optional[torch.Tensor] = None,
                        p: Optional[Plan] = None) -> dict:
    """Launch the kernel (one cooperative launch after one memset) with
    plan p, by default `plan`'s for the shape and the device's SM count."""
    _build.require_cuda_input(scores, "dual_softmax scores", 3)
    b, m, n = scores.shape
    mask2d = _check_mask(mask2d, (b, m), "mask2d")
    mask3d = _check_mask(mask3d, (b, n), "mask3d")
    dev = scores.device
    m0, sc0 = torch.empty(b, m, dtype=torch.int32, device=dev), torch.empty(b, m, device=dev)
    m1, sc1 = torch.empty(b, n, dtype=torch.int32, device=dev), torch.empty(b, n, device=dev)
    v0, v1 = torch.empty(b, m, dtype=torch.bool, device=dev), torch.empty(b, n, dtype=torch.bool,
                                                                         device=dev)
    if b * m * n == 0:
        return _result(m0.fill_(-1), sc0.zero_(), m1.fill_(-1), sc1.zero_())
    if p is None:
        p = plan(b, m, n, _build.device_sms(dev))
    # Scratch, one zero fill: column sums [B, N] u64, column max keys and
    # the column max of conf [B, N] u32 each, the frame counters [B].
    scratch = torch.zeros(4 * b * n + b, dtype=torch.int32, device=dev)
    base = scratch.data_ptr()
    lib = _build.load("dual_softmax")
    P = _build.ptr
    opt = lambda t: None if t is None else t.data_ptr()  # noqa: E731
    err = lib.dual_softmax_launch(
        P(scores), opt(mask2d), opt(mask3d), b, m, n, float(threshold),
        p.rows, p.bands, p.groups, int(p.resident), fixed_shift(m), p.smem,
        base, base + 8 * b * n, base + 12 * b * n, base + 16 * b * n,
        P(m0), P(sc0), P(m1), P(sc1), P(v0), P(v1), _build.stream(dev),
    )
    _build.check(lib, err, "dual_softmax kernel")
    global launches
    launches += 1
    return _result(m0, sc0, m1, sc1, v0, v1)
