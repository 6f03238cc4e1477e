"""Streamed log-space Sinkhorn: the CUDA kernel `csrc/sinkhorn_stream.cu` (K7).

Replaces onepose_tpu/ops/pallas/sinkhorn_stream.py::sinkhorn_potentials_streamed,
for couplings too large to stay in shared memory (the SfM budget of 4096
keypoints gives [4097, 4097], 67 MB a pair). Same contract as
`ops.kernels.sinkhorn.sinkhorn_potentials`, and the Pallas kernel's order:
each row block's u comes from the previous iteration's v, and the block's
share of lse_col(C + u) is folded into an online (max, sum) accumulator,
so one iteration reads the coupling once.

coupling_dtype=torch.bfloat16 stores the coupling in bf16 (half the bytes
of each sweep); every add, max, exp and log stays fp32. The plain version
(`sinkhorn.sinkhorn_potentials_plain`) rounds the coupling the same way.

Bound on the H100: by the contract's count (each input byte read once) the
exponentials, 2 * B * M * N * iters (2.35e10 at [7, 4097, 4097] x 100,
about 5.6 ms); the design's own floor is one sweep of the coupling per
iteration, 470 MB at that shape, 14 ms in fp32 and 7 ms in bf16.

Design (see the source and `csrc/sinkhorn.cuh`): one persistent
cooperative launch. The blocks of a pair split its rows. Each block
streams its rows, iteration after iteration, through a ring of `stages`
stages of `stage_rows` rows in shared memory (one TMA bulk copy per
stage, about 64 KB; the last warp to leave a stage refills its slot), so
the loads run on across the iterations' ends. Its 16 warps, in groups of
W, take RS rows of a stage at a time (`layout`: two, one above 8704
columns), keep v and their columns' online accumulators in registers and
work in base 2, one exponential per entry and direction; rows of up to
14848 columns, the instantiations of the source's VARIANTS list. The groups merge into one partial per block; the pair's
blocks meet at arrival counters (the scratch `ctr`, zeroed per call)
around a column reduce split over them. The wrapper stores the coupling with its row
pitch padded to a multiple of 8 elements, so that every row starts
16-byte aligned; the padding is NEG_INF.

`sinkhorn_potentials_streamed` launches the kernel on CUDA tensors and
runs the plain version only on CPU tensors. Forward-only.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from onepose_tpu_torch.ops.kernels import _build
from onepose_tpu_torch.ops.kernels.sinkhorn import (
    RED_BYTES,
    SMEM_PER_BLOCK,
    WARPS,
    check_inputs,
    group_layout,
    sinkhorn_potentials_plain,
)

launches = 0  # kernel launches since the last reset (ops.kernels.reset_launches)
NEG_INF = -1e9
PITCH = 8  # row pitch quantum of the stored coupling: 16 bytes of bf16


def row_pitch(n: int) -> int:
    return -(-n // PITCH) * PITCH


STAGE_BYTES = 65536  # bytes a stage aims at (one bulk copy)
MIN_STAGES = 3


def layout(n: int) -> tuple[int, int, int]:
    """(W, KC, RS) of the instantiation for n columns, from the source's
    VARIANTS: two groups of 8 warps up to 4352 columns, else one of 16
    (one row a step above 8704), at most 14848 columns."""
    return group_layout(n, _build.variants("sinkhorn_stream"), "sinkhorn_stream")


class Ring(NamedTuple):
    stage_rows: int  # rows of a stage
    stages: int  # stages in the ring
    smem: int  # dynamic shared memory per block, bytes


def ring(n: int, elem_bytes: int = 4, smem_per_block: int = SMEM_PER_BLOCK) -> Ring:
    """Stages of about STAGE_BYTES of whole rows (pitch `row_pitch(n)`, a
    whole number of block steps, all groups x RS rows, where possible), as
    many as shared memory holds beside the exchange and the groups' merge
    buffer [2, n] (none with one group), each with an mbarrier and a
    counter (16 bytes); fewer rows a stage if that leaves fewer than
    MIN_STAGES. [*, 4097]: 3 stages of 4 fp32 rows or of 8 bf16 rows, 64 KB
    each; [*, 14848]: 3 stages of one fp32 row."""
    row = row_pitch(n) * elem_bytes
    w, _, rs = layout(n)
    merge = 8 * n if w < WARPS else 0
    room = smem_per_block - RED_BYTES - merge
    q = WARPS // w * rs
    r = -(-STAGE_BYTES // (row * q)) * q
    if room // (r * row + 16) < MIN_STAGES:
        r = (room // MIN_STAGES - 16) // row
        r = r - r % q if r >= q else r
    if r < 1:
        raise ValueError(f"sinkhorn_stream: {MIN_STAGES} coupling rows of {n} do not fit shared "
                         "memory")
    stages = room // (r * row + 16)
    return Ring(r, stages, stages * (r * row + 16) + RED_BYTES + merge)


class Plan(NamedTuple):
    stage_rows: int  # rows of a stage
    stages: int  # stages in the ring
    blocks_per_pair: int  # blocks that split one pair's rows
    rows: int  # rows of a pair per block (the last block may hold fewer)
    pairs_per_wave: int  # pairs resident at once; the launch loops over waves
    smem: int  # dynamic shared memory per block, bytes
    warps_per_group: int  # W: warps that take RS rows at a time
    chunks: int  # KC: 4-column chunks a thread owns


def plan(b: int, m: int, n: int, max_blocks: int, elem_bytes: int = 4,
         smem_per_block: int = SMEM_PER_BLOCK) -> Plan:
    """Split a [b, m, n] problem over `max_blocks` resident blocks: as many
    blocks per pair as there are stages of rows, up to an equal share of
    the card, and the pairs in waves when there are more pairs than blocks;
    the groups as `layout` gives them."""
    rg = ring(n, elem_bytes, smem_per_block)
    w, kc, _ = layout(n)
    per_pair = max(1, min(-(-m // rg.stage_rows), max_blocks // b))
    rows = -(-m // per_pair)
    return Plan(rg.stage_rows, rg.stages, per_pair, rows, min(b, max_blocks // per_pair), rg.smem,
                w, kc)


def stored_coupling(couplings: torch.Tensor, coupling_dtype: Optional[torch.dtype]):
    """The coupling as the kernel reads it: in `coupling_dtype` (fp32 if
    None), row pitch a multiple of 8, the padding NEG_INF (never read)."""
    dtype = coupling_dtype or torch.float32
    b, m, n = couplings.shape
    ldc = row_pitch(n)
    if ldc == n and couplings.dtype == dtype and couplings.is_contiguous():
        return couplings
    out = torch.full((b, m, ldc), NEG_INF, dtype=dtype, device=couplings.device)
    out[..., :n] = couplings
    return out


def sinkhorn_potentials_streamed(
    couplings: torch.Tensor,
    log_mu: torch.Tensor,
    log_nu: torch.Tensor,
    iters: int = 100,
    coupling_dtype: Optional[torch.dtype] = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """couplings [B, M, N] fp32 log-scores (masked slots NEG_INF), log_mu
    [B, M], log_nu [B, N] -> (u [B, M], v [B, N]). coupling_dtype: None
    (fp32) or torch.bfloat16 storage of the streamed coupling."""
    if coupling_dtype not in (None, torch.float32, torch.bfloat16):
        raise ValueError(f"sinkhorn_stream: coupling_dtype {coupling_dtype} is not fp32 or bf16")
    if couplings.device.type == "cpu":
        return sinkhorn_potentials_plain(couplings, log_mu, log_nu, iters, coupling_dtype)
    return sinkhorn_stream_kernel(couplings, log_mu, log_nu, iters, coupling_dtype)


def sinkhorn_stream_kernel(
    couplings: torch.Tensor,
    log_mu: torch.Tensor,
    log_nu: torch.Tensor,
    iters: int = 100,
    coupling_dtype: Optional[torch.dtype] = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Launch the streamed kernel (one cooperative launch per call)."""
    _build.require_cuda_input(couplings, "sinkhorn_stream couplings", 3)
    check_inputs("sinkhorn_stream", couplings, log_mu, log_nu)
    b, m, n = couplings.shape
    stored = stored_coupling(couplings, coupling_dtype)
    lib = _build.load("sinkhorn_stream")
    esize = stored.element_size()
    w, kc, _ = layout(n)
    max_blocks = _build.resident_blocks(lib, "sinkhorn_stream_max_blocks", w, kc,
                                        ring(n, esize).smem)
    p = plan(b, m, n, max_blocks, esize)
    f32 = dict(dtype=torch.float32, device=couplings.device)
    u, v = torch.empty(b, m, **f32), torch.empty(b, n, **f32)
    part = torch.empty(b * p.blocks_per_pair * 2 * n, **f32)
    vbuf = torch.empty(b * n, **f32)
    ctr = torch.zeros(b, dtype=torch.int32, device=couplings.device)  # the pair barriers
    P = _build.ptr
    err = lib.sinkhorn_stream_launch(
        P(stored), int(stored.dtype == torch.bfloat16), P(log_mu), P(log_nu), P(u), P(v),
        P(part), P(vbuf), P(ctr), b, m, n, stored.shape[2], int(iters), p.stage_rows, p.stages,
        p.rows, p.blocks_per_pair, p.pairs_per_wave, p.warps_per_group, p.chunks, p.smem,
        _build.stream(couplings.device))
    _build.check(lib, err, "sinkhorn_stream kernel")
    global launches
    launches += 1
    return u, v
