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

Design (see the source): one persistent cooperative launch. The blocks of
a pair split its rows; in every iteration each block streams its rows
through shared memory in blocks of `block_rows`, with 16-byte loads, and
keeps its columns' online accumulators in shared memory; after a
grid-wide barrier every block of the pair reduces the pair's per-block
partials into v. The wrapper stores the coupling with its row pitch padded
to a multiple of 8 elements, so that every row starts 16-byte aligned; the
kernel never reads the padding.

`sinkhorn_potentials_streamed` launches the kernel on CUDA tensors and
runs the plain version only on CPU tensors. Forward-only.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from onepose_tpu_torch.ops.kernels import _build
from onepose_tpu_torch.ops.kernels.sinkhorn import (
    SMEM_PER_BLOCK,
    check_inputs,
    sinkhorn_potentials_plain,
)

launches = 0  # kernel launches since the last reset (ops.kernels.reset_launches)
NEG_INF = -1e9
PITCH = 8  # row pitch quantum of the stored coupling: 16 bytes of bf16


def row_pitch(n: int) -> int:
    return -(-n // PITCH) * PITCH


def block_smem(rows: int, ldc: int) -> int:
    """Shared memory of a block streaming `rows` rows of pitch ldc (fp32),
    with v and the two column accumulators [ldc] and the rows' u."""
    return 4 * (rows * ldc + 3 * ldc + rows)


class Plan(NamedTuple):
    block_rows: int  # rows streamed through shared memory at a time
    blocks_per_pair: int  # blocks that split one pair's rows
    rows: int  # rows of a pair per block (the last block may hold fewer)
    pairs_per_wave: int  # pairs resident at once; the launch loops over waves
    smem: int  # dynamic shared memory per block, bytes


def block_rows(n: int, smem_per_block: int = SMEM_PER_BLOCK) -> int:
    ldc = row_pitch(n)
    return max(0, (smem_per_block // 4 - 3 * ldc) // (ldc + 1))


def plan(b: int, m: int, n: int, max_blocks: int,
         smem_per_block: int = SMEM_PER_BLOCK) -> Plan:
    """Split a [b, m, n] problem over `max_blocks` resident blocks: as many
    blocks per pair as there are row blocks, up to an equal share of the
    card, and the pairs in waves when there are more pairs than blocks."""
    r = block_rows(n, smem_per_block)
    if r < 1:
        raise ValueError(f"sinkhorn_stream: a coupling row of {n} fp32 does not fit shared "
                         "memory")
    per_pair = max(1, min(-(-m // r), max_blocks // b))
    rows = -(-m // per_pair)
    return Plan(r, per_pair, rows, min(b, max_blocks // per_pair),
                block_smem(r, row_pitch(n)))


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
    smem = block_smem(block_rows(n), row_pitch(n))
    p = plan(b, m, n, _build.resident_blocks(lib, "sinkhorn_stream_max_blocks", smem))
    f32 = dict(dtype=torch.float32, device=couplings.device)
    u, v = torch.empty(b, m, **f32), torch.empty(b, n, **f32)
    part = torch.empty(2 * b * p.blocks_per_pair * 2 * n, **f32)
    P = _build.ptr
    err = lib.sinkhorn_stream_launch(
        P(stored), int(stored.dtype == torch.bfloat16), P(log_mu), P(log_nu), P(u), P(v),
        P(part), b, m, n, stored.shape[2], int(iters), p.block_rows, p.rows,
        p.blocks_per_pair, p.pairs_per_wave, p.smem, _build.stream(couplings.device))
    _build.check(lib, err, "sinkhorn_stream kernel")
    global launches
    launches += 1
    return u, v
