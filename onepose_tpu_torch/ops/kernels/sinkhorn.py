"""Resident log-space Sinkhorn: the CUDA kernel `csrc/sinkhorn.cu` (K6), the
plain version shared with the streamed kernel, and the size guard.

Replaces onepose_tpu/ops/pallas/sinkhorn.py::sinkhorn_potentials. Contract:

  (couplings [B, M, N], log_mu [B, M], log_nu [B, N], iters) -> (u, v)
  u = mu - lse_row(C + v), then v = nu - lse_col(C + u), `iters` times
  from u = v = 0, so that C + u[:, :, None] + v[:, None, :] is the
  log-assignment.

Bound on the H100: operations, the exponentials. Each iteration takes one
exp per coupling entry for the row update and one for the column update:
2 * B * M * N * iters, 3.4e9 at [16, 1025, 1025] x 100, about 0.8 ms on
the special-function units; the coupling is read from device memory once.

Design (see the source and `csrc/sinkhorn.cuh`): one persistent
cooperative launch. Each block holds a band of whole rows of one pair in
shared memory for all iterations. Its 16 warps form groups of W warps;
each thread owns fixed columns (`column_layout`) and keeps their v and
online column accumulators in registers, so a group computes the u of a
few rows and folds them into the columns in one step, in base 2 with one
exponential per entry and direction. The groups merge their accumulators
in shared memory into the block's partial; the pair's blocks meet at an
arrival counter (the scratch `ctr`, zeroed per call), each reduces its
slice of columns into v, and they meet again before reading the new v.
Columns per thread live in registers, so n is at most 8704 (`fits_smem`
sends wider rows to the streamed kernel). The instantiations are the
source's VARIANTS list (`_build.variants`). Pairs that do not fit on the
card at once run in waves, looped inside the one launch. `plan` fixes the bands;
`fits_smem` says whether one pair's bands fit on the card's SMs at once
(the guard that routes larger couplings to the streamed kernel,
`ops.kernels.sinkhorn_stream`).

`sinkhorn_potentials` launches the kernel on CUDA tensors and runs
`sinkhorn_potentials_plain` only on CPU tensors. Forward-only.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from onepose_tpu_torch.ops.kernels import _build

launches = 0  # kernel launches since the last reset (ops.kernels.reset_launches)
SMS = 132  # H100 SXM streaming multiprocessors
SMEM_PER_BLOCK = 232448  # bytes of shared memory one block may use on Hopper
RED_BYTES = 1024  # the blocks' cross-warp exchange (sinkhorn.cuh kRedBytes)
WARPS = 16  # warps of a block (both kernels)


def sinkhorn_potentials_plain(
    couplings: torch.Tensor,
    log_mu: torch.Tensor,
    log_nu: torch.Tensor,
    iters: int = 100,
    coupling_dtype: Optional[torch.dtype] = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """The kernels' function in plain PyTorch (the scan of the JAX
    package's log_sinkhorn). coupling_dtype bf16 rounds the coupling to
    bf16 first, as the streamed kernel stores it; arithmetic is fp32."""
    c = couplings.float() if coupling_dtype is None else couplings.to(coupling_dtype).float()
    log_mu, log_nu = log_mu.float(), log_nu.float()
    u, v = torch.zeros_like(log_mu), torch.zeros_like(log_nu)
    for _ in range(iters):
        u = log_mu - torch.logsumexp(c + v[:, None, :], dim=2)
        v = log_nu - torch.logsumexp(c + u[:, :, None], dim=1)
    return u, v


def column_layout(n: int, threads: int) -> tuple[int, int]:
    """(chunks, tail) of n columns over a group of `threads` threads: each
    thread owns the 4-column chunks t + threads * k for k < chunks (columns
    at and past n masked) and, for t < tail, the single column
    4 * threads * chunks + t (the dustbin column at n = 1025 or 4097)."""
    kc = n // (4 * threads)
    tail = n - 4 * threads * kc
    if kc == 0 or tail > threads:
        kc, tail = kc + 1, 0
    return kc, tail


def max_columns(table: dict[tuple[int, int], int]) -> int:
    """The widest row any instantiation of `table` (`_build.variants`) takes."""
    return max(4 * 32 * w * kc + 32 * w for w, kc in table)


def group_layout(n: int, table: dict[tuple[int, int], int], what: str) -> tuple[int, int, int]:
    """(W, KC, RS) of the instantiation for n columns: the fewest warps a
    group whose column layout of n (`column_layout`) the kernel's VARIANTS
    `table` holds."""
    for w in sorted({w for w, _ in table}):
        kc = column_layout(n, 32 * w)[0]
        if (w, kc) in table:
            return w, kc, table[w, kc]
    raise ValueError(f"{what}: {n} columns are more than the kernel's {max_columns(table)}")


def band_pitch(n: int) -> int:
    """Row pitch of a band in shared memory: n rounded up to 4 (16 bytes)."""
    return -(-n // 4) * 4


def band_smem(rows: int, n: int) -> int:
    """Shared memory of a block holding `rows` coupling rows of width n
    (fp32, pitch `band_pitch(n)`), the cross-warp exchange, the buffer that
    merges the groups' column accumulators [2, n] and the rows' mu."""
    return 4 * rows * band_pitch(n) + RED_BYTES + 8 * n + 4 * rows


def max_band_rows(n: int, smem_per_block: int = SMEM_PER_BLOCK) -> int:
    return max(0, (smem_per_block - RED_BYTES - 8 * n) // (4 * band_pitch(n) + 4))


def fits_smem(m: int, n: int, sms: int = SMS, smem_per_block: int = SMEM_PER_BLOCK) -> bool:
    """True when one pair's [m, n] coupling, in bands of whole rows that fit
    a block's shared memory, needs no more blocks than the card has SMs, and
    its rows are no wider than the kernel's widest instantiation: the
    resident kernel can hold it. (1025, 1025): 19 blocks of 54 rows;
    (2049, 2049): 79 of 26; (4097, 4097) would need 342."""
    rows = max_band_rows(n, smem_per_block)
    return (rows >= 1 and -(-m // rows) <= sms
            and n <= max_columns(_build.variants("sinkhorn")))


class Plan(NamedTuple):
    blocks_per_pair: int  # bands of one pair, one block each
    rows: int  # rows per band (the last band may hold fewer)
    smem: int  # dynamic shared memory per block, bytes
    warps_per_group: int  # W: warps that take RS rows at a time
    chunks: int  # KC: 4-column chunks a thread owns


def plan(m: int, n: int, smem_per_block: int = SMEM_PER_BLOCK, sms: int = SMS) -> Plan:
    """Bands of an [m, n] coupling: the fewest per pair, with the rows
    spread evenly over them, each band a whole number of block steps (all
    groups x RS rows) where that still fits on the card; the groups as
    `group_layout` picks them from the kernel's VARIANTS (4 warps up to
    1152 columns, 8 up to 2304, then 16). (1025, 1025): 22 bands of 47
    rows, 3 steps of 16."""
    w, kc, rs = group_layout(n, _build.variants("sinkhorn"), "sinkhorn")
    rows_max = max_band_rows(n, smem_per_block)
    if rows_max < 1:
        raise ValueError(f"sinkhorn: a coupling row of {n} fp32 does not fit shared memory")
    step = WARPS // w * rs
    cap = rows_max - rows_max % step if rows_max >= step else rows_max
    if -(-m // cap) > sms:
        cap = rows_max
    per_pair = -(-m // cap)
    rows = -(-m // per_pair)
    return Plan(per_pair, rows, band_smem(rows, n), w, kc)


def pairs_per_wave(b: int, blocks_per_pair: int, max_blocks: int) -> int:
    """Pairs resident at once when `max_blocks` blocks of the kernel fit on
    the card together; the launch loops over ceil(b / pairs) waves."""
    if blocks_per_pair > max_blocks:
        raise ValueError(f"sinkhorn: one pair needs {blocks_per_pair} resident blocks, the "
                         f"card holds {max_blocks}")
    return min(b, max_blocks // blocks_per_pair)


def sinkhorn_potentials(
    couplings: torch.Tensor,
    log_mu: torch.Tensor,
    log_nu: torch.Tensor,
    iters: int = 100,
) -> tuple[torch.Tensor, torch.Tensor]:
    """couplings [B, M, N] fp32 log-scores (masked slots NEG_INF), log_mu
    [B, M], log_nu [B, N] -> (u [B, M], v [B, N])."""
    if couplings.device.type == "cpu":
        return sinkhorn_potentials_plain(couplings, log_mu, log_nu, iters)
    return sinkhorn_kernel(couplings, log_mu, log_nu, iters)


def check_inputs(what: str, couplings, log_mu, log_nu) -> None:
    b, m, n = couplings.shape
    _build.require_cuda_input(log_mu, f"{what} log_mu", 2)
    _build.require_cuda_input(log_nu, f"{what} log_nu", 2)
    if log_mu.shape != (b, m) or log_nu.shape != (b, n):
        raise ValueError(f"{what}: log_mu must be [B, M] and log_nu [B, N] for couplings "
                         f"{tuple(couplings.shape)}")


def sinkhorn_kernel(
    couplings: torch.Tensor,
    log_mu: torch.Tensor,
    log_nu: torch.Tensor,
    iters: int = 100,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Launch the resident kernel (one cooperative launch per call)."""
    _build.require_cuda_input(couplings, "sinkhorn couplings", 3)
    check_inputs("sinkhorn", couplings, log_mu, log_nu)
    b, m, n = couplings.shape
    lib = _build.load("sinkhorn")
    p = plan(m, n)
    max_blocks = _build.resident_blocks(lib, "sinkhorn_max_blocks", p.warps_per_group, p.chunks,
                                        p.smem)
    ppw = pairs_per_wave(b, p.blocks_per_pair, max_blocks)
    f32 = dict(dtype=torch.float32, device=couplings.device)
    u, v = torch.empty(b, m, **f32), torch.empty(b, n, **f32)
    part = torch.empty(b * p.blocks_per_pair * 2 * n, **f32)
    vbuf = torch.empty(b * n, **f32)
    ctr = torch.zeros(b, dtype=torch.int32, device=couplings.device)  # the pair barriers
    P = _build.ptr
    err = lib.sinkhorn_launch(P(couplings), P(log_mu), P(log_nu), P(u), P(v), P(part), P(vbuf),
                              P(ctr), b, m, n, int(iters), p.rows, p.blocks_per_pair, ppw,
                              p.warps_per_group, p.chunks, p.smem,
                              _build.stream(couplings.device))
    _build.check(lib, err, "sinkhorn kernel")
    global launches
    launches += 1
    return u, v
