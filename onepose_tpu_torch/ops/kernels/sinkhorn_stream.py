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

Wider rows take one of two more entries of the source, by width (`entry`):

- up to MAX_CLUSTER x 14848 columns (118784), the cluster entry
  (`plan` returns a `ClusterPlan`): a thread-block cluster of CL blocks,
  CL the fewest whose column slices each fit the widest instantiation
  (`cluster_split`), takes a range of rows; each block streams its slice
  of the rows through a TMA ring and keeps the slice's v and column
  accumulators in registers (the instantiations of the source's
  CLUSTER_VARIANTS list); the blocks exchange each stage's row partials
  (max, sum) in the cluster's shared memory and merge them in rank order,
  so that every block folds the same u. One sweep of the coupling per
  iteration, as the TPU kernel: 32 ms fp32 and 16 ms bf16 at [1, 16385,
  16385] x 100. The blocks that own the same slice reduce it over the
  pair's clusters (arrival counters per slice, `ctr` [B, CL]).
- wider, the two-sweep entry (`plan` returns a `WidePlan`): each block
  takes WIDE_ROWS rows at a time in column tiles read straight from
  device memory, one pass for the rows' u against the previous v and one
  that folds C + u into the block's column partial, which lives in the
  scratch `part` (device memory, so the width is unbounded); the pair's
  blocks then merge the partials as above. Its own floor is two sweeps
  of the coupling per iteration.

Both count their launches in `wide_launches`. The bound by the contract's
count is the exponentials at any width (about 12.8 ms at [1, 16385, 16385]
x 100, 20 ms at [1, 20481, 20481]).

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
    max_columns,
    sinkhorn_potentials_plain,
)

launches = 0  # kernel launches since the last reset (ops.kernels.reset_launches)
wide_launches = 0  # launches of the two wide entries (cluster, two-sweep), likewise
NEG_INF = -1e9
PITCH = 8  # row pitch quantum of the stored coupling: 16 bytes of bf16


def row_pitch(n: int) -> int:
    return -(-n // PITCH) * PITCH


STAGE_BYTES = 65536  # bytes a stage aims at (one bulk copy)
MIN_STAGES = 3
WIDE_ROWS = 8  # rows a block of the two-sweep entry takes at a time (csrc kWideRows)
MAX_CLUSTER = 8  # blocks of a cluster at most: the portable cluster size (csrc kMaxCluster)
X_SLOTS = 4  # slots of the cluster entry's exchange (csrc kXSlots)


def widest() -> int:
    """The widest row of the source's VARIANTS instantiations (14848); wider
    rows take the cluster or the two-sweep entry (`entry`)."""
    return max_columns(_build.variants("sinkhorn_stream"))


def entry(n: int) -> str:
    """The entry of the source that takes rows of n columns: "variants" up
    to `widest()`, "cluster" up to MAX_CLUSTER times that, "two_sweep"
    above."""
    if n <= widest():
        return "variants"
    return "cluster" if n <= MAX_CLUSTER * widest() else "two_sweep"


def cluster_split(n: int) -> tuple[int, int]:
    """(CL, S) of the cluster entry for n columns: CL blocks, the fewest
    whose slices each fit `widest()`, each S columns (n / CL rounded up to
    a multiple of PITCH, so that each row's slice starts 16 bytes aligned)
    but the last, which takes the rest (the dustbin column with it)."""
    cl = -(-n // widest())
    if cl > MAX_CLUSTER:
        raise ValueError(f"sinkhorn_stream: {n} columns need more than {MAX_CLUSTER} blocks a "
                         "cluster")
    s = row_pitch(-(-n // cl))
    assert 0 < n - (cl - 1) * s <= s
    return cl, s


def cluster_layout(s: int) -> tuple[int, int, int]:
    """(W, KC, RS) of the cluster entry for slices of s columns, from the
    source's CLUSTER_VARIANTS: one group of 16 warps (two groups of 8 on
    slices half as wide, twice the blocks a cluster, were no faster on the
    H100)."""
    return group_layout(s, _build.variants("sinkhorn_stream", "CLUSTER_VARIANTS"),
                        "sinkhorn_stream cluster")


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


def cluster_ring(s: int, cl: int, elem_bytes: int = 4,
                 smem_per_block: int = SMEM_PER_BLOCK) -> Ring:
    """The cluster entry's ring for slices of s columns (pitch s): stages
    of about STAGE_BYTES of whole block steps (RS rows), as many as shared
    memory holds beside the warps' exchange, X_SLOTS exchange barriers and
    the cluster's [X_SLOTS, CL, stage_rows] float2 partials (each stage
    with an mbarrier and a counter, 16 bytes); fewer rows a stage if that
    leaves fewer than MIN_STAGES. [*, 16385] fp32 (slices of 8200): 3
    stages of 2 rows; [*, 20481] fp32 (10248): 5 stages of one row."""
    row = s * elem_bytes
    rs = cluster_layout(s)[2]

    def room(r):
        return smem_per_block - RED_BYTES - 8 * X_SLOTS - X_SLOTS * cl * r * 8

    r = -(-STAGE_BYTES // (row * rs)) * rs
    if room(r) // (r * row + 16) < MIN_STAGES:
        r = (room(r) // MIN_STAGES - 16) // row
        r -= r % rs
    if r < 1:
        raise ValueError(f"sinkhorn_stream: {MIN_STAGES} stages of slices of {s} columns do not "
                         "fit shared memory")
    stages = room(r) // (r * row + 16)
    return Ring(r, stages, smem_per_block - room(r) + stages * (r * row + 16))


class Plan(NamedTuple):
    stage_rows: int  # rows of a stage
    stages: int  # stages in the ring
    blocks_per_pair: int  # blocks that split one pair's rows
    rows: int  # rows of a pair per block (the last block may hold fewer)
    pairs_per_wave: int  # pairs resident at once; the launch loops over waves
    smem: int  # dynamic shared memory per block, bytes
    warps_per_group: int  # W: warps that take RS rows at a time
    chunks: int  # KC: 4-column chunks a thread owns


class ClusterPlan(NamedTuple):
    cluster: int  # CL: blocks of a cluster, one column slice each
    slice_cols: int  # S: columns of a slice (the last slice takes the rest)
    stage_rows: int  # rows of a stage
    stages: int  # stages in a block's ring
    clusters_per_pair: int  # clusters that split one pair's rows
    rows: int  # rows of a pair per cluster (the last cluster may hold fewer)
    pairs_per_wave: int  # pairs resident at once; the launch loops over waves
    smem: int  # dynamic shared memory per block, bytes
    chunks: int  # KC: 4-column chunks a thread owns (16 warps, one group)


class WidePlan(NamedTuple):
    blocks_per_pair: int  # blocks that split one pair's rows
    rows: int  # rows of a pair per block (the last block may hold fewer)
    pairs_per_wave: int  # pairs resident at once; the launch loops over waves


def two_sweep_plan(b: int, m: int, max_blocks: int) -> WidePlan:
    """The two-sweep entry's split of b pairs of m rows (any width):
    WIDE_ROWS-row steps over as many blocks as the card holds."""
    per_pair = max(1, min(-(-m // WIDE_ROWS), max_blocks // b))
    return WidePlan(per_pair, -(-m // per_pair), min(b, max_blocks // per_pair))


def plan(b: int, m: int, n: int, max_blocks: int, elem_bytes: int = 4,
         smem_per_block: int = SMEM_PER_BLOCK, max_clusters: Optional[int] = None):
    """Split a [b, m, n] problem over `max_blocks` resident blocks: as many
    blocks (clusters, for the cluster entry: `max_clusters` of them
    resident, max_blocks // CL if None) per pair as there are stages of
    rows (WIDE_ROWS-row steps for the two-sweep entry), up to an equal
    share of the card, and the pairs in waves when there are more pairs
    than blocks; the groups as `layout` gives them. By `entry(n)`: a `Plan`,
    a `ClusterPlan` or a `WidePlan`."""
    route = entry(n)
    if route == "two_sweep":
        return two_sweep_plan(b, m, max_blocks)
    if route == "cluster":
        cl, s = cluster_split(n)
        rg = cluster_ring(s, cl, elem_bytes, smem_per_block)
        clusters = max_blocks // cl if max_clusters is None else max_clusters
        per_pair = max(1, min(-(-m // rg.stage_rows), clusters // b))
        return ClusterPlan(cl, s, rg.stage_rows, rg.stages, per_pair, -(-m // per_pair),
                           min(b, clusters // per_pair), rg.smem, cluster_layout(s)[1])
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
    out = torch.empty((b, m, ldc), dtype=dtype, device=couplings.device)
    out[..., n:] = NEG_INF
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
    """Launch the streamed kernel (one cooperative launch per call) through
    the entry that `entry(n)` names: the VARIANTS entry up to `widest()`
    columns, the cluster entry up to MAX_CLUSTER times that, the two-sweep
    entry above. A launch that fails raises; no entry stands in for
    another."""
    _build.require_cuda_input(couplings, "sinkhorn_stream couplings", 3)
    check_inputs("sinkhorn_stream", couplings, log_mu, log_nu)
    b, m, n = couplings.shape
    stored = stored_coupling(couplings, coupling_dtype)
    lib = _build.load("sinkhorn_stream")
    esize = stored.element_size()
    route = entry(n)
    max_clusters = None
    if route == "two_sweep":
        max_blocks = _build.resident_blocks(lib, "sinkhorn_stream_wide_max_blocks")
    elif route == "cluster":
        cl, s = cluster_split(n)
        max_blocks = _build.device_sms(couplings.device)
        max_clusters = _build.resident_blocks(lib, "sinkhorn_stream_cluster_max_clusters",
                                              cluster_layout(s)[1], cl,
                                              cluster_ring(s, cl, esize).smem)
    else:
        w, kc, _ = layout(n)
        max_blocks = _build.resident_blocks(lib, "sinkhorn_stream_max_blocks", w, kc,
                                            ring(n, esize).smem)
    p = plan(b, m, n, max_blocks, esize, max_clusters=max_clusters)
    parts = p.clusters_per_pair if route == "cluster" else p.blocks_per_pair
    f32 = dict(dtype=torch.float32, device=couplings.device)
    u, v = torch.empty(b, m, **f32), torch.empty(b, n, **f32)
    part = torch.empty(b * parts * 2 * n, **f32)
    vbuf = torch.empty(b * n, **f32)
    # The arrival counters: one a pair (one a pair and slice for the cluster entry).
    ctr = torch.zeros(b * (p.cluster if route == "cluster" else 1), dtype=torch.int32,
                      device=couplings.device)
    P = _build.ptr
    head = (P(stored), int(stored.dtype == torch.bfloat16), P(log_mu), P(log_nu), P(u), P(v),
            P(part), P(vbuf), P(ctr), b, m, n, stored.shape[2], int(iters))
    st = _build.stream(couplings.device)
    if route == "two_sweep":
        err = lib.sinkhorn_stream_wide_launch(*head, p.rows, p.blocks_per_pair,
                                              p.pairs_per_wave, st)
    elif route == "cluster":
        err = lib.sinkhorn_stream_cluster_launch(
            *head, p.stage_rows, p.stages, p.rows, p.clusters_per_pair, p.pairs_per_wave,
            p.cluster, p.slice_cols, p.chunks, p.smem, st)
    else:
        err = lib.sinkhorn_stream_launch(
            *head, p.stage_rows, p.stages, p.rows, p.blocks_per_pair, p.pairs_per_wave,
            p.warps_per_group, p.chunks, p.smem, st)
    _build.check(lib, err, f"sinkhorn_stream kernel ({route} entry)")
    global launches, wide_launches
    if route == "variants":
        launches += 1
    else:
        wide_launches += 1
    return u, v
