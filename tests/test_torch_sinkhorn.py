"""Parity of the port's Sinkhorn kernel modules (K6 resident, K7 streamed)
and `log_sinkhorn` with the JAX package on the CPU.

On the CPU both wrappers run the one plain version,
`sinkhorn_potentials_plain`; the JAX side runs its Pallas kernels in
interpret mode and its XLA scan, as tests/test_pallas_kernels.py does.
Tolerance: 1e-4 absolute on the potentials and the log-assignment at 100
iterations, on the slots that carry mass (masked slots hold NEG_INF
sentinels, where an fp32 ulp is 64 and the value depends on summation
order). `_emulate` replays the CUDA kernels' schedule (bands of rows,
per-block column partials, the streamed kernel's online fold) in torch,
so that the blocking is held to the plain version before it runs on the
card.
"""

import random

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from onepose_tpu.models.superglue import extract_matches as jax_extract_matches
from onepose_tpu.models.superglue import log_sinkhorn as jax_log_sinkhorn
from onepose_tpu.ops.pallas.sinkhorn import sinkhorn_potentials as jax_resident
from onepose_tpu.ops.pallas.sinkhorn_stream import sinkhorn_potentials_streamed as jax_streamed
from onepose_tpu_torch.models import superglue
from onepose_tpu_torch.models.superglue import extract_matches, log_sinkhorn
from onepose_tpu_torch.ops.kernels import _build, sinkhorn, sinkhorn_stream

torch.set_num_threads(2)

NEG = -1e9
ITERS = 100


def _problem(seed, b, m, n, scale=1.0):
    """Masked couplings and log-marginals as the kernels get them."""
    rng = np.random.default_rng(seed)
    c = (rng.normal(size=(b, m, n)) * scale).astype(np.float32)
    m0 = rng.random((b, m)) < 0.8
    m1 = rng.random((b, n)) < 0.8
    c = np.where(m0[:, :, None] & m1[:, None, :], c, NEG).astype(np.float32)
    mu = np.where(m0, -np.log(m), NEG).astype(np.float32)
    nu = np.where(m1, -np.log(n), NEG).astype(np.float32)
    return c, mu, nu, m0, m1


def _close_on(mask, got, want, atol=1e-4):
    np.testing.assert_allclose(np.where(mask, np.asarray(got), 0.0),
                               np.where(mask, np.asarray(want), 0.0), atol=atol, rtol=0)


def _jax_scan(c, mu, nu, iters):
    def body(carry, _):
        u, v = carry
        u = mu - jax.nn.logsumexp(c + v[:, None, :], axis=2)
        v = nu - jax.nn.logsumexp(c + u[:, :, None], axis=1)
        return (u, v), None

    (u, v), _ = jax.lax.scan(body, (jnp.zeros_like(mu), jnp.zeros_like(nu)), None, length=iters)
    return u, v


@pytest.mark.parametrize("shape", [(2, 65, 97), (2, 130, 200)])
def test_plain_matches_jax_resident_and_scan(shape):
    c, mu, nu, m0, m1 = _problem(0, *shape)
    u, v = sinkhorn.sinkhorn_potentials(*map(torch.from_numpy, (c, mu, nu)), ITERS)
    for ju, jv in (jax_resident(*map(jnp.asarray, (c, mu, nu)), ITERS),
                   _jax_scan(*map(jnp.asarray, (c, mu, nu)), ITERS)):
        _close_on(m0, u, ju)
        _close_on(m1, v, jv)


def test_plain_bf16_matches_jax_streamed():
    """bf16-stored coupling at [2, 300, 260]: the JAX kernel streams three
    row blocks of 128, so its online column accumulator spans blocks."""
    c, mu, nu, m0, m1 = _problem(1, 2, 300, 260)
    ju, jv = jax_streamed(*map(jnp.asarray, (c, mu, nu)), ITERS, block_rows=128,
                          coupling_dtype=jnp.bfloat16)
    u, v = sinkhorn_stream.sinkhorn_potentials_streamed(
        *map(torch.from_numpy, (c, mu, nu)), ITERS, coupling_dtype=torch.bfloat16)
    _close_on(m0, u, ju)
    _close_on(m1, v, jv)
    # The rounding is real: fp32 storage gives other potentials.
    u32, _ = sinkhorn_stream.sinkhorn_potentials_streamed(*map(torch.from_numpy, (c, mu, nu)),
                                                          ITERS)
    assert float((u32 - u).abs()[torch.from_numpy(m0)].max()) > 1e-4


L2E, LN2 = 1.4426950408889634, 0.6931471805599453
EMPTY = float("-inf")


def _fold(m, s, ys):
    """sinkhorn.cuh fold: the entries of a step (a list of rows) into online
    column accumulators: the step's max, one rescale, one exponential per
    entry."""
    mn = torch.stack([m] + ys).amax(0)
    s = s * torch.exp2(m - mn)
    for y in ys:
        s = s + torch.exp2(y - mn)
    return mn, s


def _merge(m, s, m2, s2):
    """lse_merge in base 2: an empty side is taken over as it is."""
    mn = torch.maximum(m, m2)
    both = s * torch.exp2(m - mn) + s2 * torch.exp2(m2 - mn)
    s_out = torch.where(m2 == EMPTY, s, torch.where(m == EMPTY, s2, both))
    return torch.where(m2 == EMPTY, m, torch.where(m == EMPTY, m2, mn)), s_out


def _warp_of_column(n, threads, lanes):
    """The warp of a group that owns each column (sinkhorn.cuh Columns):
    chunk q = j // 4 on thread q % threads, the tail column on thread j -
    4 * threads * chunks."""
    kc, tail = sinkhorn.column_layout(n, threads)
    j = torch.arange(n)
    owner = torch.where(j < 4 * threads * kc, (j // 4) % threads, j - 4 * threads * kc)
    assert int((j >= 4 * threads * kc).sum()) == tail and bool((owner < threads).all())
    return owner // lanes


def _row_lse(x, warp_of, warps):
    """row_lse over the last axis of x (a row, or rows side by side): per-warp
    max and sum of exponentials, one exchange; (M, S) in base 2."""
    rows = x.reshape(-1, x.shape[-1])
    idx = warp_of.expand(rows.shape[0], -1)
    mw = torch.full((rows.shape[0], warps), EMPTY).scatter_reduce(1, idx, rows, "amax")
    sh = torch.where(mw == EMPTY, 0.0, mw)
    sw = torch.zeros(rows.shape[0], warps).scatter_add(1, idx,
                                                       torch.exp2(rows - sh.gather(1, idx)))
    M = mw.amax(1)
    S = torch.where(mw == EMPTY, 0.0, sw * torch.exp2(mw - M[:, None])).sum(1)
    return M.reshape(x.shape[:-1]), S.reshape(x.shape[:-1])


def _row_u(x, warp_of, warps, mu2):
    """row_step: row_lse, then u; base 2."""
    M, S = _row_lse(x, warp_of, warps)
    return mu2 - (M + torch.log2(S))


def _reduce_slice(pm, ps, j0, j1, threads, chunk=8):
    """reduce_slice: `sub` lanes a column, lane l taking partials l, l + sub,
    ... `chunk` at a time into an online (max, sum); then the lanes' max,
    each lane's sum scaled to it, and the xor tree; lane 0's result."""
    cols, parts = j1 - j0, pm.shape[0]
    sub = 32
    while sub > 1 and sub * cols > threads:
        sub //= 2
    lanes = []
    for lane in range(sub):
        M, S = torch.full((cols,), EMPTY), torch.zeros(cols)
        for p0 in range(lane, parts, chunk * sub):
            ps_ = range(p0, min(parts, p0 + chunk * sub), sub)
            cm = torch.stack([pm[p, j0:j1] for p in ps_]).amax(0)
            S = torch.where(cm > M, S * torch.exp2(M - cm), S)
            M = torch.maximum(M, cm)
            for p in ps_:
                S = S + ps[p, j0:j1] * torch.exp2(pm[p, j0:j1] - M)
        lanes.append((M, S))
    Mw = torch.stack([m for m, _ in lanes]).amax(0)
    sums = [torch.where(m == EMPTY, 0.0, s * torch.exp2(m - Mw)) for m, s in lanes]
    off = 1
    while off < sub:
        sums = [sums[lane] + sums[lane ^ off] for lane in range(sub)]
        off *= 2
    return Mw, sums[0]


def _emulate(c, mu, nu, iters, rows, stage_rows=None, *, stages=3, lanes=4, warps=2, groups=2,
             rs=2, reduce_threads=16, pairs_per_wave=None):
    """The CUDA kernels' schedule in torch, at a small thread count (`lanes`
    a warp, `warps` a group, `groups` a block): blocks of `rows` rows per
    pair; stage_rows None is K6 (the band resident, each group taking `rs`
    rows a step), else K7 (a ring of `stages` slots of `stage_rows` rows,
    filled in order by a producer that runs at most `stages` ahead, across
    iterations and waves; each group takes `rs` rows of a stage at a
    time, as in a band). Base 2 throughout; each group folds its rows into
    its own column accumulators (one rescale a step, one exponential per
    entry); the groups are
    merged into one partial per block; each block reduces its slice of
    columns; pairs in waves of
    `pairs_per_wave`, each block's ring carried from wave to wave."""
    b, m, n = c.shape
    threads = lanes * warps
    warp_of = _warp_of_column(n, threads, lanes)
    cpp = -(-m // rows)
    cols = -(-n // cpp)
    ppw = pairs_per_wave or b
    u2, v2 = torch.zeros(b, m), torch.zeros(b, n)
    mu2, nu2 = mu * L2E, nu * L2E
    # K7: each block's stage sequence over all its waves and iterations.
    seqs = {}
    for slot in range(ppw):
        for k in range(cpp):
            r0, r1 = k * rows, min(m, (k + 1) * rows)
            seqs[slot, k] = [(p, row0, min(stage_rows, r1 - row0))
                             for p in range(slot, b, ppw) for _ in range(iters)
                             for row0 in range(r0, r1, stage_rows)] if stage_rows else []
    rings = {key: dict(slots=torch.full((stages, stage_rows or 1, n), float("nan")),
                       filled=[-1] * stages, fills=[0] * stages, issued=0, consumed=0)
             for key in seqs}

    def consume(key):
        """The next stage of a block: the producer issues ahead while slots
        are free; the slot must hold this stage, at the phase expected."""
        rg, seq = rings[key], seqs[key]
        while rg["issued"] < len(seq) and rg["issued"] < rg["consumed"] + stages:
            gs = rg["issued"]
            p, row0, nr = seq[gs]
            sl = gs % stages
            rg["slots"][sl, :nr] = c[p, row0:row0 + nr]  # rows past nr stay stale
            rg["filled"][sl], rg["fills"][sl] = gs, rg["fills"][sl] + 1
            rg["issued"] += 1
        gs = rg["consumed"]
        sl = gs % stages
        assert rg["filled"][sl] == gs and (rg["fills"][sl] - 1) % 2 == (gs // stages) % 2
        rg["consumed"] += 1
        return seq[gs], rg["slots"][sl]

    for w0 in range(0, b, ppw):
        wave = [(slot, w0 + slot) for slot in range(ppw) if w0 + slot < b]
        for _ in range(iters):
            for slot, p in wave:
                pm, ps = [], []
                for k in range(cpp):
                    r0, r1 = k * rows, min(m, (k + 1) * rows)
                    acc = [[torch.full((n,), EMPTY), torch.zeros(n)] for _ in range(groups)]

                    def step(g, idx, crows):
                        """One group step: u of each row, then the rows folded."""
                        if not idx:
                            return
                        for i, crow in zip(idx, crows):
                            u2[p, i] = _row_u(crow * L2E + v2[p], warp_of, warps, mu2[p, i])
                        ys = [cr * L2E + u2[p, i] for i, cr in zip(idx, crows)]
                        acc[g][:] = _fold(*acc[g], ys)

                    if stage_rows is None:
                        for i0 in range(r0, r1, groups * rs):
                            for g in range(groups):
                                idx = list(range(i0 + g * rs, min(r1, i0 + (g + 1) * rs)))
                                step(g, idx, [c[p, i] for i in idx])
                    else:
                        for _ in range(r0, r1, stage_rows):
                            (p_, row0, nr), st = consume((slot, k))
                            assert p_ == p
                            for i0 in range(0, nr, groups * rs):
                                for g in range(groups):
                                    loc = list(range(i0 + g * rs, min(nr, i0 + (g + 1) * rs)))
                                    step(g, [row0 + i for i in loc], [st[i] for i in loc])
                    for g in range(groups - 1, 0, -1):  # merge_groups: into group 0
                        acc[0][:] = _merge(*acc[0], *acc[g])
                    pm.append(acc[0][0])
                    ps.append(acc[0][1])
                pm, ps = torch.stack(pm), torch.stack(ps)
                for k in range(cpp):
                    j0, j1 = min(n, k * cols), min(n, (k + 1) * cols)
                    if j1 > j0:
                        M, S = _reduce_slice(pm, ps, j0, j1, reduce_threads)
                        v2[p, j0:j1] = nu2[p, j0:j1] - (M + torch.log2(S))
    assert all(rg["consumed"] == len(seqs[key]) for key, rg in rings.items())
    return u2 * LN2, v2 * LN2


@pytest.mark.parametrize("block_rows", [None, 7])
def test_kernel_schedule_matches_plain(block_rows):
    """Resident bands (K6) and streamed stages of 7 rows (K7, a ring of 3),
    two rows a group step, with a ragged last band and stage, chunks of
    masked columns (45 over 8 threads a group), against the plain version."""
    c, mu, nu, m0, m1 = map(torch.from_numpy, _problem(2, 2, 61, 45, scale=4.0))
    want = sinkhorn.sinkhorn_potentials_plain(c, mu, nu, ITERS)
    got = _emulate(c, mu, nu, ITERS, rows=17, stage_rows=block_rows)
    _close_on(m0.numpy(), got[0], want[0])
    _close_on(m1.numpy(), got[1], want[1])


SCHEDULES = {
    # K7 as it runs: two groups, two rows a step. A block's 40 rows in
    # stages of 3 (one step short) wrap a ring of 3 slots four times an
    # iteration; 33 columns = 4 chunks of 8 threads + one tail column.
    "ring_wraps": dict(shape=(2, 61, 33), rows=40, stage_rows=3, groups=2, rs=2),
    # 5 pairs in waves of 2: the last wave holds one; the rings carry over.
    "waves": dict(shape=(5, 30, 41), rows=16, stage_rows=4, pairs_per_wave=2, groups=2, rs=2),
    # Bands of 20, 20, 20, 1: the last block's one row in a stage of 8; four
    # rows a step, as K6 takes them.
    "ragged_stage": dict(shape=(2, 61, 33), rows=20, stage_rows=8, groups=2, rs=4),
    # K6 at four groups of one warp, the last band of 8 rows ragged.
    "resident_groups": dict(shape=(3, 53, 37), rows=15, groups=4, warps=1, rs=2),
    # K7's widest instantiations: one group of all the warps (nothing to
    # merge), one row a step; 75 columns = 4 chunks of 16 threads + 11 tail.
    "one_group": dict(shape=(2, 37, 75), rows=20, stage_rows=3, groups=1, warps=4, rs=1),
}


@pytest.mark.parametrize("case", list(SCHEDULES))
def test_kernel_schedules_against_plain(case):
    cfg = dict(SCHEDULES[case])
    c, mu, nu, m0, m1 = map(torch.from_numpy, _problem(5, *cfg.pop("shape"), scale=4.0))
    want = sinkhorn.sinkhorn_potentials_plain(c, mu, nu, ITERS)
    got = _emulate(c, mu, nu, ITERS, **cfg)
    _close_on(m0.numpy(), got[0], want[0])
    _close_on(m1.numpy(), got[1], want[1])


@pytest.mark.parametrize("stage_rows", [None, 4])
def test_kernel_schedule_fully_masked_side(stage_rows):
    """No valid keypoint on side 0 (log_sinkhorn's problem with dustbins):
    every output finite, the dustbin row and the valid columns as the plain
    version gives them."""
    rng = np.random.default_rng(6)
    scores = torch.from_numpy(rng.normal(size=(2, 20, 26)).astype(np.float32))
    m0, m1 = torch.zeros(2, 20, dtype=torch.bool), torch.from_numpy(rng.random((2, 26)) < 0.8)
    c, mu, nu, _ = superglue.sinkhorn_problem(scores, torch.tensor(1.0), m0, m1)
    want = sinkhorn.sinkhorn_potentials_plain(c, mu, nu, ITERS)
    got = _emulate(c, mu, nu, ITERS, rows=8, stage_rows=stage_rows)
    assert all(bool(torch.isfinite(t).all()) for t in got)
    ones = torch.ones(2, 1, dtype=torch.bool)
    _close_on(torch.cat([m0, ones], 1).numpy(), got[0], want[0])
    _close_on(torch.cat([m1, ones], 1).numpy(), got[1], want[1])


def test_fits_smem_and_plans():
    assert sinkhorn.fits_smem(1025, 1025)  # map's default, 1024 keypoints
    assert sinkhorn.fits_smem(2049, 2049)  # fits on the H100, unlike the TPU's VMEM
    assert not sinkhorn.fits_smem(4097, 4097)  # the SfM budget goes to K7
    # 22 bands of 47 rows (at most 54 fit; 48 is 3 block steps of 4 groups x
    # 4 rows) at a pitch of 1028, the exchange, the groups' merge buffer and
    # the band's mu beside; groups of 4 warps, two chunks a thread and the
    # dustbin column as the tail.
    assert sinkhorn.max_band_rows(1025) == 54
    assert sinkhorn.plan(1025, 1025) == (22, 47, 4 * 47 * 1028 + 1024 + 8 * 1025 + 4 * 47, 4, 2)
    assert sinkhorn.plan(2049, 2049)[:2] == (86, 24)  # groups of 8, 2 rows a step
    assert sinkhorn.plan(7000, 1025)[:2] == (130, 54)  # whole steps would need 146 bands
    assert sinkhorn.plan(1025, 1025).smem <= sinkhorn.SMEM_PER_BLOCK
    assert sinkhorn.plan(2049, 2049).smem <= sinkhorn.SMEM_PER_BLOCK
    assert sinkhorn.pairs_per_wave(16, 22, 132) == 6  # 16 pairs in 3 waves
    with pytest.raises(ValueError, match="resident blocks"):
        sinkhorn.pairs_per_wave(1, 316, 132)
    assert sinkhorn.column_layout(4097, 256) == (4, 1)  # 16 columns a thread + the dustbin
    assert sinkhorn.column_layout(1025, 256) == (1, 1)
    assert sinkhorn.column_layout(3000, 256) == (3, 0)  # 952 left over: a masked chunk
    assert sinkhorn.column_layout(45, 256) == (1, 0)
    # K7: 3 stages of 4 fp32 rows (8 bf16), 64 KB each, 18 blocks of 228 rows a pair.
    stage = 4 * 4104 * 4
    for esize, stage_rows in ((4, 4), (2, 8)):
        p = sinkhorn_stream.plan(7, 4097, 4097, 132, esize)
        assert p == (stage_rows, 3, 18, 228, 7, 3 * (stage + 16) + 1024 + 8 * 4097, 8, 4)
        assert p.smem <= sinkhorn.SMEM_PER_BLOCK and p.stages >= sinkhorn_stream.MIN_STAGES
    assert sinkhorn_stream.plan(300, 33, 40, 132).pairs_per_wave == 132  # pairs in waves
    assert sinkhorn_stream.plan(1, 9000, 8000, 132)[-2:] == (16, 4)
    assert sinkhorn_stream.plan(1, 9000, 9000, 132)[-2:] == (16, 5)  # one row a step
    # One group of 16 warps has no merge buffer: 3 stages of one fp32 row.
    assert sinkhorn_stream.ring(14848) == (1, 3, 3 * (4 * 14848 + 16) + 1024)
    # One more column takes the cluster entry, which has no VARIANTS layout.
    assert isinstance(sinkhorn_stream.plan(1, 9000, 14849, 132), sinkhorn_stream.ClusterPlan)
    with pytest.raises(ValueError, match="columns"):
        sinkhorn_stream.layout(14849)
    # Rows wider than K6's widest go to K7, even when few.
    assert sinkhorn.fits_smem(100, 8704) and not sinkhorn.fits_smem(100, 8705)
    with pytest.raises(ValueError, match="columns"):
        sinkhorn.plan(100, 8705)


@pytest.mark.parametrize("kernel,esize,widest", [
    ("sinkhorn", 4, 8704), ("sinkhorn_stream", 4, 14848), ("sinkhorn_stream", 2, 14848)])
def test_plans_take_only_compiled_variants(kernel, esize, widest):
    """Every width up to the kernel's widest gets a plan whose (warps a
    group, chunks a thread) is an instantiation the source compiles (its
    VARIANTS list, which pick() expands), in shared memory, and every
    instantiation serves some width; one more column has no instantiation
    (K6's plan and K7's layout raise; K7's plan is its cluster entry's)."""
    from onepose_tpu_torch.ops.kernels import _build

    table = _build.variants(kernel)
    assert "VARIANTS(CASE)" in (_build.CSRC / f"{kernel}.cu").read_text()
    assert sinkhorn.max_columns(table) == widest
    seen = set()
    for n in range(1, widest + 1):
        if kernel == "sinkhorn":
            p = sinkhorn.plan(64, n)
        else:
            p = sinkhorn_stream.plan(2, 300, n, 132, esize)
            assert p.stages >= sinkhorn_stream.MIN_STAGES
        assert (p.warps_per_group, p.chunks) in table, n
        assert p.smem <= sinkhorn.SMEM_PER_BLOCK, n
        seen.add((p.warps_per_group, p.chunks))
    assert seen == set(table)  # and no instantiation is dead
    with pytest.raises(ValueError, match="columns"):
        if kernel == "sinkhorn":
            sinkhorn.plan(64, widest + 1)
        else:
            sinkhorn_stream.layout(widest + 1)
    if kernel == "sinkhorn_stream":
        assert isinstance(sinkhorn_stream.plan(2, 300, widest + 1, 132, esize),
                          sinkhorn_stream.ClusterPlan)


@pytest.mark.parametrize("esize", [4, 2])
def test_cluster_plans_take_only_compiled_variants(esize):
    """Every width of the cluster entry (14849 to 8 x 14848 columns, every
    7th and the ends) plans slices whose layout the source's
    CLUSTER_VARIANTS compiles, whose ring holds MIN_STAGES whole steps in
    shared memory, whose last slice is not empty and whose slices start
    16 bytes aligned; every cluster instantiation serves some width."""
    table = _build.variants("sinkhorn_stream", "CLUSTER_VARIANTS")
    assert "CLUSTER_VARIANTS(CASE)" in (_build.CSRC / "sinkhorn_stream.cu").read_text()
    widest = sinkhorn_stream.widest()
    seen = set()
    for n in sorted(set(range(widest + 1, 8 * widest + 1, 7)) | {widest + 1, 8 * widest}):
        p = sinkhorn_stream.plan(1, 300, n, 132, esize)
        assert isinstance(p, sinkhorn_stream.ClusterPlan), n
        assert p.slice_cols % sinkhorn_stream.PITCH == 0 and p.slice_cols <= widest, n
        assert 0 < n - (p.cluster - 1) * p.slice_cols <= p.slice_cols, n
        assert (16, p.chunks) in table and p.stage_rows % table[16, p.chunks] == 0, n
        assert p.stages >= sinkhorn_stream.MIN_STAGES and p.smem <= sinkhorn.SMEM_PER_BLOCK, n
        seen.add((16, p.chunks))
    assert seen == set(table)


def test_stored_coupling_pads_rows_to_16_bytes():
    c = torch.randn(2, 5, 13)
    for dtype in (None, torch.bfloat16):
        s = sinkhorn_stream.stored_coupling(c, dtype)
        assert s.shape == (2, 5, 16) and s.dtype == (dtype or torch.float32)
        assert torch.equal(s[..., :13], c.to(s.dtype)) and bool((s[..., 13:] < -9e8).all())
    aligned = torch.randn(2, 5, 16)
    assert sinkhorn_stream.stored_coupling(aligned, None) is aligned
    with pytest.raises(ValueError, match="coupling_dtype"):
        sinkhorn_stream.sinkhorn_potentials_streamed(c, c[..., 0], c[:, 0], 1, torch.float16)


def _sinkhorn_inputs(seed, b, m, n):
    rng = np.random.default_rng(seed)
    scores = rng.normal(size=(b, m, n)).astype(np.float32)
    return scores, rng.random((b, m)) < 0.85, rng.random((b, n)) < 0.85


def _valid(m0, m1):
    b = m0.shape[0]
    a = np.concatenate([m0, np.ones((b, 1), bool)], 1)
    c = np.concatenate([m1, np.ones((b, 1), bool)], 1)
    return a[:, :, None] & c[:, None, :]


@pytest.mark.parametrize("kernel", [None, False])
def test_log_sinkhorn_matches_jax(kernel):
    scores, m0, m1 = _sinkhorn_inputs(3, 2, 40, 56)
    want = jax_log_sinkhorn(jnp.asarray(scores), jnp.asarray(0.7), jnp.asarray(m0),
                            jnp.asarray(m1), ITERS, use_pallas=False)
    got = log_sinkhorn(torch.from_numpy(scores), torch.tensor(0.7), torch.from_numpy(m0),
                       torch.from_numpy(m1), ITERS, kernel=kernel)
    _close_on(_valid(m0, m1), got, want)
    jm = jax_extract_matches(want, 0.0, jnp.asarray(m0), jnp.asarray(m1))
    tm = extract_matches(got, 0.0, torch.from_numpy(m0), torch.from_numpy(m1))
    for k in ("matches0", "matches1"):
        np.testing.assert_array_equal(tm[k].numpy(), np.asarray(jm[k]), err_msg=k)


def _spy(monkeypatch, module, name, calls):
    orig = getattr(module, name)

    def spy(*a, **k):
        calls.append((name, k.get("coupling_dtype")))
        return orig(*a, **k)

    monkeypatch.setattr(module, name, spy)


@pytest.mark.parametrize("fits,stream_bf16,kernel,want", [
    (True, False, None, [("sinkhorn_potentials", None)]),
    (False, False, None, [("sinkhorn_potentials_streamed", None)]),
    (False, True, None, [("sinkhorn_potentials_streamed", torch.bfloat16)]),
    ("too_wide", False, None, []),
    ("too_wide", True, None, [("sinkhorn_potentials_streamed", torch.bfloat16)]),
    ("too_wide", False, True, [("sinkhorn_potentials_streamed", None)]),
])
def test_log_sinkhorn_routing(monkeypatch, fits, stream_bf16, kernel, want):
    """K6 when the coupling fits shared memory, else K7 (bf16 storage only
    when asked); kernel=False takes neither. A coupling wider than K7's
    widest instantiation (here 31 columns, the widest shrunk to 30) takes
    the plain scan by default, as JAX's does above its guard in its auto
    mode; asked for a kernel or for bf16 storage it goes to K7, as JAX's
    goes to its streamed kernel, and K7 computes it: on the card through
    its wide entry, whose plan the wrapper takes above the widest
    (`test_streamed_plan_takes_the_wide_entry_above_its_widest`)."""
    scores, m0, m1 = _sinkhorn_inputs(4, 1, 24, 30)
    args = (torch.from_numpy(scores), torch.tensor(0.5), torch.from_numpy(m0),
            torch.from_numpy(m1), 25)
    calls = []
    _spy(monkeypatch, sinkhorn, "sinkhorn_potentials", calls)
    _spy(monkeypatch, sinkhorn_stream, "sinkhorn_potentials_streamed", calls)
    if fits is False:
        monkeypatch.setattr(sinkhorn, "fits_smem", lambda m, n, sms: False)
    if fits == "too_wide":
        monkeypatch.setattr(sinkhorn, "max_columns", lambda table: 30)
    z = log_sinkhorn(*args, kernel=kernel, stream_bf16=stream_bf16)
    assert calls == want
    z_plain = log_sinkhorn(*args, kernel=False, stream_bf16=stream_bf16)
    assert calls == want  # the plain scan called no wrapper
    _close_on(_valid(m0, m1), z, z_plain,
              atol=1e-4 if not stream_bf16 else 2e-2)
    assert superglue.sinkhorn is sinkhorn  # log_sinkhorn routes through the module


def test_streamed_plan_takes_the_wide_entry_above_its_widest():
    """Up to K7's widest instantiation (14848 columns) the plan is the
    VARIANTS entry's; above it, up to 8 x 14848 columns, the cluster
    entry's (ClusterPlan): CL, the fewest blocks whose slices fit the
    widest row, each slice a multiple of 8 columns but the last, as many
    clusters a pair as the card holds (max_clusters, or max_blocks // CL),
    the pairs in waves; wider, the two-sweep entry's (WidePlan):
    WIDE_ROWS-row steps over as many blocks as the card holds. No width
    raises."""
    widest = sinkhorn.max_columns(_build.variants("sinkhorn_stream"))
    assert widest == sinkhorn_stream.widest() == 14848
    want = {14848: ("variants", None), 14849: ("cluster", (2, 7432)),
            16385: ("cluster", (2, 8200)), 20481: ("cluster", (2, 10248)),
            29697: ("cluster", (3, 9904)), 65537: ("cluster", (5, 13112)),
            118784: ("cluster", (8, 14848)), 118785: ("two_sweep", None)}
    types = {"variants": sinkhorn_stream.Plan, "cluster": sinkhorn_stream.ClusterPlan,
             "two_sweep": sinkhorn_stream.WidePlan}
    for n, (route, split) in want.items():
        assert sinkhorn_stream.entry(n) == route, n
        for esize in (4, 2):
            p = sinkhorn_stream.plan(1, 20000, n, 132, esize)
            assert isinstance(p, types[route]), n
            if route == "cluster":
                assert (p.cluster, p.slice_cols) == split == sinkhorn_stream.cluster_split(n)
                assert p.clusters_per_pair == 132 // p.cluster and p.pairs_per_wave == 1
                assert p.rows * p.clusters_per_pair >= 20000
    with pytest.raises(ValueError, match="blocks a cluster"):
        sinkhorn_stream.cluster_split(118785)
    # The card's count of resident clusters (66 of 2 on an H100): rows split
    # over them; few rows: one cluster a stage; many pairs: waves.
    assert sinkhorn_stream.plan(1, 16385, 16385, 132, max_clusters=66) == (
        2, 8200, 2, 3, 66, 249, 1, 198032, 4)
    assert sinkhorn_stream.plan(1, 20481, 20481, 132, max_clusters=66)[2:7] == (1, 5, 66, 311, 1)
    assert sinkhorn_stream.plan(1, 1025, 40961, 132, max_clusters=39)[:7] == (
        3, 13656, 1, 4, 39, 27, 1)
    assert sinkhorn_stream.plan(1, 20, 15000, 132)[4:7] == (10, 2, 1)
    assert sinkhorn_stream.plan(300, 20, 15000, 132)[4:7] == (1, 20, 66)
    # The two-sweep entry: WIDE_ROWS-row steps over the card's blocks.
    assert sinkhorn_stream.plan(1, 257, 131073, 132) == (33, 8, 1)
    assert sinkhorn_stream.plan(1, 20481, 131073, 132) == (132, 156, 1)
    assert sinkhorn_stream.plan(3, 1000, 131073, 132) == (44, 23, 3)
    assert sinkhorn_stream.two_sweep_plan(1, 16385, 132) == (132, 125, 1)


def _emulate_two_sweep(c, mu, nu, iters, rows, *, threads=8, lanes=4, wide_rows=3,
                  reduce_threads=16):
    """The two-sweep entry's schedule in torch, at a small thread count
    (`threads` a block, `lanes` a warp, `wide_rows` rows a step): blocks of
    `rows` rows a pair; thread t owns the 4-column chunks t, t + threads,
    ... of every row and walks them tile after tile. Pass 1: each thread's
    online (max, sum) of C + v (rescaled when a chunk's max is larger, a
    chunk with no finite entry skipped), the xor tree over the warp's
    lanes, then the warps merged in order: u of the step's rows. Pass 2:
    the step's rows (C + u) folded into the block's column partial (one
    rescale a step). Then each block reduces its slice of columns from the
    pair's partials. Base 2 throughout."""
    b, m, n = c.shape
    tiles = -(-n // (4 * threads))
    npad = tiles * 4 * threads
    cpp = -(-m // rows)
    cols = -(-n // cpp)
    u2, v2 = torch.zeros(b, m), torch.zeros(b, n)
    mu2, nu2 = mu * L2E, nu * L2E
    for p in range(b):
        v_prev = torch.zeros(n)
        for _ in range(iters):
            pm, ps = [], []
            vpad = torch.cat([v_prev, torch.full((npad - n,), EMPTY)])
            for k in range(cpp):
                r0, r1 = k * rows, min(m, (k + 1) * rows)
                acc = [torch.full((n,), EMPTY), torch.zeros(n)]
                for i0 in range(r0, r1, wide_rows):
                    idx = list(range(i0, min(r1, i0 + wide_rows)))
                    for i in idx:
                        row = torch.cat([c[p, i], torch.zeros(npad - n)])
                        x = (row * L2E + vpad).reshape(tiles, threads, 4)
                        tm, ts = torch.full((threads,), EMPTY), torch.zeros(threads)
                        for q in range(tiles):  # each thread's chunks in order
                            cm = x[q].amax(1)
                            live = cm != EMPTY
                            up = live & (cm > tm)
                            ts = torch.where(up, ts * torch.exp2(tm - cm), ts)
                            tm = torch.where(up, cm, tm)
                            add = torch.exp2(x[q] - tm[:, None]).sum(1)
                            ts = torch.where(live, ts + add, ts)
                        off = lanes // 2
                        while off:  # the xor tree over a warp's lanes
                            partner = torch.arange(threads) ^ off
                            tm, ts = _merge(tm, ts, tm[partner], ts[partner])
                            off //= 2
                        M, S = torch.tensor(EMPTY), torch.tensor(0.0)
                        for w in range(threads // lanes):  # the warps, in order
                            M, S = _merge(M, S, tm[w * lanes], ts[w * lanes])
                        u2[p, i] = mu2[p, i] - (M + torch.log2(S))
                    acc = list(_fold(*acc, [c[p, i] * L2E + u2[p, i] for i in idx]))
                pm.append(acc[0])
                ps.append(acc[1])
            pm, ps = torch.stack(pm), torch.stack(ps)
            for k in range(cpp):
                j0, j1 = min(n, k * cols), min(n, (k + 1) * cols)
                if j1 > j0:
                    M, S = _reduce_slice(pm, ps, j0, j1, reduce_threads)
                    v2[p, j0:j1] = nu2[p, j0:j1] - (M + torch.log2(S))
            v_prev = v2[p].clone()
    return u2 * LN2, v2 * LN2


@pytest.mark.parametrize("case", ["fp32", "bf16", "masked_side"])
def test_two_sweep_schedule_matches_plain(case):
    """The two-sweep entry's tile schedule against the plain version: 3 blocks
    of 17, 17 and 11 rows, 3-row steps (the last of each block ragged), 61
    columns in two tiles of 32 (the second ragged, its last chunk masked
    but one column); fp32 and bf16 storage (the plain version rounds the
    coupling the same way); and a fully masked side 0 (log_sinkhorn's
    problem with dustbins: every output finite)."""
    dtype = torch.bfloat16 if case == "bf16" else None
    if case == "masked_side":
        rng = np.random.default_rng(8)
        scores = torch.from_numpy(rng.normal(size=(2, 44, 60)).astype(np.float32))
        m0 = torch.zeros(2, 44, dtype=torch.bool)
        m1 = torch.from_numpy(rng.random((2, 60)) < 0.8)
        c, mu, nu, _ = superglue.sinkhorn_problem(scores, torch.tensor(1.0), m0, m1)
        ones = torch.ones(2, 1, dtype=torch.bool)
        m0, m1 = torch.cat([m0, ones], 1), torch.cat([m1, ones], 1)
    else:
        c, mu, nu, m0, m1 = map(torch.from_numpy, _problem(9, 2, 45, 61, scale=4.0))
    want = sinkhorn.sinkhorn_potentials_plain(c, mu, nu, ITERS, coupling_dtype=dtype)
    stored = c if dtype is None else c.to(dtype).float()
    got = _emulate_two_sweep(stored, mu, nu, ITERS, rows=17)
    assert all(bool(torch.isfinite(t).all()) for t in got)
    _close_on(m0.numpy(), got[0], want[0])
    _close_on(m1.numpy(), got[1], want[1])


def _emulate_wide(c, mu, nu, iters, rows, cl, s, *, stage_rows=2, rs=2, lanes=4, warps=2,
                  reduce_threads=16, seed=0):
    """The cluster entry's schedule in torch, at a small thread count (`lanes`
    a warp, `warps` a block): clusters of `cl` blocks take `rows` rows of a
    pair each, block q of a cluster the columns [q * s, q * s + s) (the last
    slice up to n); stages of `stage_rows` rows, `rs` rows a step. The
    blocks of a pair run as generators, interleaved at random (`seed`) but
    for the kernel's waits. A(g): each step's rows' (max, sum) of C + v
    over the block's slice (row_lse: per-warp, then across the warps; a step
    past the stage's rows pushes empties), pushed into slot g % X_SLOTS of
    every block of the cluster, itself included, which must have read that
    slot's stage g - X_SLOTS already (asserted). B(g), one stage behind: once
    every block's pushes of stage g are in, the CL partials of each row
    merged in rank order into u, and the stage's rows folded into the
    slice's column accumulators (one rescale a step). After an iteration's
    rows, each block stores its slice's partial; the blocks of the same rank
    meet, each reduces its share of the slice's columns (reduce_slice over
    the clusters' partials), they meet again, and each reads back its
    slice's v. Base 2 throughout. Returns (u, v, u_equal): u_equal says
    that every block of each cluster computed each row's u bit for bit
    alike."""
    b, m, n = c.shape
    xs = sinkhorn_stream.X_SLOTS
    threads = lanes * warps
    cpp = -(-m // rows)
    bounds = [(q * s, min(n, (q + 1) * s)) for q in range(cl)]
    assert bounds[-1][0] < n <= cl * s and stage_rows % rs == 0
    warp_of = [_warp_of_column(j1 - j0, threads, lanes) for j0, j1 in bounds]
    u2, v2 = torch.zeros(b, m), torch.zeros(b, n)
    mu2, nu2 = mu * L2E, nu * L2E
    pick = random.Random(seed)
    u_equal = True
    for p in range(b):
        if iters <= 0:
            continue
        c2 = c[p] * L2E
        part = torch.stack([torch.full((n,), EMPTY), torch.zeros(n)]).repeat(cpp, 1, 1)
        vbuf = torch.zeros(n)
        met = {}  # (rank, iteration, barrier) -> blocks arrived
        us = {}  # row -> the u each block of its cluster computed
        boxes = {(k, q): dict(xbuf=torch.zeros(xs, cl, stage_rows, 2), arrived=[0] * xs,
                              consumed=0) for k in range(cpp) for q in range(cl)}

        def block(k, q):
            r0, r1 = k * rows, min(m, (k + 1) * rows)
            j0, j1 = bounds[q]
            spi = -(-(r1 - r0) // stage_rows) if r1 > r0 else 0
            cols = -(-(j1 - j0) // cpp)
            ja, jb = j0 + min(j1 - j0, k * cols), j0 + min(j1 - j0, (k + 1) * cols)
            box, g = boxes[k, q], 0
            v = torch.zeros(j1 - j0)
            for it in range(iters):
                acc = [torch.full((j1 - j0,), EMPTY), torch.zeros(j1 - j0)]
                for step in range(spi + 1):
                    if step < spi:  # A(g + step)
                        st = g + step
                        row0 = r0 + step * stage_rows
                        nr = min(stage_rows, r1 - row0)
                        for i0 in range(0, stage_rows, rs):
                            if i0 < nr:  # an invalid row of a valid step reads row 0
                                idx = [row0 + (i if i < nr else 0) for i in range(i0, i0 + rs)]
                                vals = torch.stack(_row_lse(c2[idx, j0:j1] + v, warp_of[q],
                                                            warps), 1)
                            else:
                                vals = torch.tensor([[EMPTY, 0.0]] * rs)
                            for peer in range(cl):
                                pb = boxes[k, peer]
                                assert pb["consumed"] >= st - xs + 1, "a slot overwritten unread"
                                pb["xbuf"][st % xs, q, i0:i0 + rs] = vals
                                pb["arrived"][st % xs] += rs
                            yield
                    if step > 0:  # B(g + step - 1)
                        st = g + step - 1
                        x = st % xs
                        while box["arrived"][x] < cl * stage_rows:
                            yield
                        box["arrived"][x] = 0
                        row0 = r0 + (step - 1) * stage_rows
                        nr = min(stage_rows, r1 - row0)
                        M, S = torch.full((nr,), EMPTY), torch.zeros(nr)
                        for peer in range(cl):  # rank order
                            pm = box["xbuf"][x, peer, :nr]
                            M, S = _merge(M, S, pm[:, 0], pm[:, 1])
                        ui = mu2[p, row0:row0 + nr] - (M + torch.log2(S))
                        for i in range(nr):
                            us.setdefault(row0 + i, []).append(ui[i])
                        if q == 0 and it == iters - 1:
                            u2[p, row0:row0 + nr] = ui
                        for i0 in range(0, nr, rs):
                            idx = range(i0, min(nr, i0 + rs))
                            acc = list(_fold(*acc, [c2[row0 + i, j0:j1] + ui[i] for i in idx]))
                        box["consumed"] = st + 1
                        yield
                g += spi
                part[k, 0, j0:j1], part[k, 1, j0:j1] = acc
                for bar in (0, 1):
                    key = (q, it, bar)
                    met[key] = met.get(key, 0) + 1
                    while met[key] < cpp:
                        yield
                    if bar == 0 and jb > ja:
                        M, S = _reduce_slice(part[:, 0], part[:, 1], ja, jb, reduce_threads)
                        vbuf[ja:jb] = nu2[p, ja:jb] - (M + torch.log2(S))
                v = vbuf[j0:j1].clone()
            if it == iters - 1:
                v2[p, j0:j1] = v

        runs = [block(k, q) for k in range(cpp) for q in range(cl)]
        for _ in range(10 ** 6):
            if not runs:
                break
            run = pick.choice(runs)
            try:
                next(run)
            except StopIteration:
                runs.remove(run)
        assert not runs, "the schedule did not finish"
        for vals in us.values():
            for j in range(0, len(vals), cl):  # each iteration's u from the cl blocks
                u_equal &= all(torch.equal(vals[j], w) for w in vals[j:j + cl])
    return u2 * LN2, v2 * LN2, u_equal


def _wide_problem(case):
    """The inputs of `test_wide_schedule_matches_plain`'s cases."""
    if case in ("masked_side", "dustbin"):
        n = 60 if case == "masked_side" else 64
        rng = np.random.default_rng(8)
        scores = torch.from_numpy(rng.normal(size=(2, 44, n)).astype(np.float32))
        m0 = torch.from_numpy(rng.random((2, 44)) < 0.8)
        if case == "masked_side":
            m0 = torch.zeros(2, 44, dtype=torch.bool)
        m1 = torch.from_numpy(rng.random((2, n)) < 0.8)
        c, mu, nu, _ = superglue.sinkhorn_problem(scores, torch.tensor(1.0), m0, m1)
        ones = torch.ones(2, 1, dtype=torch.bool)
        return c, mu, nu, torch.cat([m0, ones], 1), torch.cat([m1, ones], 1)
    c, mu, nu, m0, m1 = map(torch.from_numpy, _problem(9, 2, 45, 61, scale=4.0))
    return c, mu, nu, m0, m1


# case -> (iterations, storage, widest row of the replay, rows a cluster,
# stage rows, rows a step).
WIDE_CASES = {
    # 61 columns over a widest row of 24: clusters of 3 blocks, slices of
    # 24, 24 and 13 columns; 45 rows in clusters of 17, 17 and 11 rows,
    # stages of 4 (the last of each cluster ragged), 2 rows a step.
    "fp32": (ITERS, None, 24, 17, 4, 2),
    "bf16": (ITERS, torch.bfloat16, 24, 17, 4, 2),
    # log_sinkhorn's problem with no valid keypoint on side 0.
    "masked_side": (ITERS, None, 24, 17, 4, 2),
    # The dustbin column alone in the last of 5 slices (65 = 4 x 16 + 1
    # columns over a widest row of 16); one row a step, stages of 3, 30
    # iterations.
    "dustbin": (30, None, 16, 12, 3, 1),
    # No iteration (u = v = 0) and one.
    "iters0": (0, None, 24, 17, 4, 2),
    "iters1": (1, None, 24, 17, 4, 2),
}


@pytest.mark.parametrize("case", list(WIDE_CASES))
def test_wide_schedule_matches_plain(monkeypatch, case):
    """The cluster entry's schedule (`_emulate_wide`) against the plain
    version, with the widest row shrunk so that a few dozen columns make a
    cluster (`cluster_split` picks CL and the slices, as on the card): fp32
    and bf16 storage (the plain version rounds the coupling the same way),
    a fully masked side 0 (every output finite), the dustbin column in the
    last slice, 0 and 1 iterations; every block of a cluster computes the
    same u bit for bit."""
    iters, dtype, widest, rows, stage_rows, rs = WIDE_CASES[case]
    c, mu, nu, m0, m1 = _wide_problem(case)
    monkeypatch.setattr(sinkhorn_stream, "widest", lambda: widest)
    cl, s = sinkhorn_stream.cluster_split(c.shape[2])
    assert (cl, s) == ((5, 16) if case == "dustbin" else (3, 24))
    want = sinkhorn.sinkhorn_potentials_plain(c, mu, nu, iters, coupling_dtype=dtype)
    stored = c if dtype is None else c.to(dtype).float()
    u, v, u_equal = _emulate_wide(stored, mu, nu, iters, rows, cl, s, stage_rows=stage_rows,
                                  rs=rs, seed=len(case))
    assert u_equal
    assert all(bool(torch.isfinite(t).all()) for t in (u, v))
    _close_on(m0.numpy(), u, want[0])
    _close_on(m1.numpy(), v, want[1])


@pytest.mark.parametrize("sms", [132, 114])
def test_routing_takes_the_devices_sm_count(monkeypatch, sms):
    """log_sinkhorn passes the device's SM count to fits_smem (spied: the
    count as _build.device_sms gives it); fits_smem and plan spread over
    that many SMs. Square couplings of 2408 to 2627 keypoints (2409 to 2628
    rows with the dustbin) fit 132 SMs but not 114, so they go to K7 on a
    114-SM card instead of failing in K6."""
    seen = []
    orig = sinkhorn.fits_smem
    monkeypatch.setattr(superglue._build, "device_sms", lambda dev: sms)
    monkeypatch.setattr(sinkhorn, "fits_smem",
                        lambda m, n, sms: seen.append(sms) or orig(m, n, sms=sms))
    scores, m0, m1 = _sinkhorn_inputs(4, 1, 24, 30)
    log_sinkhorn(torch.from_numpy(scores), torch.tensor(0.5), torch.from_numpy(m0),
                 torch.from_numpy(m1), 5)
    assert seen == [sms]
    for n in (2409, 2500, 2628):
        assert orig(n, n, sms=132)
        assert orig(n, n, sms=sms) == (sms == 132)
    assert orig(2408, 2408, sms=114) and not orig(2629, 2629, sms=132)
    assert sinkhorn.plan(2408, 2408, sms=114).blocks_per_pair <= 114


@pytest.mark.parametrize("kernel", [None, False])
def test_both_sides_fully_masked_stays_finite(kernel):
    rng = np.random.default_rng(3)
    b, m, n = 1, 24, 32
    none0, none1 = torch.zeros((b, m), dtype=torch.bool), torch.zeros((b, n), dtype=torch.bool)
    z = log_sinkhorn(torch.from_numpy(rng.normal(size=(b, m, n)).astype(np.float32)),
                     torch.tensor(0.5), none0, none1, 20, kernel=kernel)
    out = extract_matches(z, 0.2, mask0=none0, mask1=none1)
    assert bool(torch.isfinite(out["matching_scores0"]).all())
    assert bool((out["matches0"] == -1).all()) and bool((out["matches1"] == -1).all())


def test_marginals_sum_to_one():
    rng = np.random.default_rng(1)
    b, m, n = 1, 40, 56
    mask0 = torch.from_numpy(rng.random((b, m)) < 0.9)
    z = log_sinkhorn(torch.from_numpy(rng.normal(size=(b, m, n)).astype(np.float32)),
                     torch.tensor(1.0), mask0, None, ITERS)
    row_mass = torch.exp(z.double()).sum(dim=2)[0, :-1]
    np.testing.assert_allclose(row_mass[mask0[0]].numpy(), 1.0, rtol=1e-3)
