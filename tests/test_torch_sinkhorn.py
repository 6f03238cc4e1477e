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
from onepose_tpu_torch.ops.kernels import sinkhorn, sinkhorn_stream

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


def _row_u(x, warp_of, warps, mu2):
    """row_step: per-warp max and sum of exponentials, one exchange; base 2."""
    mw = torch.full((warps,), EMPTY).scatter_reduce(0, warp_of, x, "amax")
    sh = torch.where(mw == EMPTY, 0.0, mw)
    sw = torch.zeros(warps).scatter_add(0, warp_of, torch.exp2(x - sh[warp_of]))
    M = mw.max()
    S = torch.where(mw == EMPTY, 0.0, sw * torch.exp2(mw - M)).sum()
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
    with pytest.raises(ValueError, match="columns"):
        sinkhorn_stream.plan(1, 9000, 14849, 132)
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
    instantiation serves some width; one more column raises."""
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
            sinkhorn_stream.plan(2, 300, widest + 1, 132, esize)


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


@pytest.mark.parametrize("fits,stream_bf16,want", [
    (True, False, [("sinkhorn_potentials", None)]),
    (False, False, [("sinkhorn_potentials_streamed", None)]),
    (False, True, [("sinkhorn_potentials_streamed", torch.bfloat16)]),
])
def test_log_sinkhorn_routing(monkeypatch, fits, stream_bf16, want):
    """K6 when the coupling fits shared memory, else K7 (bf16 storage only
    when asked); kernel=False takes neither."""
    scores, m0, m1 = _sinkhorn_inputs(4, 1, 24, 30)
    args = (torch.from_numpy(scores), torch.tensor(0.5), torch.from_numpy(m0),
            torch.from_numpy(m1), 25)
    calls = []
    _spy(monkeypatch, sinkhorn, "sinkhorn_potentials", calls)
    _spy(monkeypatch, sinkhorn_stream, "sinkhorn_potentials_streamed", calls)
    if not fits:
        monkeypatch.setattr(sinkhorn, "fits_smem", lambda m, n: False)
    z = log_sinkhorn(*args, stream_bf16=stream_bf16)
    assert calls == want
    z_plain = log_sinkhorn(*args, kernel=False, stream_bf16=stream_bf16)
    assert calls == want  # the plain scan called no wrapper
    _close_on(_valid(m0, m1), z, z_plain, atol=1e-4 if not stream_bf16 else 2e-2)
    assert superglue.sinkhorn is sinkhorn  # log_sinkhorn routes through the module


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
