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


def _emulate(c, mu, nu, iters, rows, block_rows=None):
    """The CUDA kernels' schedule in torch: blocks of `rows` rows per pair,
    each streaming its rows in blocks of `block_rows` (None: one resident
    band) with an online column fold that starts empty; per-block partials
    reduced into v after every iteration."""
    b, m, n = c.shape
    u, v = torch.zeros(b, m), torch.zeros(b, n)
    empty = float("-inf")
    for _ in range(iters):
        parts = []
        for r0 in range(0, m, rows):
            r1 = min(m, r0 + rows)
            acc_m, acc_s = torch.full((b, n), empty), torch.zeros(b, n)
            for blk in range(r0, r1, block_rows or rows):
                e = min(r1, blk + (block_rows or rows))
                t = c[:, blk:e] + v[:, None, :]
                mx = t.amax(dim=2)
                u[:, blk:e] = mu[:, blk:e] - (mx + torch.log(torch.exp(t - mx[..., None]).sum(2)))
                t2 = c[:, blk:e] + u[:, blk:e, None]
                m2 = t2.amax(dim=1)
                s2 = torch.exp(t2 - m2[:, None]).sum(1)
                first = torch.isinf(acc_m)
                mn = torch.maximum(acc_m, m2)
                merged = acc_s * torch.exp(acc_m - mn) + s2 * torch.exp(m2 - mn)
                acc_s = torch.where(first, s2, merged)
                acc_m = torch.where(first, m2, mn)
            parts.append((acc_m, acc_s))
        pm = torch.stack([p[0] for p in parts])
        ps = torch.stack([p[1] for p in parts])
        mx = pm.amax(dim=0)
        v = nu - (mx + torch.log((ps * torch.exp(pm - mx)).sum(0)))
    return u, v


@pytest.mark.parametrize("block_rows", [None, 7])
def test_kernel_schedule_matches_plain(block_rows):
    """Resident bands (K6) and streamed row blocks (K7), with a ragged last
    band and last row block, against the plain version."""
    c, mu, nu, m0, m1 = map(torch.from_numpy, _problem(2, 2, 61, 45, scale=4.0))
    want = sinkhorn.sinkhorn_potentials_plain(c, mu, nu, ITERS)
    got = _emulate(c, mu, nu, ITERS, rows=17, block_rows=block_rows)
    _close_on(m0.numpy(), got[0], want[0])
    _close_on(m1.numpy(), got[1], want[1])


def test_fits_smem_and_plans():
    assert sinkhorn.fits_smem(1025, 1025)  # map's default, 1024 keypoints
    assert sinkhorn.fits_smem(2049, 2049)  # fits on the H100, unlike the TPU's VMEM
    assert not sinkhorn.fits_smem(4097, 4097)  # the SfM budget goes to K7
    assert sinkhorn.plan(1025, 1025) == (19, 54, 4 * (54 * 1025 + 1025 + 54))
    assert sinkhorn.plan(2049, 2049)[:2] == (76, 27)
    assert sinkhorn.plan(1025, 1025).smem <= sinkhorn.SMEM_PER_BLOCK
    assert sinkhorn.pairs_per_wave(16, 19, 132) == 6  # 16 pairs in 3 waves
    with pytest.raises(ValueError, match="resident blocks"):
        sinkhorn.pairs_per_wave(1, 316, 132)
    p = sinkhorn_stream.plan(7, 4097, 4097, 132)
    assert p == (11, 18, 228, 7, 4 * (11 * 4104 + 3 * 4104 + 11))
    assert p.smem <= sinkhorn.SMEM_PER_BLOCK
    assert sinkhorn_stream.plan(300, 33, 40, 132).pairs_per_wave == 132  # pairs in waves


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
