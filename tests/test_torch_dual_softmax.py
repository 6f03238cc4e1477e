"""K3, the dual-softmax match head: the CUDA kernel's schedule
(csrc/dual_softmax.cu) replayed in torch, and the masked entry, held
against the plain version and the JAX package's Pallas kernel (interpret
mode).

`_replay` follows the kernel: `plan`'s frame groups and bands, the masks
applied as the band loads, column max over bands, row sums in float64,
the bands' float64 column partials rounded to fixed point (2^shift) and
added as integers, conf once per element, each row's max with its
largest index and tie count, the column max of conf, then the candidate
check with a re-scan of tied rows. Tolerance against the plain version:
matches identical, scores 1e-6 relative (the fixed-point column sums may
round to the neighbouring float32 of the plain float64 sum).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from onepose_tpu.ops.pallas.dual_softmax import NEG_INF
from onepose_tpu.ops.pallas.dual_softmax import dual_softmax_match as jax_dual_softmax
from onepose_tpu_torch.ops.kernels import _build, dual_softmax, launch_counts

torch.set_num_threads(2)


def _replay(scores, threshold, mask2d=None, mask3d=None, sms=132, p=None):
    b, m, n = scores.shape
    p = dual_softmax.plan(b, m, n, sms) if p is None else p
    assert p.groups * p.bands <= sms and p.rows * p.bands >= m
    assert p.rows * (p.bands - 1) < m  # every band holds a row
    shift = dual_softmax.fixed_shift(m)
    m0 = torch.full((b, m), -7, dtype=torch.int32)
    sc0 = torch.full((b, m), float("nan"))
    m1 = torch.full((b, n), -7, dtype=torch.int32)
    sc1 = torch.full((b, n), float("nan"))
    for g in range(p.groups):
        for f in range(g, b, p.groups):
            rok = torch.ones(m, dtype=torch.bool) if mask2d is None else mask2d[f]
            cok = torch.ones(n, dtype=torch.bool) if mask3d is None else mask3d[f]
            s = torch.where(rok[:, None] & cok[None, :], scores[f], torch.tensor(NEG_INF))
            bands = [(k * p.rows, min(m, (k + 1) * p.rows)) for k in range(p.bands)]
            m1[f], sc1[f] = -1, 0.0  # each band initialises its slice of columns
            # 1. column max over the bands' partial maxima; row max.
            cm = torch.stack([s[a:e].amax(0) for a, e in bands]).amax(0)
            rm = s.amax(1)
            # 2. row sums in float64; column sums in fixed point.
            rs = torch.exp(s - rm[:, None]).double().sum(1).float()
            fx = [0] * n
            for a, e in bands:
                part = torch.exp(s[a:e] - cm[None, :]).double().sum(0)
                for j, v in enumerate(np.rint(part.numpy() * 2.0**shift).astype(np.uint64)):
                    fx[j] += int(v)
            assert max(fx) < 2**62
            cs = torch.tensor([float(x) for x in fx], dtype=torch.float64).mul(2.0**-shift).float()
            # 3. conf once; row (max, largest index, ties); column max of conf.
            conf = (torch.exp(s - rm[:, None]) / rs[:, None]) * (torch.exp(s - cm[None, :])
                                                                / cs[None, :])
            mx0 = conf.amax(1)
            eq = conf == mx0[:, None]
            ties = eq.sum(1)
            cand = torch.where(eq, torch.arange(n), -1).amax(1)
            ccmax = torch.stack([conf[a:e].amax(0) for a, e in bands]).amax(0)
            # 4. the hits.
            for i in range(m):
                mm = mx0[i]
                clears = bool(mm > threshold)
                if ties[i] == 1:
                    hits = [int(cand[i])] if clears and ccmax[cand[i]] == mm else []
                else:  # re-scan: every tied hit marks its column
                    hit = (conf[i] == mm) & (ccmax == mm)
                    hits = torch.nonzero(hit)[:, 0].tolist() if clears else []
                best = max(hits, default=-1)
                m0[f, i] = best
                sc0[f, i] = mm if best >= 0 else 0.0
                for j in hits:
                    m1[f, j] = max(int(m1[f, j]), i)
                    sc1[f, j] = mm
    return {"matches0": m0, "matches1": m1, "matching_scores0": sc0, "matching_scores1": sc1}


def _assert_same(got, want):
    for k in ("matches0", "matches1"):
        np.testing.assert_array_equal(np.asarray(got[k]), np.asarray(want[k]), err_msg=k)
    for k in ("matching_scores0", "matching_scores1"):
        np.testing.assert_allclose(np.asarray(got[k]), np.asarray(want[k]), rtol=1e-6, atol=0,
                                   err_msg=k)


def _logits(seed, b, m, n, c=32, scale=0.5):
    rng = np.random.default_rng(seed)
    base = rng.normal(size=(b, n, c))
    pick = rng.permutation(n)[:m] if m <= n else rng.integers(0, n, m)
    s2 = base[:, pick] + 0.1 * rng.normal(size=(b, m, c))
    scores = (np.einsum("bmc,bnc->bmn", s2, base) * scale).astype(np.float32)
    mask2d = rng.random((b, m)) < 0.85
    mask3d = rng.random((b, n)) < 0.85
    return scores, mask2d, mask3d


@pytest.mark.parametrize("b,m,n,sms", [
    (3, 45, 203, 132),  # ragged, 23 bands of 2 rows, 3 groups
    (5, 97, 61, 16),  # a few SMs: frames in rounds, bands of 7 rows
    (2, 130, 257, 114),  # the SM count of a 114-SM card
    (4, 33, 40, 7),
])
@pytest.mark.parametrize("masked", [False, True])
def test_schedule_matches_plain(b, m, n, sms, masked):
    scores, m2, m3 = _logits(m * n, b, m, n)
    t = torch.from_numpy
    m2, m3 = (t(m2), t(m3)) if masked else (None, None)
    want = dual_softmax.dual_softmax_match_plain(t(scores), 0.2, m2, m3)
    got = _replay(t(scores), 0.2, m2, m3, sms)
    _assert_same(got, want)
    assert int((want["matches0"] >= 0).sum()) > 0


@pytest.mark.parametrize("b,m,n,sms", [(5, 97, 61, 40), (3, 45, 203, 132)])
def test_every_resident_plan_matches_plain(b, m, n, sms):
    """The kernel takes any of `resident_plans` (chip_smoke times each of
    them): every one replays to the plain version, masked."""
    scores, m2, m3 = _logits(m + n, b, m, n)
    t = torch.from_numpy
    want = dual_softmax.dual_softmax_match_plain(t(scores), 0.2, t(m2), t(m3))
    plans = dual_softmax.resident_plans(b, m, n, sms)
    assert len(plans) >= 3 and len({q.groups for q in plans}) == len(plans)
    for q in plans:
        _assert_same(_replay(t(scores), 0.2, t(m2), t(m3), sms, q), want)


@pytest.mark.parametrize("case", ["dup_cols", "dup_rows", "threshold0"])
def test_schedule_planted_ties(case):
    """Exact ties: duplicated columns (a tied row max), duplicated rows (a
    tied column max) and threshold 0: the largest index wins everywhere."""
    scores, _, _ = _logits(11, 2, 40, 56)
    thr = 0.2
    if case == "dup_cols":
        scores[:, :, 30] = scores[:, :, 12]
        scores[:, :, 55] = scores[:, :, 12]
        scores[:, 5, [12, 30, 55]] = 40.0
    elif case == "dup_rows":
        scores[:, 33] = scores[:, 7]
        scores[:, [7, 33], 20] = 40.0
    else:
        scores[:, :, 3] = scores[:, :, 2]
        thr = 0.0
    s = torch.from_numpy(scores)
    want = dual_softmax.dual_softmax_match_plain(s, thr)
    _assert_same(_replay(s, thr, sms=9), want)
    if case == "dup_cols":  # three hits in row 5: its match is the largest
        assert (want["matches0"][:, 5] == 55).all()
        assert (want["matches1"][:, [12, 30, 55]] == 5).all()
    if case == "dup_rows":  # two hits in column 20: its match is the largest
        assert (want["matches1"][:, 20] == 33).all()
        assert (want["matches0"][:, [7, 33]] == 20).all()
    assert int((want["matches0"] >= 0).sum()) > 0


def test_schedule_fully_masked_rows_and_columns():
    scores, m2, m3 = _logits(5, 2, 30, 50)
    m2[0, :] = False  # a frame with no real row
    m3[1, :] = False  # a frame with no real column
    m2[1, 4:9] = False
    t = torch.from_numpy
    want = dual_softmax.dual_softmax_match_plain(t(scores), 0.0, t(m2), t(m3))
    _assert_same(_replay(t(scores), 0.0, t(m2), t(m3), sms=11), want)
    # A masked row can still be a mutual max at threshold 0 (all its conf
    # ties): the head drops it afterwards, as GATsSPG does.
    assert bool(torch.isfinite(want["matching_scores0"]).all())


@pytest.mark.parametrize("b,m,n", [(2, 45, 203), (1, 100, 150)])
def test_masked_entry_matches_masked_fill_and_pallas(b, m, n):
    """dual_softmax_match(scores, thr, mask2d, mask3d) is masked_fill then the
    unmasked function, and JAX's Pallas kernel on logits that JAX masked."""
    scores, m2, m3 = _logits(m + n, b, m, n)
    t = torch.from_numpy
    got = dual_softmax.dual_softmax_match(t(scores), 0.2, t(m2), t(m3))
    filled = dual_softmax.apply_masks(t(scores), t(m2), t(m3))
    assert float(filled.min()) == NEG_INF
    ref = dual_softmax.dual_softmax_match(filled, 0.2)
    for k in ref:
        assert torch.equal(got[k], ref[k]), k
    js = jnp.where(jnp.asarray(m2)[:, :, None], jnp.asarray(scores), NEG_INF)
    js = jnp.where(jnp.asarray(m3)[:, None, :], js, NEG_INF)
    want = jax_dual_softmax(js, 0.2)
    for k in ("matches0", "matches1", "valid0", "valid1"):
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]), err_msg=k)
    for k in ("matching_scores0", "matching_scores1"):
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]), rtol=1e-6, atol=1e-7,
                                   err_msg=k)
    assert int((got["matches0"] >= 0).sum()) > 5


def test_plan_production_and_sms():
    """The production shape on 132 SMs and on a 114-SM card; every plan
    fits shared memory and the card; a band too wide to hold reads from
    device memory in every sweep."""
    p = dual_softmax.plan(8, 1000, 2000, 132)
    assert (p.rows, p.bands, p.groups, p.resident) == (23, 44, 3, True)
    assert p.smem <= dual_softmax.SMEM_PER_BLOCK
    q = dual_softmax.plan(8, 1000, 2000, 114)
    assert q.groups * q.bands <= 114 and q.resident
    for sms in (132, 114):
        plans = dual_softmax.resident_plans(8, 1000, 2000, sms)
        assert plans and dual_softmax.plan(8, 1000, 2000, sms) in plans
        cost = [dual_softmax.plan_cost(x, 8) for x in plans]
        assert dual_softmax.plan_cost(dual_softmax.plan(8, 1000, 2000, sms), 8) == min(cost)
        for x in plans:
            assert x.groups * x.bands <= sms and x.rows * x.bands >= 1000
            assert x.smem <= dual_softmax.SMEM_PER_BLOCK
    assert [x.groups for x in dual_softmax.resident_plans(8, 1000, 2000, 132)] == [1, 2, 3]
    big = dual_softmax.plan(2, 1000, 9000, 132)
    assert not big.resident and big.bands * big.rows >= 1000 and big.bands <= 132
    assert dual_softmax.fixed_shift(1000) == 52


def test_wrapper_reads_the_devices_sm_count(monkeypatch):
    """The plans' SM count comes from the device's properties on CUDA (the
    properties spied here) and is the H100's 132 for a CPU replay."""
    monkeypatch.setattr(torch.cuda, "get_device_properties",
                        lambda dev: type("Props", (), {"multi_processor_count": 114})())
    assert _build.device_sms(torch.device("cuda", 0)) == 114
    assert _build.device_sms(torch.device("cpu")) == 132


def test_non_cpu_tensor_never_falls_back():
    s = torch.empty((1, 8, 8), device="meta")
    m = torch.ones((1, 8), dtype=torch.bool, device="meta")
    with pytest.raises(ValueError, match="CUDA"):
        dual_softmax.dual_softmax_match(s, 0.2, m, m)
    with pytest.raises(ValueError, match="CUDA"):  # the kernel entry takes no CPU tensor
        dual_softmax.dual_softmax_kernel(torch.zeros((1, 8, 8)), 0.2)
    assert launch_counts()["dual_softmax"] == 0
