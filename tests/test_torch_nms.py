"""K1, SuperPoint NMS: the schedules of both CUDA entries of
csrc/score_path.cu replayed in numpy, held bit-exact against the port's
`simple_nms` and the JAX package's `simple_nms` (XLA) and Pallas kernel
(interpret mode).

`_replay_fused` walks the fused kernel's 64 x 64 tiles with their halo,
its pass ranges, its row and column steps of 16 outputs (clamped reads,
log-step doubling), its bit-packed masks set by ballots and its dilations
by funnel shifts, exactly as the source indexes them; `_replay_large`
walks the large-radius entry's five passes (clipped row and column
windows, byte masks). Everything is max and compare, so bit-exact.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from onepose_tpu.models.superpoint import simple_nms as jax_simple_nms
from onepose_tpu.ops.pallas.score_path import nms as jax_nms
from onepose_tpu_torch.ops.kernels import launch_counts, score_path

torch.set_num_threads(2)

TILE, SEG = 64, 16
M32 = np.uint64(0xFFFFFFFF)


def _geo(r):
    h = (5 * r + 3) // 4 * 4
    d = TILE + 2 * h
    return h, d, (d + 31) // 32


def _window_max(a, r):
    """The source's window_max over the last axis of a [..., SEG + 2r]."""
    a = a.copy()
    w = 2 * r + 1
    p = 1
    while 2 * p <= w:
        n = a.shape[-1]
        for i in range(0, n - 2 * p + 1):  # ascending: a[i + p] is still the old value
            a[..., i] = np.maximum(a[..., i], a[..., i + p])
        p *= 2
    return np.maximum(a[..., :SEG], a[..., w - p:w - p + SEG])


def _funnel_r(lo, hi, d):
    return ((hi.astype(np.uint64) << np.uint64(32) | lo.astype(np.uint64)) >> np.uint64(d)) & M32


def _funnel_l(lo, hi, d):
    v = (hi.astype(np.uint64) << np.uint64(32) | lo.astype(np.uint64)) << np.uint64(d)
    return (v >> np.uint64(32)) & M32


def _bits(words, y, x):
    return ((words[y, x >> 5] >> (x & 31).astype(np.uint64)) & np.uint64(1)).astype(bool)


def _replay_tile(img, r, ty, tx):
    """One block of the fused kernel: returns (ys, xs, values) it writes."""
    H, W = img.shape
    h, D, WW = _geo(r)
    gy0, gx0 = ty * TILE - h, tx * TILE - h
    gy, gx = gy0 + np.arange(D), gx0 + np.arange(D)
    row_in, col_in = (gy >= 0) & (gy < H), (gx >= 0) & (gx < W)
    inside = row_in[:, None] & col_in[None, :]
    s = np.full((D, D), -np.inf, np.float32)
    s[np.ix_(row_in, col_in)] = img[np.ix_(gy[row_in], gx[col_in])]
    colin = np.zeros(WW, np.uint64)
    for x in range(D):
        if col_in[x]:
            colin[x // 32] |= np.uint64(1) << np.uint64(x % 32)
    maxm = np.zeros((D, WW), np.uint64)
    supp = np.zeros((D, WW), np.uint64)
    tmp = np.full((D, D), np.nan, np.float32)  # unwritten cells: garbage
    lo = lambda p: h - (5 - p) * r  # noqa: E731
    hi = lambda p: h + TILE + (5 - p) * r  # noqa: E731

    def row_step(v, p):
        a_lo, a_hi = lo(p), hi(p)
        ys = np.arange(a_lo - r, a_hi + r)
        for x0 in range(a_lo, a_hi, SEG):
            xs = np.minimum(x0 - r + np.arange(SEG + 2 * r), D - 1)
            o = _window_max(v[np.ix_(ys, xs)], r)
            keep = x0 + np.arange(SEG) < a_hi
            tmp[np.ix_(ys, x0 + np.arange(SEG)[keep])] = o[:, keep]

    def col_step(p, f):
        a_lo, a_hi = lo(p), hi(p)
        for w in range(a_lo // 32, (a_hi + 31) // 32):
            x = 32 * w + np.arange(32)
            xr = np.minimum(x, D - 1)
            in_x = (x >= a_lo) & (x < a_hi)
            for y0 in range(a_lo, a_hi, SEG):
                rows = np.minimum(y0 - r + np.arange(SEG + 2 * r), D - 1)
                o = _window_max(tmp[np.ix_(rows, xr)].T, r).T  # [SEG, 32]
                for i in range(SEG):
                    if y0 + i < a_hi:
                        f(y0 + i, w, x, in_x, o[i])

    def ballot(cond):
        return np.uint64(sum(1 << int(b) for b in np.nonzero(cond)[0]))

    def inside_at(y, x, in_x):
        return in_x & inside[y, np.minimum(x, D - 1)]

    row_step(s, 1)

    def first(y, w, x, in_x, m):
        xr = np.minimum(x, D - 1)
        maxm[y, w] = ballot(inside_at(y, x, in_x) & (s[y, xr] == m))

    col_step(1, first)

    def dilate(p):
        a_lo, a_hi = lo(p), hi(p)
        hb = np.zeros((D, WW), np.uint64)
        for y in range(a_lo - r, a_hi + r):
            for w in range(a_lo // 32, (a_hi + 31) // 32):
                cur = maxm[y, w]
                prev = maxm[y, w - 1] if w > 0 else np.uint64(0)
                nxt = maxm[y, w + 1] if w + 1 < WW else np.uint64(0)
                acc = cur
                for d in range(1, r + 1):
                    acc |= _funnel_r(cur, nxt, d) | _funnel_l(prev, cur, d)
                hb[y, w] = acc
        for y in range(a_lo, a_hi):
            for w in range(a_lo // 32, (a_hi + 31) // 32):
                acc = np.uint64(0)
                for d in range(-r, r + 1):
                    acc |= hb[y + d, w]
                supp[y, w] = acc & colin[w] if row_in[y] else np.uint64(0)

    def work():
        ys, xs = np.meshgrid(np.arange(D), np.arange(D), indexing="ij")
        return np.where(_bits(supp, ys, xs), np.float32(0), s)

    def suppressed(y, w, x, in_x, m):
        xr = np.minimum(x, D - 1)
        cond = inside_at(y, x, in_x) & ~_bits(supp, np.full(32, y), xr) & (s[y, xr] == m)
        maxm[y, w] |= ballot(cond)

    dilate(2)
    row_step(work(), 3)
    col_step(3, suppressed)
    dilate(4)
    row_step(work(), 5)
    written = []

    def last(y, w, x, in_x, m):
        xr = np.minimum(x, D - 1)
        ok = inside_at(y, x, in_x)
        v = s[y, xr]
        keep = _bits(maxm, np.full(32, y), xr) | (~_bits(supp, np.full(32, y), xr) & (v == m))
        for lane in np.nonzero(ok)[0]:
            written.append((gy0 + y, gx0 + x[lane], v[lane] if keep[lane] else np.float32(0)))

    col_step(5, last)
    return written


def _replay_fused(scores, r):
    b, H, W = scores.shape
    out = np.full(scores.shape, np.nan, np.float32)
    for i in range(b):
        for ty in range(-(-H // TILE)):
            for tx in range(-(-W // TILE)):
                for y, x, v in _replay_tile(scores[i], r, ty, tx):
                    assert np.isnan(out[i, y, x]), "a pixel written twice"
                    out[i, y, x] = v
    assert not np.isnan(out).any(), "a pixel never written"
    return out


def _replay_large(scores, radius, lt=32):
    """The large-radius entry: five passes, each a 32 x 32 tile walk with
    clipped row maxima over the tile's rows +- r, then clipped column maxima."""
    b, H, W = scores.shape
    r = min(radius, max(H, W))
    maxm = np.zeros(scores.shape, bool)
    supp = np.zeros(scores.shape, bool)
    out = np.zeros_like(scores)
    for kind, last in ((0, 0), (1, 0), (2, 0), (1, 0), (2, 1)):
        if kind == 0:
            v = scores
        elif kind == 1:
            v = maxm.astype(np.float32)
        else:
            v = np.where(supp, np.float32(0), scores)
        new_maxm, new_supp = maxm.copy(), supp.copy()
        for i in range(b):
            for y0 in range(0, H, lt):
                for x0 in range(0, W, lt):
                    ylo, yhi = max(0, y0 - r), min(H, y0 + lt + r)
                    assert yhi - ylo <= min(lt + 2 * r, H)  # large_smem holds the rows
                    for x in range(x0, min(W, x0 + lt)):
                        xa, xb = max(0, x - r), min(W - 1, x + r)
                        hm = v[i, ylo:yhi, xa:xb + 1].max(axis=1)
                        for y in range(y0, min(H, y0 + lt)):
                            ya, yb = max(0, y - r), min(H - 1, y + r)
                            m = hm[ya - ylo:yb - ylo + 1].max()
                            s = scores[i, y, x]
                            if kind == 0:
                                new_maxm[i, y, x] = s == m
                            elif kind == 1:
                                new_supp[i, y, x] = m > 0
                            else:
                                new_max = (not supp[i, y, x]) and s == m
                                if last:
                                    out[i, y, x] = s if (maxm[i, y, x] or new_max) else 0
                                elif new_max:
                                    new_maxm[i, y, x] = True
        maxm, supp = new_maxm, new_supp
    return out


def _plateau_scores(seed, b, h, w, levels=None):
    rng = np.random.default_rng(seed)
    s = rng.random((b, h, w)).astype(np.float32) ** 4
    if levels:  # quantised: many exact ties
        s = (np.floor(s * levels) / levels).astype(np.float32)
    s[:, 5 % h:8 % h + 1, 5 % w:8 % w + 1] = 0.7
    s[:, 0, 0] = 2.0
    s[:, h - 1, w // 2] = 2.0
    s[:, h // 2, w - 1] = 2.0
    return s


def _check(got, s, radius):
    want = score_path.simple_nms(torch.from_numpy(s), radius).numpy()
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, np.asarray(jax_simple_nms(jnp.asarray(s), radius)))


@pytest.mark.parametrize("b,h,w,r,levels", [
    (1, 70, 133, 4, None),  # ragged: 2 x 3 tiles, W not a multiple of 4
    (2, 20, 36, 4, None),  # smaller than one tile
    (1, 64, 128, 4, 6),  # plateaus: quantised scores, many exact ties
    (1, 72, 80, 0, 4),
    (1, 45, 70, 1, None),
    (1, 66, 40, 3, 5),
    (1, 80, 68, 9, None),
])
def test_fused_schedule_bit_exact(b, h, w, r, levels):
    s = _plateau_scores(h * w + r, b, h, w, levels)
    _check(_replay_fused(s, r), s, r)


@pytest.mark.parametrize("r", [10, 12])
def test_large_schedule_bit_exact(r):
    s = _plateau_scores(r, 1, 50, 70, levels=5)
    _check(_replay_large(s, r), s, r)


@pytest.mark.parametrize("r", [0, 4, 30])
def test_large_schedule_any_radius(r):
    """The second entry takes any radius, one wider than the image too."""
    s = _plateau_scores(r + 1, 1, 20, 26)
    _check(_replay_large(s, r), s, r)


@pytest.mark.parametrize("radius", list(range(13)))
def test_radius_0_to_12_matches_pallas_and_xla(radius):
    """The port's NMS (the plain version on the CPU) at every radius the
    kernels take, against JAX's Pallas kernel, which widens its pad lanes
    for a large radius, and its XLA reference."""
    s = _plateau_scores(radius, 1, 40, 52, levels=7 if radius % 2 else None)
    got = score_path.nms(torch.from_numpy(s), radius).numpy()
    np.testing.assert_array_equal(got, np.asarray(jax_nms(jnp.asarray(s), radius)))
    np.testing.assert_array_equal(got, np.asarray(jax_simple_nms(jnp.asarray(s), radius)))


def test_large_radius_routes_and_never_falls_back():
    """Radii above FUSED_MAX_RADIUS go to the second entry; its shared
    memory follows large_smem; a non-CPU tensor never takes the plain
    version, at any radius."""
    assert score_path.FUSED_MAX_RADIUS == 9
    assert score_path.large_smem(512, 512, 12) == (32 + 24) * 32 * 4
    assert score_path.large_smem(20, 26, 30) == 20 * 32 * 4  # clipped to the image
    for radius in (4, 12):
        with pytest.raises(ValueError, match="CUDA"):
            score_path.nms(torch.empty((1, 8, 8), device="meta"), radius)
    assert launch_counts()["nms"] == 0
