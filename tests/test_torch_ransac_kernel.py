"""K9, RANSAC-PnP's CUDA kernel pair (`ops/kernels/ransac_pnp.py`,
`csrc/ransac_pnp.cu`), on the CPU: no nvcc and no card here, so these hold
what surrounds the kernels. `ransac_pnp` never falls back to the plain
version off the CPU; the wrapper raises on what the kernels do not take
before any launch; the C entry points are the ones `_build` binds, with
their argument types; the kernels' valid-first bit set and stable keep
(replayed in torch) give the plain version's order and keep; and the card
route's glue (the draws, launch B's epnp_refit split, the EPnP choice and
the start pose) gives `ransac_pnp_plain`'s outputs with the kernels
replaced by the plain stages. The kernels themselves are held against the
plain version on the card (chip_smoke.py's phase ransac)."""

import ctypes
import re

import numpy as np
import pytest
import torch

from onepose_tpu_torch.geometry import ransac
from onepose_tpu_torch.ops.kernels import _build, launch_counts, reset_launches
from onepose_tpu_torch.ops.kernels import ransac_pnp as k9

K_NP = np.array([[600.0, 0, 256], [0, 600.0, 256], [0, 0, 1]], np.float32)


def _batch(seed, b=3, n=90, n_hyp=24, outlier_frac=0.3, noise=0.5):
    """b frames of n matches (a fifth padded) of a scene under a known pose,
    with outliers and pixel noise, and uniform draws [b, n_hyp, 3]."""
    rng = np.random.default_rng(seed)
    pts3d = (rng.random((b, n, 3)) - 0.5).astype(np.float32) * 0.3
    t = np.array([0.02, -0.01, 0.8], np.float32)
    cam = pts3d + t
    pix = cam @ K_NP.T
    pts2d = (pix[..., :2] / pix[..., 2:]).astype(np.float32)
    pts2d += rng.normal(size=pts2d.shape).astype(np.float32) * noise
    out = rng.random((b, n)) < outlier_frac
    pts2d[out] = rng.random((int(out.sum()), 2)).astype(np.float32) * 512
    mask = rng.random((b, n)) < 0.8
    draws = rng.random((b, n_hyp, 3)).astype(np.float32)
    K = np.broadcast_to(K_NP, (b, 3, 3)).copy()
    return tuple(torch.from_numpy(x) for x in (pts2d, pts3d, K, mask, draws))


def test_non_cpu_tensor_never_falls_back():
    """On a device that is neither the CPU nor CUDA, `ransac_pnp` raises
    (naming CUDA) and launches nothing: it never runs the plain version
    there."""
    reset_launches()
    pts2d, pts3d, K, mask, draws = (x.to("meta") for x in _batch(0))
    for refit in (False, True):
        with pytest.raises(ValueError, match="CUDA"):
            ransac.ransac_pnp(pts2d, pts3d, K, mask, draws=draws, n_hyp=24, epnp_refit=refit)
    with pytest.raises(ValueError, match="CUDA"):  # the kernel entry takes no CPU tensor
        k9.hypotheses(*_batch(0), 5.0, 1000.0)
    assert launch_counts()["ransac_pnp"] == 0


def _bad_inputs():
    good = _batch(1)
    cases = {
        "pts2d float64": (0, good[0].double()),
        "pts3d rank 2": (1, good[1][0]),
        "pts3d [B, N, 2]": (1, good[1][..., :2].contiguous()),
        "K [B, 3, 4]": (2, torch.zeros((3, 3, 4))),
        "mask uint8": (3, good[3].to(torch.uint8)),
        "mask [B, N - 1]": (3, good[3][:, 1:].contiguous()),
        "draws [B, H, 2]": (4, good[4][..., :2].contiguous()),
        "draws of another batch": (4, good[4][:2].contiguous()),
        "no matches": (None, None),
        "no frames": ("B", None),
    }
    for name, (i, bad) in cases.items():
        args = list(good)
        if i is None:  # N = 0
            args[0], args[1], args[3] = good[0][:, :0], good[1][:, :0], good[3][:, :0]
        elif i == "B":
            args = [x[:0] for x in good]
        else:
            args[i] = bad
        yield pytest.param(args, id=name)


@pytest.mark.parametrize("args", list(_bad_inputs()))
def test_wrapper_checks_raise_before_any_launch(args):
    """A wrong dtype, rank or shape raises ValueError before the device is
    looked at, so before any launch (CPU tensors: a launch would fail)."""
    reset_launches()
    with pytest.raises(ValueError, match="ransac_pnp kernel"):
        k9.hypotheses(*args, 5.0, 1000.0)
    assert launch_counts()["ransac_pnp"] == 0


def test_draws_shape_checked_on_the_card_route():
    """`ransac_pnp` checks the draws against n_hyp on the card route as the
    plain version does, before any launch."""
    reset_launches()
    pts2d, pts3d, K, mask, draws = (x.to("meta") for x in _batch(2))
    with pytest.raises(ValueError, match=r"draws must be \[3, 32, 3\]"):
        ransac.ransac_pnp(pts2d, pts3d, K, mask, draws=draws, n_hyp=32)
    assert launch_counts()["ransac_pnp"] == 0


def _c_type(arg: str):
    if "*" in arg:
        return ctypes.c_void_p
    kind = arg.rsplit(None, 1)[0].replace("const", "").strip()
    return {"int": ctypes.c_int, "float": ctypes.c_float, "cudaStream_t": ctypes.c_void_p}[kind]


@pytest.mark.parametrize("name", _build.KERNELS)
def test_signatures_name_every_c_entry(name):
    """`_build.SIGNATURES[name]` names every `extern "C"` entry point of
    `csrc/<name>.cu`, each with its argument count and types (pointer, int,
    float): ctypes passes what the table says, so a mismatch would hand a
    kernel a cut pointer. Read from the source as text (no nvcc here)."""
    text = (_build.CSRC / f"{name}.cu").read_text()
    found = {}
    for m in re.finditer(r'extern "C"\s+[\w\s*]+?\b(\w+)\s*\(([^)]*)\)', text):
        args = [a for a in m.group(2).split(",") if a.strip() not in ("", "void")]
        found[m.group(1)] = [_c_type(a) for a in args]
    want = {fn: argtypes for fn, (argtypes, _) in _build.SIGNATURES[name].items()}
    assert found == want


def test_ransac_pnp_builds_without_fma_contraction():
    """K9's library is built with -fmad=false (the plain version's rounding;
    the source says why), and only K9's: the flag is part of its library's
    name, and the other libraries' names do not change with it."""
    assert _build.EXTRA_FLAGS == {"ransac_pnp": ("-fmad=false",)}
    assert "-fmad=false" in (_build.CSRC / "ransac_pnp.cu").read_text()
    saved = _build.EXTRA_FLAGS
    try:
        names = {k: _build.library_path(k) for k in _build.KERNELS}
        _build.EXTRA_FLAGS = {}
        assert _build.library_path("ransac_pnp") != names["ransac_pnp"]
        assert all(_build.library_path(k) == names[k] for k in _build.KERNELS
                   if k != "ransac_pnp")
    finally:
        _build.EXTRA_FLAGS = saved


def _select_valid(mask_row: torch.Tensor, r: int) -> int:
    """Launch A's select: the r-th valid match from the bit set (32 matches
    a word) and the exclusive prefix of its popcounts."""
    n = mask_row.shape[0]
    nw = -(-n // 32)
    bits = torch.zeros(nw * 32, dtype=torch.bool)
    bits[:n] = mask_row
    words = [int(sum(1 << i for i in range(32) if bits[w * 32 + i])) for w in range(nw)]
    pre = np.concatenate([[0], np.cumsum([bin(w).count("1") for w in words])[:-1]])
    lo, hi = 0, nw - 1
    while lo < hi:
        mid = (lo + hi + 1) // 2
        lo, hi = (mid, hi) if pre[mid] <= r else (lo, mid - 1)
    word = words[lo]
    for _ in range(r - int(pre[lo])):
        word &= word - 1
    return lo * 32 + (word & -word).bit_length() - 1


@pytest.mark.parametrize("n,valid", [(1, 1.0), (31, 0.5), (70, 0.3), (200, 0.05), (97, 1.0)])
def test_bit_set_select_is_the_valid_first_order(n, valid):
    """The r-th valid match by launch A's bit set is `_valid_first`'s
    order[r] for every r < n_valid (the stable argsort of ~mask)."""
    g = torch.Generator().manual_seed(n)
    mask = torch.rand((1, n), generator=g) < valid
    mask[0, n // 2] = True
    order, n_valid = ransac._valid_first(mask)
    got = [_select_valid(mask[0], r) for r in range(int(n_valid[0]))]
    assert got == order[0, :int(n_valid[0])].tolist()


def _keep_replayed(counts: torch.Tensor, n_keep: int) -> list:
    """Launch B's keep of one frame: the threshold count T from a histogram,
    the candidates above it ranked pairwise (count, then index), then those
    equal to T in index order until the keep is full."""
    hist = torch.bincount(counts, minlength=129)
    cum, T = 0, 128
    while T > 0 and cum + int(hist[T]) < n_keep:
        cum += int(hist[T])
        T -= 1
    big = [(int(v), c) for c, v in enumerate(counts.tolist()) if v > T]
    keep = [c for _, c in sorted(big, key=lambda vc: (-vc[0], vc[1]))]
    assert len(keep) == cum < n_keep
    keep += [c for c, v in enumerate(counts.tolist()) if v == T][:n_keep - cum]
    return keep


@pytest.mark.parametrize("h4,spread", [(8, 128), (96, 3), (2048, 128), (2048, 0), (512, 20)])
def test_stable_keep_is_the_stable_sort(h4, spread):
    """Launch B's keep is torch.sort(descending, stable)'s first
    min(64, 4H): counts in [0, 128] with many ties (spread 0: every count
    equal, so the keep is the first 64 indices)."""
    g = torch.Generator().manual_seed(h4 + spread)
    counts = torch.randint(0, spread + 1, (h4,), generator=g) + (128 - spread) // 2
    counts[::7] = 0
    n_keep = min(64, h4)
    want = torch.sort(counts, descending=True, stable=True)[1][:n_keep].tolist()
    assert _keep_replayed(counts, n_keep) == want


class _PlainKernels:
    """K9's three entries computed by the plain stages on the CPU, each
    counting a launch, in the layouts of the kernels' scratch and outputs."""

    def __init__(self):
        self.calls = []

    def hypotheses(self, pts2d, pts3d, K, mask, draws, thr, scale):
        self.calls.append("A")
        pts3d_s = pts3d * scale
        order, n_valid = ransac._valid_first(mask)
        idx = ransac._sample_minimal_sets(draws, order, n_valid)
        Rs, ts, oks = ransac._p3p_hypotheses(pts2d, pts3d_s, K, idx)
        B, H4 = oks.shape
        n_sub = min(128, pts2d.shape[1])
        sub = order[:, :n_sub]
        sub_valid = torch.arange(n_sub)[None, :] < n_valid[:, None]
        errs = ransac._reproj_err(Rs, ts, K[:, None], ransac._take(pts3d_s, sub)[:, None],
                                  ransac._take(pts2d, sub)[:, None])
        counts = ((errs < thr) & sub_valid[:, None, :]).sum(-1) * oks.int()
        return k9.Hypotheses(torch.cat([Rs.reshape(B, H4, 9), ts], -1),
                             torch.stack([counts, oks.int()], -1).int())

    def _best(self, hyp, pts2d, pts3d, K, mask, thr, scale):
        B, H4 = hyp.counts.shape[:2]
        Rs, ts = hyp.poses[..., :9].reshape(B, H4, 3, 3), hyp.poses[..., 9:]
        keep = torch.sort(hyp.counts[..., 0], dim=-1, descending=True, stable=True)[1]
        R, t, inl, n_in = ransac._score_kept(Rs, ts, hyp.counts[..., 1].bool(),
                                             keep[:, :min(64, H4)], pts2d, pts3d * scale, K,
                                             mask, thr)
        return k9.Best(torch.cat([R.reshape(B, 9), t], 1), inl, n_in.int())

    def score(self, hyp, pts2d, pts3d, K, mask, thr, scale):
        self.calls.append("B1")
        return self._best(hyp, pts2d, pts3d, K, mask, thr, scale)

    def refine(self, hyp, pts2d, pts3d, K, mask, thr, iters, scale, start=None):
        self.calls.append("B" if start is None else "B2")
        best = start if start is not None else self._best(hyp, pts2d, pts3d, K, mask, thr, scale)
        pts3d_s = pts3d * scale
        R2, t2 = ransac._gn_refine(best.R, best.t, K, pts3d_s, pts2d, best.inliers.float(),
                                   iters=iters)
        inl = (ransac._reproj_err(R2, t2, K, pts3d_s, pts2d) < thr) & mask
        ok = best.count >= 4
        B = pts2d.shape[0]
        R_out = torch.where(ok[:, None, None], R2, torch.eye(3).expand(B, 3, 3))
        t_out = torch.where(ok[:, None], t2 / scale, 0.0)
        pose = torch.eye(4).repeat(B, 1, 1)
        pose[:, :3, :3], pose[:, :3, 3] = R_out, t_out
        return {"pose": pose, "R": R_out, "t": t_out, "inliers": inl & ok[:, None],
                "num_inliers": torch.where(ok, inl.sum(-1), 0), "ok": ok}

    start_from = staticmethod(k9.start_from)
    Best = k9.Best
    Hypotheses = k9.Hypotheses


@pytest.mark.parametrize("refit", [False, True])
def test_card_route_glue_gives_the_plain_outputs(monkeypatch, refit):
    """The card route (`_ransac_pnp_card`: inputs, draws, launches A and B,
    with epnp_refit launch B's second scoring, the EPnP choice and launch B
    from the chosen pose) with K9's entries computed by the plain stages on
    the CPU gives `ransac_pnp_plain`'s outputs exactly, from injected draws
    and from a generator; launches A, B (A, B1, B2 with epnp_refit)."""
    fake = _PlainKernels()
    monkeypatch.setattr(ransac, "k9", fake)
    pts2d, pts3d, K, mask, draws = _batch(5, b=4, n=120, n_hyp=32)
    mask[1, 3:] = False  # a frame with 3 valid matches: not ok
    for injected in (draws, None):
        def gen():
            return None if injected is not None else torch.Generator().manual_seed(3)

        want = ransac.ransac_pnp_plain(pts2d, pts3d, K, mask, draws=injected, n_hyp=32,
                                       epnp_refit=refit, generator=gen())
        got = ransac._ransac_pnp_card(pts2d, pts3d.double(), K, mask, injected, 5.0, 32, 5,
                                      1000.0, refit, gen())
        assert got.keys() == want.keys()
        for k in want:
            assert got[k].dtype == want[k].dtype and torch.equal(got[k], want[k]), k
        assert want["ok"].tolist() == [True, False, True, True]
    assert fake.calls == (["A", "B1", "B2"] if refit else ["A", "B"]) * 2


def test_cpu_route_is_the_plain_version():
    """On CPU tensors `ransac_pnp` is `ransac_pnp_plain`, and launches
    nothing."""
    reset_launches()
    args = _batch(6)
    got = ransac.ransac_pnp(*args[:4], draws=args[4], n_hyp=24)
    want = ransac.ransac_pnp_plain(*args[:4], draws=args[4], n_hyp=24)
    assert all(torch.equal(got[k], want[k]) for k in want)
    assert launch_counts()["ransac_pnp"] == 0
