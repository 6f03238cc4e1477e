"""Parity of the port's flash attention (K8, `ops.kernels.flash_attention`,
the `use_flash=True` route of `masked_softmax_attention`) with the JAX
package's flash route on the CPU.

The JAX side runs `masked_softmax_attention(..., use_flash=True)`, which
calls the library's Pallas flash attention, in interpret mode
(`pltpu.force_tpu_interpret_mode()`, as tests/test_pallas_kernels.py
runs it); the port's side runs the kernels' plain version, which is what
the wrapper takes for CPU tensors. Inputs are numpy draws from a seed.
Tolerance 1e-5 absolute on the outputs and on the gradients of
sum(out * w) (fp32 sums in another order); the rows and gradients of an
example whose keys are all masked are exactly 0 on both sides.

Heads: JAX's route takes D <= 128 or a multiple of 128, and so does the
port (D = 256 and 384 against JAX; D = 160 raises on both).

The CUDA kernels cannot run here; `_emulate` replays their schedule in
torch: every product in 3xTF32 as the tensor cores compute it (an fp32 x
is hi + lo, hi = x with its 13 low mantissa bits dropped, as the tensor
cores read an fp32 operand, lo = the rest, dropped likewise; three
products hi.hi + hi.lo + lo.hi), key tiles of 64 in the forward with the
online softmax in base 2 (a masked key -inf, a row without a valid key
yet weighing its tile 0), each tile's P V added to the output in fp32,
the log-sum-exp with +inf on rows without a valid key, and the
backward's recomputed weights by tiles of 32 with each tile's products
added in fp32. Heads of 65 to 128 channels and of 256 take the wide
kernels' schedule: key tiles of 32 forward and 16 backward, each score
tile summed from 64-channel slices' partials in pairs. It is held to the
plain version on ragged shapes and to JAX's route at the JAX test's
shape, where one tf32 product instead of three misses the card's
tolerance.
"""

import jax
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from onepose_tpu.models.common import masked_softmax_attention as jax_softmax_attention
from onepose_tpu_torch.models.common import masked_softmax_attention
from onepose_tpu_torch.ops.kernels import flash_attention as fa
from onepose_tpu_torch.ops.kernels import launch_counts, reset_launches

torch.set_num_threads(2)

ATOL = 1e-5
SHAPE = (2, 300, 260, 4, 64)  # [B, N, M, H, D]: tests/test_pallas_kernels.py's; pads to 512 in JAX
# The tolerances that chip_smoke.py holds the kernels to against the plain version on the card.
FLASH_FWD_ABS, FLASH_BWD_REL = fa.CARD_FWD_ABS, fa.CARD_BWD_REL


def _draw(seed, b, n, m, h, d, masked=True):
    """q, k, v, mask (80% valid keys, example 1 fully masked; None if not
    masked) and the cotangent w, as numpy."""
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(b, n, h, d)).astype(np.float32)
    k = rng.normal(size=(b, m, h, d)).astype(np.float32)
    v = rng.normal(size=(b, m, h, d)).astype(np.float32)
    w = rng.normal(size=(b, n, h, d)).astype(np.float32)
    mask = None
    if masked:
        mask = rng.random((b, m)) < 0.8
        mask[1] = False
    return q, k, v, mask, w


def _jax_flash(q, k, v, mask, w=None):
    """JAX's flash route in interpret mode: out, and with w the gradients
    of sum(out * w) with respect to q, k and v."""
    jmask = None if mask is None else jax.numpy.asarray(mask)

    def f(q_, k_, v_):
        return jax_softmax_attention(q_, k_, v_, jmask, use_flash=True)

    with pltpu.force_tpu_interpret_mode():
        if w is None:
            return np.asarray(f(q, k, v)), None
        out, vjp = jax.vjp(f, q, k, v)
        return np.asarray(out), [np.asarray(g) for g in vjp(w)]


@pytest.fixture(scope="module")
def main_case():
    """The JAX test's shape: inputs, JAX's output and gradients (one trace
    for both)."""
    q, k, v, mask, w = _draw(0, *SHAPE)
    out, grads = _jax_flash(q, k, v, mask, w)
    return dict(inputs=(q, k, v, mask), w=w, out=out, grads=grads)


def _port(q, k, v, mask, w=None):
    """The port's route on the CPU: out, and with w the gradients."""
    qt, kt, vt = (torch.from_numpy(x).requires_grad_(w is not None) for x in (q, k, v))
    mt = None if mask is None else torch.from_numpy(mask)
    out = masked_softmax_attention(qt, kt, vt, mt, use_flash=True)
    if w is None:
        return out.detach().numpy(), None
    grads = torch.autograd.grad(out, (qt, kt, vt), torch.from_numpy(w))
    return out.detach().numpy(), [g.numpy() for g in grads]


def test_forward_matches_jax_flash_route(main_case):
    got, _ = _port(*main_case["inputs"])
    want = main_case["out"]
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)
    assert np.all(got[1] == 0) and np.all(want[1] == 0)  # example 1: no valid key
    assert np.abs(got[0]).max() > 0.1


def test_gradients_match_jax_flash_route(main_case):
    _, got = _port(*main_case["inputs"], main_case["w"])
    for name, g, want in zip("qkv", got, main_case["grads"]):
        np.testing.assert_allclose(g, want, atol=ATOL, rtol=0, err_msg=f"d{name}")
        assert np.all(g[1] == 0) and np.all(want[1] == 0), f"d{name} of the masked example"
        assert np.abs(g[0]).max() > 1e-3, f"d{name}"


@pytest.mark.parametrize("case", ["no_mask", "d32"])
def test_forward_cases_match_jax_flash_route(case):
    """kv_mask None, and a head of 32 channels (ragged N and M)."""
    if case == "no_mask":
        q, k, v, mask, _ = _draw(1, 1, 100, 90, 4, 64, masked=False)
    else:
        q, k, v, mask, _ = _draw(2, 2, 100, 90, 4, 32)
    got, _ = _port(q, k, v, mask)
    want, _ = _jax_flash(q, k, v, mask)
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)
    assert np.all(np.isfinite(got))


@pytest.mark.parametrize("d", [96, 128, 256, 384])
def test_wide_heads_match_jax_flash_route(d):
    """JAX's route takes a head of up to 128 channels or of any multiple of
    128, and so does the port: forward and gradients, an empty example."""
    q, k, v, mask, w = _draw(5, 2, 100, 90, 2, d)
    want, want_grads = _jax_flash(q, k, v, mask, w)
    got, grads = _port(q, k, v, mask, w)
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)
    assert np.all(got[1] == 0) and np.abs(got[0]).max() > 0.1
    for name, g, wg in zip("qkv", grads, want_grads):
        np.testing.assert_allclose(g, wg, atol=ATOL, rtol=0, err_msg=f"d{name}")
        assert np.all(g[1] == 0), f"d{name} of the masked example"


def test_cpu_route_launches_nothing_and_wide_heads_raise():
    q, k, v, mask, w = (None if x is None else torch.from_numpy(x)
                        for x in _draw(3, 2, 20, 30, 2, 16))
    reset_launches()
    out = masked_softmax_attention(q.requires_grad_(), k, v, mask, use_flash=True)
    torch.autograd.grad(out, q, w)
    counts = launch_counts()
    assert counts["flash_attention"] == 0 and counts["flash_attention_bwd"] == 0
    wide = torch.zeros((1, 4, 2, 160))
    with pytest.raises(ValueError, match="head dimension 160"):
        masked_softmax_attention(wide, wide, wide, None, use_flash=True)
    with pytest.raises(ValueError, match="kv_mask"):
        fa.flash_attention(q, k, v, mask[:, :5], 0.25)


def _tf32(x):
    """x as the tensor cores read an fp32 operand: its 13 low mantissa bits dropped."""
    return (x.view(torch.int32) & -8192).view(torch.float32)


def _mm(a, b, terms=3):
    """a @ b (fp32, batched) as the kernels compute it: 3xTF32, hi.hi +
    hi.lo + lo.hi with hi = tf32(x), lo = tf32(x - hi); or one tf32 product."""
    ah, bh = _tf32(a), _tf32(b)
    if terms == 1:
        return ah @ bh
    return ah @ _tf32(b - bh) + _tf32(a - ah) @ bh + ah @ bh


def _wide(d):
    """Whether a head of d channels takes the wide kernels (65 to 128
    channels, or 256; the others' schedules differ only in tile sizes)."""
    return 64 < d <= 128 or d == 256


def _scores(a, b, terms, wide):
    """a @ b^T over the channels as the kernels sum it: one product, or (the
    wide kernels) a partial product a 64-channel slice, the slices added in
    pairs (a block's two), then the pairs (a cluster's two blocks); a slice
    past D is zeros and adds nothing."""
    if not wide:
        return _mm(a, b.transpose(-1, -2), terms)
    parts = [_mm(a[..., c:c + 64], b[..., c:c + 64].transpose(-1, -2), terms)
             for c in range(0, a.shape[-1], 64)]
    pairs = [parts[i] + parts[i + 1] if i + 1 < len(parts) else parts[i]
             for i in range(0, len(parts), 2)]
    return pairs[0] if len(pairs) == 1 else pairs[0] + pairs[1]


def _emulate(q, k, v, mask, scale, do, terms=3):
    """The CUDA kernels' schedule in torch: (o, lse, dq, dk, dv).

    Forward: key tiles of 64 in order (32 for the wide kernels); scores in
    base 2 (s scale log2 e), -inf on invalid keys; the online max and sum, a
    row whose max is still -inf weighing the tile exp2(-inf - 0) = 0; each
    tile's P V (a fresh accumulator) added to the rescaled output; o = acc /
    l and lse = m ln 2 + log(l), or 0 and +inf where no key was valid.
    Backward with di = sum(o * do): the dK / dV kernel by query tiles of 32
    and the dQ kernel by key tiles of 32 (16 for the wide kernels), p =
    exp2(s scale log2 e - lse log2 e) on valid keys (0 past the tails and on
    +inf rows), ds = p (dp - di), each tile's products added in fp32. In the
    wide kernels every consumer of a row tile holds the whole score (and dp)
    tile, summed from the slices' partials by `_scores`, and takes the same
    softmax, so one P (one dS) serves every slice's products. Every product
    through `_mm` (`terms` tf32 products)."""
    b, n, h, d = q.shape
    m = k.shape[1]
    wide = _wide(d)
    fwd_tile, bwd_tile = (32, 16) if wide else (64, 32)
    valid = torch.ones((b, m), dtype=torch.bool) if mask is None else mask
    qh, kh, vh, doh = (x.permute(0, 2, 1, 3) for x in (q, k, v, do))  # [B, H, rows, D]
    log2e = 1.4426950408889634
    sl2 = torch.tensor(scale * log2e, dtype=torch.float32)
    m_run = torch.full((b, h, n), -torch.inf)
    l_run = torch.zeros((b, h, n))
    acc = torch.zeros((b, h, n, d))
    for c0 in range(0, m, fwd_tile):
        cols = slice(c0, c0 + fwd_tile)
        s = _scores(qh, kh[:, :, cols], terms, wide)
        s = torch.where(valid[:, None, None, cols], s * sl2, -torch.inf)
        m_new = torch.maximum(m_run, s.amax(dim=-1))
        m_use = torch.where(m_new == -torch.inf, 0.0, m_new)
        alpha = torch.exp2(m_run - m_use)
        p = torch.exp2(s - m_use[..., None])
        l_run = l_run * alpha + p.sum(dim=-1)
        acc = acc * alpha[..., None] + _mm(p, vh[:, :, cols], terms)
        m_run = m_new
    ran = l_run > 0
    o = torch.where(ran[..., None], acc / l_run.clamp(min=1e-30)[..., None], 0.0)
    lse = torch.where(ran, m_run * 0.6931471805599453 + torch.log(l_run.clamp(min=1e-30)),
                      torch.inf)
    di = (o * doh).sum(dim=-1)
    lse2 = lse * log2e

    def weights(rows, cols):
        s = _scores(qh[:, :, rows], kh[:, :, cols], terms, wide)
        p = torch.where(valid[:, None, None, cols], torch.exp2(s * sl2 - lse2[:, :, rows, None]), 0.0)
        dp = _scores(doh[:, :, rows], vh[:, :, cols], terms, wide)
        return p, p * (dp - di[:, :, rows, None])

    dq, dk, dv = torch.zeros_like(qh), torch.zeros_like(kh), torch.zeros_like(vh)
    for n0 in range(0, n, bwd_tile):  # the dK / dV kernel's query tiles
        rows = slice(n0, n0 + bwd_tile)
        p, ds = weights(rows, slice(0, m))
        dv += _mm(p.transpose(-1, -2), doh[:, :, rows], terms)
        dk += _mm(ds.transpose(-1, -2), qh[:, :, rows], terms) * scale
    for c0 in range(0, m, bwd_tile):  # the dQ kernel's key tiles
        cols = slice(c0, c0 + bwd_tile)
        _, ds = weights(slice(0, n), cols)
        dq += _mm(ds, kh[:, :, cols], terms) * scale
    back = lambda x: x.permute(0, 2, 1, 3)  # noqa: E731
    return back(o), lse.permute(0, 2, 1), back(dq), back(dk), back(dv)


@pytest.mark.parametrize("case", ["ragged", "masked_tile", "large_scores"])
def test_tile_schedule_matches_plain(case):
    """The kernels' schedule against the plain version and its autograd:
    ragged N and M (tails of 6 and 2 rows), a whole key tile masked inside
    a valid example (it changes nothing), and masked keys whose scores
    (|s| up to about 4e3, either sign) dwarf the valid ones': they must
    weigh 0 and take no part in the row's max."""
    _check_schedule(case, 48)


@pytest.mark.parametrize("d", [128, 256])
@pytest.mark.parametrize("case", ["ragged", "masked_tile", "large_scores"])
def test_wide_tile_schedule_matches_plain(case, d):
    """The wide kernels' schedule (slices' partial scores summed in pairs,
    key tiles of 32 forward and 16 backward, fresh accumulators) against
    the plain version and its autograd, in the cases above: keys 64 to 127
    masked are whole tiles of both, and |s| reaches about 1e3 at D 256."""
    _check_schedule(case, d)


def _check_schedule(case, d):
    b, n, m, h = 3, 70, 130, 2
    q, k, v, mask, w = (torch.from_numpy(x) for x in _draw(4, b, n, m, h, d))
    if case == "masked_tile":
        mask[0, 64:128] = False
    if case == "large_scores":
        k[:, ::3] *= 1e3  # |s| up to about 4e3 on these keys, every one masked
        mask[:, ::3] = False
    scale = 1.0 / d ** 0.5
    o, lse, dq, dk, dv = _emulate(q, k, v, mask, scale, w)
    qt, kt, vt = (x.clone().requires_grad_() for x in (q, k, v))
    ref = fa.flash_attention_plain(qt, kt, vt, mask, scale)
    grads = torch.autograd.grad(ref, (qt, kt, vt), w)
    assert torch.equal(o[1], torch.zeros_like(o[1])) and bool(torch.isinf(lse[1]).all())
    torch.testing.assert_close(o, ref.detach(), atol=ATOL, rtol=0)
    s = torch.einsum("bnhd,bmhd->bnhm", q, k) * scale
    want_lse = torch.logsumexp(s.masked_fill(~mask[:, None, None, :], -torch.inf), dim=-1)
    torch.testing.assert_close(lse[0], want_lse[0], atol=ATOL * max(1.0, float(want_lse.abs().max())),
                               rtol=0)
    for name, got, want in zip("qkv", (dq, dk, dv), grads):
        scale_g = max(1.0, float(want.abs().max()))
        torch.testing.assert_close(got, want, atol=ATOL * scale_g, rtol=0, msg=f"d{name}")
        assert torch.equal(got[1], torch.zeros_like(got[1])), f"d{name} of the masked example"
    if case != "ragged":  # masked keys carry no gradient
        gone = ~mask[0]
        assert torch.equal(dk[0][gone], torch.zeros_like(dk[0][gone]))
        assert torch.equal(dv[0][gone], torch.zeros_like(dv[0][gone]))


def test_three_tf32_products_meet_the_card_tolerance(main_case):
    """At the JAX test's shape the replayed 3xTF32 schedule stays within
    chip_smoke's tolerances of JAX's route, forward and gradients; one tf32
    product for each fp32 one does not (its forward error is about 1e-3),
    which is why the kernels take three."""
    q, k, v, mask = (None if x is None else torch.tensor(x) for x in main_case["inputs"])
    w = torch.tensor(main_case["w"])
    scale = 1.0 / q.shape[-1] ** 0.5
    want_o = torch.tensor(main_case["out"])
    o, _, dq, dk, dv = _emulate(q, k, v, mask, scale, w)
    assert float((o - want_o).abs().max()) <= FLASH_FWD_ABS
    for name, got, want in zip("qkv", (dq, dk, dv), main_case["grads"]):
        want = torch.tensor(want)
        rel = float((got - want).abs().max()) / float(want.abs().max())
        assert rel <= FLASH_BWD_REL, f"d{name}: {rel:.3e}"
    o1 = _emulate(q, k, v, mask, scale, w, terms=1)[0]
    assert float((o1 - want_o).abs().max()) > FLASH_FWD_ABS


def test_phase_profiler_instruments_every_warp_specialised_kernel():
    """scripts/profile_flash_phases.py finds its anchors in the kernel
    source: four consumer phases in each D <= 64 kernel and five (the
    partials' sum too) in each wide one, three in each producer loop
    (`produce`, `produce_wide`), and each kernel's counters go to its own
    row."""
    import re

    from onepose_tpu_torch.scripts import profile_flash_phases as phases

    src = phases.instrumented_source()
    wide = [name for name in phases.KERNELS if name.endswith("_wide")]
    assert len(wide) == 3
    assert len(re.findall(r"^\s*PHASE\(\d\)$", src, re.M)) == (
        4 * (len(phases.KERNELS) - len(wide)) + 5 * len(wide) + 2 * 3)
    for kid, name in enumerate(phases.KERNELS):
        producer = "produce_wide" if name in wide else "produce"
        assert f"{producer}<{kid}>(" in src and f"PHASES_PUT({kid}, 0, 5)" in src, name


@pytest.mark.parametrize("script", ["profile_flash_phases", "compare_flash_builds"])
def test_flash_scripts_refuse_the_cpu(script):
    """The phase profiler and the two-build comparison time the card: on the
    CPU each main stops before building anything."""
    import importlib

    module = importlib.import_module(f"onepose_tpu_torch.scripts.{script}")
    argv = ["--device", "cpu"] + (["--build", "a=x", "--build", "b=y"]
                                  if script == "compare_flash_builds" else [])
    with pytest.raises(SystemExit, match="card"):
        module.main(argv)
