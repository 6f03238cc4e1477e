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

The CUDA kernels cannot run here; `_emulate` replays their tile schedule
in torch (key tiles of 64 skipped when they hold no valid key, the online
max and sum, the log-sum-exp with +inf on rows without a valid key, the
backward's recomputed weights by key tile and query tile) against the
plain version, on ragged shapes.
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


def _emulate(q, k, v, mask, scale, do, tile=64):
    """The CUDA kernels' schedule in torch: (o, lse, dq, dk, dv).

    Forward: key tiles in order, each skipped where the example has no
    valid key in it (`__syncthreads_or`), invalid scores -inf, the online
    max and sum; o = acc / l and lse = m + log(l), or 0 and +inf where no
    tile ran. Backward: per key tile (dK / dV) and per query tile (dQ),
    p = exp(s - lse) on valid keys (0 past the tails and on +inf rows),
    ds = p (dp - di), di = sum(o * do)."""
    b, n, h, d = q.shape
    m = k.shape[1]
    valid = torch.ones((b, m), dtype=torch.bool) if mask is None else mask
    qh, kh, vh, doh = (x.permute(0, 2, 1, 3) for x in (q, k, v, do))  # [B, H, rows, D]
    m_run = torch.full((b, h, n), -torch.inf)
    l_run = torch.zeros((b, h, n))
    acc = torch.zeros((b, h, n, d))
    for c0 in range(0, m, tile):
        vt = valid[:, c0:c0 + tile]
        run = vt.any(dim=1)[:, None, None]
        s = torch.einsum("bhnd,bhmd->bhnm", qh, kh[:, :, c0:c0 + tile]) * scale
        s = torch.where(vt[:, None, None, :], s, -torch.inf)
        m_new = torch.maximum(m_run, s.amax(dim=-1))
        alpha = torch.exp(m_run - m_new)
        p = torch.exp(s - m_new[..., None])
        l_run = torch.where(run, l_run * alpha + p.sum(dim=-1), l_run)
        acc = torch.where(run[..., None], acc * alpha[..., None] + p @ vh[:, :, c0:c0 + tile], acc)
        m_run = torch.where(run, m_new, m_run)
    ran = l_run > 0
    o = torch.where(ran[..., None], acc / l_run.clamp(min=1e-30)[..., None], 0.0)
    lse = torch.where(ran, m_run + torch.log(l_run.clamp(min=1e-30)), torch.inf)
    di = (o * doh).sum(dim=-1)
    dq, dk, dv = torch.zeros_like(qh), torch.zeros_like(kh), torch.zeros_like(vh)
    for c0 in range(0, m, tile):
        vt = valid[:, None, None, c0:c0 + tile]
        if not bool(vt.any()):
            continue
        for n0 in range(0, n, tile):
            rows, cols = slice(n0, n0 + tile), slice(c0, c0 + tile)
            s = torch.einsum("bhnd,bhmd->bhnm", qh[:, :, rows], kh[:, :, cols]) * scale
            p = torch.where(vt, torch.exp(s - lse[:, :, rows, None]), 0.0)
            dp = torch.einsum("bhnd,bhmd->bhnm", doh[:, :, rows], vh[:, :, cols])
            ds = p * (dp - di[:, :, rows, None])
            dv[:, :, cols] += p.transpose(-1, -2) @ doh[:, :, rows]
            dk[:, :, cols] += ds.transpose(-1, -2) @ qh[:, :, rows] * scale
            dq[:, :, rows] += ds @ kh[:, :, cols] * scale
    back = lambda x: x.permute(0, 2, 1, 3)  # noqa: E731
    return back(o), lse.permute(0, 2, 1), back(dq), back(dk), back(dv)


@pytest.mark.parametrize("case", ["ragged", "masked_tile", "large_scores"])
def test_tile_schedule_matches_plain(case):
    """The kernels' schedule against the plain version and its autograd:
    ragged N and M (tails of 6 and 2 rows), a whole key tile masked inside
    a valid example (skipped), and masked keys whose scores (|s| up to
    about 4e3, either sign) dwarf the valid ones': they must weigh 0 and
    take no part in the row's max."""
    b, n, m, h, d = 3, 70, 130, 2, 48
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
