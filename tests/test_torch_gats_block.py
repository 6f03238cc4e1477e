"""Parity of the port's fused GATsSPG block (K4) with the JAX package's kernel.

On the CPU `fused_gats_block` runs `fused_gats_block_plain` (the CUDA
kernels run only on the card, where chip_smoke.py holds them against the
same plain version). The JAX side runs
onepose_tpu/ops/pallas/gats_block.py::fused_gats_block in interpret mode,
as tests/test_pallas_kernels.py does. Shapes: B = 2, N2 = 16, N3 = 24,
L = 4, C = 256, 4 heads; inputs and weights from a numpy seed, weights
bridged from flax init.

Tolerances: fp32 1e-4 absolute and relative (the same math, fp32 sums in
another order). bf16 2e-2 of each output's largest magnitude: both sides
round the same operands to bf16, but a sum that lands on the other side
of a rounding boundary moves one operand by 2^-8 relative, and four
attention layers with instance norms carry that on.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from onepose_tpu.models.gats_spg import GATsSPG as JaxGATsSPG
from onepose_tpu.ops.pallas.gats_block import fused_gats_block as jax_block
from onepose_tpu.ops.pallas.gats_block import pack_block_params as jax_pack
from onepose_tpu_torch.models import bridge
from onepose_tpu_torch.models.gats_spg import GATsSPG
from onepose_tpu_torch.ops.kernels import _layout, gats_block, launch_counts, reset_launches

torch.set_num_threads(2)

B, N2, N3, L, C, H = 2, 16, 24, 4, 256, 4


def _setup(seed=0):
    rng = np.random.default_rng(seed)
    x2 = rng.normal(size=(B, N2, C)).astype(np.float32)
    x3 = rng.normal(size=(B, N3, C)).astype(np.float32)
    leaves = rng.normal(size=(B, N3, L, C)).astype(np.float32)
    masks = (rng.random((B, N2)) < 0.8, rng.random((B, N3)) < 0.8, rng.random((B, N3, L)) < 0.7)
    params = JaxGATsSPG(num_blocks=1).init(
        jax.random.PRNGKey(seed), *map(jnp.asarray, (x2, x3, leaves)))["params"]
    model = GATsSPG(num_blocks=1)
    model.load_state_dict(bridge.gats_spg_state_dict(jax.tree.map(np.asarray, params)))
    return (x2, x3, leaves), masks, params, model


def _port_params(model):
    with torch.no_grad():
        return gats_block.pack_block_params(model.gats_0, model.self_0, model.cross_0)


def test_pack_block_params_matches_jax():
    _, _, params, model = _setup()
    want = jax_pack(params["gats_0"], params["self_0"], params["cross_0"])
    got = _port_params(model)
    assert set(got) == set(want)
    for k in want:
        assert tuple(got[k].shape) == want[k].shape, k
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]), atol=1e-6, rtol=0,
                                   err_msg=k)


@pytest.mark.parametrize("masked", [True, False])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_plain_matches_pallas(masked, dtype):
    (x2, x3, leaves), masks, params, model = _setup(seed=1 if masked else 2)
    masks = masks if masked else (None, None, None)
    packed = jax_pack(params["gats_0"], params["self_0"], params["cross_0"])
    want = jax_block(*map(jnp.asarray, (x2, x3, leaves)),
                     *[None if m is None else jnp.asarray(m) for m in masks], packed,
                     dtype=getattr(jnp, dtype))
    got = gats_block.fused_gats_block(
        *map(torch.from_numpy, (x2, x3, leaves)),
        *[None if m is None else torch.from_numpy(m) for m in masks], _port_params(model),
        dtype=getattr(torch, dtype))
    for g, w in zip(got, want):
        g, w = g.numpy(), np.asarray(w)
        assert g.dtype == np.float32 and g.shape == w.shape
        if dtype == "float32":
            np.testing.assert_allclose(g, w, atol=1e-4, rtol=1e-4)
        else:
            err = np.abs(g - w).max() / np.abs(w).max()
            assert err <= 2e-2, err


def test_bf16_rounds_differently_from_fp32():
    """The bf16 block is not the fp32 one: the rounding points are real."""
    (x2, x3, leaves), masks, _, model = _setup(seed=3)
    args = [torch.from_numpy(a) for a in (x2, x3, leaves, *masks)]
    p = _port_params(model)
    f32 = gats_block.fused_gats_block_plain(*args, p, dtype=torch.float32)
    b16 = gats_block.fused_gats_block_plain(*args, p, dtype=torch.bfloat16)
    d = max(float((a - b).abs().max()) for a, b in zip(f32, b16))
    assert 1e-4 < d < 0.5 * float(f32[0].abs().max())


def test_non_cpu_tensor_never_falls_back():
    reset_launches()
    (x2, x3, leaves), masks, _, model = _setup()
    meta = [torch.from_numpy(a).to("meta") for a in (x2, x3, leaves)]
    params = {k: v.to("meta") for k, v in _port_params(model).items()}
    with pytest.raises(ValueError, match="CUDA"):
        gats_block.fused_gats_block(*meta, None, None, None, params)
    assert launch_counts()["gats_block"] == 0


def test_block_fused_is_inference_only():
    """As in the JAX package (no VJP): GATsSPG(block_fused=True) raises while
    autograd records, and runs under no_grad."""
    (x2, x3, leaves), masks, _, model = _setup()
    fused = GATsSPG(num_blocks=1, block_fused=True)
    fused.load_state_dict(model.state_dict())
    args = [torch.from_numpy(a) for a in (x2, x3, leaves, *masks)]
    with pytest.raises(RuntimeError, match="inference-only"):
        fused(*args)
    with torch.no_grad():
        assert fused(*args)["matches0"].shape == (B, N2)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_gemm_plain_rounds_operands(dtype):
    """The block's GEMM alone (timed on the card beside torch.matmul): both
    operands rounded to dtype, summed in fp32, bias added."""
    rng = np.random.default_rng(5)
    a, w = (torch.from_numpy(rng.normal(size=s).astype(np.float32)) for s in ((70, 128), (128, 64)))
    bias = torch.from_numpy(rng.normal(size=64).astype(np.float32))
    got = gats_block.gemm(a, w, bias, dtype)
    want = a.to(dtype).double() @ w.to(dtype).double() + bias.double()
    assert got.dtype == torch.float32 and got.shape == (70, 64)
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=1e-4, rtol=1e-5)


# --- The CUDA kernels' schedules and storage, replayed in torch ---

def _stat_parts_emulated(t, n_rows, rows=gats_block.STAT_ROWS):
    """csrc/gats_block.cu colpart + colcombine in torch: per part of `rows`
    rows of an example, the mean (8 row lanes strided by 8, then the lanes
    summed in order) and the centred M2 the same way; then Chan's merge of
    the parts in order. t [B * N, K] fp32 -> mean, rstd [B, K]."""
    k = t.shape[1]
    t = t.reshape(-1, n_rows, k)
    n, mu, m2 = torch.zeros(()), torch.zeros(t.shape[0], k), torch.zeros(t.shape[0], k)

    def lanes(x):  # the kernel's order: lane l sums rows l, l + 8, ...; then lanes 0..7
        acc = [torch.zeros(x.shape[0], k) for _ in range(8)]
        for r in range(x.shape[1]):
            acc[r % 8] = acc[r % 8] + x[:, r]
        tot = torch.zeros(x.shape[0], k)
        for a in acc:
            tot = tot + a
        return tot

    for r0 in range(0, n_rows, rows):
        part = t[:, r0:r0 + rows]
        npart = torch.tensor(float(part.shape[1]))
        pm = lanes(part) / npart
        pm2 = lanes((part - pm[:, None]) ** 2)
        tot = n + npart
        d = pm - mu
        mu = mu + d * (npart / tot)
        m2 = m2 + pm2 + d * d * (n * npart / tot)
        n = tot
    return mu, 1.0 / torch.sqrt(m2 / n_rows + gats_block.EPS_NORM)


@pytest.mark.parametrize("n_rows", [37, 300, 2000])
def test_norm_statistics_in_parts_match_two_pass(n_rows):
    """The partial statistics and their fixed-order combine give the two-pass
    mean and centred variance of the plain version (fp32, 1e-6 relative)."""
    rng = np.random.default_rng(n_rows)
    t = torch.from_numpy((rng.normal(size=(2 * n_rows, 64)) * 2.0 + 3.0).astype(np.float32))
    mu, rstd = _stat_parts_emulated(t, n_rows)
    x = t.double().reshape(2, n_rows, 64)
    mu_ref = x.mean(dim=1)
    var_ref = (x - mu_ref[:, None]).square().mean(dim=1)
    np.testing.assert_allclose(mu.numpy(), mu_ref.numpy(), rtol=1e-6)
    var = 1.0 / rstd.double() ** 2 - gats_block.EPS_NORM
    np.testing.assert_allclose(var.numpy(), var_ref.numpy(), rtol=1e-6)


def test_bf16_storage_leaves_the_plain_block_bit_identical():
    """The bf16 kernels store the attention output and the message in bf16
    and read bf16 leaves: the GEMMs that read att and msg round them to bf16
    anyway, and bf16 leaves hold the values the fp32 copy held, so the
    plain block gives the same bits either way."""
    (x2, x3, leaves), masks, _, model = _setup(seed=4)
    p = _port_params(model)
    args = [torch.from_numpy(a) for a in (x2, x3)]
    mk = [torch.from_numpy(m) for m in masks]
    lv = torch.from_numpy(leaves).bfloat16()
    got = gats_block.fused_gats_block_plain(*args, lv, *mk, p, dtype=torch.bfloat16)
    want = gats_block.fused_gats_block_plain(*args, lv.float(), *mk, p, dtype=torch.bfloat16)
    assert all(torch.equal(g, w) for g, w in zip(got, want))
    rng = np.random.default_rng(6)
    att = torch.from_numpy(rng.normal(size=(40, C)).astype(np.float32))
    w, b = p["self_w4"][3], p["self_b4"][3]
    assert torch.equal(gats_block.gemm_plain(att, w, b), gats_block.gemm_plain(
        att.bfloat16().float(), w, b))
    msg = torch.from_numpy(rng.normal(size=(40, C)).astype(np.float32))
    xm = torch.cat([args[0][0, :16].repeat(3, 1)[:40], msg], dim=1)
    xm_b = torch.cat([args[0][0, :16].repeat(3, 1)[:40], msg.bfloat16().float()], dim=1)
    w0, b0 = p["self_w0"], p["self_b0"]
    assert torch.equal(gats_block.gemm_plain(xm, w0, b0), gats_block.gemm_plain(xm_b, w0, b0))


def test_kernel_weights_layout():
    """kernel_weights packs each GEMM weight [K, N] as swizzled bf16 chunks
    [K / 64, N, 64] (fp32 [N, K] for the fp32 kernels)."""
    _, _, _, model = _setup()
    p = _port_params(model)
    kw = gats_block.kernel_weights(p, torch.bfloat16)
    assert kw["self_wqkv"].shape == (C // 64, 3 * C, 64)
    assert kw["cross_w0"].shape == (2 * C // 64, 2 * C, 64)
    w4 = p["self_w4"]
    qkv = torch.cat([w4[0], w4[1], w4[2]], dim=1)  # [C, 3C]
    assert torch.equal(_layout.unswizzle128(kw["self_wqkv"], C), qkv.T.bfloat16())
    assert torch.equal(_layout.unswizzle128(kw["self_w1"], 2 * C), p["self_w1"].T.bfloat16())
    k32 = gats_block.kernel_weights(p, torch.float32)
    assert torch.equal(k32["cross_wm"], p["cross_w4"][3].T)


def test_gatsspg_caches_block_weights():
    """GATsSPG(block_fused) packs each block's weights once, gives what a
    fresh pack gives, and packs again after an in-place parameter update."""
    (x2, x3, leaves), masks, _, model = _setup(seed=5)
    fused = GATsSPG(num_blocks=1, block_fused=True)
    fused.load_state_dict(model.state_dict())
    args = [torch.from_numpy(a) for a in (x2, x3, leaves, *masks)]
    with torch.no_grad():
        first = fused(*args)
        assert fused._packs.packs == 1
        again = fused(*args)
        assert fused._packs.packs == 1
        assert torch.equal(first["matches0"], again["matches0"])
        uncached = gats_block.fused_gats_block(
            *args[:6], gats_block.pack_block_params(fused.gats_0, fused.self_0, fused.cross_0),
            dtype=torch.float32)
        cached = gats_block.fused_gats_block(*args[:6], fused.block_weights(0)[0],
                                             dtype=torch.float32)
        assert all(torch.equal(a, b) for a, b in zip(uncached, cached))
        fused.self_0.mlp.dense_1.bias.add_(0.5)
        fused(*args)
        assert fused._packs.packs == 2
        assert torch.equal(fused.block_weights(0)[0]["self_b1"], fused.self_0.mlp.dense_1.bias)
