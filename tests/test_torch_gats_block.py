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
from onepose_tpu_torch.ops.kernels import gats_block, launch_counts, reset_launches

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
