"""Parity of the port's GATsSPG matcher and its building blocks with the
JAX package on the CPU.

Shapes: N2 = 64 2D keypoints, N3 = 96 3D points, L = 8 leaves, C = 256,
padded masks. Parameters come from flax init through
onepose_tpu_torch.models.bridge. Tolerances: 1e-5 absolute on activations
and conf_matrix (fp32 matmuls sum in another order); matches identical.
The JAX Pallas kernels run in interpret mode; on the CPU the port's
kernel flags route to the plain versions of its CUDA kernels.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from onepose_tpu.models.common import AttentionalPropagation as JaxAttnProp
from onepose_tpu.models.common import masked_linear_attention as jax_linear_attention
from onepose_tpu.models.gats import GraphAttentionLayer as JaxGATs
from onepose_tpu.models.gats_spg import GATsSPG as JaxGATsSPG
from onepose_tpu_torch.models import bridge
from onepose_tpu_torch.models.common import AttentionalPropagation, masked_linear_attention
from onepose_tpu_torch.models.gats import GraphAttentionLayer
from onepose_tpu_torch.models.gats_spg import GATsSPG

torch.set_num_threads(2)

B, N2, N3, L, C = 2, 64, 96, 8, 256


def _unit(x):
    return x / np.linalg.norm(x, axis=-1, keepdims=True)


def _inputs(seed=0):
    rng = np.random.default_rng(seed)
    d2 = _unit(rng.normal(size=(B, N2, C))).astype(np.float32)
    d3 = _unit(rng.normal(size=(B, N3, C))).astype(np.float32)
    leaves = _unit(rng.normal(size=(B, N3, L, C))).astype(np.float32)
    # Correlate a third of the 3D points with 2D keypoints so matches exist.
    d3[:, : N3 // 3] = _unit(d2[:, : N3 // 3] + 0.3 * d3[:, : N3 // 3])
    leaves[:, : N3 // 3] = _unit(d3[:, : N3 // 3, None] + 0.3 * leaves[:, : N3 // 3])
    m2 = np.ones((B, N2), bool)
    m3 = np.ones((B, N3), bool)
    m2[0, -10:] = False  # padded keypoint slots
    m3[1, -20:] = False  # padded 3D points
    lm = rng.random((B, N3, L)) < 0.75
    return d2, d3, leaves, m2, m3, lm


def _t(*xs):
    return [torch.from_numpy(x) for x in xs]


def _j(*xs):
    return [jnp.asarray(x) for x in xs]


def test_masked_linear_attention_matches_jax():
    rng = np.random.default_rng(1)
    q, k, v = (rng.normal(size=(B, n, 4, 16)).astype(np.float32) for n in (N2, N3, N3))
    mask = rng.random((B, N3)) < 0.8
    want = jax_linear_attention(*_j(q, k, v, mask))
    got = masked_linear_attention(*_t(q, k, v, mask))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5, rtol=0)


@pytest.mark.parametrize("cross", [False, True])
def test_attentional_propagation_matches_jax(cross):
    d2, d3, _, m2, m3, _ = _inputs()
    src, src_mask = (d3, m3) if cross else (d2, m2)
    jax_layer = JaxAttnProp(C, 4, kind="linear", norm="instance")
    params = jax_layer.init(jax.random.PRNGKey(0), *_j(d2, src, src_mask, m2))
    want = jax_layer.apply(params, *_j(d2, src, src_mask, m2))
    layer = AttentionalPropagation(C, 4, kind="linear", norm="instance")
    layer.load_state_dict(bridge.jax_to_state_dict(jax.tree.map(np.asarray, params)))
    with torch.no_grad():
        got = layer(*_t(d2, src, src_mask, m2))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5, rtol=0)


@pytest.mark.parametrize(
    "include_self,additional,with_linear_transform,concat,kernel",
    [
        (True, False, False, True, True),  # shipped: the leaf-attention kernel
        (True, False, False, True, False),  # shipped, plain path
        (True, True, False, True, False),
        (True, False, True, True, False),
        (False, False, False, True, False),
        (False, False, True, False, False),
    ],
)
def test_graph_attention_layer_matches_jax(include_self, additional, with_linear_transform,
                                           concat, kernel):
    _, d3, leaves, _, _, lm = _inputs()
    flags = dict(include_self=include_self, additional=additional,
                 with_linear_transform=with_linear_transform, concat=concat)
    jax_layer = JaxGATs(C, C, use_pallas=kernel, **flags)
    params = jax_layer.init(jax.random.PRNGKey(2), *_j(leaves, d3, lm))
    want = jax_layer.apply(params, *_j(leaves, d3, lm))
    layer = GraphAttentionLayer(C, C, gats_kernel=kernel, **flags)
    layer.load_state_dict(bridge.jax_to_state_dict(jax.tree.map(np.asarray, params)))
    with torch.no_grad():
        got = layer(*_t(leaves, d3, lm))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5, rtol=0)


@pytest.mark.parametrize("gats_kernel", [False, True])
@pytest.mark.parametrize("fused_match", [False, True])
def test_gats_spg_matches_jax(gats_kernel, fused_match):
    args = _inputs()
    jax_model = JaxGATsSPG(num_blocks=2, gats_use_pallas=gats_kernel, fused_match=fused_match)
    params = JaxGATsSPG(num_blocks=2).init(jax.random.PRNGKey(3), *_j(*args))
    want = jax_model.apply(params, *_j(*args))
    model = GATsSPG(num_blocks=2, gats_kernel=gats_kernel, fused_match=fused_match)
    model.load_state_dict(bridge.gats_spg_state_dict(jax.tree.map(np.asarray, params)))
    with torch.no_grad():
        got = model(*_t(*args))
    if fused_match:
        assert got["conf_matrix"] is None and want["conf_matrix"] is None
    else:
        np.testing.assert_allclose(got["conf_matrix"].numpy(), np.asarray(want["conf_matrix"]),
                                   atol=1e-5, rtol=0)
    for k in ("matches0", "matches1"):
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]), err_msg=k)
    for k in ("matching_scores0", "matching_scores1"):
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]), atol=1e-5, rtol=0)
    assert (got["matches0"] >= 0).sum() > 0


@pytest.mark.parametrize("block_fused", [False, True])
@pytest.mark.parametrize("mixed_attention", [False, True])
def test_gats_spg_bf16_matches_jax(block_fused, mixed_attention):
    """bf16 GNN (JAX's serving dtype) against JAX, fused and unfused blocks.

    Tolerances: conf_matrix 1.5e-2 absolute and matches0 agreeing on at
    least 95% of the slots. Each layer agrees bit for bit on over 99% of
    its bf16 outputs (the frameworks sum in another order; JAX's mixed
    contractions keep fp32 operands on the CPU, where the port rounds them
    as JAX does on an accelerator), and a 1-ulp flip of a bf16 final
    projection (2^-8 relative) moves a conf value near 0.8 by about 1e-2
    through the scores' 1 / 0.07 scale."""
    args = _inputs()
    jax_model = JaxGATsSPG(num_blocks=2, dtype=jnp.bfloat16, block_fused=block_fused,
                           mixed_attention=mixed_attention)
    params = JaxGATsSPG(num_blocks=2).init(jax.random.PRNGKey(3), *_j(*args))
    want = jax_model.apply(params, *_j(*args))
    model = GATsSPG(num_blocks=2, dtype=torch.bfloat16, block_fused=block_fused,
                    mixed_attention=mixed_attention)
    model.load_state_dict(bridge.gats_spg_state_dict(jax.tree.map(np.asarray, params)))
    with torch.no_grad():
        got = model(*_t(*args))
    np.testing.assert_allclose(got["conf_matrix"].numpy(), np.asarray(want["conf_matrix"]),
                               atol=1.5e-2, rtol=0)
    agree = np.mean(got["matches0"].numpy() == np.asarray(want["matches0"]))
    assert agree >= 0.95, agree
    assert (got["matches0"] >= 0).sum() > 0


def test_gats_spg_rejects_non_fp32():
    """float32 and bfloat16 are the compute dtypes; float16 raises."""
    for dtype in (torch.float32, torch.bfloat16):
        model = GATsSPG(num_blocks=1, dtype=dtype)
        assert model.final_proj.dtype == dtype and model.self_0.attn.dtype == dtype
    assert not GATsSPG(num_blocks=1, dtype=torch.bfloat16, gats_kernel=True).gats_0.shipped
    with pytest.raises(ValueError, match="bfloat16"):
        GATsSPG(num_blocks=1, dtype=torch.float16)
