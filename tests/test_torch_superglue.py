"""Parity of the port's SuperGlue matcher, softmax attention and NN matcher
with the JAX package on the CPU.

Shapes: 2-3 (self, cross) layers, 48 and 64 keypoints with padded masks,
d_model 256, 4 heads, 100 Sinkhorn iterations. Parameters come from flax
init (batch-norm affines and the dustbin score perturbed, so that they
matter) through onepose_tpu_torch.models.bridge. Tolerances: 1e-5 on the
attention outputs (fp32 sums in another order), 1e-4 on the log-assignment
on the slots that carry mass, matches identical. With random weights no
pair clears the shipped threshold of 0.2, so the model tests use 0.0:
every mutual maximum is a match.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from onepose_tpu.models.common import AttentionalPropagation as JaxAttnProp
from onepose_tpu.models.common import masked_softmax_attention as jax_softmax_attention
from onepose_tpu.models.nn_matcher import NNMatcher2D3D as JaxNNMatcher
from onepose_tpu.models.nn_matcher import mutual_nn_match as jax_mutual_nn_match
from onepose_tpu.models.superglue import SuperGlue as JaxSuperGlue
from onepose_tpu.models.superglue import extract_matches as jax_extract_matches
from onepose_tpu.models.superglue import normalize_keypoints as jax_normalize_keypoints
from onepose_tpu_torch.models import bridge
from onepose_tpu_torch.models.common import AttentionalPropagation, masked_softmax_attention
from onepose_tpu_torch.models.nn_matcher import NNMatcher2D3D, mutual_nn_match
from onepose_tpu_torch.models.superglue import SuperGlue, extract_matches, normalize_keypoints

torch.set_num_threads(2)

B, N0, N1, C = 2, 48, 64, 256
HW = (96, 128)


def _t(*xs):
    return [torch.from_numpy(np.asarray(x)) for x in xs]


def _j(*xs):
    return [jnp.asarray(x) for x in xs]


def _unit(x):
    return (x / np.linalg.norm(x, axis=-1, keepdims=True)).astype(np.float32)


def _qkv(seed, n=N0, m=N1, h=4, d=64):
    rng = np.random.default_rng(seed)
    q, k, v = (rng.normal(size=(B, s, h, d)).astype(np.float32) for s in (n, m, m))
    mask = rng.random((B, m)) < 0.8
    mask[1] = False  # a fully masked key set
    return q, k, v, mask


def test_masked_softmax_attention_matches_jax():
    q, k, v, mask = _qkv(0)
    want = jax_softmax_attention(*_j(q, k, v, mask))
    got = masked_softmax_attention(*_t(q, k, v, mask))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5, rtol=0)


def test_masked_softmax_attention_bf16_matches_jax():
    """compute_dtype bf16: q, k, v rounded to bf16, sums in fp32. The port
    also rounds the probabilities, as JAX does on an accelerator; JAX on
    the CPU keeps them fp32. A bf16 probability is within 2^-9 relative,
    so the output moves by at most 2^-9 of sum |v| weighted: within 1e-2
    here (|v| about 1), and the rest matches the fp32 path's bf16 rounding."""
    q, k, v, mask = _qkv(1)
    want = np.asarray(jax_softmax_attention(*_j(q, k, v, mask), compute_dtype=jnp.bfloat16))
    got = masked_softmax_attention(*_t(q, k, v, mask), compute_dtype=torch.bfloat16).numpy()
    np.testing.assert_allclose(got, want, atol=1e-2, rtol=0)
    assert np.abs(got - want).max() > 0  # the rounding points differ as stated


def test_flash_route_matches_plain_and_zeroes_masked_rows():
    """use_flash=True (scaled_dot_product_attention, opt-in) against the
    plain path; rows whose keys are all masked are zeroed, where the plain
    path averages v."""
    q, k, v, mask = _qkv(2)
    qt, kt, vt, mt = _t(q, k, v, mask)
    plain = masked_softmax_attention(qt, kt, vt, mt)
    flash = masked_softmax_attention(qt, kt, vt, mt, use_flash=True)
    np.testing.assert_allclose(flash[0].numpy(), plain[0].numpy(), atol=1e-5, rtol=0)
    assert bool((flash[1] == 0).all())
    assert not bool((plain[1] == 0).all())


@pytest.mark.parametrize("cross", [False, True])
def test_attentional_propagation_softmax_batch_matches_jax(cross):
    rng = np.random.default_rng(3)
    x = rng.normal(size=(B, N0, C)).astype(np.float32)
    src = rng.normal(size=(B, N1 if cross else N0, C)).astype(np.float32)
    src_mask = rng.random(src.shape[:2]) < 0.8
    x_mask = rng.random((B, N0)) < 0.8
    jax_layer = JaxAttnProp(C, 4, kind="softmax", norm="batch")
    params = jax_layer.init(jax.random.PRNGKey(0), *_j(x, src, src_mask, x_mask))
    params = jax.tree.map(np.asarray, params)
    mlp = params["params"]["mlp"]
    mlp["bn_scale_0"] = (1.0 + 0.3 * rng.normal(size=mlp["bn_scale_0"].shape)).astype(np.float32)
    mlp["bn_bias_0"] = (0.1 * rng.normal(size=mlp["bn_bias_0"].shape)).astype(np.float32)
    want = jax_layer.apply(params, *_j(x, src, src_mask, x_mask))
    layer = AttentionalPropagation(C, 4, kind="softmax", norm="batch")
    layer.load_state_dict(bridge.jax_to_state_dict(params))
    with torch.no_grad():
        got = layer(*_t(x, src, src_mask, x_mask))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5, rtol=0)


def test_normalize_keypoints_matches_jax():
    rng = np.random.default_rng(4)
    kpts = rng.uniform(0, 128, size=(B, N0, 2)).astype(np.float32)
    hw = np.array([[96, 128], [480, 640]], np.float32)
    np.testing.assert_allclose(normalize_keypoints(*_t(kpts), HW).numpy(),
                               np.asarray(jax_normalize_keypoints(jnp.asarray(kpts), HW)),
                               atol=1e-7, rtol=0)
    np.testing.assert_allclose(normalize_keypoints(*_t(kpts, hw)).numpy(),
                               np.asarray(jax_normalize_keypoints(*_j(kpts, hw))),
                               atol=1e-7, rtol=0)


def _sg_inputs(seed=5):
    rng = np.random.default_rng(seed)
    d0 = _unit(rng.normal(size=(B, N0, C)))
    d1 = _unit(rng.normal(size=(B, N1, C)))
    d1[:, :N0] = _unit(d0[:, rng.permutation(N0)] + 0.2 * d1[:, :N0])  # planted pairs
    k0 = rng.uniform(0, 96, size=(B, N0, 2)).astype(np.float32)
    k1 = rng.uniform(0, 96, size=(B, N1, 2)).astype(np.float32)
    s0, s1 = (rng.random((B, n)).astype(np.float32) for n in (N0, N1))
    m0, m1 = np.ones((B, N0), bool), np.ones((B, N1), bool)
    m0[0, -8:] = False  # padded keypoint slots
    m1[1, -12:] = False
    return k0, k1, d0, d1, s0, s1, m0, m1


def _sg_params(num_layers, seed=6):
    k0, k1, d0, d1, s0, s1, m0, m1 = _sg_inputs()
    params = JaxSuperGlue(num_layers=num_layers).init(
        jax.random.PRNGKey(seed), *_j(k0, k1, d0, d1, s0, s1), HW, HW, *_j(m0, m1))
    params = jax.tree.map(np.asarray, params)
    rng = np.random.default_rng(seed)
    kenc = params["params"]["kenc"]
    for name in list(kenc):
        if name.startswith("bn_scale"):
            kenc[name] = (1.0 + 0.3 * rng.normal(size=kenc[name].shape)).astype(np.float32)
        elif name.startswith("bn_bias"):
            kenc[name] = (0.1 * rng.normal(size=kenc[name].shape)).astype(np.float32)
    params["params"]["bin_score"] = np.asarray(0.8, np.float32)
    return params


def _run_both(num_layers, dtype=torch.float32, jdtype=jnp.float32, **kw):
    args = _sg_inputs()
    k0, k1, d0, d1, s0, s1, m0, m1 = args
    params = _sg_params(num_layers)
    want = JaxSuperGlue(num_layers=num_layers, match_threshold=0.0, dtype=jdtype).apply(
        params, *_j(k0, k1, d0, d1, s0, s1), HW, HW, *_j(m0, m1))
    model = SuperGlue(num_layers=num_layers, match_threshold=0.0, dtype=dtype, **kw)
    model.load_state_dict(bridge.superglue_state_dict(params))
    with torch.no_grad():
        got = model(*_t(k0, k1, d0, d1, s0, s1), HW, HW, *_t(m0, m1))
    valid = np.concatenate([m0, np.ones((B, 1), bool)], 1)[:, :, None] & np.concatenate(
        [m1, np.ones((B, 1), bool)], 1)[:, None, :]
    return got, want, valid


@pytest.mark.parametrize("num_layers,sinkhorn_kernel", [(2, None), (3, None), (2, False)])
def test_superglue_matches_jax(num_layers, sinkhorn_kernel):
    got, want, valid = _run_both(num_layers, sinkhorn_kernel=sinkhorn_kernel)
    z, jz = got["log_assignment"].numpy(), np.asarray(want["log_assignment"])
    np.testing.assert_allclose(np.where(valid, z, 0.0), np.where(valid, jz, 0.0), atol=1e-4,
                               rtol=0)
    for k in ("matches0", "matches1"):
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]), err_msg=k)
    assert int((got["matches0"] >= 0).sum()) > 0


def test_superglue_bf16_matches_jax():
    """bf16 layers (Dense rounding as the JAX package's). The port runs
    Sinkhorn in fp32 on the bf16 scores, where JAX's bf16 model runs its
    scan in bf16 (a bf16 log-assignment between -8 and -4 has an ulp of
    1/32), so the log-assignment is held to 0.15 absolute on valid slots.
    JAX's bf16 rows hold exact ties and one-ulp leads: matches0 may differ
    only on rows whose JAX best leads its runner-up by at most two ulps
    (1/16), and agree on at least 85% of the slots (JAX's own bf16 and fp32
    models agree on 87.5% here)."""
    got, want, valid = _run_both(2, dtype=torch.bfloat16, jdtype=jnp.bfloat16)
    z = got["log_assignment"].float().numpy()
    jz = np.asarray(want["log_assignment"], np.float32)
    np.testing.assert_allclose(np.where(valid, z, 0.0), np.where(valid, jz, 0.0), atol=0.15,
                               rtol=0)
    top2 = np.sort(jz[:, :-1, :-1], axis=2)[..., -2:]
    lead = top2[..., 1] - top2[..., 0]
    same = got["matches0"].numpy() == np.asarray(want["matches0"])
    assert (same | (lead <= 1 / 16)).all(), lead[~same]
    assert same.mean() >= 0.85, same.mean()


def test_extract_matches_ties_take_the_first_index():
    z = np.full((1, 5, 6), -3.0, np.float32)
    z[0, 0, [1, 3]] = -0.5  # row 0 ties between columns 1 and 3
    z[0, [2, 4], 2] = -0.7  # column 2 ties between rows 2 and 4
    z[0, 1] = -1e9  # a masked row: all NEG_INF, ties everywhere
    jm = jax_extract_matches(jnp.asarray(z), 0.0)
    tm = extract_matches(torch.from_numpy(z), 0.0)
    for k in ("matches0", "matches1", "valid0", "valid1"):
        np.testing.assert_array_equal(tm[k].numpy(), np.asarray(jm[k]), err_msg=k)
    np.testing.assert_allclose(tm["matching_scores0"].numpy(),
                               np.asarray(jm["matching_scores0"]), rtol=1e-6)
    assert tm["matches0"][0, 0] == 1 and tm["matches1"][0, 2] == 2


@pytest.mark.parametrize("ratio,dist", [(None, None), (0.9, None), (None, 0.7), (0.95, 0.8)])
def test_mutual_nn_match_matches_jax(ratio, dist):
    rng = np.random.default_rng(7)
    d0 = _unit(rng.normal(size=(B, N0, 32)))
    d1 = _unit(rng.normal(size=(B, N1, 32)))
    d1[:, :N0] = _unit(d0 + 0.4 * d1[:, :N0])
    m0, m1 = rng.random((B, N0)) < 0.85, rng.random((B, N1)) < 0.85
    want = jax_mutual_nn_match(*_j(d0, d1, m0, m1), ratio_thresh=ratio, distance_thresh=dist)
    got = mutual_nn_match(*_t(d0, d1, m0, m1), ratio_thresh=ratio, distance_thresh=dist)
    np.testing.assert_array_equal(got["matches0"].numpy(), np.asarray(want["matches0"]))
    np.testing.assert_allclose(got["similarity0"].numpy(), np.asarray(want["similarity0"]),
                               atol=1e-6, rtol=0)
    assert int((got["matches0"] >= 0).sum()) > 0


def test_nn_matcher_2d3d_matches_jax():
    rng = np.random.default_rng(8)
    d2 = rng.normal(size=(B, N0, C)).astype(np.float32)
    d3 = rng.normal(size=(B, N1, C)).astype(np.float32)
    d3[:, :N0] = d2 * 3.0 + 0.5 * d3[:, :N0]  # unnormalised: the matcher normalises
    m2, m3 = rng.random((B, N0)) < 0.9, rng.random((B, N1)) < 0.9
    want = JaxNNMatcher(distance_thresh=0.7).apply({}, *_j(d2, d3), None, *_j(m2, m3))
    got = NNMatcher2D3D(distance_thresh=0.7)(*_t(d2, d3), None, *_t(m2, m3))
    np.testing.assert_array_equal(got["matches0"].numpy(), np.asarray(want["matches0"]))
    np.testing.assert_allclose(got["matching_scores0"].numpy(),
                               np.asarray(want["matching_scores0"]), atol=1e-6, rtol=0)
    assert got["conf_matrix"] is None and int((got["matches0"] >= 0).sum()) > 0


def test_bridge_rejects_foreign_names():
    params = _sg_params(1)
    sd = bridge.superglue_state_dict(params)
    assert sd["bin_score"].shape == () and "kenc.bn_scale_0" in sd
    SuperGlue(num_layers=1).load_state_dict(sd)
    params["params"]["gats_0"] = {"W": np.zeros((4, 4), np.float32)}
    with pytest.raises(ValueError, match="not SuperGlue parameters"):
        bridge.superglue_state_dict(params)
