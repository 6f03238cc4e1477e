"""Parity of the port's SuperPoint, keypoint extraction and weight bridge
with the JAX package on the CPU.

The same seeded numpy images and flax parameters (through
onepose_tpu_torch.models.bridge) go through the JAX modules and the port's.
Tolerances: score maps and descriptors 1e-5 absolute (fp32 convolutions
sum in another order); keypoint slots and masks identical.
"""

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from onepose_tpu.models.superpoint import SuperPoint as JaxSuperPoint
from onepose_tpu.models.superpoint import extract_keypoints as jax_extract
from onepose_tpu_torch.models import bridge
from onepose_tpu_torch.models.superpoint import SuperPoint, extract_keypoints, topk_lowest_index

torch.set_num_threads(2)


def _superpoint_pair(size, nms_kernel, seed=0):
    rng = np.random.default_rng(seed)
    img = rng.random((2, size, size, 1)).astype(np.float32)
    params = JaxSuperPoint().init(jax.random.PRNGKey(seed), jnp.asarray(img))
    jax_out = JaxSuperPoint(nms_pallas=nms_kernel).apply(params, jnp.asarray(img))
    model = SuperPoint(nms_kernel=nms_kernel)
    model.load_state_dict(bridge.superpoint_state_dict(jax.tree.map(np.asarray, params)))
    with torch.no_grad():
        out = model(torch.from_numpy(img))
    return jax_out, out


@pytest.mark.parametrize("size", [64, 128])
@pytest.mark.parametrize("nms_kernel", [False, True])
def test_dense_forward_matches_jax(size, nms_kernel):
    jax_out, out = _superpoint_pair(size, nms_kernel)
    assert out["score_map"].shape == (2, size, size)
    assert out["descriptor_map"].shape == (2, size // 8, size // 8, 256)
    np.testing.assert_allclose(out["score_map"].numpy(), np.asarray(jax_out["score_map"]),
                               atol=1e-5, rtol=0)
    np.testing.assert_allclose(out["descriptor_map"].numpy(),
                               np.asarray(jax_out["descriptor_map"]), atol=1e-5, rtol=0)


@pytest.mark.parametrize(
    "size,max_keypoints",
    [(64, 64), (128, 200), (72, 40)],  # 72 does not tile 8 x 16 blocks: flat top-k
)
def test_extract_keypoints_matches_jax(size, max_keypoints):
    """Same dense maps into both extractors: identical slots and masks."""
    rng = np.random.default_rng(size)
    img = rng.random((2, size, size, 1)).astype(np.float32)
    params = JaxSuperPoint().init(jax.random.PRNGKey(1), jnp.asarray(img))
    dense = JaxSuperPoint().apply(params, jnp.asarray(img))
    score = np.asarray(dense["score_map"]).copy()
    score[1, 16:24, 16:24] = 0.5  # plateau: equal scores across slots
    desc = np.asarray(dense["descriptor_map"])
    want = jax_extract(jnp.asarray(score), jnp.asarray(desc), max_keypoints=max_keypoints)
    got = extract_keypoints(torch.from_numpy(score), torch.from_numpy(desc),
                            max_keypoints=max_keypoints)
    np.testing.assert_array_equal(got["mask"].numpy(), np.asarray(want["mask"]))
    np.testing.assert_array_equal(got["keypoints"].numpy(), np.asarray(want["keypoints"]))
    np.testing.assert_array_equal(got["scores"].numpy(), np.asarray(want["scores"]))
    np.testing.assert_allclose(got["descriptors"].numpy(), np.asarray(want["descriptors"]),
                               atol=1e-5, rtol=0)
    assert got["mask"].sum() > 0


def test_topk_tie_order_is_jax_order():
    """jax.lax.top_k puts the lowest index first on ties; so must the port."""
    x = np.array([1, 3, 3, 1, 3, 0, 3], np.float32)
    _, idx = topk_lowest_index(torch.from_numpy(x), 3)
    np.testing.assert_array_equal(idx.numpy(), [1, 2, 4])
    rng = np.random.default_rng(0)
    ties = rng.integers(0, 5, size=(4, 300)).astype(np.float32)
    want_v, want_i = jax.lax.top_k(jnp.asarray(ties), 50)
    got_v, got_i = topk_lowest_index(torch.from_numpy(ties), 50)
    np.testing.assert_array_equal(got_i.numpy(), np.asarray(want_i))
    np.testing.assert_array_equal(got_v.numpy(), np.asarray(want_v))


def test_bridge_conv_and_dense_weights():
    """A flax Conv (HWIO) and Dense ([in, out]) through the bridge equal
    torch's conv2d (OIHW) and linear ([out, in]) on the same input."""
    rng = np.random.default_rng(2)
    x = rng.normal(size=(2, 12, 10, 5)).astype(np.float32)

    class Net(fnn.Module):
        @fnn.compact
        def __call__(self, x):
            y = fnn.Conv(7, (3, 3), padding="SAME", name="conv")(x)
            return y, fnn.Dense(4, name="dense")(y)

    params = Net().init(jax.random.PRNGKey(0), jnp.asarray(x))
    want_conv, want_dense = Net().apply(params, jnp.asarray(x))
    sd = bridge.jax_to_state_dict(jax.tree.map(np.asarray, params))
    assert sd["conv.weight"].shape == (7, 5, 3, 3)
    assert sd["dense.weight"].shape == (4, 7)
    y = F.conv2d(torch.from_numpy(x).permute(0, 3, 1, 2), sd["conv.weight"], sd["conv.bias"],
                 padding=1).permute(0, 2, 3, 1)
    np.testing.assert_allclose(y.numpy(), np.asarray(want_conv), atol=1e-5, rtol=0)
    z = F.linear(y, sd["dense.weight"], sd["dense.bias"])
    np.testing.assert_allclose(z.numpy(), np.asarray(want_dense), atol=1e-5, rtol=0)


@pytest.mark.parametrize(
    "kwargs", [{}, {"dtype": torch.bfloat16}, {"dtype": torch.bfloat16, "vgg_kernel": True}])
def test_superpoint_state_dict_loads_strictly(kwargs):
    """The same state_dict loads with and without the kernel flag, in every
    dtype (parameters stay fp32)."""
    params = JaxSuperPoint().init(jax.random.PRNGKey(0), jnp.zeros((1, 16, 16, 1)))
    sd = bridge.superpoint_state_dict(jax.tree.map(np.asarray, params))
    model = SuperPoint(**kwargs)
    missing, unexpected = model.load_state_dict(sd, strict=True)
    assert not missing and not unexpected
    assert all(p.dtype == torch.float32 for p in model.parameters())


@pytest.mark.parametrize("vgg_kernel", [False, True])
def test_bf16_dense_forward_matches_jax(vgg_kernel):
    """bf16 SuperPoint against JAX SuperPoint(dtype=bf16, use_pallas=...).

    Dense maps: the raw score map (nms_radius=0 keeps every pixel) and the
    descriptors within 1e-2 absolute (bf16 keeps 8 significant bits; the
    sums run in another order). Keypoint slots after NMS and top-k: at
    least 80% agree. With random weights the score map is nearly flat
    (every score within 0.02 of 1/65), so NMS and top-k turn 1-ulp bf16
    differences into other picks: JAX's own two bf16 paths (XLA and
    Pallas) do not agree on every slot either."""
    rng = np.random.default_rng(4)
    img = rng.random((2, 64, 64, 1)).astype(np.float32)
    params = JaxSuperPoint().init(jax.random.PRNGKey(4), jnp.asarray(img))
    sd = bridge.superpoint_state_dict(jax.tree.map(np.asarray, params))
    out = {}
    for radius in (0, 4):
        jax_sp = JaxSuperPoint(dtype=jnp.bfloat16, use_pallas=vgg_kernel, nms_radius=radius)
        model = SuperPoint(dtype=torch.bfloat16, vgg_kernel=vgg_kernel, nms_radius=radius,
                           nms_kernel=radius > 0)
        model.load_state_dict(sd)
        with torch.no_grad():
            out[radius] = jax_sp.apply(params, jnp.asarray(img)), model(torch.from_numpy(img))
    want, got = out[0]
    np.testing.assert_allclose(got["score_map"].numpy(), np.asarray(want["score_map"]),
                               atol=1e-4, rtol=1e-2)
    np.testing.assert_allclose(got["descriptor_map"].numpy(), np.asarray(want["descriptor_map"]),
                               atol=1e-2, rtol=0)
    want, got = out[4]
    kw = jax_extract(want["score_map"], want["descriptor_map"], max_keypoints=64)
    kg = extract_keypoints(got["score_map"], got["descriptor_map"], max_keypoints=64)
    same = np.all(kg["keypoints"].numpy() == np.asarray(kw["keypoints"]), axis=-1)
    assert same.mean() >= 0.8, same.mean()
    assert kg["mask"].sum() > 0


def test_superpoint_rejects_non_fp32():
    """float32 and bfloat16 are the compute dtypes; float16 raises."""
    assert SuperPoint(dtype=torch.bfloat16).dtype == torch.bfloat16
    with pytest.raises(ValueError, match="bfloat16"):
        SuperPoint(dtype=torch.float16)
