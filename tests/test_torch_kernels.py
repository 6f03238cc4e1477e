"""Parity of the port's kernel modules with the JAX package's Pallas kernels.

On the CPU each wrapper in onepose_tpu_torch.ops.kernels runs its plain
PyTorch version (the CUDA kernels run only on the card, where
chip_smoke.py holds them against these same plain versions). The JAX side
runs its Pallas kernels in interpret mode, as tests/test_pallas_kernels.py
does, and its XLA references. Inputs are made with numpy from a seed.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from onepose_tpu.models.gats_spg import match_from_conf as jax_match_from_conf
from onepose_tpu.models.superpoint import simple_nms as jax_simple_nms
from onepose_tpu.ops.pallas.dual_softmax import NEG_INF
from onepose_tpu.ops.pallas.dual_softmax import dual_softmax_match as jax_dual_softmax
from onepose_tpu.ops.pallas.gats import gats_leaf_attention as jax_gats
from onepose_tpu.ops.pallas.gats import gats_reference_xla
from onepose_tpu.ops.pallas.score_path import nms as jax_nms
from onepose_tpu_torch.ops.kernels import dual_softmax, gats, launch_counts, score_path

torch.set_num_threads(2)


def _scores_with_plateaus(rng, b, h, w):
    s = rng.random((b, h, w)).astype(np.float32) ** 4
    s[:, 5:8, 5:8] = 0.7  # plateau (ties)
    s[:, 20:23, 30:31] = 0.9  # vertical plateau
    s[:, 0, 0] = 2.0  # corner maximum
    s[:, h - 1, w // 2] = 2.0  # bottom-edge maximum
    s[:, h // 2, w - 1] = 2.0  # right-edge maximum
    s[:, :, 10:12] = 0.0
    return s


class TestNMS:
    # K1: bit-exact, everything is max and compare.
    @pytest.mark.parametrize("b,h,w", [(2, 64, 72), (1, 136, 200)])
    def test_matches_pallas_and_xla(self, b, h, w):
        s = _scores_with_plateaus(np.random.default_rng(h), b, h, w)
        got = score_path.nms(torch.from_numpy(s), 4).numpy()
        np.testing.assert_array_equal(got, np.asarray(jax_nms(jnp.asarray(s), 4)))
        np.testing.assert_array_equal(got, np.asarray(jax_simple_nms(jnp.asarray(s), 4)))

    @pytest.mark.parametrize("radius", [0, 2, 3])
    def test_other_radii_match_xla(self, radius):
        s = _scores_with_plateaus(np.random.default_rng(radius), 1, 48, 40)
        got = score_path.simple_nms(torch.from_numpy(s), radius).numpy()
        np.testing.assert_array_equal(got, np.asarray(jax_simple_nms(jnp.asarray(s), radius)))

    def test_non_cpu_tensor_never_falls_back(self):
        s = torch.empty((1, 8, 8), device="meta")
        with pytest.raises(ValueError, match="CUDA"):
            score_path.nms(s, 4)
        assert launch_counts()["nms"] == 0


def _gats_data(n3, L=8, C=256, b=2, seed=0):
    rng = np.random.default_rng(seed)
    leaf = rng.normal(size=(b, n3, L, C)).astype(np.float32)
    d3 = rng.normal(size=(b, n3, C)).astype(np.float32)
    mask = rng.random((b, n3, L)) < 0.8
    mask[0, 0] = False  # a point whose leaves are all masked
    W = (rng.normal(size=(C, C)) * 0.06).astype(np.float32)
    a2 = (rng.normal(size=(2, C)) * 0.06).astype(np.float32)
    return leaf, d3, mask, W, a2


class TestGATs:
    # K2: 1e-5 absolute. The port reassociates (X @ W) @ a as X @ (W @ a),
    # as the JAX XLA path does; fp32 rounding differs by ~1e-6 here.
    @pytest.mark.parametrize("n3", [37, 300])
    @pytest.mark.parametrize("masked", [True, False])
    def test_matches_pallas_and_xla(self, n3, masked):
        leaf, d3, mask, W, a2 = _gats_data(n3)
        jm = jnp.asarray(mask) if masked else None
        want_k = np.asarray(jax_gats(jnp.asarray(leaf), jnp.asarray(d3), jm,
                                     jnp.asarray(W), jnp.asarray(a2), 0.2))
        want_x = np.asarray(gats_reference_xla(jnp.asarray(leaf), jnp.asarray(d3), jm,
                                               jnp.asarray(W), jnp.asarray(a2), 0.2))
        got = gats.gats_leaf_attention(
            torch.from_numpy(leaf), torch.from_numpy(d3),
            torch.from_numpy(mask) if masked else None,
            torch.from_numpy(W), torch.from_numpy(a2), 0.2,
        ).numpy()
        np.testing.assert_allclose(got, want_k, atol=1e-5, rtol=0)
        np.testing.assert_allclose(got, want_x, atol=1e-5, rtol=0)

    def test_plain_takes_the_kernels_inputs(self):
        """The plain version is a function of (leaves, d3, additive mask,
        wa): what chip_smoke.py feeds the kernel on the card."""
        leaf, d3, mask, W, a2 = _gats_data(20, L=5, C=64, b=1, seed=3)
        t = torch.from_numpy
        wa = gats.leaf_logit_vectors(t(W), t(a2))
        np.testing.assert_allclose(wa.numpy(), np.stack([W @ a2[0], W @ a2[1]]), atol=1e-6)
        add = gats.additive_mask(t(mask))
        assert add.dtype == torch.float32
        np.testing.assert_array_equal(add.numpy(), np.where(mask, 0.0, gats.NEG_INF))
        got = gats.gats_leaf_attention_plain(t(leaf), t(d3), add, wa, 0.2).numpy()
        want = np.asarray(gats_reference_xla(jnp.asarray(leaf), jnp.asarray(d3),
                                             jnp.asarray(mask), jnp.asarray(W),
                                             jnp.asarray(a2), 0.2))
        np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)


def _dual_softmax_data(b, m, n, seed):
    rng = np.random.default_rng(seed)
    base = rng.normal(size=(b, n, 32))
    s2 = base[:, rng.permutation(n)[:m]] + 0.1 * rng.normal(size=(b, m, 32))
    scores = np.einsum("bmc,bnc->bmn", s2, base) * 0.5
    mask2d = rng.random((b, m)) < 0.85
    mask3d = rng.random((b, n)) < 0.85
    mask2d[0, -3:] = False  # masked tail rows
    mask3d[0, :4] = False  # masked leading columns
    scores = np.where(mask2d[:, :, None], scores, NEG_INF)
    scores = np.where(mask3d[:, None, :], scores, NEG_INF)
    return scores.astype(np.float32), mask2d, mask3d


class TestDualSoftmax:
    # K3: matches identical; scores 1e-6 (the softmax sums are taken in
    # another order than in JAX). M, N are not multiples of 8 / 128: the
    # Pallas wrapper pads with NEG_INF, the port does not.
    @pytest.mark.parametrize("b,m,n", [(2, 45, 203), (1, 100, 150)])
    def test_matches_pallas(self, b, m, n):
        scores, _, _ = _dual_softmax_data(b, m, n, seed=m)
        want = jax_dual_softmax(jnp.asarray(scores), 0.2)
        got = dual_softmax.dual_softmax_match(torch.from_numpy(scores), 0.2)
        for k in ("matches0", "matches1", "valid0", "valid1"):
            np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]), err_msg=k)
        for k in ("matching_scores0", "matching_scores1"):
            np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                       rtol=1e-6, atol=1e-7, err_msg=k)
        assert (got["matches0"] >= 0).sum() > 5

    def test_hits_agree_with_xla_head(self):
        """Away from exact ties the kernel's hits are match_from_conf's."""
        scores, mask2d, mask3d = _dual_softmax_data(2, 60, 90, seed=5)
        conf = jax.nn.softmax(jnp.asarray(scores), axis=1) * jax.nn.softmax(
            jnp.asarray(scores), axis=2)
        ref = jax_match_from_conf(conf, 0.2, mask2d=jnp.asarray(mask2d),
                                  mask3d=jnp.asarray(mask3d))
        got = dual_softmax.dual_softmax_match(torch.from_numpy(scores), 0.2)
        np.testing.assert_array_equal(got["matches0"].numpy(), np.asarray(ref["matches0"]))
        np.testing.assert_array_equal(got["matches1"].numpy(), np.asarray(ref["matches1"]))

    def test_exact_tie_takes_largest_index(self):
        """Two identical columns tie exactly: like the Pallas kernel, the
        row's match is the larger column index (match_from_conf would take
        the smaller one)."""
        scores, _, _ = _dual_softmax_data(1, 30, 40, seed=7)
        scores = scores.copy()
        scores[0, :, 25] = scores[0, :, 11]
        scores[0, 3, 11] = scores[0, 3, 25] = 50.0
        want = jax_dual_softmax(jnp.asarray(scores), 0.2)
        got = dual_softmax.dual_softmax_match(torch.from_numpy(scores), 0.2)
        assert int(got["matches0"][0, 3]) == 25 == int(np.asarray(want["matches0"])[0, 3])
        np.testing.assert_array_equal(got["matches1"].numpy(), np.asarray(want["matches1"]))
