"""The slice as a whole: the port's batched pair matchers for `map` against
the JAX package's, on the CPU, in the setup of tests/test_sfm_parallel.py
(mesh=None, an odd pair count so that the last chunk is padded,
pair_chunk 4, the same features and weights): identical [P, N] matches.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from onepose_tpu.models import SuperGlue as JaxSuperGlue
from onepose_tpu.parallel import sfm_parallel as jax_sfm
from onepose_tpu_torch.models import bridge
from onepose_tpu_torch.models.superglue import SuperGlue
from onepose_tpu_torch.ops.kernels import launch_counts, reset_launches
from onepose_tpu_torch.parallel import sfm_parallel

torch.set_num_threads(2)


def _random_feats(rng, F=10, N=48, C=32, hw=(96, 96)):
    desc = rng.normal(size=(F, N, C)).astype(np.float32)
    desc /= np.linalg.norm(desc, axis=-1, keepdims=True)
    n_valid = rng.integers(N // 2, N + 1, size=F)
    return {
        "keypoints": rng.uniform(0, hw[0], size=(F, N, 2)).astype(np.float32),
        "descriptors": desc,
        "scores": rng.random((F, N)).astype(np.float32),
        "mask": np.arange(N)[None] < n_valid[:, None],
        "image_hw": hw,
    }


def _random_pairs(rng, F, P):
    pairs = []
    while len(pairs) < P:
        i, j = rng.integers(0, F, size=2)
        if i != j:
            pairs.append((i, j))
    return np.asarray(pairs)


def test_nn_pair_matcher_matches_jax():
    rng = np.random.default_rng(0)
    feats = _random_feats(rng)
    pairs = _random_pairs(rng, 10, 11)  # odd count: the last chunk is padded
    want = jax_sfm.make_nn_pair_matcher(feats["descriptors"], feats["mask"],
                                        distance_thresh=0.7, pair_chunk=4)(pairs)
    match = sfm_parallel.make_nn_pair_matcher(feats["descriptors"], feats["mask"],
                                              distance_thresh=0.7, pair_chunk=4, device="cpu")
    got = match(pairs)
    assert got.dtype == np.int64 and got.shape == (11, 48)
    np.testing.assert_array_equal(got, want)
    assert match([]).shape == (0, 48)


def _superglue(feats, num_layers=2, iters=10):
    # Threshold 0: with random weights no pair clears 0.2, and the
    # comparison should see real matches.
    sg = JaxSuperGlue(num_layers=num_layers, sinkhorn_iterations=iters, match_threshold=0.0)
    n = feats["keypoints"].shape[1]
    params = sg.init(jax.random.PRNGKey(0), jnp.zeros((1, n, 2)), jnp.zeros((1, n, 2)),
                     jnp.zeros((1, n, 256)), jnp.zeros((1, n, 256)), jnp.zeros((1, n)),
                     jnp.zeros((1, n)), feats["image_hw"], feats["image_hw"])
    model = SuperGlue(num_layers=num_layers, sinkhorn_iterations=iters, match_threshold=0.0)
    model.load_state_dict(bridge.superglue_state_dict(jax.tree.map(np.asarray, params)))
    return sg, params, model


@pytest.mark.parametrize("guard_bytes,want_chunk", [(None, 4), (3 * 4 * 33 * 33 * 3, 3)])
def test_superglue_pair_matcher_matches_jax(monkeypatch, guard_bytes, want_chunk):
    """pair_chunk 4; with the HBM guard patched to three pairs' couplings,
    the guard sets the chunk instead. The JAX matcher runs unpatched:
    chunking does not change what a pair's matches are."""
    rng = np.random.default_rng(1)
    feats = _random_feats(rng, F=6, N=32, C=256)
    feats["descriptors"][3, :16] = feats["descriptors"][1, 8:24]  # planted pairs
    pairs = _random_pairs(rng, 6, 5)
    sg, params, model = _superglue(feats)
    want = jax_sfm.make_superglue_pair_matcher(sg, params, feats, pair_chunk=4)(pairs)
    if guard_bytes is not None:
        monkeypatch.setattr(sfm_parallel, "HBM_GUARD_BYTES", guard_bytes)
    match = sfm_parallel.make_superglue_pair_matcher(model, feats, pair_chunk=4, device="cpu")
    assert match.chunk == want_chunk
    reset_launches()
    got = match(pairs)
    assert got.dtype == np.int64 and got.shape == (5, 32)
    np.testing.assert_array_equal(got, want)
    assert (got >= 0).sum() > 0
    assert set(launch_counts().values()) == {0}  # CPU tensors: plain versions only


def test_superglue_chunk_guard():
    assert sfm_parallel.superglue_chunk(1024, 16) == 16  # map's default
    assert sfm_parallel.superglue_chunk(4096, 16) == 7  # the SfM budget
    assert sfm_parallel.superglue_chunk(100000, 16) == 1


def test_mesh_and_missing_cuda_raise():
    rng = np.random.default_rng(2)
    feats = _random_feats(rng, F=3, N=8, C=256)
    with pytest.raises(NotImplementedError, match="mesh"):
        sfm_parallel.make_nn_pair_matcher(feats["descriptors"], feats["mask"], mesh=object(),
                                          device="cpu")
    if torch.cuda.is_available():
        pytest.skip("this machine has CUDA: the no-CUDA error cannot be shown here")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        sfm_parallel.make_superglue_pair_matcher(SuperGlue(num_layers=1), feats)
