"""Parity of the port's VGG stage (K5) with the JAX package's Pallas kernel.

On the CPU `vgg_stage` runs `vgg_stage_plain` (the CUDA kernel runs only on
the card, where chip_smoke.py holds it against the same plain version).
The JAX side runs onepose_tpu/ops/pallas/vgg_stage.py::vgg_stage in
interpret mode, as tests/test_pallas_kernels.py does. Inputs come from a
numpy seed.

Tolerance: both sides round at the same points (bf16 input, bf16 conv1
output, bf16 conv2 output) and only the order of the fp32 sums differs, so
at least 99% of the elements are bit-identical; the rest lie within 2^-6
of the largest output. Where a conv1 sum lands on the other side of a
bf16 rounding boundary, that one-ulp flip moves conv2's sums by a few ulps
of their own (chip_smoke.py holds the CUDA kernel to the same bound).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from onepose_tpu.ops.pallas.vgg_stage import vgg_stage as jax_vgg_stage
from onepose_tpu_torch.ops.kernels import launch_counts, reset_launches, vgg_stage

torch.set_num_threads(2)


def _stage_inputs(seed, b, h, w, cin, c1, c2):
    rng = np.random.default_rng(seed)
    if cin == 1:
        x = rng.random((b, h, w, 1)).astype(np.float32)
    else:  # a ReLU'd bf16 activation, as a stage after the first sees
        x = np.maximum(rng.normal(size=(b, h, w, cin)), 0).astype(np.float32)
        x = torch.from_numpy(x).bfloat16().float().numpy()
    w1 = (rng.normal(size=(3, 3, cin, c1)) * (2.0 / (9 * cin)) ** 0.5).astype(np.float32)
    w2 = (rng.normal(size=(3, 3, c1, c2)) * (2.0 / (9 * c1)) ** 0.5).astype(np.float32)
    b1 = (rng.normal(size=(c1,)) * 0.1).astype(np.float32)
    b2 = (rng.normal(size=(c2,)) * 0.1).astype(np.float32)
    return x, w1, b1, w2, b2


@pytest.mark.parametrize(
    "shape,pool",
    [
        ((2, 32, 48, 1, 64, 64), True),  # the image stage: fp32 out
        ((2, 16, 24, 64, 64, 128), True),  # a multi-channel stage: bf16 out
        ((1, 16, 24, 128, 128, 128), False),  # the last stage: no pool
    ],
)
def test_plain_matches_pallas(shape, pool):
    x, w1, b1, w2, b2 = _stage_inputs(sum(shape), *shape)
    xj = jnp.asarray(x) if shape[3] == 1 else jnp.asarray(x, jnp.bfloat16)
    want = np.asarray(jax_vgg_stage(xj, *map(jnp.asarray, (w1, b1, w2, b2)), pool)).astype(
        np.float32)
    xt = torch.from_numpy(x) if shape[3] == 1 else torch.from_numpy(x).bfloat16()
    got = vgg_stage.vgg_stage(xt, *map(torch.from_numpy, (w1, b1, w2, b2)), pool)
    b, h, w, cin, c1, c2 = shape
    s = 2 if pool else 1
    assert got.shape == (b, h // s, w // s, c2)
    assert got.dtype == (torch.float32 if cin == 1 else torch.bfloat16)
    got = got.float().numpy()
    assert want.shape == got.shape
    same = np.mean(got == want)
    assert same >= 0.99, same
    assert np.abs(got - want).max() <= np.abs(want).max() / 64
    assert np.count_nonzero(got) > got.size // 10  # ReLU leaves real work


def test_plain_rounds_at_the_kernels_points():
    """The output is bf16-valued even for the fp32 image stage. On an
    all-zero image an interior pixel of conv2 sees relu(b1) on all 9 taps
    (the SAME padding of conv2 is zero only outside the image)."""
    x, w1, b1, w2, b2 = _stage_inputs(3, 1, 16, 16, 1, 64, 64)
    out = vgg_stage.vgg_stage_plain(*map(torch.from_numpy, (x, w1, b1, w2, b2)), True)
    assert torch.equal(out, out.bfloat16().float())
    zero = vgg_stage.vgg_stage_plain(torch.zeros(1, 8, 8, 1), *map(torch.from_numpy,
                                                                   (w1, b1, w2, b2)), False)
    c = torch.from_numpy(w2).bfloat16().float()
    r1 = torch.relu(torch.from_numpy(b1)).bfloat16().float()
    inner = torch.relu(torch.einsum("hwio,i->o", c, r1) + torch.from_numpy(b2))
    torch.testing.assert_close(zero[0, 4, 4], inner.bfloat16().float(), atol=1e-2, rtol=1e-2)


def test_pack_conv_weight_layout():
    w = torch.arange(3 * 3 * 4 * 5, dtype=torch.float32).reshape(3, 3, 4, 5)
    p = vgg_stage.pack_conv_weight(w)
    assert p.shape == (9, 5, 4) and p.dtype == torch.bfloat16
    assert float(p[3 * 1 + 2, 4, 1]) == float(w[1, 2, 1, 4].bfloat16())


def test_non_cpu_tensor_never_falls_back():
    reset_launches()
    x = torch.empty((1, 8, 8, 64), device="meta", dtype=torch.bfloat16)
    w = torch.empty((3, 3, 64, 64), device="meta")
    b = torch.empty((64,), device="meta")
    with pytest.raises(ValueError, match="CUDA"):
        vgg_stage.vgg_stage(x, w, b, w, b, True)
    assert launch_counts()["vgg_stage"] == 0
