"""The port's pyramidal LK (`ops/optical_flow.py`) against the JAX package's,
on the CPU.

Each case feeds the same float32 images and points to both. `status` must
be equal; `new_pts` must agree within 2e-3 px where `status` is True (the
fixed-iteration LK freezes a point once a step is below eps 0.03 px, and
which iteration that happens on turns on fp32 sums of 225-sample windows,
so a point may take one step more in one package).
- a textured pair (a smooth random field shifted by a sub-pixel amount);
- a blank image: every window's G is zero, status False, no motion;
- straight edges, vertical and horizontal: G singular in exact
  arithmetic, status False, no exception, the same finite pattern as JAX;
- an exact diagonal edge: G is singular in fp32 too (ix == iy bit for
  bit). The closed-form inverse gives inf / NaN there; JAX's LU gives
  finite values on some points, decided by how it rounds. So status
  (False but where the image border breaks the edge's symmetry) and the
  points whose windows never see the edge are compared;
- points near and outside the border (the bilinear sample extrapolates).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.ndimage import gaussian_filter, shift

from onepose_tpu.ops.optical_flow import pyramidal_lk as jax_lk
from onepose_tpu_torch.ops.optical_flow import _bilinear, _downsample2, pyramidal_lk

torch.set_num_threads(2)

H, W = 96, 128
PX = 2e-3


def _both(img0, img1, pts):
    jp, js = jax_lk(jnp.asarray(img0), jnp.asarray(img1), jnp.asarray(pts))
    tp, ts = pyramidal_lk(torch.from_numpy(img0), torch.from_numpy(img1), torch.from_numpy(pts))
    return np.asarray(jp), np.asarray(js), tp.numpy(), ts.numpy()


def _points(rng, n=60, margin=5):
    return rng.uniform(margin, [W - margin, H - margin], (n, 2)).astype(np.float32)


def _textured(rng):
    img0 = gaussian_filter(rng.random((H, W)), 2).astype(np.float32)
    img0 = (img0 - img0.min()) / (img0.max() - img0.min())
    return img0, shift(img0, (1.3, -2.1), order=3, mode="nearest").astype(np.float32)


def test_textured_pair_matches_jax():
    rng = np.random.default_rng(0)
    img0, img1 = _textured(rng)
    pts = _points(rng)
    jp, js, tp, ts = _both(img0, img1, pts)
    np.testing.assert_array_equal(ts, js)
    assert js.sum() >= 40
    np.testing.assert_allclose(tp[js], jp[js], atol=PX)
    # The flow found the shift (dx, dy) = (-2.1, 1.3).
    np.testing.assert_allclose(np.median(tp[ts] - pts[ts], axis=0), [-2.1, 1.3], atol=0.05)


def test_border_points_match_jax():
    rng = np.random.default_rng(1)
    img0, img1 = _textured(rng)
    pts = np.array([[0.5, 1.0], [W - 1.5, 50.0], [60.0, H - 1.2], [-2.0, 10.0], [3.0, 3.0],
                    [W + 4.0, H / 2], [W - 3.0, H - 3.0]], np.float32)
    jp, js, tp, ts = _both(img0, img1, pts)
    np.testing.assert_array_equal(ts, js)
    np.testing.assert_allclose(tp[js], jp[js], atol=PX)
    np.testing.assert_array_equal(np.isfinite(tp), np.isfinite(jp))


def test_blank_image_matches_jax():
    rng = np.random.default_rng(2)
    blank = np.zeros((H, W), np.float32)
    pts = _points(rng)
    jp, js, tp, ts = _both(blank, blank, pts)
    assert not js.any() and not ts.any()
    np.testing.assert_array_equal(tp, pts)
    np.testing.assert_array_equal(jp, pts)


@pytest.mark.parametrize("axis", ["vertical", "horizontal"])
def test_straight_edge_matches_jax(axis):
    rng = np.random.default_rng(3)
    ys, xs = np.mgrid[0:H, 0:W]
    edge = ((xs > 60) if axis == "vertical" else (ys > 40)).astype(np.float32)
    pts = _points(rng)
    moved = ((xs - 1 > 60) if axis == "vertical" else (ys - 1 > 40)).astype(np.float32)
    jp, js, tp, ts = _both(edge, moved, pts)
    assert not js.any() and not ts.any()
    np.testing.assert_array_equal(np.isfinite(tp), np.isfinite(jp))
    assert np.isfinite(tp).all()


def test_singular_diagonal_edge_raises_nothing():
    rng = np.random.default_rng(4)
    S = 96
    ys, xs = np.mgrid[0:S, 0:S]
    edge = (xs + ys > 130).astype(np.float32)
    moved = (xs - 1 + ys > 130).astype(np.float32)
    pts = rng.uniform(5, S - 5, (200, 2)).astype(np.float32)
    jp, js, tp, ts = _both(edge, moved, pts)
    np.testing.assert_array_equal(ts, js)  # True only where the border breaks the edge
    np.testing.assert_allclose(tp[js], jp[js], atol=PX)
    # Windows that see no edge at any level have G = 0: no motion. A window
    # reaches 4 x (7 + 1) px in x and in y at the coarsest level, the two
    # blurs and the gradient 10 px more.
    far = np.abs(pts.sum(1) - 130.5) > 2 * (4 * 8 + 10)
    assert far.sum() >= 10
    np.testing.assert_array_equal(tp[far], pts[far])
    np.testing.assert_array_equal(jp[far], pts[far])


def test_helpers_match_jax():
    """The pyramid step and the bilinear sample, outside the image too."""
    from onepose_tpu.ops import optical_flow as jax_of

    rng = np.random.default_rng(5)
    img = rng.random((37, 50)).astype(np.float32)
    np.testing.assert_allclose(_downsample2(torch.from_numpy(img)).numpy(),
                               np.asarray(jax_of._downsample2(jnp.asarray(img))), atol=1e-6)
    ys = rng.uniform(-3, 40, 200).astype(np.float32)
    xs = rng.uniform(-3, 53, 200).astype(np.float32)
    np.testing.assert_allclose(
        _bilinear(torch.from_numpy(img), torch.from_numpy(ys), torch.from_numpy(xs)).numpy(),
        np.asarray(jax_of._bilinear(jnp.asarray(img), jnp.asarray(ys), jnp.asarray(xs))),
        atol=1e-5)
