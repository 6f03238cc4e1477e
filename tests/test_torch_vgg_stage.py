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
from onepose_tpu_torch.ops.kernels import _layout, launch_counts, reset_launches, vgg_stage

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


# --- The CUDA kernel's schedule, replayed in torch (csrc/vgg_stage.cu) ---

def _emulate_kernel(x, w1, b1, w2, b2, pool):
    """The kernel's tile walk in torch: tiles of tile_rows() x 32 outputs,
    the input tile with its 2-pixel halo, conv1 over the (TH + 2) x 34
    region in tasks of 64 pixels (padded rows repeat the last pixel),
    conv2 in tasks of 2 rows x 32 columns whose ldmatrix rows map as the
    kernel's lanes do, 9 taps x 64-channel chunks read from the swizzled
    weight layout, pool partners paired as in the register pool. Returns
    the stage output and how many times each output element was written."""
    b, h, w, cin = x.shape
    c1, c2 = w1.shape[-1], w2.shape[-1]
    th, tw = vgg_stage.tile_rows(cin, c1, c2), vgg_stage.TILE_W
    w1p, b1f, w2p, b2f = vgg_stage.pack_stage_weights(w1, b1, w2, b2)
    s = 2 if pool else 1
    out = torch.zeros((b, h // s, w // s, c2))
    hits = torch.zeros((b, h // s, w // s, c2), dtype=torch.int32)
    taps = [(dy, dx) for dy in range(3) for dx in range(3)]

    def chunks(wp, k):  # [9, K/64, N, 64] swizzled -> per tap [N, K] fp32
        return _layout.unswizzle128(wp, wp.shape[1] * 64).float()[..., :k]

    xr = x.float().bfloat16().float()
    for bi in range(b):
        for y0 in range(0, h, th):
            for x0 in range(0, w, tw):
                tin = torch.zeros((th + 4, tw + 4, cin))
                ys, xs = slice(max(y0 - 2, 0), min(y0 + th + 2, h)), slice(max(x0 - 2, 0),
                                                                          min(x0 + tw + 2, w))
                tin[ys.start - y0 + 2:ys.stop - y0 + 2, xs.start - x0 + 2:xs.stop - x0 + 2] = \
                    xr[bi, ys, xs]
                q1 = (th + 2) * (tw + 2)
                rr, cc = torch.arange(q1) // (tw + 2), torch.arange(q1) % (tw + 2)
                inside = ((y0 - 1 + rr >= 0) & (y0 - 1 + rr < h) & (x0 - 1 + cc >= 0)
                          & (x0 - 1 + cc < w))
                if cin == 1:  # scalar fp32, the Pallas kernel's order
                    wr = w1p.float()  # [9, C1]
                    acc = None
                    for dx in range(3):
                        part = (tin[rr, cc + dx, 0, None] * wr[dx]
                                + tin[rr + 1, cc + dx, 0, None] * wr[3 + dx]
                                + tin[rr + 2, cc + dx, 0, None] * wr[6 + dx])
                        acc = part if acc is None else acc + part
                else:
                    wt = chunks(w1p, cin)  # [9, C1, Cin]
                    n_task = -(-q1 // 64)
                    q = torch.clamp(torch.arange(n_task * 64), max=q1 - 1)
                    acc = torch.zeros((n_task * 64, c1))
                    for t, (dy, dx) in enumerate(taps):
                        a = tin[q // (tw + 2) + dy, q % (tw + 2) + dx]  # [64 n_task, Cin]
                        acc += a @ wt[t].T
                    acc = acc[:q1]
                t1 = torch.where(inside[:, None], torch.relu(acc + b1f), 0.0).bfloat16().float()
                t1 = t1.reshape(th + 2, tw + 2, c1)
                # conv2: pixel block pb, warp wl, ldmatrix row lrow -> (2 pb + lrow // 8, 8 wl + lrow % 8)
                wt = chunks(w2p, c1)
                for pb in range(th // 2):
                    lrow = torch.arange(64) % 16
                    wl = torch.arange(64) // 16
                    r2, c2_ = 2 * pb + lrow // 8, 8 * wl + lrow % 8
                    acc = torch.zeros((64, c2))
                    for t, (dy, dx) in enumerate(taps):
                        acc += t1[r2 + dy, c2_ + dx] @ wt[t].T
                    v = torch.relu(acc + b2f).bfloat16().float()
                    gy, gx = y0 + r2, x0 + c2_
                    if pool:  # row g with row g + 8, then the lane 4 apart (column g ^ 1)
                        top, bot = v.reshape(4, 2, 8, c2)[:, 0], v.reshape(4, 2, 8, c2)[:, 1]
                        m = torch.maximum(top, bot)  # [warp, g, C2]
                        m = torch.maximum(m, m[:, torch.arange(8) ^ 1])
                        for wi in range(4):
                            for g in range(0, 8, 2):
                                oy, ox = (y0 + 2 * pb) // 2, (x0 + 8 * wi + g) // 2
                                if oy < h // 2 and ox < w // 2:
                                    out[bi, oy, ox] = m[wi, g]
                                    hits[bi, oy, ox] += 1
                    else:
                        ok = (gy < h) & (gx < w)
                        out[bi, gy[ok], gx[ok]] = v[ok]
                        hits[bi, gy[ok], gx[ok]] += 1
    return out, hits


@pytest.mark.parametrize(
    "shape,pool",
    [
        ((1, 20, 72, 1, 64, 64), True),  # the image stage, ragged in both directions
        ((1, 12, 40, 64, 64, 64), True),  # TH 16, a ragged row tile
        ((1, 10, 36, 16, 64, 64), True),  # Cin padded to 64 in the input tile and weights
        ((1, 10, 36, 64, 128, 128), True),  # TH 8, two output-channel blocks
        ((1, 6, 34, 128, 128, 128), False),  # TH 4, two input chunks per tap, no pool
        ((1, 10, 38, 96, 64, 128), True),  # Cin padded to 128, C1 != C2, ragged columns
    ],
)
def test_kernel_schedule_emulation_matches_plain(shape, pool):
    """The kernel's tile walk covers every output element exactly once and
    gives the plain version's result (fp32 sums in another order: at least
    99% of the elements bit-identical, the rest within 2^-6 of the largest
    output)."""
    b, h, w, cin, c1, c2 = shape
    x, w1, b1, w2, b2 = map(torch.from_numpy, _stage_inputs(sum(shape), *shape))
    with torch.no_grad():
        got, hits = _emulate_kernel(x, w1, b1, w2, b2, pool)
        want = vgg_stage.vgg_stage_plain(x, w1, b1, w2, b2, pool).float()
    assert bool((hits == 1).all())
    assert float((got == want).float().mean()) >= 0.99
    assert float((got - want).abs().max()) <= float(want.abs().max()) / 64


def test_swizzled_weights_round_trip():
    """pack_stage_weights lays conv taps out as the kernel's TMA chunks:
    unswizzled they give back the bf16 taps [9, Cout, Cin]."""
    rng = np.random.default_rng(7)
    w1, w2 = (torch.from_numpy(rng.normal(size=s).astype(np.float32))
              for s in ((3, 3, 48, 64), (3, 3, 64, 128)))
    b1, b2 = torch.zeros(64), torch.zeros(128)
    w1p, _, w2p, _ = vgg_stage.pack_stage_weights(w1, b1, w2, b2)
    assert w1p.shape == (9, 1, 64, 64) and w2p.shape == (9, 1, 128, 64)
    assert torch.equal(_layout.unswizzle128(w1p, 48), vgg_stage.pack_conv_weight(w1))
    assert torch.equal(_layout.unswizzle128(w2p, 64), vgg_stage.pack_conv_weight(w2))
    # Row n's 16-byte group j sits at position j ^ (n % 8).
    assert torch.equal(w2p[4, 0, 13, 8 * (2 ^ 5):8 * (2 ^ 5) + 8],
                       vgg_stage.pack_conv_weight(w2)[4, 13, 16:24])
    assert float(_layout.unswizzle128(w1p, 64)[..., 48:].abs().max()) == 0.0  # zero padding


def test_superpoint_caches_packed_weights():
    """SuperPoint packs each stage once, again only after a parameter changes
    in place, and the cache holds what a fresh pack gives."""
    from onepose_tpu_torch.models.superpoint import SuperPoint

    torch.manual_seed(0)
    sp = SuperPoint(vgg_kernel=True)
    first = sp.packed_stages()
    assert sp._packs.packs == 4
    again = sp.packed_stages()
    assert sp._packs.packs == 4 and all(a is b for a, b in zip(first, again))
    fresh = vgg_stage.pack_stage_weights(sp.conv2a.weight.permute(2, 3, 1, 0), sp.conv2a.bias,
                                         sp.conv2b.weight.permute(2, 3, 1, 0), sp.conv2b.bias)
    assert all(torch.equal(a, b) for a, b in zip(first[1], fresh))
    with torch.no_grad():
        sp.conv2b.weight.mul_(2.0)
    updated = sp.packed_stages()
    assert sp._packs.packs == 5
    assert updated[0] is first[0] and not torch.equal(updated[1][2], first[1][2])
    sp.load_state_dict(SuperPoint().state_dict())  # copy_ into every parameter
    sp.packed_stages()
    assert sp._packs.packs == 9
