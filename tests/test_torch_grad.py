"""Gradients of the port's K1 (NMS) and K5 (VGG stage) against the JAX
package's custom VJPs, on the CPU.

The JAX side runs onepose_tpu/ops/pallas/score_path.py::nms and
onepose_tpu/ops/pallas/vgg_stage.py::vgg_stage (their Pallas forwards in
interpret mode, as tests/test_pallas_kernels.py runs them; their `_bwd`s
recompute through XLA). The port side runs `Nms` and `VggStage` through
the public wrappers, whose CPU forward is the plain version. Every case
passes one explicit cotangent, made from a numpy seed, to both sides, so
the forwards' outputs (bf16 for a multi-channel stage) do not enter the
comparison. Tolerances:
- NMS: output and gradient bit-equal (the VJP is where(max_mask, g, 0));
- a VGG stage: each gradient within 1e-4 x its largest value (fp32 convs
  that sum in another order), on inputs with exact ties at the ReLU and in
  the pool windows, where the tie rules decide the gradient;
- SuperPoint: each gradient within 1e-4 x its largest value (the same
  convs, the NMS masks identical).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from onepose_tpu.models.superpoint import SuperPoint as JaxSuperPoint
from onepose_tpu.ops.pallas.score_path import nms as jax_nms
from onepose_tpu.ops.pallas.vgg_stage import vgg_stage as jax_vgg_stage
from onepose_tpu_torch.models import bridge
from onepose_tpu_torch.models.superpoint import SuperPoint
from onepose_tpu_torch.ops.kernels import (
    Nms,
    VggStage,
    launch_counts,
    reset_launches,
    score_path,
    vgg_stage,
)

torch.set_num_threads(2)

GRAD_REL = 1e-4  # a gradient's max abs error over its max abs value


def _close(got, want, name):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    assert got.shape == want.shape, name
    err, top = float(np.abs(got - want).max()), float(np.abs(want).max())
    assert top > 0, f"{name}: a zero gradient tests nothing"
    assert err <= GRAD_REL * top, f"{name}: max abs err {err:.3e} over max {top:.3e}"


# --- K1: NMS -------------------------------------------------------------------


def _nms_scores(kind, seed=0, b=2, h=40, w=48):
    """Plateaus (quantised scores: exact ties inside a window) or exact
    zeros (a zero band and a zero block: zeros kept as maxima, whose kept
    score looks like a suppressed one in the output)."""
    rng = np.random.default_rng(seed)
    s = rng.random((b, h, w)).astype(np.float32) ** 4
    if kind == "plateau":
        s = np.floor(s * 8) / 8
        s[:, 5:8, 5:8] = 0.7
    else:
        s[:, :, 10:13] = 0.0
        s[:, 25:, 30:] = 0.0
    return s


@pytest.mark.parametrize("kind", ["plateau", "zeros"])
@pytest.mark.parametrize("radius", [0, 4, 12])
def test_nms_gradient_is_jax_vjp_bit_for_bit(radius, kind):
    s = _nms_scores(kind, seed=radius)
    g = np.random.default_rng(100 + radius).normal(size=s.shape).astype(np.float32)
    want_out, vjp = jax.vjp(lambda x: jax_nms(x, radius), jnp.asarray(s))
    (want,) = vjp(jnp.asarray(g))

    st = torch.tensor(s, requires_grad=True)
    out = score_path.nms(st, radius)
    assert out.grad_fn is not None and type(out.grad_fn).__name__ == "NmsBackward"
    (got,) = torch.autograd.grad(out, st, torch.from_numpy(g))
    bits = lambda a: np.asarray(a, np.float32).view(np.int32)  # noqa: E731  (+0.0 != -0.0)
    np.testing.assert_array_equal(bits(out.detach().numpy()), bits(want_out))
    np.testing.assert_array_equal(bits(got.numpy()), bits(want))
    # autograd through the plain version gives the same bits
    (plain,) = torch.autograd.grad(score_path.simple_nms(st, radius), st, torch.from_numpy(g))
    np.testing.assert_array_equal(bits(got.numpy()), bits(plain.numpy()))
    if kind == "zeros":  # kept zeros: the output alone could not give this gradient
        kept_zero = (out.detach() == 0) & (got != 0)
        assert bool(kept_zero.any())


# --- K5: VGG stage (C18's regression test) --------------------------------------


def _tied_stage(seed, cin, b=2, hw=16, c=64):
    """fp32 stage inputs with exact ties: a flat 6 x 6 patch (conv sums
    equal inside it, so its 2 x 2 pool window ties) and a zero block in a
    corner with a quarter of the biases 0 (conv1 sums of exactly 0: ReLU
    inputs of 0)."""
    rng = np.random.default_rng(seed)
    x = rng.random((b, hw, hw, cin)).astype(np.float32)
    x[:, 4:10, 4:10, :] = x[:, 4:5, 4:5, :]
    x[:, hw - 6:, :6, :] = 0.0
    w1 = (rng.normal(size=(3, 3, cin, c)) * (2.0 / (9 * cin)) ** 0.5).astype(np.float32)
    w2 = (rng.normal(size=(3, 3, c, c)) * (2.0 / (9 * c)) ** 0.5).astype(np.float32)
    b1 = (rng.normal(size=(c,)) * 0.1).astype(np.float32)
    b2 = (rng.normal(size=(c,)) * 0.1).astype(np.float32)
    b1[::4] = 0.0
    b2[::4] = 0.0
    return x, w1, b1, w2, b2


@pytest.mark.parametrize("pool", [True, False], ids=["pool", "no_pool"])
@pytest.mark.parametrize("cin", [1, 64])
def test_vgg_stage_gradient_matches_jax_vjp_on_ties(cin, pool):
    """The stage's VJP is the unrounded fp32 stage's, with jnp.maximum's and
    jnp.max's tie rules: the port's CPU gradient used to differentiate the
    bf16-rounded plain version through F.relu and F.max_pool2d."""
    args = _tied_stage(cin + int(pool), cin)
    out_dtype = jnp.float32 if cin == 1 else jnp.bfloat16
    want_out, vjp = jax.vjp(lambda *a: jax_vgg_stage(*a, pool), *map(jnp.asarray, args))
    rng = np.random.default_rng(7)
    g = np.asarray(jnp.asarray(rng.normal(size=want_out.shape), out_dtype))
    want = vjp(jnp.asarray(g, out_dtype))

    ts = [torch.tensor(a, requires_grad=True) for a in args]
    out = vgg_stage.vgg_stage(*ts, pool)
    assert type(out.grad_fn).__name__ == "VggStageBackward"
    assert out.dtype == (torch.float32 if cin == 1 else torch.bfloat16)
    gt = torch.from_numpy(g.astype(np.float32)).to(out.dtype)
    got = torch.autograd.grad(out, ts, gt)
    for name, a, w in zip(("x", "w1", "b1", "w2", "b2"), got, want):
        assert a.dtype == torch.float32
        _close(a.numpy(), w, name)


def test_vgg_stage_reference_splits_ties_as_jax():
    """The reference's own tie rules: half the gradient each way at a ReLU
    input of 0, equal shares among a pool window's tied values."""
    x = torch.zeros((1, 4, 4, 1), requires_grad=True)
    w1 = torch.zeros((3, 3, 1, 1))
    w1[1, 1] = 1.0
    w2 = w1.clone()
    zero = torch.zeros(1)
    out = vgg_stage.vgg_stage_reference(x, w1, zero, w2, zero, True)
    (dx,) = torch.autograd.grad(out, x, torch.ones_like(out))
    np.testing.assert_array_equal(dx.numpy(), np.full((1, 4, 4, 1), 0.25 * 0.5 * 0.5))


def test_bf16_input_raises_in_backward_as_jax():
    """JAX's `_bwd` feeds a bf16 x with fp32 weights to conv_general_dilated,
    which raises TypeError; the port's backward raises the same type. The
    forward alone runs."""
    x, w1, b1, w2, b2 = _tied_stage(3, 64, hw=8)
    xb = jnp.asarray(x, jnp.bfloat16)
    with pytest.raises(TypeError):
        jax.grad(lambda w: jnp.sum(jax_vgg_stage(xb, w, *map(jnp.asarray, (b1, w2, b2)),
                                                 True).astype(jnp.float32)))(jnp.asarray(w1))
    ts = [torch.tensor(a, requires_grad=True) for a in (w1, b1, w2, b2)]
    out = vgg_stage.vgg_stage(torch.from_numpy(x).bfloat16(), *ts, True)
    assert out.shape == (2, 4, 4, 64) and out.dtype == torch.bfloat16
    with pytest.raises(TypeError, match="vgg_stage.py::_bwd"):
        out.float().sum().backward()


# --- SuperPoint -------------------------------------------------------------------


def _superpoint_inputs(size=64, seed=0):
    rng = np.random.default_rng(seed)
    img = rng.random((1, size, size, 1)).astype(np.float32)
    params = JaxSuperPoint().init(jax.random.PRNGKey(seed), jnp.asarray(img))
    cot = {"score_map": rng.normal(size=(1, size, size)).astype(np.float32),
           "descriptor_map": rng.normal(size=(1, size // 8, size // 8, 256)).astype(np.float32)}
    return img, params, cot


def _port_grads(model, img, cot):
    """Gradients of <cot, outputs> with respect to the image and every
    parameter: (image gradient, {name: gradient})."""
    im = torch.tensor(img, requires_grad=True)
    out = model(im)
    names, params = zip(*model.named_parameters())
    grads = torch.autograd.grad([out["score_map"], out["descriptor_map"]], (im, *params),
                                [torch.from_numpy(cot["score_map"]),
                                 torch.from_numpy(cot["descriptor_map"])])
    return out, grads[0], dict(zip(names, grads[1:]))


def _graph_nodes(t) -> list:
    seen, todo, names = set(), [t.grad_fn], []
    while todo:
        fn = todo.pop()
        if fn is None or fn in seen:
            continue
        seen.add(fn)
        names.append(type(fn).__name__)
        todo.extend(f for f, _ in fn.next_functions)
    return names


def test_superpoint_nms_kernel_gradients_match_jax():
    """SuperPoint(nms_kernel=True) against jax.vjp through
    SuperPoint(nms_pallas=True), fp32, [1, 64, 64, 1], parameters through
    the bridge: the image's and every parameter's gradient within 1e-4 x
    its largest value."""
    img, params, cot = _superpoint_inputs()
    jax_model = JaxSuperPoint(nms_pallas=True)
    want_out, vjp = jax.vjp(lambda p, im: jax_model.apply(p, im), params, jnp.asarray(img))
    dparams, dimg = vjp({k: jnp.asarray(v) for k, v in cot.items()})
    want = bridge.superpoint_state_dict(jax.tree.map(np.asarray, dparams))

    model = SuperPoint(nms_kernel=True)
    model.load_state_dict(bridge.superpoint_state_dict(jax.tree.map(np.asarray, params)))
    reset_launches()
    out, gimg, got = _port_grads(model, img, cot)
    assert _graph_nodes(out["score_map"]).count("NmsBackward") == 1
    assert launch_counts()["nms"] == 0  # the CPU runs the plain version
    # the same NMS masks on both sides, so the comparison sees only conv rounding
    np.testing.assert_array_equal(out["score_map"].detach().numpy() > 0,
                                  np.asarray(want_out["score_map"]) > 0)
    _close(gimg.numpy(), dimg, "image")
    assert set(got) == set(want)
    for name in got:
        _close(got[name].numpy(), want[name].numpy(), name)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
def test_superpoint_nms_kernel_gradients_equal_plain_nms(dtype):
    """Through `Nms` or through autograd of simple_nms, the same bits, in
    either compute dtype (the scores are fp32 in both)."""
    img, params, cot = _superpoint_inputs(seed=1)
    sd = bridge.superpoint_state_dict(jax.tree.map(np.asarray, params))
    res = []
    for nms_kernel in (True, False):
        model = SuperPoint(nms_kernel=nms_kernel, dtype=dtype)
        model.load_state_dict(sd)
        res.append(_port_grads(model, img, cot))
    (out_k, gimg_k, got_k), (out_p, gimg_p, got_p) = res
    assert _graph_nodes(out_k["score_map"]).count("NmsBackward") == 1
    assert "NmsBackward" not in _graph_nodes(out_p["score_map"])
    np.testing.assert_array_equal(gimg_k.numpy(), gimg_p.numpy())
    for name in got_k:
        assert bool(torch.isfinite(got_k[name]).all()) and bool(got_k[name].abs().max() > 0), name
        np.testing.assert_array_equal(got_k[name].numpy(), got_p[name].numpy(), err_msg=name)


def test_superpoint_vgg_kernel_gradient_raises_as_jax():
    """jax.grad through SuperPoint(use_pallas=True) raises TypeError (from
    the third stage on, the stage input is bf16); so does the backward of
    SuperPoint(vgg_kernel=True), whose forward runs under autograd with all
    four stages through `VggStage`."""
    img, params, cot = _superpoint_inputs(seed=2)
    jax_model = JaxSuperPoint(use_pallas=True, nms_pallas=True)
    with pytest.raises(TypeError):
        jax.grad(lambda p: jnp.sum(jax_model.apply(p, jnp.asarray(img))["score_map"]))(params)

    model = SuperPoint(vgg_kernel=True, nms_kernel=True)
    model.load_state_dict(bridge.superpoint_state_dict(jax.tree.map(np.asarray, params)))
    out = model(torch.tensor(img, requires_grad=True))
    nodes = _graph_nodes(out["score_map"])
    assert nodes.count("VggStageBackward") == 4 and nodes.count("NmsBackward") == 1
    assert bool(torch.isfinite(out["score_map"]).all())
    with pytest.raises(TypeError, match="vgg_stage.py::_bwd"):
        torch.autograd.grad(out["score_map"], list(model.parameters()),
                            torch.from_numpy(cot["score_map"]))


def test_superpoint_first_two_stages_differentiate():
    """Stages 1 and 2 as SuperPoint(vgg_kernel=True) chains them (fp32
    input, fp32 then bf16 output): the gradients of the image and of each
    stage's weights are the reference's VJPs, stage 2's taken at stage 1's
    forward output, bit for bit."""
    torch.manual_seed(0)
    model = SuperPoint(vgg_kernel=True)
    img = torch.rand((1, 32, 32, 1), requires_grad=True)
    hwio = lambda c: c.weight.permute(2, 3, 1, 0)  # noqa: E731
    s1 = (hwio(model.conv1a), model.conv1a.bias, hwio(model.conv1b), model.conv1b.bias)
    s2 = (hwio(model.conv2a), model.conv2a.bias, hwio(model.conv2b), model.conv2b.bias)
    x1 = vgg_stage.vgg_stage(img, *s1, True)
    x2 = vgg_stage.vgg_stage(x1, *s2, True)
    assert (x1.dtype, x2.dtype) == (torch.float32, torch.bfloat16)
    cot = torch.randn(x2.shape, generator=torch.Generator().manual_seed(1)).bfloat16()
    wanted = (img, model.conv1a.weight, model.conv2b.bias)
    got = torch.autograd.grad(x2, wanted, cot)

    x1r = x1.detach().requires_grad_()
    dx1, db2 = torch.autograd.grad(vgg_stage.vgg_stage_reference(x1r, *s2, True),
                                   (x1r, model.conv2b.bias), cot.float())
    dimg, dw1 = torch.autograd.grad(vgg_stage.vgg_stage_reference(img, *s1, True),
                                    (img, model.conv1a.weight), dx1)
    for name, a, w in zip(("image", "conv1a.weight", "conv2b.bias"), got, (dimg, dw1, db2)):
        assert float(w.abs().max()) > 0, name
        np.testing.assert_array_equal(a.numpy(), w.numpy(), err_msg=name)


# --- Functions, fallbacks and the weight cache ------------------------------------


def test_injected_forwards_get_detached_inputs():
    """`Nms` and `VggStage` hand their forward detached tensors (a CUDA
    kernel input must not require grad), and return gradients only where
    the inputs need them."""
    seen = []

    def record(fn):
        def forward(*args):
            seen.extend(t.requires_grad for t in args if isinstance(t, torch.Tensor))
            return fn(*args)
        return forward

    s = torch.rand((1, 12, 12), requires_grad=True)
    Nms.apply(s, 2, record(score_path.simple_nms)).sum().backward()
    assert s.grad is not None
    x, w1, b1, w2, b2 = _tied_stage(5, 1, b=1, hw=8)
    x = torch.from_numpy(x)  # data: no gradient wanted
    ws = [torch.tensor(a, requires_grad=True) for a in (w1, b1, w2, b2)]
    VggStage.apply(x, *ws, True, record(vgg_stage.vgg_stage_plain)).sum().backward()
    assert seen and not any(seen)
    assert x.grad is None and all(w.grad is not None for w in ws)


def test_grad_on_non_cpu_tensor_never_falls_back():
    """Under autograd a non-CPU tensor goes to the kernel through the
    Function and raises there (no CUDA here); it never runs the plain
    version."""
    reset_launches()
    s = torch.empty((1, 8, 8), device="meta", requires_grad=True)
    with pytest.raises(ValueError, match="CUDA"):
        score_path.nms(s, 4)
    x = torch.empty((1, 8, 8, 64), device="meta", requires_grad=True)
    w = torch.empty((3, 3, 64, 64), device="meta", requires_grad=True)
    b = torch.empty((64,), device="meta", requires_grad=True)
    with pytest.raises(ValueError, match="CUDA"):
        vgg_stage.vgg_stage(x, w, b, w, b, True)
    assert launch_counts()["nms"] == 0 and launch_counts()["vgg_stage"] == 0


def test_packed_stages_repack_after_optimizer_step():
    """An optimizer step writes the parameters in place: the packed
    weights the kernel reads follow it (`PackCache` reads `_version`)."""
    torch.manual_seed(0)
    sp = SuperPoint(vgg_kernel=True)
    first = sp.packed_stages()
    assert sp._packs.packs == 4
    opt = torch.optim.SGD(sp.parameters(), lr=0.1)
    for p in sp.parameters():
        p.grad = torch.ones_like(p)
    opt.step()
    after = sp.packed_stages()
    assert sp._packs.packs == 8
    fresh = vgg_stage.pack_stage_weights(sp.conv1a.weight.permute(2, 3, 1, 0), sp.conv1a.bias,
                                         sp.conv1b.weight.permute(2, 3, 1, 0), sp.conv1b.bias)
    assert all(torch.equal(a, b) for a, b in zip(after[0], fresh))
    assert not torch.equal(after[0][0], first[0][0])  # conv1a's packed taps moved
