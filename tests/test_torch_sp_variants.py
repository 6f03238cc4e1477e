"""SuperPoint's front-end forms (`models.superpoint_variants`) against the
JAX package's SuperPoint on the CPU, and the three benchmarks that time
them (`scripts.bench_sp_front`, `bench_sp_score`, `bench_sp_variants`)
end to end on the CPU.

The same numpy image (B 2, 64 x 64) and the same flax parameters (through
the bridge) go to both packages; the JAX side is onepose_tpu's SuperPoint
(its flax convs, its `simple_nms`, its Pallas VGG stage in interpret
mode). Each form of the port is held to the JAX counterpart of its part
within the tolerance `superpoint_variants` states for the form against the
port's default:
- the input conv (cudnn, pad8, im2col) against flax's conv1a and ReLU,
  and the first stage (those, and K5's) against flax's conv pair and pool
  or JAX's `vgg_stage`: fp32 1e-5 absolute, bf16 2^-6 of the largest
  output;
- the score path (each softmax, depth-to-space and NMS form, and the sync)
  against JAX's softmax, depth-to-space and `simple_nms` on the same
  logits: 1e-6 absolute, the kept pixels identical;
- the dense forward with each encoder form against JAX's SuperPoint at
  NMS radius 0 (NMS then picks among near-ties, which the conv sum order
  flips): fp32 1e-5 absolute, bf16 2e-3 of the largest raw score and
  5e-3 absolute on descriptors; with every default form, the port's
  SuperPoint bit for bit.
"""

import json

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from onepose_tpu.models.superpoint import SuperPoint as JaxSuperPoint
from onepose_tpu.models.superpoint import simple_nms as jax_simple_nms
from onepose_tpu.ops.pallas.vgg_stage import vgg_stage as jax_vgg_stage
from onepose_tpu_torch.models import bridge
from onepose_tpu_torch.models import superpoint_variants as V
from onepose_tpu_torch.models.superpoint import SuperPoint
from onepose_tpu_torch.scripts import bench_sp_front, bench_sp_score, bench_sp_variants

torch.set_num_threads(2)

B, IMG = 2, 64
DTYPES = {"fp32": (torch.float32, jnp.float32), "bf16": (torch.bfloat16, jnp.bfloat16)}


@pytest.fixture(scope="module")
def setup():
    rng = np.random.default_rng(0)
    img = rng.random((B, IMG, IMG, 1)).astype(np.float32)
    params = JaxSuperPoint().init(jax.random.PRNGKey(0), jnp.asarray(img))
    sd = bridge.superpoint_state_dict(jax.tree.map(np.asarray, params))
    logits = rng.normal(size=(B, IMG // 8, IMG // 8, 65)).astype(np.float32)
    return dict(img=img, params=params, sd=sd, logits=logits)


def _port(setup, dtype, **kw) -> SuperPoint:
    sp = SuperPoint(dtype=dtype, **kw).eval()
    sp.load_state_dict(setup["sd"])
    return sp


def _conv(setup, name, x, jdt, features=64):
    conv = fnn.Conv(features, (3, 3), padding="SAME", dtype=jdt)
    return jax.nn.relu(conv.apply({"params": setup["params"]["params"][name]}, x))


def _close(got: torch.Tensor, want, tol: tuple) -> None:
    want = np.asarray(want, np.float32)
    err = np.abs(got.float().numpy() - want).max()
    limit = tol[0] * np.abs(want).max() if tol[1] else tol[0]
    assert err <= limit, (err, limit)


@pytest.mark.parametrize("tag", list(DTYPES))
@pytest.mark.parametrize("form", V.CONV1A_FORMS)
def test_conv1a_forms_match_flax(setup, tag, form):
    dt, jdt = DTYPES[tag]
    want = _conv(setup, "conv1a", jnp.asarray(setup["img"]).astype(jdt), jdt)
    with torch.no_grad():
        got = V.conv1a(_port(setup, dt), torch.from_numpy(setup["img"]), form)
    assert got.dtype == dt and got.shape == (B, 64, IMG, IMG)
    _close(got.permute(0, 2, 3, 1), want, V.encoder_tolerance(dt))


@pytest.mark.parametrize("tag,form", [("fp32", f) for f in V.CONV1A_FORMS]
                         + [("bf16", f) for f in V.STAGE1_FORMS])
def test_stage1_forms_match_jax(setup, tag, form):
    """The first stage: flax's conv pair and pool, or, for K5's form, JAX's
    Pallas VGG stage (the JAX SuperPoint's use_pallas path)."""
    dt, jdt = DTYPES[tag]
    x = jnp.asarray(setup["img"]).astype(jdt)
    if form == "k5":
        p = setup["params"]["params"]
        want = jax_vgg_stage(x.astype(jnp.float32), p["conv1a"]["kernel"], p["conv1a"]["bias"],
                             p["conv1b"]["kernel"], p["conv1b"]["bias"], True)
    else:
        y = _conv(setup, "conv1b", _conv(setup, "conv1a", x, jdt), jdt)
        want = fnn.max_pool(y, (2, 2), strides=(2, 2))
    with torch.no_grad():
        got = V.stage1(_port(setup, dt), torch.from_numpy(setup["img"]), form)
    assert got.dtype == dt and got.shape == (B, 64, IMG // 2, IMG // 2)
    _close(got.permute(0, 2, 3, 1), want, V.encoder_tolerance(dt))


def test_k5_forms_are_bf16_only(setup):
    with pytest.raises(ValueError, match="bf16"):
        V.stage1(_port(setup, torch.float32), torch.from_numpy(setup["img"]), "k5")
    with pytest.raises(ValueError, match="unknown form"):
        V.conv1a(_port(setup, torch.float32), torch.from_numpy(setup["img"]), "winograd")


SCORE_FORMS = ([dict(softmax_form=f) for f in V.SOFTMAX_FORMS]
               + [dict(d2s=f) for f in V.D2S_FORMS[1:]]
               + [dict(nms_form=f) for f in V.NMS_FORMS[1:]]
               + [dict(sync=True), dict(softmax_form="channels_last", d2s="pixel_shuffle",
                                        nms_form="k1", sync=True)])


@pytest.mark.parametrize("kw", SCORE_FORMS, ids=lambda kw: "-".join(map(str, kw.values())))
def test_score_path_forms_match_jax(setup, kw):
    """softmax -> depth-to-space -> simple_nms at radius 4, JAX's code on
    NHWC logits and each form on the same logits NCHW."""
    lg = setup["logits"]
    probs = jax.nn.softmax(jnp.asarray(lg), axis=-1)[..., :-1]
    b, h, w, _ = probs.shape
    scores = probs.reshape(b, h, w, 8, 8).transpose(0, 1, 3, 2, 4).reshape(b, h * 8, w * 8)
    want = np.asarray(jax_simple_nms(scores, 4))
    got = V.score_path(torch.from_numpy(lg).permute(0, 3, 1, 2).contiguous(), 4, **kw).numpy()
    np.testing.assert_allclose(got, want, atol=V.SOFTMAX_ABS, rtol=0)
    np.testing.assert_array_equal(got > 0, want > 0)


DENSE = ([("fp32", e, n, "dim1") for e in V.CONV1A_FORMS for n in ("separable", "k1")]
         + [("bf16", e, "k1", "dim1") for e in V.STAGE1_FORMS]
         + [("fp32", "pad8", "k1", "channels_last"), ("bf16", "k5", "k1", "channels_last")])


@pytest.mark.parametrize("tag,encoder,nms,softmax", DENSE)
def test_dense_forward_forms_match_jax(setup, tag, encoder, nms, softmax):
    """The whole dense forward at NMS radius 0 against JAX's SuperPoint in
    the same dtype (with its Pallas VGG stages for K5's form)."""
    dt, jdt = DTYPES[tag]
    jm = JaxSuperPoint(dtype=jdt, nms_radius=0, use_pallas=encoder == "k5")
    want = jax.tree.map(np.asarray, jm.apply(setup["params"], jnp.asarray(setup["img"])))
    with torch.no_grad():
        got = V.dense_forward(_port(setup, dt), torch.from_numpy(setup["img"]), encoder, nms,
                              sync=True, radius=0, softmax_form=softmax)
    tols = V.dense_tolerances(dt)
    _close(got["score_map"], want["score_map"], tols["raw_score_map"])
    _close(got["descriptor_map"], want["descriptor_map"], tols["descriptor_map"])


@pytest.mark.parametrize("tag,kw", [("fp32", {}), ("fp32", dict(nms_kernel=True)),
                                    ("bf16", dict(nms_kernel=True, vgg_kernel=True))])
def test_default_forms_are_superpoint_forward(setup, tag, kw):
    sp = _port(setup, DTYPES[tag][0], **kw)
    image = torch.from_numpy(setup["img"])
    with torch.no_grad():
        want = sp(image)
        got = V.dense_forward(sp, image, "k5" if sp.vgg_kernel else "cudnn",
                              "k1" if sp.nms_kernel else "separable")
    for k in want:
        assert torch.equal(got[k], want[k]), k


# --- the benchmarks, end to end on the CPU ----------------------------------

SMALL = ["--device", "cpu", "--batch", "1", "--img", "64", "--iters", "1", "--windows", "2"]


@pytest.mark.parametrize("module,name,n_rows", [
    (bench_sp_front, "bench_sp_front", 16), (bench_sp_score, "bench_sp_score", 11),
    (bench_sp_variants, "bench_sp_variants", 42)])
def test_main_runs_on_the_cpu(module, name, n_rows, capsys):
    assert module.main(SMALL) == 0
    lines = capsys.readouterr().out.strip().splitlines()
    out = json.loads(lines[-1])[name]
    assert out["card"].startswith("cpu") and len(out["rows"]) == n_rows
    for row in out["rows"]:
        assert row["ok"] and row["launches"] == {} and len(row["windows"]) == 2, row
        assert row["min_ms"] <= row["ms"] <= row["max_ms"]
        assert set(row["err"]) == set(row["tol"]) and (row["ref"] is None) == (not row["err"])
    assert len(lines) == n_rows + 2 + (2 if name == "bench_sp_variants" else 0)
    if name == "bench_sp_variants":
        assert set(out["fastest"]) == {"fp32", "bf16"}
        assert out["fastest"]["bf16"]["on"].startswith("bf16 encoder=k5 nms=k1")


def test_variant_forms_run_their_dtypes_superpoint():
    """Each dtype's forms run that dtype's SuperPoint: its default form is
    the SuperPoint of bench_sp_variants.make_superpoint, bit for bit."""
    image = bench_sp_variants.make_image(1, 32, device="cpu")
    forms = bench_sp_variants.build_forms(image)
    for tag, dtype in bench_sp_variants.DTYPES.items():
        first = next(f for f in forms if f.section == tag)
        assert first.ref is None and first.label.endswith("cudnn nms=separable")
        with torch.no_grad():
            want = bench_sp_variants.make_superpoint(dtype, image.device)(image)
            got = first.fn()
        for k in want:
            assert torch.equal(got[k], want[k]), (tag, k)


def test_a_form_out_of_tolerance_fails_its_row(monkeypatch, capsys):
    """A form that gives another output marks its row and the exit code."""
    real = V.softmax

    def off(logits, form="dim1"):
        p = real(logits, form)
        return p + 1e-3 if form == "manual" else p

    monkeypatch.setattr(V, "softmax", off)
    assert bench_sp_score.main(SMALL) == 1
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])["bench_sp_score"]
    assert [r["form"] for r in out["rows"] if not r["ok"]] == ["manual"]
