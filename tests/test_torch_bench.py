"""The port's measurement entry points on the CPU: `onepose_tpu_torch.bench`,
`scripts.roofline_audit`, `scripts.bench_train_step` and `utils.costs`.

What they hold, at small shapes (the entry points themselves run on the
card and raise here):
- the cost model's operation counts against XLA's
  `cost_analysis()["flops"]` of the JAX package's SuperPoint and GATsSPG,
  within COST_REL: XLA leaves out SAME padding's out-of-bounds taps (5.4%
  of SuperPoint's dense count at 64 x 64, less on larger maps) and adds
  elementwise operations that the cost model leaves out; SuperPoint at
  [8, 512, 512, 1] is 355.69 GFLOP;
- the bench's inputs bit for bit against bench.py's draws, restated;
- the dependent chain: each call fed images + 1e-12 * the pose[0, 0, 0]
  of the call before, and exactly the asked-for calls;
- the train-step bench's losses over 3 steps, from JAX's initial
  parameters through the bridge, against the JAX script's scan of
  make_train_step (fp32 within 1e-4, ROADMAP A11's criterion; bf16
  within BF16_LOSS_REL: the two packages round at other places);
- every entry point's main raising without CUDA, printing no metric;
- the roofline's rows and last line from a CPU dry run of its stages
  (no time, so no share).
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from onepose_tpu.models.gats_spg import GATsSPG as JaxGATsSPG
from onepose_tpu.models.superpoint import SuperPoint as JaxSuperPoint
from onepose_tpu.train import train_step as jts
from onepose_tpu_torch import bench
from onepose_tpu_torch.models import bridge
from onepose_tpu_torch.models.gats_spg import GATsSPG
from onepose_tpu_torch.ops.kernels import launch_counts
from onepose_tpu_torch.runtime.pipeline import PosePipeline
from onepose_tpu_torch.scripts import bench_train_step, roofline_audit
from onepose_tpu_torch.train import train_step as pts
from onepose_tpu_torch.utils import costs

torch.set_num_threads(2)

COST_REL = 0.10
LOSS_REL = 1e-4  # ROADMAP A11's criterion for the loss history
BF16_LOSS_REL = 0.1  # bf16 rounding points differ between the packages (measured 3.4e-2)
SMALL = dict(batch=2, img=64, n_points=40, n_leaf=3)


def _xla_flops(fn, *args) -> float:
    ca = jax.jit(fn).lower(*args).compile().cost_analysis()
    return float((ca[0] if isinstance(ca, (list, tuple)) else ca)["flops"])


@pytest.mark.parametrize("shape", [(1, 64, 64), (2, 64, 96)], ids=str)
def test_superpoint_count_matches_xla(shape):
    b, h, w = shape
    model = JaxSuperPoint()
    img = jnp.zeros((b, h, w, 1), jnp.float32)
    params = model.init(jax.random.PRNGKey(0), img)
    want = _xla_flops(lambda p, x: model.apply(p, x), params, img)
    got, n_bytes = costs.superpoint_dense(b, h, w, torch.float32)
    assert abs(got / want - 1) < COST_REL, (got, want)
    assert n_bytes > b * h * w * 4


@pytest.mark.parametrize("shape", [(1, 32, 48, 4, 256, 4, 1), (2, 24, 40, 3, 128, 4, 2)], ids=str)
def test_matcher_count_matches_xla(shape):
    b, n2, n3, L, c, heads, blocks = shape
    model = JaxGATsSPG(d_model=c, num_heads=heads, num_blocks=blocks)
    args = (jnp.zeros((b, n2, c)), jnp.zeros((b, n3, c)), jnp.zeros((b, n3, L, c)),
            jnp.ones((b, n2), bool), jnp.ones((b, n3), bool), jnp.ones((b, n3, L), bool))
    params = model.init(jax.random.PRNGKey(0), *args)
    want = _xla_flops(lambda p, *a: model.apply(p, *a), params, *args)
    got, _ = costs.gats_spg_matcher(b, n2, n3, L, c, heads, blocks, torch.float32)
    assert abs(got / want - 1) < COST_REL, (got, want)


def test_production_counts():
    """SuperPoint at bench's shape is 355.69 GFLOP; the whole call is the
    sum of its stages, and the convolutions and the matcher bound it."""
    flops, _ = costs.superpoint_dense(8, 512, 512)
    assert round(flops / 1e9, 2) == 355.69
    parts = [costs.superpoint_dense(8, 512, 512), costs.extract_keypoints(8, 512, 512, 1000),
             costs.gats_spg_matcher(8, 1000, 2000, 8), costs.ransac_pnp(8, 1000, 512)]
    whole = costs.pose_pipeline(8, 512, 512, 1000, 2000, 8)
    assert whole == (sum(f for f, _ in parts), sum(b for _, b in parts))
    assert costs.bound(*whole)[1] == "operations"
    assert costs.bound(0, parts[1][1]) == (parts[1][1] / costs.PEAK_BYTES_PER_S, "bytes")


def test_bench_inputs_are_bench_py_draws():
    """bench.py's rng(0) sequence, restated: images, then points, desc3d
    and leaves, each rounded to float32 as jnp.asarray(..., float32) does."""
    b, s, n, L = 2, 16, 7, 3
    rng = np.random.default_rng(0)
    images = rng.random((b, s, s, 1), np.float32)
    points = np.asarray(rng.normal(size=(n, 3)) * 0.1, np.float32)
    desc3d = np.asarray(rng.normal(size=(n, 256)), np.float32)
    leaves = np.asarray(rng.normal(size=(n, L, 256)), np.float32)
    K = np.broadcast_to(np.asarray([[600.0, 0, s / 2], [0, 600.0, s / 2], [0, 0, 1]],
                                   np.float32), (b, 3, 3))
    got_images, got_K, anno = bench.make_inputs(b, s, n, L, device="cpu")
    for got, want in ((got_images, images), (got_K, K), (anno.points3d, points),
                      (anno.desc3d, desc3d), (anno.leaf_desc, leaves)):
        assert got.dtype == torch.float32 and np.array_equal(got.numpy(), want)
    assert bool(anno.mask3d.all()) and tuple(anno.leaf_mask.shape) == (n, L)
    assert bool(anno.leaf_mask.all())


def _small_pipeline():
    torch.manual_seed(0)
    return PosePipeline(max_keypoints=32, ransac_hypotheses=16, device="cpu")


def test_dependent_chain_feeds_each_pose_forward():
    """One warm-up call, then a window of 3: the real pipeline (plain
    versions on the CPU) wrapped to record each call's input."""
    pipe = _small_pipeline()
    images, K, anno = bench.make_inputs(**SMALL, device="cpu")
    seen = []

    def recording(x, *args, **kw):
        out = pipe(x, *args, **kw)
        seen.append((x.clone(), out["pose"].clone()))
        return out

    gen = torch.Generator().manual_seed(0)
    x, _ = bench.dependent_calls(recording, images, images, K, anno, gen, 1)
    x, last = bench.dependent_calls(recording, x, images, K, anno, gen, 3)
    assert len(seen) == 4
    assert torch.equal(seen[0][0], images)
    for (_, pose), (nxt, _) in zip(seen, seen[1:]):
        assert torch.equal(nxt, images + 1e-12 * pose[0, 0, 0])
    assert torch.equal(x, images + 1e-12 * last["pose"][0, 0, 0])
    assert tuple(last["pose"].shape) == (SMALL["batch"], 4, 4)


def test_check_launches():
    counts = launch_counts()
    want = {**dict.fromkeys(counts, 0), **bench.EXPECTED_LAUNCHES}
    assert bench.check_launches(dict(want)) == want
    with pytest.raises(SystemExit, match="kernel launches"):
        bench.check_launches({**want, "gats": 4})


@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
def test_train_step_losses_match_jax_scan(dtype):
    """The JAX script's scan of make_train_step against the port's
    run_steps, from JAX's initial parameters, on the script's batch."""
    b, n2, n3, L, c, steps = 2, 32, 48, 4, 256, 3
    batch = bench_train_step.make_batch(b, n2, n3, L, c, device="cpu")
    jbatch = {k: jnp.asarray(v.numpy()) for k, v in batch.items()}
    jdt, tdt = (jnp.bfloat16, torch.bfloat16) if dtype == "bf16" else (jnp.float32, torch.float32)
    jmodel = JaxGATsSPG(num_blocks=1, fused_match=False, dtype=jdt)
    jcfg = jts.TrainConfig(steps_per_epoch=100)
    state0 = jts.create_train_state(jax.random.PRNGKey(0), jmodel, jcfg, jbatch)
    jstep = jts.make_train_step(jmodel, jcfg)

    def body(s, _):
        s2, m = jstep(s, jbatch)
        return s2, m["loss"]

    want = np.asarray(jax.jit(lambda s: jax.lax.scan(body, s, None, length=steps)[1])(state0))

    model = GATsSPG(num_blocks=1, gats_kernel=True, fused_match=False, dtype=tdt)
    model.load_state_dict(bridge.gats_spg_state_dict(jax.tree.map(np.asarray, state0.params)))
    cfg = pts.TrainConfig(steps_per_epoch=100)
    state = pts.TrainState(model, pts.make_optimizer(cfg, model))
    _, losses = bench_train_step.run_steps(pts.make_train_step(model, cfg), state, batch, steps)
    got = np.array([float(x) for x in losses])
    assert np.all(np.isfinite(got))
    np.testing.assert_allclose(got, want, rtol=LOSS_REL if dtype == "fp32" else BF16_LOSS_REL)


@pytest.mark.parametrize("entry", ["bench", "roofline_audit", "bench_train_step"])
def test_main_raises_without_cuda(entry, monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    main = {"bench": bench.main, "roofline_audit": roofline_audit.main,
            "bench_train_step": bench_train_step.main}[entry]
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        main([])
    out = capsys.readouterr().out
    for word in ("pose_pipeline_frames_per_s", "roofline", "train_step", "MFU", "bound"):
        assert word not in out


def test_roofline_rows_from_a_cpu_dry_run():
    """Every stage runs once on its upstream-produced inputs; its row has
    the JSON keys, a bound and what sets it, and no time, MFU or share."""
    pipe = _small_pipeline()
    images, K, anno = bench.make_inputs(**SMALL, device="cpu")
    stages = roofline_audit.build_stages(pipe, images, K, anno, torch.Generator().manual_seed(0))
    assert list(stages) == ["superpoint_dense", "extract_keypoints", "gats_spg_matcher",
                            "ransac_pnp", "fused_pipeline"]
    rows = []
    for name, (fn, args, cost) in stages.items():
        roofline_audit.chain(fn, args, 1)
        rows.append(roofline_audit.row(name, cost))
    for r in rows:
        assert tuple(r) == roofline_audit.ROW_KEYS
        assert r["ms"] is None and r["mfu"] is None and r["bw_util"] is None
        assert r["bound_ms"] > 0 and r["bound_by"] in ("operations", "bytes")
    assert rows[1]["gflop"] == 0 and rows[1]["bound_by"] == "bytes"
    card = "NVIDIA H100 80GB HBM3, 700.00 W"
    line = json.loads(json.dumps(roofline_audit.summary(card, rows, [])))["roofline"]
    assert set(line) == {"card", "rows", "stage_sum_ms", "stage_sum_bound_ms", "mfu", "sweep"}
    assert line["stage_sum_ms"] is None and line["mfu"] is None and line["sweep"] == []
    assert line["stage_sum_bound_ms"] == pytest.approx(sum(r["bound_ms"] for r in rows[:4]))
    assert roofline_audit.power_limit_w(card) == 700.0
