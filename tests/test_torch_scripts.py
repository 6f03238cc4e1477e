"""The port's last measurement entry points on the CPU, at small shapes:
`scripts.profile_pnp` (A16), `audit_collectives` (A17),
`bench_pair_batching`, `bench_matcher_parts`, `bench_mixed_attention`
(A18), `profile_sp_layers`, `profile_superpoint_parts` (A19) and
`demo_pipeline` (A20); the SuperPoint front-end benchmarks
(`bench_sp_front`, `bench_sp_score`, `bench_sp_variants`) are held in
tests/test_torch_sp_variants.py, and here only raise without CUDA.

Each entry point runs on the card and raises here; these tests hold its
building blocks, with an explicit CPU device:
- A16: the plain version's sub-stages compose to ransac_pnp's pose and
  inliers for injected draws, and each of the profile's rows runs (K9's
  launches computed by the plain stages), the refine row giving the
  whole call's pose;
- A17: over 2 gloo ranks (tests/torch_rank_worker.py), the per-block
  collective volume is the same at two N3 and equals the closed form;
  the recorder counts nothing when off;
- A18: the batched pair matchers give the serial loops' matches; the
  matcher with 0 and 2 blocks gives JAX's GATsSPG's scores through the
  bridge (1e-5); the mixed-attention pipelines share their weights;
- A19: the prefix stack's last prefix is SuperPoint's score map (bit for
  bit, plain convs and K5's plain stages), the layers' operations add up
  to the cost model's; every part of the parts profile runs;
- A20: the command plan is the shell script's, and the run stops at the
  first failing command with its exit code;
- every main raises without CUDA, printing no result line.
"""

import json
import shutil
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from onepose_tpu.models.gats_spg import GATsSPG as JaxGATsSPG
from onepose_tpu_torch.geometry.ransac import (
    _gn_refine,
    _p3p_hypotheses,
    _preemptive_keep,
    _sample_minimal_sets,
    _score_kept,
    _valid_first,
    ransac_pnp,
)
from onepose_tpu_torch.models import bridge
from onepose_tpu_torch.scripts import (
    audit_collectives,
    bench_matcher_parts,
    bench_mixed_attention,
    bench_pair_batching,
    bench_sp_front,
    bench_sp_score,
    bench_sp_variants,
    demo_pipeline,
    profile_pnp,
    profile_sp_layers,
    profile_superpoint_parts,
)
from onepose_tpu_torch.utils import comm, costs
from onepose_tpu_torch.utils.profiling import host_syncs
from test_torch_geometry import _ransac_batch
from test_torch_ransac_kernel import _PlainKernels
from test_torch_scan import capture  # noqa: F401  (a fixture)
from torch_ranks import spawn

torch.set_num_threads(2)

CPU = torch.device("cpu")
AUDIT = dict(n3s=[48, 96], b=2, n2=16, leaves=2, c=64, blocks=2)


# --- A16 ------------------------------------------------------------------

def test_pnp_sub_stages_compose_to_ransac_pnp(monkeypatch):
    """ransac_pnp's sub-stages give its refined pose (where a frame is ok)
    and its consensus, for injected draws; each row of build_stages runs
    (K9's launches computed by the plain stages on the CPU), and launch B
    on the fixed draws' launch A gives the whole call's pose."""
    pts2d, pts3d, K, mask, _ = (torch.from_numpy(x) for x in _ransac_batch(seed=5))
    n_hyp, thr = 32, 5.0
    draws = torch.from_numpy(np.random.default_rng(1).random((2, n_hyp, 3)).astype(np.float32))
    want = ransac_pnp(pts2d, pts3d, K, mask, draws=draws, n_hyp=n_hyp, reproj_threshold=thr)
    p3 = pts3d * profile_pnp.SCALE
    order, n_valid = _valid_first(mask)
    Rs, ts, oks = _p3p_hypotheses(pts2d, p3, K, _sample_minimal_sets(draws, order, n_valid))
    keep = _preemptive_keep(Rs, ts, oks, pts2d, p3, K, order, n_valid, thr)
    R, t, inl, n_in = _score_kept(Rs, ts, oks, keep, pts2d, p3, K, mask, thr)
    R2, t2 = _gn_refine(R, t, K, p3, pts2d, inl.float(), iters=profile_pnp.REFINE_ITERS)
    assert want["ok"].all() and torch.equal(want["ok"], n_in >= 4)
    assert torch.equal(want["pose"][:, :3, :3], R2)
    assert torch.equal(want["pose"][:, :3, 3], t2 / profile_pnp.SCALE)

    fake = _PlainKernels()
    monkeypatch.setattr(profile_pnp, "k9", fake)
    gen = torch.Generator().manual_seed(0)
    stages = profile_pnp.build_stages(pts2d, pts3d, K, mask, gen, n_hyp=n_hyp, threshold=thr)
    assert list(stages) == ["pnp_fixed", "pnp_varying", "hypotheses", "refine"]
    assert set(profile_pnp.STAGE_SUM) < set(stages)
    outs = {name: fn(*args) for name, (fn, args) in stages.items()}
    for name, out in outs.items():
        assert torch.isfinite(out.float()).all(), name
    assert outs["hypotheses"].shape == (2, 4 * n_hyp, 2)
    assert torch.equal(outs["refine"], outs["pnp_fixed"])
    assert fake.calls == ["A", "A", "B"]
    rows = [{"stage": s, "ms": 1.0} for s in stages]
    out = profile_pnp.summary("card", rows)["profile_pnp"]
    assert out["stage_sum_ms"] == len(profile_pnp.STAGE_SUM) and out["whole_ms"] == 1.0


def test_profile_pnp_inputs_are_the_jax_scripts():
    pts2d, pts3d, K, mask = profile_pnp.make_inputs(device="cpu")
    rng = np.random.default_rng(0)
    np.testing.assert_array_equal(pts2d.numpy(), (rng.random((8, 1000, 2)) * 512)
                                  .astype(np.float32))
    np.testing.assert_array_equal(pts3d.numpy(), (rng.normal(size=(8, 1000, 3)) * 0.1)
                                  .astype(np.float32))
    np.testing.assert_array_equal(mask.numpy(), rng.random((8, 1000)) < 0.3)
    assert K[0, 0, 0] == 600.0 and K[0, 0, 2] == 256.0


def test_host_syncs_names_each_sync(monkeypatch):
    """Each synchronizing warning is one entry with the caller's line;
    other warnings are not counted."""
    monkeypatch.setattr(torch.cuda, "synchronize", lambda: None)
    monkeypatch.setattr(torch.cuda, "set_sync_debug_mode", lambda mode: None)

    def fn():
        warnings.warn("called a synchronizing CUDA operation")
        warnings.warn("something else")
        warnings.warn("called a synchronizing CUDA operation")

    line = fn.__code__.co_firstlineno
    assert host_syncs(fn) == [f"tests/test_torch_scripts.py:{line + 1}",
                              f"tests/test_torch_scripts.py:{line + 3}"]


# --- A17 ------------------------------------------------------------------

@pytest.fixture(scope="module")
def audit_ranks(tmp_path_factory):
    ranks = spawn("audit", 2, tmp_path_factory.mktemp("audit"), {"unused": np.zeros(1)},
                  options={"audit": AUDIT}, timeout=120.0)
    return [(json.loads(str(r["audit.result"])), json.loads(str(r["audit.bad"]))) for r in ranks]


def test_audit_per_block_volume_is_independent_of_n3(audit_ranks):
    result, bad = audit_ranks[0]
    assert bad == []
    for name in ("serving", "train_step"):
        blocks = [r["block"] for r in result[name].values()]
        assert len(blocks) == 2 and blocks[0] == blocks[1] and blocks[0]
    # The head grows with N3 (the conf all-gather), the blocks do not.
    heads = [r["head"]["all_gather"]["bytes"] for r in result["serving"].values()]
    assert heads[1] == 2 * heads[0]
    assert audit_ranks[1] == audit_ranks[0]


def test_audit_matches_the_closed_forms(audit_ranks):
    """The serving block: 10 all-reduces (the two sharded attentions' KV
    moments and key sums, the two sharded MLPs' instance-norm sums); the
    train step's block: its parameters' fp32 gradients, counted from the
    model."""
    from onepose_tpu_torch.models.gats_spg import GATsSPG

    result, _ = audit_ranks[0]
    b, c = AUDIT["b"], AUDIT["c"]
    d = c // 4
    block = result["serving"]["48"]["block"]["all_reduce"]
    assert block == {"calls": 10, "bytes": 4 * (2 * (b * 4 * d * d + b * 4 * d) + 2 * (b + 4 * b
                                                                                        * c))}
    n = [sum(p.numel() for p in GATsSPG(d_model=c, num_blocks=k).parameters()) for k in (0, 1)]
    assert audit_collectives.block_params(c) == n[1] - n[0]
    assert result["train_step"]["96"]["block"] == {"all_reduce": {"calls": 0,
                                                                  "bytes": 4 * (n[1] - n[0])}}
    assert result["train_step"]["96"]["head"]["all_reduce"]["bytes"] == 4 * (6 + n[0])


def test_recorder_is_off_outside_its_block():
    t = torch.ones(3)
    assert comm.all_reduce(t, None) is t
    with comm.record_collectives() as log:
        comm.all_reduce(t, None)  # no group: nothing moves
        with comm.record_collectives() as inner:
            pass
    assert log.totals() == {} and inner.totals() == {}
    assert comm._LOG is None


# --- A18 ------------------------------------------------------------------

def test_batched_pair_matches_equal_serial():
    """The JAX script's roster; its random descriptors match nothing under
    the NN distance gate, so each frame's here are one shared set plus
    noise (planted correspondences)."""
    feats, pairs = bench_pair_batching.make_features(64, 12, frames=6)
    assert pairs.tolist()[:7] == [[0, 1], [1, 2], [2, 3], [3, 4], [4, 5], [5, 0], [0, 2]]
    rng = np.random.default_rng(3)
    desc = rng.normal(size=(1, 64, 256)) + 0.4 * rng.normal(size=(6, 64, 256))
    feats["descriptors"] = (desc / np.linalg.norm(desc, axis=-1, keepdims=True)).astype(
        np.float32)
    outs = {}
    for label, match, ref in bench_pair_batching.make_matchers(feats, CPU):
        outs[label] = match(pairs)
        assert outs[label].shape == (12, 64)
        if ref is not None:
            np.testing.assert_array_equal(outs[label], outs[ref], err_msg=label)
    assert (outs["NN serial (per-pair dispatch)"] >= 0).any()
    assert (outs["SuperGlue serial (per-pair)"] >= 0).any()


@pytest.mark.parametrize("num_blocks", [0, 2])
def test_matcher_parts_match_jax(num_blocks):
    """The fp32 rows' matcher with JAX's parameters through the bridge:
    scores and conf within 1e-5 of JAX's GATsSPG(num_blocks)."""
    b, n2, n3, L, c = 2, 16, 24, 3, 64
    inputs = bench_matcher_parts.make_inputs(b, n2, n3, L, c, device="cpu")
    jargs = [jnp.asarray(x.numpy()) for x in inputs]
    jm = JaxGATsSPG(d_model=c, num_blocks=num_blocks, gats_use_pallas=False)
    params = jm.init(jax.random.PRNGKey(0), *jargs)
    want = jax.tree.map(np.asarray, jm.apply(params, *jargs))
    model = bench_matcher_parts.make_matcher("fp32", num_blocks, CPU, d_model=c)
    model.load_state_dict(bridge.gats_spg_state_dict(jax.tree.map(np.asarray, params)))
    with torch.inference_mode():
        got = model(*inputs)
    np.testing.assert_allclose(got["conf_matrix"].numpy(), want["conf_matrix"], atol=1e-5)
    scores = bench_matcher_parts.scores_fn(model, inputs)
    with torch.inference_mode():
        np.testing.assert_allclose(scores(inputs[0]).numpy(), want["matching_scores0"],
                                   atol=1e-5)
    bf16 = bench_matcher_parts.make_matcher("bf16", num_blocks, CPU, d_model=c)
    assert bf16.block_fused and bf16.fused_match and bf16.dtype == torch.bfloat16
    with torch.inference_mode():
        assert torch.isfinite(bench_matcher_parts.scores_fn(bf16, inputs)(inputs[0])).all()


def test_mixed_attention_pipelines_share_weights():
    pipes = bench_mixed_attention.make_pipelines(CPU, max_keypoints=32)
    a, b = pipes[False], pipes[True]
    for m in ("superpoint", "matcher"):
        sa, sb = getattr(a, m).state_dict(), getattr(b, m).state_dict()
        assert sa.keys() == sb.keys() and all(torch.equal(sa[k], sb[k]) for k in sa)
    assert not a.matcher.block_fused and a.matcher.fused_match
    assert a.superpoint.vgg_kernel and a.superpoint.nms_kernel
    for pipe, mixed in ((a, False), (b, True)):
        flags = [m.mixed for m in pipe.matcher.modules() if hasattr(m, "mixed")]
        assert flags and all(f == mixed for f in flags)
    out = {"matches0": torch.tensor([[1, -1, 3]]), "pose": torch.eye(4)[None]}
    assert bench_mixed_attention.compare(out, out) == (1.0, 0.0)


# --- A19 ------------------------------------------------------------------

@pytest.mark.parametrize("vgg_kernel", [False, True])
def test_prefix_stack_ends_at_superpoint_score_map(vgg_kernel):
    image = profile_sp_layers.make_image(b=1, img=64, device="cpu")
    sp = profile_sp_layers.make_superpoint(vgg_kernel, CPU)
    steps = profile_sp_layers.prefix_steps(sp)
    with torch.inference_mode():
        want = sp(image)["score_map"]
        got = profile_sp_layers.prefix(steps, len(steps))(image)
        for n in range(1, len(steps)):
            assert torch.isfinite(profile_sp_layers.prefix(steps, n)(image).float()).all()
    assert torch.equal(got, want)
    flops = profile_sp_layers.layer_flops(1, 64, 64, vgg_kernel)
    assert len(flops) == len(steps) == (6 if vgg_kernel else 13)
    # With the descriptor head's two convs, the cost model's count.
    desc = costs._conv(64, 3, 128, 256)[0] + costs._conv(64, 1, 256, 256)[0]
    assert sum(flops) + desc == costs.superpoint_dense(1, 64, 64)[0]


def test_superpoint_parts_run():
    images, scores = profile_superpoint_parts.make_inputs(b=1, img=32, device="cpu")
    parts = profile_superpoint_parts.build_parts(images, scores)
    assert len(parts) == 8
    for label, fn, x in parts:
        with torch.inference_mode():
            assert torch.isfinite(fn(x).float()).all(), label
    with torch.inference_mode():
        enc = [fn(x) for label, fn, x in parts[:2]]
    assert enc[0].shape == enc[1].shape == ()  # one element: nothing else read


# --- A20 ------------------------------------------------------------------

def test_demo_pipeline_plan_is_the_shell_scripts():
    plan = demo_pipeline.plan("/d/cup", True, "matcher=nn cache=false", "device=cpu")
    assert [argv for _, argv in plan] == [
        ["parse-scan", "data_dir=/d/cup/cup-annotate", "out_dir=/d/cup/cup-annotate-parsed"],
        ["parse-scan", "data_dir=/d/cup/cup-test", "out_dir=/d/cup/cup-test-parsed"],
        ["map", "data_dir=/d/cup/cup-annotate-parsed", "out_dir=/d/cup/sfm_model",
         "matcher=nn", "cache=false"],
        ["demo", "data_dir=/d/cup/cup-test-parsed", "anno_dir=/d/cup/sfm_model/anno",
         "out_dir=/d/cup/demo_out", "use_tracking=true", "make_video=true", "device=cpu"],
    ]
    assert "use_tracking=false" in demo_pipeline.plan("/d/cup")[3][1]


def test_demo_pipeline_runs_in_order_and_stops_at_a_failure(capture, tmp_path):  # noqa: F811
    """Both parse-scan commands on test_torch_scan.py's capture, then a map
    that fails (no weights directory): the run returns map's exit code and
    runs no demo."""
    obj = tmp_path / "cup"
    for part in ("annotate", "test"):
        shutil.copytree(capture, obj / f"cup-{part}")
    plan = demo_pipeline.plan(str(obj), map_args="weights.superpoint=/nonexistent device=cpu")
    rc, records = demo_pipeline.run(plan)
    assert rc != 0 and len(records) == 3
    for r in records[:2]:
        assert r["rc"] == 0 and r["summary"] == {"num_frames": 4, "num_video_frames": 4}
        assert r["launches"] and not any(r["launches"].values())
    assert records[2]["rc"] == rc and records[2]["argv"][0] == "map"
    assert (obj / "cup-test-parsed" / "color").is_dir() and not (obj / "demo_out").exists()


# --- every entry point ----------------------------------------------------

MAINS = {
    "profile_pnp": (profile_pnp.main, []),
    "audit_collectives": (audit_collectives.main, []),
    "bench_pair_batching": (bench_pair_batching.main, []),
    "bench_matcher_parts": (bench_matcher_parts.main, []),
    "bench_mixed_attention": (bench_mixed_attention.main, []),
    "profile_sp_layers": (profile_sp_layers.main, []),
    "profile_superpoint_parts": (profile_superpoint_parts.main, []),
    "demo_pipeline": (demo_pipeline.main, ["/nonexistent/obj"]),
    "bench_sp_front": (bench_sp_front.main, []),
    "bench_sp_score": (bench_sp_score.main, []),
    "bench_sp_variants": (bench_sp_variants.main, []),
}


@pytest.mark.parametrize("entry", sorted(MAINS))
def test_main_raises_without_cuda(entry, monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.delenv("RANK", raising=False)
    main, argv = MAINS[entry]
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        main(argv)
    out = capsys.readouterr().out
    assert "{" not in out and "Parse scanned data" not in out
