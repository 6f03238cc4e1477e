"""The port's multi-device library against the JAX package on the CPU.

The JAX side runs on the conftest's 8-device CPU mesh at the JAX tests'
mesh shapes (tests/test_sharded_attention.py, test_tp_stage_pipeline.py,
test_distributed_ba.py): make_mesh(n_points=4) (2 x 4 devices) and
make_tp_mesh(4). The port side runs once over 4 gloo ranks on the CPU
(`torch_ranks.spawn`, one torchrun): the sharded attention over a 1 x 4
("data", "points") mesh, the points-sharded GATsSPG over 1 x 4 and 2 x 2,
the tensor-parallel GATsSPG over n_model 4 and 2, distributed BA over 4
and 2 point shards, and the collectives of utils.comm.

Tolerances: 1e-5 absolute on attention outputs and conf (fp32 sums over
shards in another order), matches identical; BA costs 1e-5 relative and
points 1e-4 (the single-device solver's criterion in
tests/test_distributed_ba.py). StagePipeline runs in this process on the
CPU and must equal PosePipeline.__call__ exactly.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from onepose_tpu.models.gats_spg import GATsSPG as JaxGATsSPG
from onepose_tpu.ops.lm import ba_solve as jax_ba_solve
from onepose_tpu.parallel.distributed_ba import distributed_ba_solve as jax_dist_ba
from onepose_tpu.parallel.distributed_ba import partition_obs_by_point as jax_partition
from onepose_tpu.parallel.mesh import make_mesh as jax_make_mesh
from onepose_tpu.parallel.sharded_attention import ring_softmax_attention as jax_ring
from onepose_tpu.parallel.sharded_attention import sharded_dual_softmax as jax_dual
from onepose_tpu.parallel.sharded_attention import sharded_linear_attention as jax_linear
from onepose_tpu.parallel.tensor_parallel import make_tp_mesh as jax_tp_mesh
from onepose_tpu.parallel.tensor_parallel import shard_params as jax_shard_params
from onepose_tpu_torch.models import bridge
from onepose_tpu_torch.models.gats_spg import GATsSPG
from onepose_tpu_torch.parallel import distributed_ba, mesh as port_mesh, tensor_parallel
from onepose_tpu_torch.parallel.sharded_attention import (
    ring_softmax_attention,
    sharded_dual_softmax,
    sharded_linear_attention,
)
from onepose_tpu_torch.parallel.stage_pipeline import StagePipeline
from test_ops import make_ba_problem
from test_torch_lm import SINGULAR_BA, singular_ba_args
from torch_ranks import spawn

torch.set_num_threads(2)

RANKS = 4
B, N, M, H, D = 2, 16, 32, 4, 16  # attention (tests/test_sharded_attention.py)
MB, N2, N3, L, C, BLOCKS = 2, 32, 64, 4, 256, 2  # matcher
MESHES = [(1, 4), (2, 2)]
TP = [4, 2]
BA_ITERS = (1, 10)  # one step (cost 8.9, above the fp32 floor), and converged


def _qkv(rng, masked_shard: bool):
    q, k, v = (rng.normal(size=(B, n, H, D)).astype(np.float32) for n in (N, M, M))
    mask = rng.random((B, M)) > 0.2
    if masked_shard:
        mask[:, 8:16] = False  # the whole of shard 1 of 4
    return q, k, v, mask


def _matcher_inputs(rng):
    def unit(x):
        return (x / np.linalg.norm(x, axis=-1, keepdims=True)).astype(np.float32)

    d2 = unit(rng.normal(size=(MB, N2, C)))
    d3 = unit(rng.normal(size=(MB, N3, C)))
    d3[:, :N2 // 2] = unit(d2[:, :N2 // 2] + 0.3 * d3[:, :N2 // 2])
    leaves = unit(rng.normal(size=(MB, N3, L, C)))
    m2 = rng.random((MB, N2)) > 0.1
    m3 = rng.random((MB, N3)) > 0.1
    lm = rng.random((MB, N3, L)) > 0.2
    return dict(d2=d2, d3=d3, leaves=leaves, m2=m2, m3=m3, lm=lm)


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """Inputs, the JAX references and the 4 ranks' results."""
    rng = np.random.default_rng(0)
    inputs, ref = {}, {}
    jmesh = jax_make_mesh(n_points=4)
    for name, masked in (("plain", False), ("masked_shard", True)):
        q, k, v, mask = _qkv(rng, masked)
        inputs.update({f"{name}_q": q, f"{name}_k": k, f"{name}_v": v, f"{name}_mask": mask})
        jq, jk, jv, jm = (jnp.asarray(x) for x in (q, k, v, mask))
        ref[f"{name}_linear"] = jax_linear(jmesh, jq, jk, jv, jm, v_length=M)
        ref[f"{name}_ring"] = jax_ring(jmesh, jq, jk, jv, jm)
        ref[f"{name}_linear_qkv"] = jax_linear(jmesh, jk, jk, jv, jm, v_length=M, q_sharded=True)
        ref[f"{name}_ring_qkv"] = jax_ring(jmesh, jk, jk, jv, jm, q_sharded=True)
    scores = rng.normal(size=(B, 12, M)).astype(np.float32)
    m2, m3 = rng.random((B, 12)) > 0.2, rng.random((B, M)) > 0.2
    inputs.update(scores=scores, ds_m2=m2, ds_m3=m3)
    ref["dual_softmax"] = jax_dual(jmesh, *(jnp.asarray(x) for x in (scores, m2, m3)))

    mi = _matcher_inputs(rng)
    inputs.update({f"mi_{k}": v for k, v in mi.items()})
    margs = [jnp.asarray(mi[k]) for k in ("d2", "d3", "leaves", "m2", "m3", "lm")]
    dense = JaxGATsSPG(num_blocks=BLOCKS, match_threshold=0.0, fused_match=False)
    params = dense.init(jax.random.PRNGKey(0), *margs)
    ref["matcher_dense"] = jax.jit(dense.apply)(params, *margs)
    ref["matcher_points"] = jax.jit(JaxGATsSPG(num_blocks=BLOCKS, match_threshold=0.0,
                                               fused_match=False, mesh=jmesh).apply)(params, *margs)
    ref["matcher_tp"] = jax.jit(dense.apply)(jax_shard_params(params, jax_tp_mesh(4)), *margs)
    sd = bridge.gats_spg_state_dict(jax.tree.map(np.asarray, params))

    prob = make_ba_problem(np.random.default_rng(0), n_pts=64, n_cams=5)
    cams0 = prob["cams0"].copy()
    cams0[0] = prob["cams_gt"][0]
    fix = np.zeros(5, np.float32)
    fix[0] = 1.0
    mask = np.ones(len(prob["pt_idx"]), bool)
    inputs.update(pts0=prob["pts0"].astype(np.float32), cams0=cams0.astype(np.float32), fix=fix)
    for n_shards in sorted({p for _, p in MESHES}):
        parts = jax_partition(64, n_shards, prob["features"], prob["pt_idx"], prob["cam_idx"],
                              mask)
        inputs.update({f"part{n_shards}_{k}": a
                       for k, a in zip(("feats", "pt", "cam", "mask"), parts)})
    parts4 = [jnp.asarray(inputs[f"part4_{k}"]) for k in ("feats", "pt", "cam", "mask")]
    for it in BA_ITERS:
        ref[f"ba_single_{it}"] = jax_ba_solve(
            *(jnp.asarray(x) for x in (prob["pts0"], cams0, prob["features"], prob["pt_idx"],
                                       prob["cam_idx"], mask)),
            fix_cam_mask=jnp.asarray(fix), n_iters=it)
        ref[f"ba_dist4_{it}"] = jax_dist_ba(jmesh, jnp.asarray(prob["pts0"]),
                                            jnp.asarray(cams0), *parts4,
                                            fix_cam_mask=jnp.asarray(fix), n_iters=it)
    ref = jax.tree.map(np.asarray, ref)

    # The matcher task reads its inputs without the "mi_" prefix.
    worker_inputs = dict(inputs, **mi)
    ranks = spawn("attention,matcher,ba,collectives", RANKS, tmp_path_factory.mktemp("ranks"),
                  worker_inputs,
                  options={"n_points": 4, "num_blocks": BLOCKS, "match_threshold": 0.0,
                           "meshes": MESHES, "tp": TP, "n_iters": BA_ITERS},
                  state_dicts={"matcher": sd})
    return {"inputs": inputs, "ref": ref, "ranks": ranks, "sd": sd}


def _got(world, key, rank=0):
    return world["ranks"][rank][key]


@pytest.mark.parametrize("case", ["plain", "masked_shard"])
@pytest.mark.parametrize("fn", ["linear", "ring", "linear_qkv", "ring_qkv"])
def test_sharded_attention_matches_jax(world, case, fn):
    got = _got(world, f"attention.{case}_{fn}")
    assert np.all(np.isfinite(got))
    np.testing.assert_allclose(got, world["ref"][f"{case}_{fn}"], atol=1e-5, rtol=0)


def test_sharded_dual_softmax_matches_jax(world):
    np.testing.assert_allclose(_got(world, "attention.dual_softmax"),
                               world["ref"]["dual_softmax"], atol=1e-5, rtol=0)


@pytest.mark.parametrize("tag", [f"points{d}x{p}{k}" for d, p in MESHES
                                 for k in ("", "_gats_kernel")])
def test_points_sharded_matcher_matches_jax(world, tag):
    ref = world["ref"]["matcher_points"]
    conf = _got(world, f"matcher.{tag}_conf_matrix")
    np.testing.assert_allclose(conf, ref["conf_matrix"], atol=1e-5, rtol=0)
    for k in ("matches0", "matches1"):
        np.testing.assert_array_equal(_got(world, f"matcher.{tag}_{k}"), ref[k])
    assert (ref["matches0"] >= 0).sum() > 10
    # The dense model of the port on the same rank agrees too.
    np.testing.assert_allclose(conf, _got(world, "matcher.dense_conf_matrix"), atol=1e-5, rtol=0)


@pytest.mark.parametrize("n_model", TP)
def test_tp_matcher_matches_dense(world, n_model):
    conf = _got(world, f"matcher.tp{n_model}_conf_matrix")
    np.testing.assert_allclose(conf, world["ref"]["matcher_dense"]["conf_matrix"], atol=1e-5,
                               rtol=0)
    np.testing.assert_allclose(conf, world["ref"]["matcher_tp"]["conf_matrix"], atol=1e-5,
                               rtol=0)
    np.testing.assert_allclose(conf, _got(world, "matcher.dense_conf_matrix"), atol=1e-5, rtol=0)


@pytest.mark.parametrize("n_iters", BA_ITERS)
@pytest.mark.parametrize("mesh", [f"{d}x{p}" for d, p in MESHES])
def test_distributed_ba_matches_single_device(world, mesh, n_iters):
    """Costs within 1e-5 of single-device ba_solve's, relative to the
    problem's cost (the initial cost, 2.5e4): the cost after a step is
    what is left of it after a cancellation (8.9 after one step, about 3e-8
    at fp32's floor after ten), whose absolute rounding follows the initial
    cost. Points and cameras within 1e-4."""
    single, dist4 = world["ref"][f"ba_single_{n_iters}"], world["ref"][f"ba_dist4_{n_iters}"]
    got = {k: _got(world, f"ba.{mesh}_{n_iters}_{k}")
           for k in ("cost_initial", "cost_final", "points", "cam_poses")}
    scale = float(single["cost_initial"])
    for k in ("cost_initial", "cost_final"):
        np.testing.assert_allclose(got[k], single[k], atol=1e-5 * scale, rtol=0)
    assert got["cost_final"] < got["cost_initial"] * 1e-3
    for k in ("points", "cam_poses"):
        np.testing.assert_allclose(got[k], single[k], atol=1e-4)
        np.testing.assert_allclose(got[k], dist4[k], atol=1e-4)


def test_every_rank_returns_the_same(world):
    """Every rank holds the same whole outputs: bit for bit where they come
    from all-reduced sums, within 1e-6 for the ring, whose ranks merge the
    blocks in their own order."""
    r0 = world["ranks"][0]
    for r in range(1, RANKS):
        for k, v in world["ranks"][r].items():
            if "_ring" in k:
                np.testing.assert_allclose(v, r0[k], atol=1e-6, rtol=0, err_msg=f"rank {r} {k}")
            elif k.startswith(("attention.", "matcher.", "ba.")):
                np.testing.assert_array_equal(v, r0[k], err_msg=f"rank {r} {k}")


def test_collectives(world):
    for r in range(RANKS):
        got = world["ranks"][r]
        np.testing.assert_array_equal(got["collectives.gather_a"],
                                      np.arange(RANKS)[:, None, None] * np.ones((1, 2, 3)))
        np.testing.assert_array_equal(got["collectives.gather_b0"], 10 * np.arange(RANKS))
        np.testing.assert_array_equal(got["collectives.gather_b1"],
                                      np.stack([np.arange(RANKS), -np.arange(RANKS)], 1))
        assert str(got["collectives.gather_a_dtype"]) == "float32"
        assert float(got["collectives.reduce_mean"]) == pytest.approx(2.5)
        assert float(got["collectives.reduce_sum"]) == pytest.approx(10.0)
        assert bool(got["collectives.is_main"]) == (r == 0)
        np.testing.assert_array_equal(got["collectives.shard_batch"],
                                      np.arange(4 * RANKS).reshape(2 * RANKS, 2)[2 * r:2 * r + 2])
        np.testing.assert_array_equal(got["collectives.replicated"], np.zeros(3))


def test_resolve_sfm_mesh_over_ranks(world):
    """False / None / 0 / 1 give no mesh; True and an int above the world
    give a mesh over every rank; a count between 1 and the world raises
    (ADVICE.md's multi-host fault: a mesh that leaves ranks out)."""
    for r in range(RANKS):
        got = world["ranks"][r]
        assert got["collectives.resolve_none"].all()
        np.testing.assert_array_equal(got["collectives.resolve_shapes"], [[RANKS, 1]] * 2)
        assert "must span every rank" in str(got["collectives.resolve_partial_raised"])


# --- in one process -------------------------------------------------------

def test_one_process_mesh_is_the_identity():
    """Without a process group the mesh is 1 x 1 and every sharded function
    equals its dense counterpart."""
    from onepose_tpu_torch.models.common import masked_linear_attention, masked_softmax_attention

    mesh = port_mesh.make_mesh(device="cpu")
    assert mesh.shape == (1, 1) and mesh.group("points") is None
    rng = np.random.default_rng(5)
    q, k, v, mask = (torch.from_numpy(x) for x in _qkv(rng, True))
    torch.testing.assert_close(sharded_linear_attention(mesh, q, k, v, mask, v_length=M),
                               masked_linear_attention(q, k, v, mask), atol=1e-5, rtol=0)
    torch.testing.assert_close(ring_softmax_attention(mesh, q, k, v, mask),
                               masked_softmax_attention(q, k, v, mask), atol=1e-5, rtol=0)
    s = torch.randn(B, 12, M)
    m2 = torch.ones(B, 12, dtype=torch.bool)
    conf = sharded_dual_softmax(mesh, s, m2, mask)
    sm = s.masked_fill(~mask[:, None, :], -1e9)
    torch.testing.assert_close(conf, sm.softmax(1) * sm.softmax(2), atol=1e-6, rtol=0)
    with pytest.raises(ValueError, match="every rank"):
        port_mesh.make_mesh(n_data=2, device="cpu")


@pytest.mark.parametrize("case", sorted(SINGULAR_BA))
def test_distributed_ba_on_a_singular_system_matches_jax(case):
    """tests/test_torch_lm.py's singular windows through distributed_ba_solve
    on a one-process mesh against JAX's on one device: no raise, both
    steps rejected, costs within fp32 rounding."""
    pts, cams, feats, pt_idx, cam_idx, mask = singular_ba_args(case)
    parts = jax_partition(1, 1, feats, pt_idx, cam_idx, mask)
    jmesh = jax_make_mesh(n_data=1, n_points=1, devices=jax.devices()[:1])
    want = jax_dist_ba(jmesh, jnp.asarray(pts), jnp.asarray(cams), *map(jnp.asarray, parts),
                       n_iters=2, init_lambda=1e-9)
    got = distributed_ba.distributed_ba_solve(
        port_mesh.make_mesh(device="cpu"), torch.from_numpy(pts), torch.from_numpy(cams),
        *(torch.from_numpy(np.asarray(a)) for a in parts), n_iters=2, init_lambda=1e-9)
    for k in ("points", "cam_poses"):
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]), err_msg=k)
    for k in ("cost_initial", "cost_final"):
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]), rtol=1e-6, err_msg=k)


def test_tp_specs_split_attention_and_mlp():
    sd = GATsSPG(num_blocks=1).state_dict()
    specs = tensor_parallel.gats_spg_tp_specs(sd)
    A = tensor_parallel.MODEL_AXIS
    assert specs["self_0.attn.proj_q.weight"] == (A, None)
    assert specs["self_0.attn.proj_q.bias"] == (A,)
    assert specs["self_0.attn.merge.weight"] == (None, A)
    assert specs["self_0.attn.merge.bias"] == (None,)
    assert specs["cross_0.mlp.dense_0.weight"] == (A, None)
    assert specs["cross_0.mlp.dense_1.weight"] == (None, A)
    assert specs["final_proj.weight"] == (None, None)
    assert specs["gats_0.W"] == (None, None)


def test_tp_and_points_mesh_reject_what_they_cannot_split():
    mesh = port_mesh.make_mesh(device="cpu")
    with pytest.raises(ValueError, match="fused"):
        GATsSPG(mesh=mesh, fused_match=True)
    with pytest.raises(ValueError, match="fused"):
        GATsSPG(mesh=mesh, block_fused=True)
    tp_mesh = tensor_parallel.make_tp_mesh(1, device="cpu")
    tp_mesh.shape = (1, 3)  # a model axis of 3 cannot split 4 heads
    with pytest.raises(ValueError, match="divide"):
        tensor_parallel.shard_params(GATsSPG(num_blocks=1), tp_mesh)
    with pytest.raises(ValueError, match="block_fused"):
        tensor_parallel.shard_params(GATsSPG(num_blocks=1, block_fused=True),
                                     tensor_parallel.make_tp_mesh(1, device="cpu"))


def test_partition_covers_all_observations():
    rng = np.random.default_rng(1)
    prob = make_ba_problem(rng, n_pts=32, n_cams=3)
    mask = rng.random(len(prob["pt_idx"])) > 0.2
    got = distributed_ba.partition_obs_by_point(32, 4, prob["features"], prob["pt_idx"],
                                                prob["cam_idx"], mask)
    want = jax_partition(32, 4, prob["features"], prob["pt_idx"], prob["cam_idx"], mask)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    with pytest.raises(ValueError, match="divide"):
        distributed_ba.partition_obs_by_point(30, 4, prob["features"], prob["pt_idx"],
                                              prob["cam_idx"], mask)


@pytest.fixture(scope="module")
def stage_setup():
    from onepose_tpu_torch.runtime.pipeline import ObjectAnnotation, PosePipeline

    torch.manual_seed(0)
    rng = np.random.default_rng(0)
    b, img, nk, n3, lv = 2, 64, 64, 32, 4
    pipe = PosePipeline(max_keypoints=nk, compute_dtype=torch.float32, ransac_hypotheses=32,
                        device="cpu")
    pipe.matcher.match_threshold = 0.0

    def unit(x):
        return (x / np.linalg.norm(x, axis=-1, keepdims=True)).astype(np.float32)

    anno = ObjectAnnotation(
        points3d=torch.from_numpy((rng.normal(size=(n3, 3)) * 0.1).astype(np.float32)),
        desc3d=torch.from_numpy(unit(rng.normal(size=(n3, 256)))),
        leaf_desc=torch.from_numpy(unit(rng.normal(size=(n3, lv, 256)))),
        mask3d=torch.ones(n3, dtype=torch.bool), leaf_mask=torch.ones(n3, lv, dtype=torch.bool))
    images = [torch.from_numpy(rng.random((b, img, img, 1), np.float32)) for _ in range(3)]
    K = torch.tensor([[60.0, 0, 32], [0, 60.0, 32], [0, 0, 1]]).expand(b, 3, 3)
    draws = [torch.from_numpy(rng.random((b, 32, 3)).astype(np.float32)) for _ in range(3)]
    return pipe, anno, images, K, draws


@pytest.mark.parametrize("devices", [None, ["cpu", "cpu", "cpu"]])
def test_stage_pipeline_matches_pose_pipeline(stage_setup, devices):
    pipe, anno, images, K, draws = stage_setup
    stages = StagePipeline(pipe, anno, devices=devices)
    assert len(stages.devices) == 3 and stages.streams == [None] * 3
    outs = stages.run(images, [K] * 3, draws=draws)
    assert len(outs) == 3
    for img, dr, out in zip(images, draws, outs):
        want = pipe(img, K, anno, draws=dr)
        for k in ("pose", "num_inliers", "pnp_ok", "matches0"):
            torch.testing.assert_close(out[k], want[k if k != "pnp_ok" else "pnp_ok"],
                                       atol=0, rtol=0)
    assert (outs[0]["matches0"] >= 0).any()
