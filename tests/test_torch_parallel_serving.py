"""Serving and `map`'s front end over 2 gloo ranks on the CPU, against the
same calls in one process and against the JAX package on its CPU mesh.

- `PosePipeline.sharded` over a mesh of both ranks (each rank serves 2 of
  4 frames at 64 x 64, 64 keypoint slots, 32 3D points x 4 leaves, 2
  blocks, 32 hypotheses), fp32 (NMS, GATs and dual-softmax kernels: their
  plain versions on the CPU) and bf16 (NMS, VGG stage, fused block, dual
  softmax), with a single-object and a batched annotation: every rank
  returns the whole batch, equal to `__call__` on it; fp32 also against
  JAX's `sharded` over 2 devices with JAX's draws injected.
- Pair matching over the data axis (NN and SuperGlue, an odd pair count,
  chunk 3 rounded to 4): identical matches to one process and to JAX's
  matchers over an 8-device mesh.
- SuperPoint extraction over the mesh (batch 3 rounded to 4): identical
  keypoints and masks, descriptors and scores within 1e-5, against one
  process and JAX's.
- run_mapping with global BA (points, then points and cameras) over both
  ranks (distributed BA, the points padded to the shard count) against one
  process: map points and refined poses within 1e-4, RMSEs within 1e-4 px.
- train's pose validation (`make_pose_val_fn`) over both ranks, each a
  strided share of 5 planted items (one with a wrong ground truth): the
  metrics of one process, exactly (the JAX package's cross-process
  aggregation, tests/test_multiprocess.py).

Tolerances on the sharded call against the whole batch: exact where a
frame's program is the same (fp32 on the CPU), 1e-5 on bf16 descriptors
and poses (a batch of 2 against 4 may round a bf16 convolution another
way).
"""

from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_cli import build_sequence
from test_torch_sfm import make_scene, nn_pair_matcher

from onepose_tpu.cli.common import extract_sequence_features as jax_extract
from onepose_tpu.models import SuperGlue as JaxSuperGlue
from onepose_tpu.models.gats_spg import GATsSPG as JaxGATsSPG
from onepose_tpu.models.superpoint import SuperPoint as JaxSuperPoint
from onepose_tpu.parallel import sfm_parallel as jax_sfm
from onepose_tpu.parallel.mesh import make_mesh as jax_make_mesh
from onepose_tpu.runtime.pipeline import ObjectAnnotation as JaxAnno
from onepose_tpu.runtime.pipeline import PosePipeline as JaxPipeline
from onepose_tpu.sfm.mapping import MappingConfig as JaxMappingConfig
from onepose_tpu.sfm.mapping import run_mapping as jax_run_mapping
from onepose_tpu_torch.models import bridge
from torch_ranks import spawn

torch.set_num_threads(2)

RANKS = 2
B, S, KPTS, N3, L, BLOCKS, HYP, THR = 4, 64, 64, 32, 4, 2, 32, 0.02
FIELDS = ("points3d", "desc3d", "leaf_desc", "mask3d", "leaf_mask")


def _anno(rng, c=256):
    def unit(x):
        return (x / np.linalg.norm(x, axis=-1, keepdims=True)).astype(np.float32)

    mask3d = np.ones(N3, bool)
    mask3d[-4:] = False
    return dict(points3d=((rng.random((N3, 3)) - 0.5) * 0.2).astype(np.float32),
                desc3d=unit(rng.normal(size=(N3, c))), leaf_desc=unit(rng.normal(size=(N3, L, c))),
                mask3d=mask3d, leaf_mask=rng.random((N3, L)) < 0.8)


def _random_feats(rng, F=8, N=32, C=256, hw=(96, 96)):
    desc = rng.normal(size=(F, N, C)).astype(np.float32)
    desc /= np.linalg.norm(desc, axis=-1, keepdims=True)
    desc[3, :16] = desc[1, 8:24]  # planted pairs
    n_valid = rng.integers(N // 2, N + 1, size=F)
    return {"keypoints": rng.uniform(0, hw[0], size=(F, N, 2)).astype(np.float32),
            "descriptors": desc, "scores": rng.random((F, N)).astype(np.float32),
            "mask": np.arange(N)[None] < n_valid[:, None], "image_hw": hw}


def _val_items(rng, n=5):
    """Planted validation items: keypoints the exact projections of their
    points under a known pose; item 3's ground truth is off by 10 cm."""
    K = np.array([[500.0, 0, 256], [0, 500.0, 256], [0, 0, 1]], np.float32)
    items = []
    for i in range(n):
        xyz = (rng.random((40, 3)) - 0.5).astype(np.float32) * 0.2
        pose = np.eye(4, dtype=np.float32)
        pose[:3, 3] = [0.01 * i, -0.02, 0.8]
        uv = (xyz + pose[:3, 3]) @ K.T
        gt = pose.copy()
        if i == 3:
            gt[2, 3] += 0.1
        mask = np.ones(40, bool)
        mask[30:] = False
        items.append({"desc2d": np.zeros((40, 8), np.float32),
                      "desc3d": np.zeros((40, 8), np.float32),
                      "leaf_desc": np.zeros((40, 2, 8), np.float32), "mask2d": mask,
                      "mask3d": np.ones(40, bool), "leaf_mask": np.ones((40, 2), bool),
                      "kpts2d": (uv[:, :2] / uv[:, 2:]).astype(np.float32), "points3d": xyz,
                      "pose_gt": gt, "K": K})
    return items


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    root = tmp_path_factory.mktemp("serving")
    rng = np.random.default_rng(0)
    images = rng.random((B, S, S, 1)).astype(np.float32)
    K = np.broadcast_to(np.array([[60.0, 0, 32], [0, 60.0, 32], [0, 0, 1]], np.float32),
                        (B, 3, 3)).copy()
    anno, anno2 = _anno(rng), _anno(rng)
    jax_anno = JaxAnno(**{k: jnp.asarray(v) for k, v in anno.items()})
    sp_params = JaxSuperPoint().init(jax.random.PRNGKey(0), jnp.asarray(images[:1]))
    m_params = JaxGATsSPG(num_blocks=BLOCKS).init(
        jax.random.PRNGKey(1), jnp.zeros((1, KPTS, 256)), jax_anno.desc3d[None],
        jax_anno.leaf_desc[None])
    key = jax.random.PRNGKey(5)
    draws = np.stack([np.asarray(jax.random.uniform(k, (HYP, 3)))
                      for k in jax.random.split(key, B)])
    jax_pipe = JaxPipeline(JaxSuperPoint(nms_pallas=True),
                           JaxGATsSPG(num_blocks=BLOCKS, gats_use_pallas=True, fused_match=True,
                                      match_threshold=THR),
                           max_keypoints=KPTS, ransac_hypotheses=HYP, compute_dtype=jnp.float32)
    jmesh = jax_make_mesh(n_data=RANKS, devices=jax.devices()[:RANKS])
    ref = {"serving": jax.tree.map(np.asarray, jax_pipe.sharded(jmesh)(
        sp_params, m_params, jnp.asarray(images), jnp.asarray(K), jax_anno, key))}

    feats = _random_feats(rng)
    pairs = np.asarray([(0, 1), (1, 3), (2, 5), (3, 1), (4, 6), (7, 2), (5, 0)])
    mesh8 = jax_make_mesh(n_data=8, n_points=1)
    ref["nn"] = jax_sfm.make_nn_pair_matcher(feats["descriptors"], feats["mask"], mesh=mesh8,
                                             pair_chunk=3)(pairs)
    sg = JaxSuperGlue(num_layers=2, sinkhorn_iterations=10, match_threshold=0.0)
    n = feats["keypoints"].shape[1]
    sg_params = sg.init(jax.random.PRNGKey(0), jnp.zeros((1, n, 2)), jnp.zeros((1, n, 2)),
                        jnp.zeros((1, n, 256)), jnp.zeros((1, n, 256)), jnp.zeros((1, n)),
                        jnp.zeros((1, n)), feats["image_hw"], feats["image_hw"])
    ref["sg"] = jax_sfm.make_superglue_pair_matcher(sg, sg_params, feats, mesh=mesh8,
                                                    pair_chunk=3)(pairs)

    seq = build_sequence(root, np.random.default_rng(3), n_frames=5, img=96, n_pts=40)
    ref["extract"] = jax_extract(str(seq), sp_params, JaxSuperPoint(), max_keypoints=64,
                                 batch=3, mesh=mesh8)

    scene = make_scene(np.random.default_rng(42), n_frames=8, n_pts=120)
    ref["map"] = {}
    for cams in (False, True):
        res = jax_run_mapping(
            scene["keypoints"], scene["descriptors"], scene["scores"], scene["mask"],
            scene["K"], scene["poses"], nn_pair_matcher(scene),
            config=JaxMappingConfig(global_ba=True, global_ba_iters=5,
                                    global_ba_refine_cameras=cams,
                                    mesh=jax_make_mesh(n_data=1, n_points=RANKS,
                                                       devices=jax.devices()[:RANKS])))
        ref["map"][cams] = res

    inputs = {"images": images, "K": K, "draws": draws.astype(np.float32), "pairs": pairs}
    items = _val_items(np.random.default_rng(13))
    for i, item in enumerate(items):
        inputs.update({f"val{i}_{k}": v for k, v in item.items()})
    inputs["val_n"] = np.asarray(len(items))
    inputs.update({f"anno_{k}": v for k, v in anno.items()})
    inputs.update({f"anno2_{k}": v for k, v in anno2.items()})
    inputs.update({f"pf_{k}": np.asarray(v) for k, v in feats.items()})
    inputs.update({f"scene_{k}": scene[k] for k in ("keypoints", "descriptors", "scores",
                                                     "mask", "K", "poses")})
    sds = {"superpoint": bridge.superpoint_state_dict(jax.tree.map(np.asarray, sp_params)),
           "matcher": bridge.gats_spg_state_dict(jax.tree.map(np.asarray, m_params)),
           "superglue": bridge.superglue_state_dict(jax.tree.map(np.asarray, sg_params))}
    from torch_rank_worker import IdentityMatcher

    from onepose_tpu_torch.train.loop import make_pose_val_fn

    model = IdentityMatcher()
    ref["validation"] = make_pose_val_fn(items, model, n_hyp=64)(SimpleNamespace(model=model))
    ranks = spawn("serving,sfm,validation", RANKS, root, inputs,
                  options={"num_blocks": BLOCKS, "match_threshold": THR, "max_keypoints": KPTS,
                           "n_hyp": HYP, "seq": str(seq)},
                  state_dicts=sds)
    return {"ref": ref, "ranks": ranks, "scene": scene}


@pytest.mark.parametrize("anno", ["single", "batched"])
@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
def test_sharded_serving_matches_whole_batch(world, dtype, anno):
    for got in world["ranks"]:
        pre = f"serving.{dtype}_{anno}"
        for k in ("num_inliers", "pnp_ok", "matches0", "keypoints"):
            np.testing.assert_array_equal(got[f"{pre}_sharded_{k}"], got[f"{pre}_whole_{k}"],
                                          err_msg=k)
        atol = 0 if dtype == "fp32" else 1e-5
        for k in ("descriptors", "pose"):
            np.testing.assert_allclose(got[f"{pre}_sharded_{k}"], got[f"{pre}_whole_{k}"],
                                       atol=atol, rtol=0, err_msg=k)
        assert got[f"{pre}_sharded_pose"].shape == (B, 4, 4)


def test_sharded_serving_matches_jax_sharded(world):
    want = world["ref"]["serving"]
    for got in world["ranks"]:
        g = {k: got[f"serving.fp32_single_sharded_{k}"] for k in
             ("num_inliers", "pnp_ok", "matches0", "keypoints", "pose")}
        for k in ("num_inliers", "pnp_ok", "matches0", "keypoints"):
            np.testing.assert_array_equal(g[k], np.asarray(want[k]).astype(np.float32),
                                          err_msg=k)
        ok = g["pnp_ok"].astype(bool)
        np.testing.assert_allclose(g["pose"][ok], want["pose"][ok], atol=1e-4)
        assert (g["matches0"] >= 0).sum() > 0


def test_sharded_serving_checks_the_batch(world):
    assert "must divide the data axis" in str(world["ranks"][0]["serving.odd_batch_raised"])


@pytest.mark.parametrize("matcher", ["nn", "sg"])
def test_pair_matching_over_ranks_matches_one_process_and_jax(world, matcher):
    for got in world["ranks"]:
        np.testing.assert_array_equal(got[f"sfm.{matcher}_mesh"], got[f"sfm.{matcher}_single"])
        np.testing.assert_array_equal(got[f"sfm.{matcher}_mesh"], world["ref"][matcher])
        assert (got[f"sfm.{matcher}_mesh"] >= 0).sum() > 0


def test_extraction_over_ranks_matches_one_process_and_jax(world):
    want = world["ref"]["extract"]
    for got in world["ranks"]:
        for k in ("keypoints", "mask"):
            np.testing.assert_array_equal(got[f"sfm.extract_mesh_{k}"],
                                          got[f"sfm.extract_single_{k}"], err_msg=k)
            np.testing.assert_array_equal(got[f"sfm.extract_mesh_{k}"], want[k], err_msg=k)
        for k in ("descriptors", "scores"):
            np.testing.assert_allclose(got[f"sfm.extract_mesh_{k}"], want[k], atol=1e-5,
                                       rtol=0, err_msg=k)
        assert got["sfm.extract_mesh_mask"].shape[0] == 5


@pytest.mark.parametrize("cams", [False, True])
def test_global_ba_over_ranks_matches_one_process_and_jax(world, cams):
    c = "cams" if cams else "pts"
    want = world["ref"]["map"][cams]
    for got in world["ranks"]:
        mesh_pts, single_pts = got[f"sfm.map_mesh_{c}_points"], got[f"sfm.map_single_{c}_points"]
        assert mesh_pts.shape == single_pts.shape == want.points_xyz.shape
        np.testing.assert_allclose(mesh_pts, single_pts, atol=1e-4)
        np.testing.assert_allclose(mesh_pts, want.points_xyz, atol=1e-4)
        rmse = got[f"sfm.map_mesh_{c}_rmse"]
        np.testing.assert_allclose(rmse, got[f"sfm.map_single_{c}_rmse"], atol=1e-4)
        np.testing.assert_allclose(rmse, [want.stats["global_ba_rmse_initial_px"],
                                          want.stats["global_ba_rmse_final_px"]], atol=1e-4)
        if cams:
            np.testing.assert_allclose(got[f"sfm.map_mesh_{c}_poses"], want.refined_poses,
                                       atol=1e-4)


def test_validation_over_ranks_matches_one_process(world):
    want = world["ref"]["validation"]
    assert want["val_num_frames"] == 5 and want["val_cmd1"] == pytest.approx(0.8)
    for got in world["ranks"]:
        assert {k[len("validation."):] for k in got if k.startswith("validation.")} == set(want)
        for k, v in want.items():
            assert float(got[f"validation.{k}"]) == pytest.approx(v, abs=1e-9), k
