"""The rank program of the port's multi-rank tests on the CPU.

Run by `tests/torch_ranks.py::spawn` under torchrun
(`python -m torch.distributed.run --standalone --nproc-per-node N
tests/torch_rank_worker.py TASKS IN_DIR OUT_DIR`): each rank joins the gloo
group, runs each task of the comma-separated TASKS on the arrays of
IN_DIR/inputs.npz (and the options of IN_DIR/options.json, the
state_dicts of IN_DIR/*.pt), and writes the results to
OUT_DIR/rank<r>.npz as "<task>.<name>". The tests hold them against the JAX
package and against the port in one process. Imports torch and the port
only.
"""

from __future__ import annotations

import json
import os
import os.path as osp
import sys

import numpy as np
import torch

TASKS = {}


def task(fn):
    TASKS[fn.__name__] = fn
    return fn


def _t(x):
    return torch.from_numpy(np.asarray(x))


@task
def attention(d: dict, opt: dict) -> dict:
    """The three sharded-attention functions over make_mesh(n_points=W)."""
    from onepose_tpu_torch.parallel.mesh import POINTS_AXIS, gather, make_mesh, shard
    from onepose_tpu_torch.parallel.sharded_attention import (
        ring_softmax_attention,
        sharded_dual_softmax,
        sharded_linear_attention,
    )

    mesh = make_mesh(n_points=opt["n_points"], device="cpu")
    pts = (None, POINTS_AXIS)
    out = {}
    for name in ("plain", "masked_shard"):
        q, k, v, m = (_t(d[f"{name}_{x}"]) for x in ("q", "k", "v", "mask"))
        kl, vl, ml = (shard(mesh, x, pts) for x in (k, v, m))
        out[f"{name}_linear"] = sharded_linear_attention(mesh, q, kl, vl, ml, v_length=k.shape[1])
        out[f"{name}_ring"] = ring_softmax_attention(mesh, q, kl, vl, ml)
        # Queries from the sharded point set itself ("qkv").
        ql = shard(mesh, k, pts)
        out[f"{name}_linear_qkv"] = gather(mesh, sharded_linear_attention(
            mesh, ql, kl, vl, ml, v_length=k.shape[1]), pts)
        out[f"{name}_ring_qkv"] = gather(mesh, ring_softmax_attention(mesh, ql, kl, vl, ml), pts)
    s, m2, m3 = _t(d["scores"]), _t(d["ds_m2"]), _t(d["ds_m3"])
    spec = (None, None, POINTS_AXIS)
    conf = sharded_dual_softmax(mesh, shard(mesh, s, spec), m2, shard(mesh, m3, pts))
    out["dual_softmax"] = gather(mesh, conf, spec)
    return {k: v.numpy() for k, v in out.items()}


def _matcher(opt: dict, sd_path: str, **kw):
    from onepose_tpu_torch.models.gats_spg import GATsSPG

    model = GATsSPG(num_blocks=opt["num_blocks"], match_threshold=opt["match_threshold"], **kw)
    model.load_state_dict(torch.load(sd_path))
    return model.eval()


@task
def matcher(d: dict, opt: dict) -> dict:
    """The points-sharded matcher (over each mesh of opt["meshes"]) and the
    tensor-parallel matcher (over each of opt["tp"]), against the dense
    matcher on the same rank."""
    from onepose_tpu_torch.parallel.mesh import make_mesh
    from onepose_tpu_torch.parallel.tensor_parallel import make_tp_mesh, shard_params

    args = [_t(d[k]) for k in ("d2", "d3", "leaves", "m2", "m3", "lm")]
    sd = osp.join(opt["in_dir"], "matcher.pt")
    out = {}

    def run(tag, model):
        with torch.inference_mode():
            o = model(*args)
        for k in ("conf_matrix", "matches0", "matches1", "matching_scores0"):
            out[f"{tag}_{k}"] = o[k].numpy()

    run("dense", _matcher(opt, sd))
    for n_data, n_points in opt["meshes"]:
        mesh = make_mesh(n_data=n_data, n_points=n_points, device="cpu")
        run(f"points{n_data}x{n_points}", _matcher(opt, sd, mesh=mesh))
        run(f"points{n_data}x{n_points}_gats_kernel", _matcher(opt, sd, mesh=mesh,
                                                               gats_kernel=True))
    for n_model in opt["tp"]:
        run(f"tp{n_model}", shard_params(_matcher(opt, sd), make_tp_mesh(n_model, device="cpu")))
    return out


@task
def ba(d: dict, opt: dict) -> dict:
    """distributed_ba_solve over the points axis of each mesh in
    opt["meshes"] (the partition of each shard count is an input)."""
    from onepose_tpu_torch.parallel.distributed_ba import distributed_ba_solve
    from onepose_tpu_torch.parallel.mesh import make_mesh

    out = {}
    for n_data, n_points in opt["meshes"]:
        mesh = make_mesh(n_data=n_data, n_points=n_points, device="cpu")
        p = f"part{n_points}_"
        for n_iters in opt["n_iters"]:
            res = distributed_ba_solve(
                mesh, _t(d["pts0"]), _t(d["cams0"]),
                *(_t(d[p + k]) for k in ("feats", "pt", "cam", "mask")),
                fix_cam_mask=_t(d["fix"]), n_iters=n_iters)
            for k, v in res.items():
                out[f"{n_data}x{n_points}_{n_iters}_{k}"] = v.numpy()
    return out


@task
def collectives(d: dict, opt: dict) -> dict:
    """utils.comm and parallel.mesh's helpers, and resolve_sfm_mesh over the
    ranks."""
    from onepose_tpu_torch.parallel.mesh import make_mesh, replicate_pytree, shard_batch
    from onepose_tpu_torch.parallel.sfm_parallel import resolve_sfm_mesh
    from onepose_tpu_torch.utils import comm

    r, w = comm.get_rank(), comm.get_world_size()
    tree = {"a": np.full((2, 3), r, np.float32), "b": [np.int64(10 * r), torch.tensor([r, -r])]}
    gathered = comm.all_gather_pytree(tree)
    out = {
        "gather_a": np.stack([g["a"] for g in gathered]),
        "gather_b0": np.asarray([g["b"][0] for g in gathered]),
        "gather_b1": torch.stack([g["b"][1] for g in gathered]).numpy(),
        "gather_a_dtype": np.asarray(str(gathered[0]["a"].dtype)),
        "reduce_mean": np.asarray(comm.reduce_dict({"x": r + 1.0})["x"]),
        "reduce_sum": np.asarray(comm.reduce_dict({"x": r + 1.0}, average=False)["x"]),
        "is_main": np.asarray(comm.is_main_process()),
    }
    comm.synchronize()
    mesh = make_mesh(device="cpu")
    batch = shard_batch(mesh, {"x": np.arange(4 * w).reshape(2 * w, 2)})
    out["shard_batch"] = batch["x"].numpy()
    rep = replicate_pytree(mesh, {"y": torch.full((3,), float(r))})
    out["replicated"] = rep["y"].numpy()
    out["resolve_none"] = np.asarray([resolve_sfm_mesh(v) is None for v in (False, None, 0, 1)])
    m_true, m_big = resolve_sfm_mesh(True, device="cpu"), resolve_sfm_mesh(w + 3, device="cpu")
    out["resolve_shapes"] = np.asarray([m_true.shape, m_big.shape])
    try:
        resolve_sfm_mesh(w - 1, device="cpu")
        out["resolve_partial_raised"] = np.asarray("")
    except ValueError as e:
        out["resolve_partial_raised"] = np.asarray(str(e))
    return out


def _pipeline(opt: dict, dtype):
    from onepose_tpu_torch.models.gats_spg import GATsSPG
    from onepose_tpu_torch.models.superpoint import SuperPoint
    from onepose_tpu_torch.runtime.pipeline import PosePipeline

    bf16 = dtype == torch.bfloat16
    sp = SuperPoint(nms_kernel=True, vgg_kernel=bf16, dtype=dtype)
    sp.load_state_dict(torch.load(osp.join(opt["in_dir"], "superpoint.pt")))
    gm = GATsSPG(num_blocks=opt["num_blocks"], match_threshold=opt["match_threshold"],
                 gats_kernel=not bf16, block_fused=bf16, fused_match=True, dtype=dtype)
    gm.load_state_dict(torch.load(osp.join(opt["in_dir"], "matcher.pt")))
    return PosePipeline(sp, gm, max_keypoints=opt["max_keypoints"],
                        ransac_hypotheses=opt["n_hyp"], device="cpu")


@task
def serving(d: dict, opt: dict) -> dict:
    """PosePipeline.sharded over every rank against __call__ on the whole
    batch, fp32 and bf16, single-object and batched annotations."""
    from onepose_tpu_torch.parallel.mesh import make_mesh
    from onepose_tpu_torch.runtime.pipeline import ObjectAnnotation, stack_annotations

    mesh = make_mesh(device="cpu")
    fields = ("points3d", "desc3d", "leaf_desc", "mask3d", "leaf_mask")
    anno = ObjectAnnotation(**{k: _t(d[f"anno_{k}"]) for k in fields})
    batched = stack_annotations([anno] * (len(d["images"]) - 1) + [
        ObjectAnnotation(**{k: _t(d[f"anno2_{k}"]) for k in fields})])
    images, K, draws = _t(d["images"]), _t(d["K"]), _t(d["draws"])
    out = {}
    for tag, dtype in (("fp32", torch.float32), ("bf16", torch.bfloat16)):
        pipe = _pipeline(opt, dtype)
        run = pipe.sharded(mesh)
        for a_tag, a in (("single", anno), ("batched", batched)):
            whole = pipe(images, K, a, draws=draws)
            sharded = run(images, K, a, draws=draws)
            for k in ("pose", "num_inliers", "pnp_ok", "matches0", "keypoints", "descriptors"):
                out[f"{tag}_{a_tag}_whole_{k}"] = whole[k].float().numpy()
                out[f"{tag}_{a_tag}_sharded_{k}"] = sharded[k].float().numpy()
    try:
        run(images[:3], K[:3], anno, draws=draws[:3])
        out["odd_batch_raised"] = np.asarray("")
    except ValueError as e:
        out["odd_batch_raised"] = np.asarray(str(e))
    return out


@task
def sfm(d: dict, opt: dict) -> dict:
    """map's front end and global BA over a mesh of every rank, against the
    same calls without one: pair matching (NN, SuperGlue), SuperPoint
    extraction over a sequence, run_mapping with global BA."""
    from onepose_tpu_torch.cli.common import extract_sequence_features
    from onepose_tpu_torch.models.superglue import SuperGlue
    from onepose_tpu_torch.models.superpoint import SuperPoint
    from onepose_tpu_torch.parallel.mesh import make_mesh
    from onepose_tpu_torch.parallel.sfm_parallel import (
        make_nn_pair_matcher,
        make_superglue_pair_matcher,
    )
    from onepose_tpu_torch.sfm.mapping import MappingConfig, run_mapping

    mesh = make_mesh(device="cpu")
    out = {}
    feats = {k: d[f"pf_{k}"] for k in ("keypoints", "descriptors", "scores", "mask")}
    feats["image_hw"] = tuple(int(x) for x in d["pf_image_hw"])
    pairs = d["pairs"]
    for tag, m in (("single", None), ("mesh", mesh)):
        out[f"nn_{tag}"] = make_nn_pair_matcher(feats["descriptors"], feats["mask"], mesh=m,
                                                pair_chunk=3, device="cpu")(pairs)
        sg = SuperGlue(num_layers=2, sinkhorn_iterations=10, match_threshold=0.0)
        sg.load_state_dict(torch.load(osp.join(opt["in_dir"], "superglue.pt")))
        out[f"sg_{tag}"] = make_superglue_pair_matcher(sg, feats, mesh=m, pair_chunk=3,
                                                       device="cpu")(pairs)
        sp = SuperPoint()
        ex = extract_sequence_features(opt["seq"], torch.load(osp.join(opt["in_dir"],
                                                                       "superpoint.pt")),
                                       sp, max_keypoints=64, batch=3, mesh=m, device="cpu")
        for k in ("keypoints", "descriptors", "scores", "mask"):
            out[f"extract_{tag}_{k}"] = ex[k]
        scene = {k: d[f"scene_{k}"] for k in ("keypoints", "descriptors", "scores", "mask",
                                              "K", "poses")}
        matcher = make_nn_pair_matcher(scene["descriptors"], scene["mask"], distance_thresh=0.2,
                                       mesh=m, device="cpu")
        for cams in (False, True):
            res = run_mapping(scene["keypoints"], scene["descriptors"], scene["scores"],
                              scene["mask"], scene["K"], scene["poses"], matcher,
                              config=MappingConfig(global_ba=True, global_ba_iters=5,
                                                   global_ba_refine_cameras=cams, mesh=m),
                              device="cpu")
            c = f"map_{tag}_{'cams' if cams else 'pts'}"
            out[f"{c}_points"] = res.points_xyz
            out[f"{c}_rmse"] = np.asarray([res.stats["global_ba_rmse_initial_px"],
                                           res.stats["global_ba_rmse_final_px"]])
            if cams:
                out[f"{c}_poses"] = res.refined_poses
    return out


class IdentityMatcher(torch.nn.Module):
    """Keypoint i matched to 3D point i where both are valid (the planted
    validation items' correspondences)."""

    def __init__(self):
        super().__init__()
        self.w = torch.nn.Parameter(torch.zeros(1))

    def forward(self, desc2d, desc3d, leaf_desc, mask2d, mask3d, leaf_mask):
        n = desc2d.shape[1]
        idx = torch.arange(n, dtype=torch.int32)[None].expand(desc2d.shape[0], n)
        return {"matches0": torch.where(mask2d & mask3d[:, :n], idx, -1)}


def val_items(d: dict) -> list:
    keys = ("desc2d", "desc3d", "leaf_desc", "mask2d", "mask3d", "leaf_mask", "kpts2d",
            "points3d", "pose_gt", "K")
    return [{k: d[f"val{i}_{k}"] for k in keys} for i in range(int(d["val_n"]))]


@task
def validation(d: dict, opt: dict) -> dict:
    """train.loop.make_pose_val_fn over the ranks: each rank a strided share
    of the items, the counts combined exactly."""
    from types import SimpleNamespace

    from onepose_tpu_torch.train.loop import make_pose_val_fn

    model = IdentityMatcher()
    out = make_pose_val_fn(val_items(d), model, n_hyp=64)(SimpleNamespace(model=model))
    return {k: np.asarray(v) for k, v in out.items()}


@task
def audit(d: dict, opt: dict) -> dict:
    """scripts.audit_collectives' audit over make_mesh(n_points=W) and the
    world group at opt["audit"]'s widths: its result (as JSON) and what
    its check finds."""
    from onepose_tpu_torch.parallel.mesh import make_mesh
    from onepose_tpu_torch.scripts import audit_collectives as ac
    from onepose_tpu_torch.utils import comm

    w = opt["audit"]
    mesh = make_mesh(n_data=1, n_points=comm.get_world_size(), device="cpu")
    result = ac.audit(mesh, torch.distributed.group.WORLD, w["n3s"], b=w["b"], n2=w["n2"],
                      leaves=w["leaves"], c=w["c"], blocks=w["blocks"])
    bad = ac.check(result, b=w["b"], n2=w["n2"], c=w["c"])
    return {"result": np.array(json.dumps(result)), "bad": np.array(json.dumps(bad))}


def main() -> None:
    name, in_dir, out_dir = sys.argv[1:4]
    torch.set_num_threads(1)
    from onepose_tpu_torch.utils import comm

    assert comm.init_distributed(device="cpu")
    d = dict(np.load(osp.join(in_dir, "inputs.npz")))
    with open(osp.join(in_dir, "options.json")) as f:
        opt = json.load(f)
    opt["in_dir"] = in_dir
    out = {f"{t}.{k}": v for t in name.split(",") for k, v in TASKS[t](d, opt).items()}
    np.savez(osp.join(out_dir, f"rank{comm.get_rank()}.npz"), **out)
    comm.synchronize()
    torch.distributed.destroy_process_group()


if __name__ == "__main__":
    sys.path.insert(0, osp.dirname(osp.dirname(osp.abspath(__file__))))
    os.environ.setdefault("OMP_NUM_THREADS", "1")
    main()
