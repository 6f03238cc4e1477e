"""`infer` command: evaluation inference over a sequence or a roster.

Port of onepose_tpu/cli/infer.py: the same config keys, the same roster
forms (a directory, a comma list or a glob), the two feature routes (the
images through SuperPoint, or a reference-layout `features_h5` cache), the
mixed-object batches of `batch_objects`, `dump_vis3d`, `eval_out` and the
JSON metrics line; one more key, `device` ("cuda" unless the caller names
"cpu"). Per frame batch: SuperPoint on the crop, the matcher against the
object annotation, RANSAC-PnP, cm-degree evaluation, through
`runtime.pipeline.PosePipeline`.

The modules are built as the JAX command builds them, fp32 and passed to
the pipeline as they are, with the port's kernels on: SuperPoint with the
NMS kernel (K1); GATsSPG with the GATs leaf-attention (K2) and dual-softmax
(K3) kernels, whose tie rule the matches then follow (ROADMAP C watch
item 4). Each wrapper runs its plain version on CPU tensors.

RANSAC draws come per batch from a CPU `torch.Generator` seeded with the
batch's first frame index (JAX keys each batch with PRNGKey(start)) and
go to the device, so the card and the CPU draw alike. The pipeline runs
in full fp32 (TF32 off, `utils.precision.fp32_matmuls`), as JAX's fp32
modules compute on the CPU and as `map` extracts features.

Over several ranks (`torchrun --nproc-per-node N -m onepose_tpu_torch
infer ...`), as for `map`: with `data_parallel` off the roster is split
over the ranks (the JAX package's multi-process behaviour), each rank
records its own sequences to `eval_out`, and the recalls combine exactly
(`utils.comm.all_gather_pytree` of `Evaluator.counts`, then
`Evaluator.combine_counts`; rank 0 writes ALL). With `data_parallel` on,
the mesh spans the ranks, every rank walks the whole roster, each image
batch (rounded up to the data axis) is served by `PosePipeline.sharded`
(each rank its frames), every rank holds every pose, and rank 0 alone
writes `eval_out` and `dump_vis3d`. The feature-cache route stays on one
rank's device, as in the JAX package. Copied from the reference (ROADMAP C
watch item 5): with `batch_objects` the sequences are named by their
directories whatever `seq_name` says, and `dump_vis3d` is not written.
"""

from __future__ import annotations

import json
import os.path as osp
from typing import Optional

import numpy as np
import torch

from onepose_tpu_torch._device import resolve_device
from onepose_tpu_torch.utils import comm

DEFAULTS = {
    "data_dir": None,  # sequence root with color/, poses_ba/, intrin_ba/
    "anno_dir": None,  # anno npz dir (defaults to ../outputs/anno)
    "weights": {"superpoint": None, "matcher": None},
    "matcher": "gats",  # 'gats' (learned) | 'nn' (descriptor mutual-NN)
    "nn_distance_thresh": 0.7,
    "max_keypoints": 1000,
    "shape3d": 2000,
    "num_leaf": 8,
    "batch": 8,
    "det_type": "GT_box",
    # Evaluate from a reference-layout feature cache (feats-superpoint.h5,
    # keyed by image basename or full relative path) instead of running the
    # extractor on images; the injection point of the oracle accuracy gate.
    "features_h5": None,
    "eval_out": None,
    "seq_name": "seq",
    "dump_vis3d": None,  # dir for per-frame 3D dumps (Wis3D-export parity)
    # Frame batches over the ranks (PosePipeline.sharded): False = each
    # rank its own share of the roster; True (or the world size) = a mesh
    # over every rank.
    "data_parallel": False,
    # Mixed-object batches: the whole roster as one frame stream, each
    # batch served against a per-frame gathered annotation.
    "batch_objects": False,
    # Where the pipeline runs: "cuda" (raises without CUDA) or "cpu".
    "device": "cuda",
}


def build_pipeline(cfg: dict, device):
    """The command's PosePipeline: fp32 SuperPoint (NMS kernel) and the
    matcher of cfg["matcher"], with their weights, on `device`."""
    from onepose_tpu_torch.cli.common import build_matcher, load_superpoint_params
    from onepose_tpu_torch.models.superpoint import SuperPoint
    from onepose_tpu_torch.runtime.pipeline import PosePipeline

    sp = SuperPoint(nms_kernel=True)
    sp.load_state_dict(load_superpoint_params(sp, cfg["weights"]["superpoint"]))
    matcher, m_params = build_matcher(cfg)
    matcher.load_state_dict(m_params)
    return PosePipeline(superpoint=sp, matcher=matcher, max_keypoints=cfg["max_keypoints"],
                        device=device)


class _ShardedServing:
    """A PosePipeline whose image batches go through its `sharded` call
    over `mesh`; everything else is the pipeline's."""

    def __init__(self, pipe, mesh):
        self._pipe, self._run = pipe, pipe.sharded(mesh)

    def __call__(self, *args, **kwargs) -> dict:
        return self._run(*args, **kwargs)

    def __getattr__(self, name):
        return getattr(self._pipe, name)


def run(cfg: dict) -> dict:
    from onepose_tpu_torch.cli.common import sequence_dirs
    from onepose_tpu_torch.data.anno_io import annotation_from_npz_dir
    from onepose_tpu_torch.eval import Evaluator, record_eval_result

    dev = resolve_device(cfg["device"])  # no CUDA and no device=cpu: raise before any work
    comm.init_distributed(device=dev)
    assert cfg["data_dir"], "infer: data_dir is required"
    seq_dirs = sequence_dirs(cfg["data_dir"], "infer")
    pipe = build_pipeline(cfg, dev)

    from onepose_tpu_torch.parallel.sfm_parallel import resolve_sfm_mesh

    mesh = resolve_sfm_mesh(cfg["data_parallel"], device=dev)
    if mesh is not None:
        n_data = mesh.axis_size("data")
        cfg = dict(cfg, batch=-(-cfg["batch"] // n_data) * n_data)
        pipe = _ShardedServing(pipe, mesh)
    world, rank = comm.get_world_size(), comm.get_rank()
    split = world > 1 and mesh is None  # each rank its share of the roster
    my_seq_dirs = seq_dirs[rank::world] if split else seq_dirs
    writer = mesh is None or rank == 0
    if not writer:
        cfg = dict(cfg, dump_vis3d=None)

    per_seq = {}
    overall = Evaluator()
    total_frames = 0
    if cfg["batch_objects"] and my_seq_dirs:
        assert not cfg.get("features_h5"), (
            "batch_objects evaluates from images (the feature cache is per-sequence)")
        per_seq = _eval_roster_batched(cfg, my_seq_dirs, pipe, overall)
        for seq_name, m in per_seq.items():
            total_frames += m["num_frames"]
            if cfg["eval_out"] and writer:
                record_eval_result(cfg["eval_out"], seq_name, m)
    elif not cfg["batch_objects"]:
        for seq_dir in my_seq_dirs:
            anno_dir = cfg["anno_dir"] or osp.join(osp.dirname(seq_dir), "outputs", "anno")
            anno = annotation_from_npz_dir(anno_dir, num_leaf=cfg["num_leaf"],
                                           shape3d=cfg["shape3d"], device=dev)
            seq_name = (cfg["seq_name"] if len(seq_dirs) == 1
                        else osp.basename(osp.normpath(seq_dir)))
            m = eval_sequence(cfg, seq_dir, anno, pipe, overall)
            per_seq[seq_name] = m
            total_frames += m["num_frames"]
            if cfg["eval_out"] and writer:
                record_eval_result(cfg["eval_out"], seq_name, m)

    if split:
        # Exact aggregation over the ranks: every rank returns the metrics
        # of the whole roster; per_seq stays each rank's own.
        counts = comm.all_gather_pytree(overall.counts())
        frames = comm.all_gather_pytree(np.asarray(total_frames))
        metrics = Evaluator.combine_counts(counts)
        metrics["num_frames"] = int(sum(int(f) for f in frames))
        metrics["per_seq"] = per_seq
        if cfg["eval_out"] and rank == 0:
            record_eval_result(cfg["eval_out"], "ALL",
                               {k: v for k, v in metrics.items() if k != "per_seq"})
    elif len(seq_dirs) == 1:
        metrics = next(iter(per_seq.values()))
    else:
        metrics = overall.summarize()
        metrics["num_frames"] = total_frames
        metrics["per_seq"] = per_seq
        if cfg["eval_out"] and writer:
            record_eval_result(cfg["eval_out"], "ALL",
                               {k: v for k, v in metrics.items() if k != "per_seq"})
    print(json.dumps(metrics))
    return metrics


def _load_txt(path: str) -> np.ndarray:
    return np.loadtxt(path).astype(np.float32)


def _serve(pipe, batch_start: int, K: np.ndarray, anno, images=None, feats=None) -> dict:
    """One batch through the pipeline in full fp32, with the RANSAC draws
    of a CPU generator seeded with the batch's first frame index."""
    from onepose_tpu_torch.utils.precision import fp32_matmuls

    gen = torch.Generator().manual_seed(batch_start)
    draws = torch.rand((K.shape[0], pipe.ransac_hypotheses, 3), generator=gen)
    with fp32_matmuls():
        if feats is not None:
            return pipe.from_features(feats, torch.from_numpy(K), anno, draws=draws)
        return pipe(torch.from_numpy(images)[..., None], torch.from_numpy(K), anno, draws=draws)


def eval_sequence(cfg: dict, data_dir: str, anno, pipe, overall,
                  features: Optional[dict] = None) -> dict:
    """Evaluate one sequence in batches of cfg["batch"]; returns its metrics.

    Features come from `features` (a dict of [F, N, ...] arrays in the
    layout `sfm.cache.load_features_h5` returns, one row per color image in
    order), else from cfg["features_h5"], else SuperPoint runs on the
    images, which `native.frame_loader.FrameLoader` decodes ahead."""
    from onepose_tpu_torch.data import paths as path_utils
    from onepose_tpu_torch.eval import Evaluator

    img_paths = path_utils.list_color_images(data_dir, cfg["det_type"])
    ev = Evaluator()
    B = cfg["batch"]
    n_frames = 0

    frames = None
    if features is None and cfg.get("features_h5"):
        from onepose_tpu_torch.sfm.cache import load_features_h5

        features = load_features_h5(cfg["features_h5"], [osp.basename(p) for p in img_paths],
                                    pad_to=cfg["max_keypoints"])
    if features is None:
        from onepose_tpu_torch.native.frame_loader import FrameLoader

        frames = iter(FrameLoader(img_paths, queue_cap=2 * B))
    for s in range(0, len(img_paths), B):
        chunk = img_paths[s:s + B]
        imgs, Ks, poses = [], [], []
        for p in chunk:
            if frames is not None:
                _, img = next(frames)
                if img is None:
                    raise FileNotFoundError(p)
                imgs.append(img)
            Ks.append(_load_txt(path_utils.intrin_path_by_color(p, cfg["det_type"])))
            poses.append(_load_txt(path_utils.gt_pose_path_by_color(p, cfg["det_type"])))
        pad = B - len(chunk)
        if pad:
            imgs += [imgs[-1]] * pad if imgs else []
            Ks += [Ks[-1]] * pad
            poses += [poses[-1]] * pad
        if features is not None:
            sl = [min(s + j, len(img_paths) - 1) for j in range(B)]
            feats_b = {k: torch.from_numpy(np.asarray(features[k])[sl])
                       for k in ("keypoints", "descriptors", "scores", "mask")}
            out = _serve(pipe, s, np.stack(Ks), anno, feats=feats_b)
        else:
            out = _serve(pipe, s, np.stack(Ks), anno, images=np.stack(imgs))
        pose_pred = out["pose"][:len(chunk)].cpu().numpy()
        gt = np.stack(poses)[:len(chunk)]
        ev.evaluate(pose_pred, gt)
        overall.evaluate(pose_pred, gt)
        if cfg["dump_vis3d"]:
            from onepose_tpu_torch.utils.vis import dump_scene_3d

            pts3d_all = anno.points3d.cpu().numpy()
            m0_all = out["matches0"].cpu().numpy()
            kpts_all = out["keypoints"].cpu().numpy()
            for j, p in enumerate(chunk):
                m0 = m0_all[j]
                dump_scene_3d(cfg["dump_vis3d"], osp.splitext(osp.basename(p))[0], pts3d_all,
                              pose_pred[j], Ks[j], kpts2d=kpts_all[j],
                              matched_pts3d=pts3d_all[m0[m0 >= 0]])
        n_frames += len(chunk)

    metrics = ev.summarize()
    metrics["num_frames"] = n_frames
    return metrics


def _eval_roster_batched(cfg: dict, seq_dirs, pipe, overall) -> dict:
    """Mixed-object roster evaluation: one frame stream over every
    sequence, each batch matched against a per-frame annotation gathered
    on the device from the stacked object annotations. Returns
    {sequence directory name: metrics}."""
    from onepose_tpu_torch.data import paths as path_utils
    from onepose_tpu_torch.data.anno_io import annotation_from_npz_dir
    from onepose_tpu_torch.eval import Evaluator
    from onepose_tpu_torch.native.frame_loader import FrameLoader
    from onepose_tpu_torch.runtime.pipeline import ObjectAnnotation, stack_annotations

    dev = pipe.device
    annos, jobs, seq_names = [], [], []
    for si, seq_dir in enumerate(seq_dirs):
        anno_dir = cfg["anno_dir"] or osp.join(osp.dirname(seq_dir), "outputs", "anno")
        annos.append(annotation_from_npz_dir(anno_dir, num_leaf=cfg["num_leaf"],
                                             shape3d=cfg["shape3d"], device=dev))
        seq_names.append(osp.basename(osp.normpath(seq_dir)))
        for p in path_utils.list_color_images(seq_dir, cfg["det_type"]):
            jobs.append((si, p))
    stacked = stack_annotations(annos)  # leaves [K_obj, ...] on the device

    B = cfg["batch"]
    evs = [Evaluator() for _ in seq_dirs]
    frames = iter(FrameLoader([p for _, p in jobs], queue_cap=2 * B))
    for s in range(0, len(jobs), B):
        chunk = jobs[s:s + B]
        imgs, Ks, poses, sis = [], [], [], []
        for si, p in chunk:
            _, img = next(frames)
            if img is None:
                raise FileNotFoundError(p)
            imgs.append(img)
            Ks.append(_load_txt(path_utils.intrin_path_by_color(p, cfg["det_type"])))
            poses.append(_load_txt(path_utils.gt_pose_path_by_color(p, cfg["det_type"])))
            sis.append(si)
        pad = B - len(chunk)
        if pad:
            imgs += [imgs[-1]] * pad
            Ks += [Ks[-1]] * pad
            sis += [sis[-1]] * pad
        # Per-frame annotation: a device-side gather of the stacked object
        # annotations by sequence index.
        obj_idx = torch.as_tensor(sis, device=dev)
        banno = ObjectAnnotation(**{k: getattr(stacked, k)[obj_idx]
                                    for k in ("points3d", "desc3d", "leaf_desc", "mask3d",
                                              "leaf_mask")})
        out = _serve(pipe, s, np.stack(Ks), banno, images=np.stack(imgs))
        pose_pred = out["pose"][:len(chunk)].cpu().numpy()
        gt = np.stack(poses)
        for j, (si, _) in enumerate(chunk):
            evs[si].evaluate(pose_pred[j][None], gt[j][None])
        overall.evaluate(pose_pred, gt)

    return {name: ev.summarize() for name, ev in zip(seq_names, evs)}


def add_parser(subparsers):
    p = subparsers.add_parser("infer", help="GT-box evaluation inference")
    p.add_argument("--config", default=None)
    p.add_argument("overrides", nargs="*")
    p.set_defaults(_defaults=DEFAULTS, _run=run)
