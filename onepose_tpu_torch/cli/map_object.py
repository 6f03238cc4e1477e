"""`map` command: build an object's sparse map + annotations.

The reference equivalent is `python run.py +preprocess=sfm_spp_spg_*`
(run.py:96-249). Steps: SuperPoint over the mapping frames -> covis pairs
-> pair matching (SuperGlue-class or mutual-NN) -> verification/tracks/
triangulation/filtering/aggregation (sfm.mapping) -> anno npz + COLMAP
model export + PLY + stats.

Port of onepose_tpu/cli/map_object.py, whole: the same config keys, the
same artifacts and cache fingerprints (so either package resumes from the
other's caches and reads the other's maps), one more key, `device`
("cuda" unless the caller names "cpu"; the fingerprints leave it out, so a
cache resumes across devices), and one more matcher, `matcher: lightglue`
(no JAX counterpart; `parallel.sfm_parallel.make_lightglue_pair_matcher`,
its attention on K8 on the card): its weights from `weights.lightglue`
(upstream's `superpoint_lightglue.pth`, or the seeded random init) and its
conf from the optional `lightglue` keys (`LIGHTGLUE_CONF`: upstream's
`default_conf`, 1536 keypoints as the pruning floor); neither key is in
DEFAULTS, so the shipped presets resolve as in JAX. On the card SuperPoint runs the NMS kernel
(bit-exact with the plain NMS) and no VGG-stage kernel (it rounds taps to
bf16 even in fp32, where the JAX `map` runs plain convolutions); SuperGlue
routes its Sinkhorn as the port does by default (4096 keypoints: the
streamed kernel).

Over several ranks (`torchrun --nproc-per-node N -m onepose_tpu_torch map
...`; each rank joins through `utils.comm.init_distributed`): the output
names come from the full roster first. With `data_parallel` off the
roster is split over the ranks (rank r maps objects r, r + N, ...; one
sequence: rank 0 maps it), the JAX package's multi-process behaviour.
With `data_parallel` on, the mesh spans the ranks and every rank walks the
whole roster in lockstep: extraction and pair matching split their
batches over the ranks, global BA its points; rank 0 alone writes the
files (artifacts and caches), and the ranks meet at a barrier around each
cache step so that they all read the same cache state. The roster is
never split over a mesh that spans ranks (the JAX package does so, and
its ranks then wait on each other's collectives).
"""

from __future__ import annotations

import importlib.util
import json
import os
import os.path as osp

import numpy as np

from onepose_tpu_torch._device import resolve_device
from onepose_tpu_torch.utils import comm

DEFAULTS = {
    "data_dir": None,  # sequence root (color/, poses_ba/, intrin_ba/)
    "out_dir": None,  # defaults to <data_dir>/../outputs
    "weights": {"superpoint": None, "superglue": None},
    "matcher": "nn",  # 'nn' | 'superglue' | 'lightglue'
    "max_keypoints": 1024,
    "keypoint_threshold": 0.005,
    # SuperGlue match threshold for SfM pair matching — the reference's
    # SfM config uses 0.7, not the model default 0.2
    # (src/sfm/match_features.py:8-17).
    "match_threshold": 0.7,
    "num_covis": 10,
    "max_points3d": 2500,
    "num_leaf": 8,
    "det_type": "GT_box",
    # redo=True (the documented clean-rebuild flag, run.py:154) rebuilds
    # everything and drops both HDF5 caches; redo=False resumes: a
    # completed map is skipped, a partial one reuses caches.
    "redo": True,
    # Reference-layout HDF5 caches (feats-superpoint.h5 / matches.h5 under
    # out_dir, reference extract_features.py:44-59 / match_features.py:45-85):
    # features are loaded from cache when present, matches resume per-pair.
    # Caches carry a fingerprint (extraction/matcher config + weights hash);
    # a mismatch forces re-extraction, and re-extracted features invalidate
    # the match cache (indices would desync from the new keypoints).
    "cache": True,
    # Map-block parallelism (SURVEY §2.3): shard frame extraction, pair
    # matching, and global BA over a mesh of the ranks. False = one rank's
    # work; True = every rank; an int = that many (it must be 1 or every
    # rank). Pure data parallelism over frames/pairs — results are
    # identical to the serial path; BA uses the distributed Schur solver
    # (points sharded).
    "data_parallel": False,
    # Pairs matched per compiled call (rounded up to the device count).
    "pair_chunk": 16,
    # Optional global bundle adjustment after triangulation (reference
    # src/sfm/global_ba.py:9-39, intrinsics refinement disabled).
    "global_ba": False,
    "global_ba_iters": 10,
    # Per-image 2D annotation format: 'json' (reference feature_process.py
    # layout, interop default) | 'npz' (binary, ~70x faster writes; the
    # training dataset reads both).
    "anno_format": "json",
    # Where the map is computed: "cuda" (raises without CUDA) or "cpu".
    "device": "cuda",
}


# LightGlue's conf for `matcher: lightglue` (upstream's default_conf with
# the SuperPoint features); cfg["lightglue"] overrides any of it.
LIGHTGLUE_CONF = {"n_layers": 9, "num_heads": 4, "depth_confidence": 0.95,
                  "width_confidence": 0.99, "filter_threshold": 0.1,
                  "pruning_min_keypoints": 1536}


def lightglue_conf(cfg: dict) -> dict:
    return {**LIGHTGLUE_CONF, **(cfg.get("lightglue") or {})}


def _file_hash(path: str) -> str:
    import hashlib

    h = hashlib.sha256()
    with open(path, "rb") as f:
        for block in iter(lambda: f.read(1 << 20), b""):
            h.update(block)
    return h.hexdigest()[:16]


def _extraction_fingerprint(cfg: dict) -> str:
    w = cfg["weights"]["superpoint"]
    return json.dumps(
        {
            "max_keypoints": cfg["max_keypoints"],
            "keypoint_threshold": cfg["keypoint_threshold"],
            "det_type": cfg["det_type"],
            "weights": _file_hash(w) if w and osp.exists(w) else "random-init",
        },
        sort_keys=True,
    )


def _matcher_fingerprint(cfg: dict, feature_fingerprint: str) -> str:
    if cfg["matcher"] == "lightglue":
        w = cfg["weights"].get("lightglue")
        return json.dumps(
            {
                "matcher": "lightglue",
                "conf": lightglue_conf(cfg),
                "weights": _file_hash(w) if w and osp.exists(w) else "random-init",
                "features": feature_fingerprint,
            },
            sort_keys=True,
        )
    w = cfg["weights"]["superglue"]
    return json.dumps(
        {
            "matcher": cfg["matcher"],
            "match_threshold": cfg["match_threshold"],
            "weights": _file_hash(w) if w and osp.exists(w) else "random-init",
            "features": feature_fingerprint,
        },
        sort_keys=True,
    )


def _roster_names(seq_dirs: list) -> list:
    """Unique output directory name per roster entry, deterministic in the
    roster order (so every process derives identical names)."""
    taken: dict = {}
    names = []
    for d in seq_dirs:
        parts = osp.normpath(d).split(osp.sep)
        name = "_".join(p for p in parts[-2:] if p)
        k = 2
        while name in taken and k < len(parts):
            k += 1  # disambiguate with more path context
            name = "_".join(p for p in parts[-k:] if p)
        n = 2
        while name in taken:  # same path listed twice
            name = f"{name}.{n}"
            n += 1
        taken[name] = d
        names.append(name)
    return names


def run(cfg: dict) -> dict:
    """Build maps for one sequence or a roster. `data_dir` may be a single
    directory, a comma-separated list, or a glob pattern — the reference
    `sfm()` loops over all configured objects in one invocation
    (run.py:96-137); here the compiled extractor/matcher programs are
    reused across objects."""
    from onepose_tpu_torch.cli.common import sequence_dirs
    from onepose_tpu_torch.parallel.sfm_parallel import resolve_sfm_mesh

    dev = resolve_device(cfg["device"])  # no CUDA and no device=cpu: raise before any work
    comm.init_distributed(device=dev)

    raw = cfg["data_dir"]
    assert raw, "map: data_dir is required"
    seq_dirs = sequence_dirs(raw, "map")
    mesh = resolve_sfm_mesh(cfg["data_parallel"], device=dev)
    world, rank = comm.get_world_size(), comm.get_rank()
    # Split the roster over the ranks only when no mesh spans them.
    split = world > 1 and mesh is None

    if len(seq_dirs) == 1:
        if split and rank != 0:
            return {}
        return _run_object(cfg, seq_dirs[0], cfg["out_dir"], mesh)

    # Output names must be derived from the FULL roster before any
    # process-sharding: disambiguation is stateful (it appends path
    # context on collision), and if each process named only its own share,
    # two processes could map DIFFERENT objects to the SAME directory and
    # race on its caches (caught by tests/test_multiprocess.py).
    names = _roster_names(seq_dirs)
    jobs = list(zip(seq_dirs, names))

    if split:
        jobs = jobs[rank::world]

    all_stats = {}
    for d, name in jobs:
        out_dir = osp.join(cfg["out_dir"], name) if cfg["out_dir"] else None
        all_stats[name] = _run_object(cfg, d, out_dir, mesh)
    summary = {
        "num_objects": len(all_stats),
        "total_points3d": int(
            sum(s.get("num_points3d", 0) for s in all_stats.values())
        ),
        "objects": all_stats,
    }
    print(json.dumps(summary))
    return summary


def _run_object(cfg: dict, data_dir: str, out_dir, mesh) -> dict:
    """Map one sequence into out_dir; `mesh` (`resolve_sfm_mesh`) splits
    its batches over the ranks, or None."""
    import json as _json

    from onepose_tpu_torch.cli.common import (
        extract_sequence_features,
        load_superglue_params,
        load_superpoint_params,
    )
    from onepose_tpu_torch.data import paths as path_utils
    from onepose_tpu_torch.data.anno_io import (
        save_anno2d,
        save_anno2d_npz,
        save_annotation_npz,
        write_anno_index,
    )
    from onepose_tpu_torch.data.colmap_io import export_ply
    from onepose_tpu_torch.models.superglue import SuperGlue
    from onepose_tpu_torch.models.superpoint import SuperPoint
    from onepose_tpu_torch.parallel.sfm_parallel import (
        make_nn_pair_matcher,
        make_superglue_pair_matcher,
    )
    from onepose_tpu_torch.sfm.mapping import MappingConfig, run_mapping

    assert cfg["anno_format"] in ("json", "npz"), (
        f"anno_format must be 'json' or 'npz', got {cfg['anno_format']!r}"
    )
    out_dir = out_dir or osp.join(osp.dirname(data_dir), "outputs")
    dev = resolve_device(cfg["device"])
    # With a mesh over several ranks, rank 0 alone writes; `sync` orders
    # its cache steps against the other ranks' reads.
    writer = mesh is None or comm.is_main_process()

    def sync():
        if mesh is not None:
            comm.synchronize()

    # Resume semantics (reference run.py:154, redo flag): a completed map
    # (stats + annotation index on disk) is not rebuilt unless redo=True.
    stats_path = osp.join(out_dir, "stats.json")
    index_path = osp.join(out_dir, "anno", "anno_index.json")
    if not cfg["redo"] and osp.exists(stats_path) and osp.exists(index_path):
        with open(stats_path) as f:
            stats = _json.load(f)
        stats["skipped_existing"] = True
        print(_json.dumps(stats))
        return stats

    if cfg["cache"] and importlib.util.find_spec("h5py") is None:
        raise ImportError("map with cache=true keeps HDF5 caches and needs h5py, which is not "
                          "installed: install it or pass cache=false")

    feats_cache = osp.join(out_dir, "feats-superpoint.h5")
    matches_cache = osp.join(out_dir, "matches.h5")
    feat_fp = _extraction_fingerprint(cfg)

    if cfg["redo"] and writer:
        # Clean rebuild: caches are part of the outputs being rebuilt.
        for p in (feats_cache, matches_cache):
            if osp.exists(p):
                os.remove(p)
    sync()

    feats = None
    if cfg["cache"] and osp.exists(feats_cache):
        from onepose_tpu_torch.sfm.cache import load_features_h5, read_fingerprint

        stored_fp = read_fingerprint(feats_cache)
        # A missing fingerprint means a reference-produced cache: accept it
        # as-is (interop). A present-but-different one means our own config
        # or weights changed: re-extract.
        if stored_fp is not None and stored_fp != feat_fp:
            feats = None
        else:
            img_paths = path_utils.list_color_images(
                data_dir, cfg["det_type"]
            )
            names = [osp.basename(p) for p in img_paths]
            try:
                cached = load_features_h5(
                    feats_cache, names, pad_to=cfg["max_keypoints"]
                )
                Ks, poses = [], []
                for p in img_paths:
                    _, K, pose = path_utils.load_frame(p, cfg["det_type"])
                    Ks.append(K)
                    poses.append(pose)
                feats = {
                    **{
                        k: cached[k]
                        for k in ("keypoints", "descriptors", "scores", "mask")
                    },
                    "K": np.stack(Ks),
                    "poses": np.stack(poses),
                    "image_paths": img_paths,
                    "image_hw": cached["image_hw"],
                }
            except KeyError:
                feats = None  # stale cache (image set changed): re-extract
    sync()  # every rank has read the feature cache before rank 0 rewrites it

    # Per-stage wall times (reference emits per-stage logs across
    # extract_features/match_features/triangulation; here one timer whose
    # totals land in stats.json as stage_s).
    from onepose_tpu_torch.utils.profiling import StageTimer

    timer = StageTimer(sync=dev.type == "cuda")

    if feats is None:
        sp = SuperPoint(nms_kernel=dev.type == "cuda", vgg_kernel=False)
        sp_params = load_superpoint_params(sp, cfg["weights"]["superpoint"])
        with timer.stage("extract_features"):
            feats = extract_sequence_features(
                data_dir, sp_params, sp,
                max_keypoints=cfg["max_keypoints"],
                keypoint_threshold=cfg["keypoint_threshold"],
                det_type=cfg["det_type"],
                mesh=mesh,
                device=dev,
            )
        # Keypoints changed: cached match indices would desync.
        if writer and osp.exists(matches_cache):
            os.remove(matches_cache)
        if cfg["cache"] and writer:
            from onepose_tpu_torch.sfm.cache import save_features_h5

            save_features_h5(
                feats_cache,
                [osp.basename(p) for p in feats["image_paths"]],
                feats["keypoints"], feats["descriptors"], feats["scores"],
                feats["mask"], feats["image_hw"],
                fingerprint=feat_fp,
            )

    if cfg["matcher"] == "lightglue":
        from onepose_tpu_torch.cli.common import load_lightglue_params
        from onepose_tpu_torch.models.lightglue import LightGlue
        from onepose_tpu_torch.parallel.sfm_parallel import make_lightglue_pair_matcher

        lg = LightGlue(descriptor_dim=feats["descriptors"].shape[-1], **lightglue_conf(cfg))
        lg.load_state_dict(load_lightglue_params(lg, cfg["weights"].get("lightglue")))
        match_pairs = make_lightglue_pair_matcher(
            lg, feats,
            mesh=mesh,
            pair_chunk=cfg["pair_chunk"],
            device=dev,
        )
    elif cfg["matcher"] == "nn":
        match_pairs = make_nn_pair_matcher(
            feats["descriptors"],
            feats["mask"],
            distance_thresh=0.7,
            mesh=mesh,
            pair_chunk=cfg["pair_chunk"],
            device=dev,
        )
    else:
        sg = SuperGlue(match_threshold=cfg["match_threshold"])
        sg.load_state_dict(load_superglue_params(sg, cfg["weights"]["superglue"]))
        match_pairs = make_superglue_pair_matcher(
            sg, feats,
            mesh=mesh,
            pair_chunk=cfg["pair_chunk"],
            device=dev,
        )

    if cfg["cache"]:
        from onepose_tpu_torch.sfm.cache import CachedPairMatcher

        sync()
        match_pairs = CachedPairMatcher(
            match_pairs,
            matches_cache,
            [osp.basename(p) for p in feats["image_paths"]],
            feats["keypoints"].shape[1],
            fingerprint=_matcher_fingerprint(cfg, feat_fp),
            writer=writer,
        )
        sync()

    # Accumulate pair-matching time separately from the rest of the SfM
    # core (it is called lazily from inside run_mapping).
    _inner_match = match_pairs

    def match_pairs(pairs):
        with timer.stage("pair_matching"):
            return _inner_match(pairs)

    # Object-root convention first; parse-scan writes the corners inside
    # the sequence dir itself.
    box = None
    for cand in (osp.dirname(data_dir), data_dir):
        box_path = path_utils.box3d_path(cand)
        if osp.exists(box_path):
            box = np.loadtxt(box_path)
            break

    with timer.stage("mapping"):
        result = run_mapping(
            feats["keypoints"], feats["descriptors"], feats["scores"],
            feats["mask"], feats["K"], feats["poses"],
            match_pairs,
            box_corners=box,
            config=MappingConfig(
                num_covis=cfg["num_covis"],
                max_points3d=cfg["max_points3d"],
                num_leaf=cfg["num_leaf"],
                global_ba=cfg["global_ba"],
                global_ba_iters=cfg["global_ba_iters"],
                mesh=mesh,
            ),
            device=dev,
        )

    anno_dir = osp.join(out_dir, "anno")
    if not writer:
        return result.stats
    with timer.stage("write_anno"):
        save_annotation_npz(result, anno_dir)
        export_ply(
            osp.join(out_dir, "points.ply"), result.points_xyz
        )

        # Per-image 2D annotations + training index.
        entries = []
        for f_idx, am in sorted(result.frame_assign.items()):
            if am.shape[1] == 0:
                continue
            img_file = feats["image_paths"][f_idx]
            ext = ".npz" if cfg["anno_format"] == "npz" else ".json"
            anno_file = osp.join(
                anno_dir, osp.basename(img_file).rsplit(".", 1)[0] + ext
            )
            valid = feats["mask"][f_idx]
            _save2d = save_anno2d_npz if ext == ".npz" else save_anno2d
            _save2d(
                anno_file,
                feats["keypoints"][f_idx][valid],
                feats["descriptors"][f_idx][valid],
                feats["scores"][f_idx][valid],
                am,
            )
            entries.append(
                {
                    "anno_id": len(entries) + 1,
                    "anno_file": anno_file,
                    "anno3d_dir": anno_dir,
                    "img_file": img_file,
                    "pose_file": path_utils.gt_pose_path_by_color(
                        img_file, cfg["det_type"]
                    ),
                    "height": feats["image_hw"][0],
                    "width": feats["image_hw"][1],
                }
            )
        write_anno_index(osp.join(anno_dir, "anno_index.json"), entries)

    # Per-stage wall seconds: mapping minus the lazily-invoked pair
    # matching gives the SfM core (tracks/triangulation/filter/BA/agg).
    rep = timer.report()
    stage_s = {
        k: round(v["total_ms"] / 1e3, 3) for k, v in rep.items()
    }
    if "mapping" in stage_s:
        stage_s["sfm_core"] = round(
            stage_s["mapping"] - stage_s.get("pair_matching", 0.0), 3
        )
    result.stats["stage_s"] = stage_s

    stats_path = osp.join(out_dir, "stats.json")
    os.makedirs(out_dir, exist_ok=True)
    with open(stats_path, "w") as f:
        json.dump(result.stats, f, indent=2)
    print(json.dumps(result.stats))
    return result.stats


def add_parser(subparsers):
    p = subparsers.add_parser("map", help="build an object map (SfM)")
    p.add_argument("--config", default=None)
    p.add_argument("overrides", nargs="*")
    p.set_defaults(_defaults=DEFAULTS, _run=run)
