"""Object mapping driver: frames -> sparse 3D object map + annotations.

Port of onepose_tpu/sfm/mapping.py (`run_mapping` and `_global_ba`). The
device stages (epipolar verification, triangulation with its refinement,
global bundle adjustment) run on `device`, CUDA unless the caller passes
"cpu", in full fp32; the graph stages (covisibility, tracks, merge,
aggregation, leaves, assign matrices) are host numpy and the native
union-find, as in the JAX package. The output is the port's
`ObjectAnnotation` on `device`, plus reconstruction statistics equivalent
to COLMAP's model_analyzer. `MappingConfig` has the JAX package's fields
but `pair_batch`, which nothing reads (pair batching is the matcher's).
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import numpy as np
import torch

from onepose_tpu_torch._device import resolve_device
from onepose_tpu_torch.geometry.rotations import angle_axis_to_rotmat, rotmat_to_angle_axis
from onepose_tpu_torch.ops.lm import ba_solve
from onepose_tpu_torch.runtime.pipeline import ObjectAnnotation
from onepose_tpu_torch.sfm.aggregate import (
    aggregate_point_features,
    assign_matrix_for_frame,
    build_leaf_slots,
)
from onepose_tpu_torch.sfm.covis import covis_pairs_from_poses
from onepose_tpu_torch.sfm.filtering import (
    filter_points_by_box,
    merge_close_points,
    track_length_for_max_points,
)
from onepose_tpu_torch.sfm.tracks import build_tracks
from onepose_tpu_torch.sfm.triangulate import triangulate_and_filter_tracks
from onepose_tpu_torch.sfm.verify import epipolar_verify_matches


@dataclasses.dataclass
class MappingConfig:
    num_covis: int = 10
    min_rotation_deg: float = 10.0
    max_epipolar_px: float = 4.0
    max_reproj_px: float = 4.0
    min_tri_angle_deg: float = 1.5
    min_track_length: int = 2
    max_track_length: int = 32
    max_points3d: int = 2500
    merge_dist: float = 1e-3
    num_leaf: int = 8
    leaf_seed: int = 0
    # Optional global bundle adjustment after triangulation + merge (the
    # reference's `colmap bundle_adjuster`, intrinsics fixed).
    # refine_cameras=False keeps the known capture poses as the gauge and
    # refines the points only.
    global_ba: bool = False
    global_ba_iters: int = 10
    global_ba_refine_cameras: bool = False
    # A `parallel.mesh.Mesh` of more than one rank: global BA splits the
    # points over every rank (`parallel.distributed_ba`); every rank calls
    # run_mapping alike.
    mesh: Optional[object] = None


@dataclasses.dataclass
class MappingResult:
    annotation: ObjectAnnotation
    points_xyz: np.ndarray  # [P, 3] unpadded
    leaf_scores: np.ndarray
    scores_avg: np.ndarray
    desc_concat: np.ndarray
    scores_concat: np.ndarray
    idxs: np.ndarray
    frame_assign: dict  # {frame_idx: [2, K] assign matrix}
    stats: dict
    refined_poses: Optional[np.ndarray] = None  # [F, 4, 4] if global BA refined the cameras


def _t(x, device: torch.device) -> torch.Tensor:
    """numpy -> tensor on `device`; floating arrays as fp32 (as JAX takes
    them without 64-bit mode)."""
    x = np.ascontiguousarray(x)
    if np.issubdtype(x.dtype, np.floating):
        x = x.astype(np.float32, copy=False)
    return torch.as_tensor(x, device=device)


def run_mapping(
    keypoints: np.ndarray,
    descriptors: np.ndarray,
    scores: np.ndarray,
    kpt_mask: np.ndarray,
    K: np.ndarray,
    poses: np.ndarray,
    match_pair_fn: Callable[[np.ndarray], np.ndarray],
    box_corners: Optional[np.ndarray] = None,
    seq_ids: Optional[np.ndarray] = None,
    config: MappingConfig = MappingConfig(),
    pad_points_to: Optional[int] = None,
    device: str | torch.device = "cuda",
) -> MappingResult:
    """Build an object map from per-frame features with known poses.

    keypoints [F, N, 2]; descriptors [F, N, C]; scores [F, N]; kpt_mask
    [F, N]; K [F, 3, 3]; poses [F, 4, 4] world->cam (numpy).
    match_pair_fn: pairs [P, 2] -> matches0 [P, N] (-1 = unmatched), the
    caller's matcher (`parallel.sfm_parallel.make_*_pair_matcher`).
    box_corners: optional [8, 3] object box for point filtering.
    pad_points_to: 3D slots of the annotation (default config.max_points3d).
    """
    cfg = config
    dev = resolve_device(device)
    keypoints, K, poses = np.asarray(keypoints), np.asarray(K), np.asarray(poses)
    kpt_mask = np.asarray(kpt_mask, bool)
    F, N = keypoints.shape[:2]
    R = poses[:, :3, :3]
    t = poses[:, :3, 3]

    pairs = covis_pairs_from_poses(poses, seq_ids, num_matched=cfg.num_covis,
                                   min_rotation_deg=cfg.min_rotation_deg)
    if len(pairs) == 0:
        raise ValueError("no covisible pairs — check poses / thresholds")

    matches0 = np.asarray(match_pair_fn(pairs))
    if matches0.shape != (len(pairs), N):
        raise ValueError(f"match_pair_fn returned {matches0.shape}, want one row of {N} per pair "
                         f"({len(pairs)} pairs)")

    # Epipolar verification (batched on the device).
    i, j = pairs[:, 0], pairs[:, 1]
    midx = np.maximum(matches0, 0)
    uv0 = keypoints[i[:, None], np.arange(N)[None, :]]
    uv1 = keypoints[j[:, None], midx]
    valid = ((matches0 >= 0) & kpt_mask[i[:, None], np.arange(N)[None, :]]
             & kpt_mask[j[:, None], midx])
    verified = epipolar_verify_matches(
        _t(uv0, dev), _t(uv1, dev), _t(valid, dev),
        _t(K[i], dev), _t(R[i], dev), _t(t[i], dev),
        _t(K[j], dev), _t(R[j], dev), _t(t[j], dev),
        max_epipolar_px=cfg.max_epipolar_px,
    ).cpu().numpy()
    matches0 = np.where(verified, matches0, -1)

    tracks = build_tracks(pairs, matches0, F, N, min_track_length=cfg.min_track_length,
                          max_track_length=cfg.max_track_length)
    if tracks.n_tracks == 0:
        raise ValueError("no tracks survived verification")

    tri = triangulate_and_filter_tracks(
        _t(tracks.obs_frame, dev), _t(tracks.obs_kpt, dev), _t(tracks.obs_mask, dev),
        _t(keypoints, dev), _t(K, dev), _t(R, dev), _t(t, dev),
        max_reproj_px=cfg.max_reproj_px, min_tri_angle_deg=cfg.min_tri_angle_deg,
    )
    tri = {k: v.cpu().numpy() for k, v in tri.items()}
    ok = tri["ok"]

    # Track-length threshold so that <= max_points3d points survive
    # (reference filter_tkl.get_tkl semantics, applied to inlier counts).
    inlier_counts = tri["obs_inlier"].sum(axis=1)
    tkl = track_length_for_max_points(inlier_counts[ok], cfg.max_points3d)
    ok = ok & (inlier_counts >= tkl)
    if box_corners is not None:
        ok = ok & filter_points_by_box(tri["xyz"], np.asarray(box_corners))
    track_ids = np.nonzero(ok)[0]
    if len(track_ids) == 0:
        raise ValueError("no 3D points survived filtering")

    merged_xyz, groups = merge_close_points(tri["xyz"][track_ids], track_ids,
                                            dist_threshold=cfg.merge_dist)

    ba_stats: dict = {}
    refined_poses = None
    if cfg.global_ba:
        merged_xyz, refined_poses, ba_stats = _global_ba(
            merged_xyz, groups, tracks, tri["obs_inlier"], keypoints, K, poses, cfg, dev)

    agg = aggregate_point_features(tracks, tri["obs_inlier"], ok, groups, descriptors, scores)
    leaves = build_leaf_slots(agg["desc_concat"], agg["scores_concat"], agg["idxs"],
                              cfg.num_leaf, rng=np.random.default_rng(cfg.leaf_seed))
    frame_assign = {f: assign_matrix_for_frame(obs, N, len(merged_xyz))
                    for f, obs in agg["frame_obs"].items()}

    # Pad to the static annotation layout.
    P = len(merged_xyz)
    target = pad_points_to or cfg.max_points3d
    pad = max(target - P, 0)

    def pad0(x, value=0.0):
        widths = [(0, pad)] + [(0, 0)] * (x.ndim - 1)
        return np.pad(x[:target], widths, constant_values=value)

    annotation = ObjectAnnotation(
        points3d=_t(pad0(merged_xyz), dev),
        desc3d=_t(pad0(agg["desc_avg"], 1.0), dev),
        leaf_desc=_t(pad0(leaves["leaf_desc"], 1.0), dev),
        mask3d=_t(pad0(np.ones(P, bool), False), dev),
        leaf_mask=_t(pad0(leaves["leaf_mask"], False), dev),
    )
    stats = {
        "num_frames": int(F),
        "num_pairs": int(len(pairs)),
        "num_tracks": int(tracks.n_tracks),
        "num_points3d": int(P),
        "track_length_threshold": int(tkl),
        "mean_track_length": float(inlier_counts[track_ids].mean() if len(track_ids) else 0.0),
        "mean_reproj_error_px": float(tri["mean_reproj"][track_ids].mean()),
        "num_observations": int(inlier_counts[track_ids].sum()),
        **ba_stats,
    }
    return MappingResult(
        annotation=annotation,
        points_xyz=merged_xyz,
        leaf_scores=leaves["leaf_scores"],
        scores_avg=agg["scores_avg"],
        desc_concat=agg["desc_concat"],
        scores_concat=agg["scores_concat"],
        idxs=agg["idxs"],
        frame_assign=frame_assign,
        stats=stats,
        refined_poses=refined_poses,
    )


def _global_ba(merged_xyz, groups, tracks, obs_inlier, keypoints, K, poses,
               cfg: MappingConfig, dev: torch.device):
    """Global LM bundle adjustment over the merged map (the reference's
    `colmap bundle_adjuster` with intrinsics fixed) on one device, or with
    the points split over every rank of cfg.mesh. Returns (points,
    refined_poses | None, stats)."""
    P = len(merged_xyz)
    pt_l, cam_l, uv_l = [], [], []
    for new_id in range(P):
        for tid in np.atleast_1d(groups[new_id]):
            sel = tracks.obs_mask[tid] & obs_inlier[tid].astype(bool)
            fr = tracks.obs_frame[tid][sel]
            kp = tracks.obs_kpt[tid][sel]
            pt_l.append(np.full(len(fr), new_id, np.int32))
            cam_l.append(fr.astype(np.int32))
            uv_l.append(keypoints[fr, kp])
    pt_idx = np.concatenate(pt_l)
    cam_idx = np.concatenate(cam_l)
    uv = np.concatenate(uv_l).astype(np.float32)
    f = 0.5 * (K[cam_idx, 0, 0] + K[cam_idx, 1, 1])
    feats = np.concatenate([uv, f[:, None], K[cam_idx, 0, 2:3], K[cam_idx, 1, 2:3]],
                           axis=1).astype(np.float32)

    aa = rotmat_to_angle_axis(_t(poses[:, :3, :3], dev)).cpu().numpy()
    cam6 = np.concatenate([aa, poses[:, :3, 3]], axis=1).astype(np.float32)
    fix = (None if cfg.global_ba_refine_cameras
           else torch.ones((len(cam6),), dtype=torch.float32, device=dev))
    n_dev = cfg.mesh.size if cfg.mesh is not None else 1
    if n_dev > 1:
        # Points padded to a multiple of the shard count, as the JAX package
        # pads them: a padded point has no observation, so its Hpp block is
        # pure damping and its update exactly zero.
        from onepose_tpu_torch.parallel.distributed_ba import (
            distributed_ba_solve,
            partition_obs_by_point,
        )
        from onepose_tpu_torch.parallel.mesh import make_mesh

        P_pad = -(-P // n_dev) * n_dev
        pts_pad = np.pad(merged_xyz.astype(np.float32), ((0, P_pad - P), (0, 0)))
        parts = partition_obs_by_point(P_pad, n_dev, feats, pt_idx, cam_idx,
                                       np.ones((len(pt_idx),), bool))
        out = distributed_ba_solve(
            make_mesh(n_data=1, n_points=n_dev, device=dev), _t(pts_pad, dev), _t(cam6, dev),
            *(_t(a, dev) for a in parts), fix_cam_mask=fix, n_iters=cfg.global_ba_iters,
        )
        out["points"] = out["points"][:P]
    else:
        out = ba_solve(
            _t(merged_xyz, dev), _t(cam6, dev), _t(feats, dev), _t(pt_idx, dev),
            _t(cam_idx, dev), torch.ones((len(pt_idx),), dtype=torch.bool, device=dev),
            fix_cam_mask=fix, n_iters=cfg.global_ba_iters,
        )
    n_obs = max(len(pt_idx), 1)
    stats = {
        "global_ba_rmse_initial_px": float(np.sqrt(2.0 * float(out["cost_initial"]) / n_obs)),
        "global_ba_rmse_final_px": float(np.sqrt(2.0 * float(out["cost_final"]) / n_obs)),
    }
    refined_poses = None
    if cfg.global_ba_refine_cameras:
        cams = out["cam_poses"]
        refined_poses = np.tile(np.eye(4, dtype=np.float32), (len(cams), 1, 1))
        refined_poses[:, :3, :3] = angle_axis_to_rotmat(cams[:, :3]).cpu().numpy()
        refined_poses[:, :3, 3] = cams[:, 3:6].cpu().numpy()
    return out["points"].cpu().numpy(), refined_poses, stats
