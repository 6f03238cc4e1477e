"""Keyframe tracker with sliding-window bundle adjustment.

Port of onepose_tpu/tracker/ba_tracker.py (the reference BATracker,
src/tracker/ba_tracker.py). A tracked frame: LK flow of the keyframe's
keypoints that carry 3D ids into the query, RANSAC-PnP for an initial
pose, a constant-velocity motion prediction where that pose fails or
jumps more than 20 cm / 20 degrees; mutual-NN descriptor matching
keyframe <-> query, matched keypoints inheriting the keyframe's 3D ids
(gated at 1.2 x the median reprojection error), two-view triangulation of
the matched pairs without 3D (20 px in both views, an object-frame radius
gate); window BA over every observation (10 frames, 5 LM iterations).
Every `kf_interval` frames the result is committed as the new keyframe,
if its pose stays within 2 x the keyframe gate; otherwise the window is
rolled back. `update_kf` injects a matcher-verified keyframe, rejected
beyond 10 cm / 10 degrees.

The state is a dataclass of fixed-shape tensors on the tracker's device
(ring buffers of the window's frames, a point buffer), as the JAX
package's pytree. A tracked frame is host-launched PyTorch (the JAX
package makes it one jitted program); its diagnostics come back packed in
one [54] tensor, read once per frame by `_unpack`. The keyframe cadence is
a host counter, so a non-keyframe frame skips the commit selection and
the state it returns is the one it was given (only `pose_hist` moves).
Nothing writes into a state's tensors in place: every step builds new
ones, so a rolled-back window is the window before the frame.

Deliberate differences from the JAX package, each giving its results
where they are defined:
- the median of the reprojection gate has `jnp.median`'s semantics
  (`jnp_median`: NaN if any entry is NaN, the mean of the two middle
  values on an even count), not `torch.median`'s (the lower middle value)
  or `torch.nanmedian`'s (NaNs dropped). Copied defect: every slot
  without a 3D match is NaN, so the median is NaN, turned into inf, and
  the gate never fires (ROADMAP C watch item 5);
- the point-buffer scatter writes only the rows it stores (JAX writes
  every other row's old value back to row 0; the same result whenever
  the buffer is not empty), and the query frame's 3D ids drop their
  unwritten rows through a spare last row, not a scatter's drop mode;
- RANSAC takes `draws` [1, n_hyp, 3] (JAX draws them from
  `PRNGKey(frame_count)` or the caller's key); without them a CPU
  generator seeded with the frame count draws them;
- flow points that failed LK enter PnP as zeros: they are masked there,
  and the closed-form 2 x 2 inverse of `ops.optical_flow` gives NaN on a
  singular window (JAX's LU gives finite garbage), which times its zero
  weight would poison the refinement.
Copied as they are: the 3-strike motion counter `_use_motion_cnt`, which
nothing reads. Full fp32, TF32 off.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from onepose_tpu_torch._device import resolve_device
from onepose_tpu_torch.geometry.ransac import ransac_pnp
from onepose_tpu_torch.geometry.rotations import angle_axis_to_rotmat, rotmat_to_angle_axis
from onepose_tpu_torch.geometry.triangulation import triangulate_two_view
from onepose_tpu_torch.models.nn_matcher import mutual_nn_match
from onepose_tpu_torch.ops.lm import ba_solve
from onepose_tpu_torch.ops.optical_flow import pyramidal_lk
from onepose_tpu_torch.utils.precision import fp32_matmuls


@dataclasses.dataclass(frozen=True)
class TrackerConfig:
    window_size: int = 10
    n_kpts: int = 512
    point_capacity: int = 4096
    kf_interval: int = 5
    ba_iters: int = 5
    nn_distance_thresh: float = 0.7
    triang_max_reproj_px: float = 20.0
    max_point_radius: float = 0.5  # object-frame distance gate
    flow_accept_cm: float = 20.0
    flow_accept_deg: float = 20.0
    kf_reject_cm: float = 10.0
    kf_reject_deg: float = 10.0
    ransac_hyp: int = 128


@dataclasses.dataclass
class TrackerState:
    # Window ring buffers (axis 0 = slot).
    frame_kpts: torch.Tensor  # [W, N, 2]
    frame_descs: torch.Tensor  # [W, N, C]
    frame_p3d: torch.Tensor  # [W, N] int32 point-buffer ids (-1 = none)
    frame_mask: torch.Tensor  # [W, N]
    cam_poses: torch.Tensor  # [W, 6] (angle-axis, t) world->cam
    cam_intr: torch.Tensor  # [W, 3] (f, cx, cy)
    frame_valid: torch.Tensor  # [W]
    # Point buffer.
    points: torch.Tensor  # [P, 3]
    point_valid: torch.Tensor  # [P]
    n_points: torch.Tensor  # scalar int32
    # Keyframe context.
    kf_slot: torch.Tensor  # scalar int32
    kf_image: torch.Tensor  # [H, W]
    kf_pose: torch.Tensor  # [4, 4]
    # Motion history: last three poses (world->cam 4x4).
    pose_hist: torch.Tensor  # [3, 4, 4]


_FIELDS = tuple(f.name for f in dataclasses.fields(TrackerState))


def jnp_median(x: torch.Tensor) -> torch.Tensor:
    """The median of all of x with `jnp.median`'s semantics: NaN if any
    entry is NaN; on an even count the mean of the two middle values."""
    s = torch.sort(x.reshape(-1))[0]
    n = s.numel()
    mid = (s[(n - 1) // 2] + s[n // 2]) * 0.5
    return torch.where(torch.isnan(x).any(), torch.full_like(mid, torch.nan), mid)


def _row(x: torch.Tensor, i: torch.Tensor) -> torch.Tensor:
    """x[i] for a 0-d index tensor on x's device, without a host read."""
    return x.index_select(0, i.reshape(1).long())[0]


def _with_row(x: torch.Tensor, i: torch.Tensor, v) -> torch.Tensor:
    """A copy of x with row i set to v (no host read)."""
    v = torch.as_tensor(v, dtype=x.dtype, device=x.device)
    return x.index_copy(0, i.reshape(1).long(), v.expand(x.shape[1:])[None])


def pose_to_aa(pose: torch.Tensor) -> torch.Tensor:
    aa = rotmat_to_angle_axis(pose[..., :3, :3])
    return torch.cat([aa, pose[..., :3, 3]], dim=-1)


def aa_to_pose(cam: torch.Tensor) -> torch.Tensor:
    R = angle_axis_to_rotmat(cam[..., :3])
    top = torch.cat([R, cam[..., 3:6, None]], dim=-1)  # [..., 3, 4]
    bottom = torch.zeros(cam.shape[:-1] + (1, 4), dtype=cam.dtype, device=cam.device)
    bottom[..., 0, 3] = 1.0
    return torch.cat([top, bottom], dim=-2)


def pose_distance(p0: torch.Tensor, p1: torch.Tensor):
    """(trans cm, rot deg) between two 4x4 poses."""
    t = torch.linalg.vector_norm(p0[:3, 3] - p1[:3, 3]) * 100.0
    tr = torch.clamp(torch.trace(p0[:3, :3] @ p1[:3, :3].T), -1.0, 3.0)
    r = torch.rad2deg(torch.arccos((tr - 1.0) / 2.0))
    return t, r


def motion_prediction(pose_hist: torch.Tensor) -> torch.Tensor:
    """Constant-velocity extrapolation from the last three poses
    (reference ba_tracker.py:275-293, angle-axis instead of Euler)."""
    aa = pose_to_aa(pose_hist)  # [3, 6]
    v = ((aa[1] - aa[0]) + (aa[2] - aa[1])) / 2.0
    return aa_to_pose(aa[2] + v)


class BATracker:
    def __init__(self, config: TrackerConfig = TrackerConfig(),
                 device: str | torch.device = "cuda"):
        self.cfg = config
        self.device = resolve_device(device)
        self._frame_count = 0
        self._use_motion_cnt = 0
        self.state: Optional[TrackerState] = None

    def _t(self, x, dtype=torch.float32) -> torch.Tensor:
        return torch.as_tensor(x, device=self.device).to(dtype)

    # ------------------------------------------------------------------
    def initialize(self, image, kpts, descs, mask, p3d_ids, points3d, pose, K) -> None:
        """Start tracking from a posed frame whose keypoints carry 3D ids
        into `points3d` (e.g. the matcher's output on the first frame)."""
        cfg, dev = self.cfg, self.device
        W, N, P = cfg.window_size, cfg.n_kpts, cfg.point_capacity
        descs = self._t(descs)
        C = descs.shape[-1]
        K = self._t(K)
        points3d = self._t(points3d)
        n_pts = min(points3d.shape[0], P)
        points = torch.zeros((P, 3), dtype=torch.float32, device=dev)
        points[:n_pts] = points3d[:n_pts]
        point_valid = torch.zeros((P,), dtype=torch.bool, device=dev)
        point_valid[:n_pts] = True

        def first(shape, fill, row, dtype):
            x = torch.full(shape, fill, dtype=dtype, device=dev)
            x[0] = row
            return x

        pose = self._t(pose)
        self.state = TrackerState(
            frame_kpts=first((W, N, 2), 0, self._t(kpts)[:N], torch.float32),
            frame_descs=first((W, N, C), 0, descs[:N], torch.float32),
            frame_p3d=first((W, N), -1, self._t(p3d_ids, torch.int32)[:N], torch.int32),
            frame_mask=first((W, N), False, self._t(mask, torch.bool)[:N], torch.bool),
            cam_poses=first((W, 6), 0, pose_to_aa(pose), torch.float32),
            cam_intr=first((W, 3), 0, torch.stack([K[0, 0], K[0, 2], K[1, 2]]), torch.float32),
            frame_valid=first((W,), False, True, torch.bool),
            points=points,
            point_valid=point_valid,
            n_points=torch.tensor(n_pts, dtype=torch.int32, device=dev),
            kf_slot=torch.tensor(0, dtype=torch.int32, device=dev),
            kf_image=self._t(image),
            kf_pose=pose,
            pose_hist=torch.stack([pose, pose, pose]),
        )
        self._frame_count = 1

    # ------------------------------------------------------------------
    def update_kf(self, image, kpts, descs, mask, p3d_ids, pose, K) -> bool:
        """Inject a matcher-verified keyframe (reference update_kf,
        src/tracker/ba_tracker.py:128-145): rejected when the proposed
        pose jumps more than kf_reject_cm / kf_reject_deg from the last
        tracked pose. `p3d_ids` index the SAME point cloud passed to
        initialize() (the object map). Returns True when the keyframe was
        accepted."""
        assert self.state is not None, "call initialize() first"
        cfg = self.cfg
        pose = self._t(pose)
        if not bool(_kf_accept(self.state.pose_hist[2], pose, cfg)):
            return False

        st = self.state
        N = cfg.n_kpts
        slot = torch.tensor((int(st.kf_slot) + 1) % cfg.window_size, dtype=torch.int32,
                            device=self.device)
        K = self._t(K)
        self.state = dataclasses.replace(
            st,
            frame_kpts=_with_row(st.frame_kpts, slot, self._t(kpts)[:N]),
            frame_descs=_with_row(st.frame_descs, slot, self._t(descs)[:N]),
            frame_p3d=_with_row(st.frame_p3d, slot, self._t(p3d_ids, torch.int32)[:N]),
            frame_mask=_with_row(st.frame_mask, slot, self._t(mask, torch.bool)[:N]),
            cam_poses=_with_row(st.cam_poses, slot, pose_to_aa(pose)),
            cam_intr=_with_row(st.cam_intr, slot, torch.stack([K[0, 0], K[0, 2], K[1, 2]])),
            frame_valid=_with_row(st.frame_valid, slot, True),
            kf_slot=slot,
            kf_image=self._t(image),
            kf_pose=pose,
            pose_hist=torch.cat([st.pose_hist[1:], pose[None]], dim=0),
        )
        self._frame_count += 1
        return True

    # ------------------------------------------------------------------
    def track(self, image, kpts, descs, mask, K, draws: Optional[torch.Tensor] = None) -> dict:
        """Track one frame; returns dict(pose, pose_init, pose_flow,
        flow_ok, used_motion, n_tracked, n_new_points, ba_cost_initial,
        ba_cost_final), numpy and Python scalars.

        draws [1, ransac_hyp, 3]: the flow PnP's RANSAC uniforms, or None
        to draw them from a CPU generator seeded with the frame count. The
        whole flow -> PnP -> match -> triangulate -> window-BA chain is
        `_megastep`; its diagnostics are read back once, by `_unpack`."""
        assert self.state is not None, "call initialize() first"
        cfg = self.cfg
        if draws is None:
            gen = torch.Generator().manual_seed(self._frame_count)
            draws = torch.rand((1, cfg.ransac_hyp, 3), generator=gen)
        is_kf = (self._frame_count % cfg.kf_interval) == 0
        have_hist = self._frame_count >= 3
        self.state, packed = _megastep(
            self.state, self._t(image), self._t(kpts), self._t(descs),
            self._t(mask, torch.bool), self._t(K), is_kf, have_hist, draws, cfg)
        self._frame_count += 1
        return self._unpack(packed)

    def _unpack(self, packed: torch.Tensor) -> dict:
        """The one host read of a frame: the packed diagnostics."""
        v = packed.cpu().numpy()  # [54]
        flow_ok = bool(v[48] > 0.5)
        if flow_ok:
            self._use_motion_cnt = 0
        else:
            self._use_motion_cnt += 1
        return {
            "pose": v[0:16].reshape(4, 4),
            "pose_init": v[16:32].reshape(4, 4),
            "pose_flow": v[32:48].reshape(4, 4),
            "flow_ok": flow_ok,
            "used_motion": not flow_ok,
            "n_tracked": int(v[50]),
            "n_new_points": int(v[51]),
            "ba_cost_initial": float(v[52]),
            "ba_cost_final": float(v[53]),
        }


# ----------------------------------------------------------------------
@fp32_matmuls()
def _kf_accept(last_pose, pose, cfg: TrackerConfig) -> torch.Tensor:
    """Keyframe accept predicate (reference ba_tracker.py:128-145) as one
    scalar: finite AND within the pose-jump gates."""
    t_j, r_j = pose_distance(last_pose, pose)
    return torch.isfinite(pose).all() & (t_j < cfg.kf_reject_cm) & (r_j < cfg.kf_reject_deg)


def _flow_pose(st: TrackerState, image, K, draws, cfg: TrackerConfig) -> dict:
    """LK-track keyframe keypoints with 3D ids into the query; PnP."""
    kf = st.kf_slot
    kpts = _row(st.frame_kpts, kf)
    p3d = _row(st.frame_p3d, kf)
    has3d = (p3d >= 0) & _row(st.frame_mask, kf)
    new_pts, status = pyramidal_lk(st.kf_image, image, kpts)
    valid = has3d & status
    pts3d = st.points[p3d.clamp(min=0).long()]
    pnp = ransac_pnp(torch.where(valid[:, None], new_pts, 0.0)[None], pts3d[None], K[None],
                     valid[None], draws=draws, n_hyp=cfg.ransac_hyp)
    return {
        "pose": pnp["pose"][0],
        "ok": pnp["ok"][0] & (pnp["num_inliers"][0] >= 6),
        "num_inliers": pnp["num_inliers"][0],
        "flow_pts": new_pts,
        "flow_valid": valid,
    }


def _track_ba_step(st: TrackerState, kpts, descs, mask, K, pose_init, cfg: TrackerConfig):
    """Match KF<->query, inherit/extend 3D, window BA, slot insertion.
    Returns (a new state, diagnostics); `st` is left as it was."""
    W, N, P = cfg.window_size, cfg.n_kpts, cfg.point_capacity
    dev = kpts.device
    kf = st.kf_slot
    kf_kpts, kf_p3d = _row(st.frame_kpts, kf), _row(st.frame_p3d, kf)

    # 1. NN match keyframe -> query.
    m = mutual_nn_match(_row(st.frame_descs, kf), descs, _row(st.frame_mask, kf), mask,
                        distance_thresh=cfg.nn_distance_thresh)
    midx = m["matches0"].clamp(min=0).long()  # [N] query index per KF kpt
    matched = m["matches0"] >= 0

    # 2. Existing 3D: the query keypoint inherits the KF 3D id, gated by
    # reprojection error under pose_init (< 1.2 x median of the matched
    # set; the median is NaN unless every slot is matched: never fires).
    q_kpts = kpts[midx]  # [N, 2] query position per KF slot
    has3d = matched & (kf_p3d >= 0)
    pts3d = st.points[kf_p3d.clamp(min=0).long()]
    p_cam = pts3d @ pose_init[:3, :3].T + pose_init[:3, 3]
    pix = p_cam @ K.T
    uv_hat = pix[:, :2] / pix[:, 2:].abs().clamp(min=1e-9)
    rep_err = torch.linalg.vector_norm(uv_hat - q_kpts, dim=-1)
    med = jnp_median(torch.where(has3d, rep_err, torch.nan))
    med = torch.where(torch.isnan(med), torch.inf, med)
    keep3d = has3d & (rep_err < 1.2 * med)

    # 3. New points: matched pairs without 3D -> two-view triangulation.
    tri_cand = matched & (kf_p3d < 0)
    kf_pose_mat = aa_to_pose(_row(st.cam_poses, kf))
    f_kf, cx_kf, cy_kf = _row(st.cam_intr, kf).unbind()
    zero, one = torch.zeros_like(f_kf), torch.ones_like(f_kf)
    K_kf = torch.stack([f_kf, zero, cx_kf, zero, f_kf, cy_kf, zero, zero, one]).reshape(3, 3)
    P_kf = K_kf @ kf_pose_mat[:3, :4]
    P_q = K @ pose_init[:3, :4]
    xyz_new = triangulate_two_view(kf_kpts, q_kpts, P_kf, P_q)  # [N, 3]

    def reproj(Pm, X):
        x = torch.cat([X, torch.ones_like(X[..., :1])], -1) @ Pm.T
        return x[..., :2] / x[..., 2:].abs().clamp(min=1e-9)

    err_kf = torch.linalg.vector_norm(reproj(P_kf, xyz_new) - kf_kpts, dim=-1)
    err_q = torch.linalg.vector_norm(reproj(P_q, xyz_new) - q_kpts, dim=-1)
    tri_ok = (tri_cand
              & (err_kf < cfg.triang_max_reproj_px)
              & (err_q < cfg.triang_max_reproj_px)
              & (torch.linalg.vector_norm(xyz_new, dim=-1) < cfg.max_point_radius)
              & torch.isfinite(xyz_new).all(dim=-1))

    # Allocate point ids for new points (prefix sum into the buffer); only
    # the stored rows are written, the others go to a spare row P.
    order = torch.cumsum(tri_ok.int(), dim=0, dtype=torch.int32) - 1
    new_ids = st.n_points + order
    can_store = tri_ok & (new_ids < P)
    new_ids_c = torch.where(can_store, new_ids, 0)
    dest = torch.where(can_store, new_ids, P).long()
    points = torch.cat([st.points, st.points.new_zeros(1, 3)]).index_copy(0, dest, xyz_new)[:P]
    point_valid = torch.cat([st.point_valid, st.point_valid.new_zeros(1)]).index_copy(
        0, dest, can_store)[:P]
    n_points = torch.clamp(st.n_points + can_store.sum(), max=P).to(torch.int32)

    # 4. Query frame's per-keypoint 3D ids, written through the query
    # index (mutual NN makes midx unique over matched slots); unwritten
    # slots go to a spare row N.
    src_ids = torch.where(keep3d, kf_p3d.clamp(min=0), torch.where(can_store, new_ids_c, -1))
    write = (keep3d | can_store) & matched
    write_idx = torch.where(write, midx, N)
    q_p3d = torch.full((N + 1,), -1, dtype=torch.int32, device=dev).index_copy(
        0, write_idx, src_ids.to(torch.int32))[:N]

    # 5. Insert the query frame into the window: it takes the slot of the
    # OLDEST window entry (ring buffer).
    oldest = (st.kf_slot + 1) % W
    st2 = dataclasses.replace(
        st,
        frame_kpts=_with_row(st.frame_kpts, oldest, kpts),
        frame_descs=_with_row(st.frame_descs, oldest, descs),
        frame_p3d=_with_row(st.frame_p3d, oldest, q_p3d),
        frame_mask=_with_row(st.frame_mask, oldest, mask),
        cam_poses=_with_row(st.cam_poses, oldest, pose_to_aa(pose_init)),
        cam_intr=_with_row(st.cam_intr, oldest, torch.stack([K[0, 0], K[0, 2], K[1, 2]])),
        frame_valid=_with_row(st.frame_valid, oldest, True),
        points=points,
        point_valid=point_valid,
        n_points=n_points,
        kf_slot=oldest,
    )

    # 6. Window BA over all observations with 3D ids.
    obs_p = st2.frame_p3d.reshape(-1)  # [W*N]
    obs_mask = (obs_p >= 0) & st2.frame_mask.reshape(-1) & st2.frame_valid.repeat_interleave(N)
    uv = st2.frame_kpts.reshape(-1, 2)
    cam_idx = torch.arange(W, device=dev).repeat_interleave(N)
    features = torch.cat([uv, st2.cam_intr[cam_idx]], dim=-1)  # [W*N, 5]
    # Gauge: fix the oldest valid camera (the one right after the new slot
    # in ring order); the keyframe where that slot is still empty.
    anchor = (oldest + 1) % W
    fix = torch.zeros(W, dtype=torch.float32, device=dev).index_fill(0, anchor.reshape(1).long(),
                                                                    1.0)
    fix = torch.where(_row(st.frame_valid, anchor), fix,
                      fix.index_fill(0, kf.reshape(1).long(), 1.0))
    ba = ba_solve(st2.points, st2.cam_poses, features, obs_p.clamp(min=0), cam_idx, obs_mask,
                  point_mask=st2.point_valid, fix_cam_mask=fix, n_iters=cfg.ba_iters)
    st3 = dataclasses.replace(st2, points=ba["points"], cam_poses=ba["cam_poses"])
    pose_opt = aa_to_pose(_row(ba["cam_poses"], oldest))

    return st3, {
        "pose_opt": pose_opt,
        "n_tracked": keep3d.sum(),
        "n_new": can_store.sum(),
        "cost_initial": ba["cost_initial"],
        "cost_final": ba["cost_final"],
    }


# ----------------------------------------------------------------------
@fp32_matmuls()
def _megastep(st: TrackerState, image, kpts, descs, mask, K, is_kf: bool, have_hist: bool,
              draws, cfg: TrackerConfig):
    """The whole tracked frame: LK flow -> PnP init (with the motion-
    prediction fallback) -> NN match -> 3D inherit / triangulate -> window
    BA -> pose-accept policy -> conditional state commit. Returns
    (new_state, packed): packed is a single [54] fp32 tensor of
    diagnostics, the caller's only host read. `is_kf` / `have_hist` are
    the host's keyframe-cadence flags."""
    flow = _flow_pose(st, image, K, draws, cfg)
    pose_ftk = flow["pose"]
    last_pose = st.pose_hist[2]
    t_d, r_d = pose_distance(last_pose, pose_ftk)
    pose_mo = motion_prediction(st.pose_hist) if have_hist else last_pose
    flow_ok = flow["ok"] & (t_d < cfg.flow_accept_cm) & (r_d < cfg.flow_accept_deg)
    pose_init = torch.where(flow_ok, pose_ftk, pose_mo)

    new_state, out = _track_ba_step(st, kpts, descs, mask, K, pose_init, cfg)
    pose_opt = out["pose_opt"]

    # Pose-accept policy (reference KF rejection, ba_tracker.py:128-145,
    # at 2x the keyframe gate for in-window frames).
    t_j, r_j = pose_distance(last_pose, pose_opt)
    accept = (torch.isfinite(pose_opt).all() & (t_j < cfg.kf_reject_cm * 2)
              & (r_j < cfg.kf_reject_deg * 2))
    pose_final = torch.where(accept, pose_opt, pose_init)

    # Only accepted keyframes persist into the window / point database
    # (reference cadence every kf_interval frames, ba_tracker.py:684);
    # otherwise the window is the one before the frame.
    sel = st
    if is_kf:
        committed = dataclasses.replace(new_state, kf_image=image, kf_pose=pose_final)
        sel = TrackerState(**{f: torch.where(accept, getattr(committed, f), getattr(st, f))
                              for f in _FIELDS})
    sel = dataclasses.replace(sel, pose_hist=torch.cat([sel.pose_hist[1:], pose_final[None]]))

    packed = torch.cat([
        pose_final.reshape(-1),
        pose_init.reshape(-1),
        pose_ftk.reshape(-1),
        torch.stack([flow_ok.float(), accept.float(), out["n_tracked"].float(),
                     out["n_new"].float(), out["cost_initial"].float(),
                     out["cost_final"].float()]),
    ])
    return sel, packed
