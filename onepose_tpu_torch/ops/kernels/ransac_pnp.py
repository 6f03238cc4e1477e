"""RANSAC-PnP on the card: K9, the CUDA kernel pair `csrc/ransac_pnp.cu`.

Replaces no Pallas kernel. The JAX package compiles the whole of
`geometry/ransac.py::ransac_pnp` into one XLA program; in eager PyTorch the
same function is about 2400 small kernels a serving call, each launched by
the host, and two host syncs, so the host paced the call. K9 computes it
stage by stage in fp32 in two launches: `hypotheses` (launch A: the
valid-first order, the minimal samples, P3P and the preemptive scoring) and
`refine` (launch B: the stable keep, the second scoring, Gauss-Newton and
the final stage). Bound on the H100: operations, about 0.71 GFLOP of fp32 at
[64, 1000, 512] (`portbench/counts.py::ransac_pnp`), 0.0106 ms at 67
TFLOP/s; see the source for the design and its rounding.

The plain version is `geometry.ransac.ransac_pnp_plain`;
`geometry.ransac.ransac_pnp` runs it for CPU tensors and K9 for CUDA
tensors, with no fallback. With epnp_refit, launch B runs as `score` (its
second scoring only) and `refine(..., start=...)` (from the pose that the
EPnP choice takes), so a call launches A, B1 and B2. `launches` counts
every launch: 2 a call, 3 with epnp_refit.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from onepose_tpu_torch.ops.kernels import _build

MAX_POINTS = 1 << 19  # matches a frame: the valid bit set lives in shared memory
MAX_FRAMES = 65535  # launch A's grid rows
launches = 0  # kernel launches since the last reset (ops.kernels.reset_launches)

_FULL, _SCORE, _FROM_START = 0, 1, 2  # launch B's modes


class Hypotheses(NamedTuple):
    """Launch A's scratch: each candidate's pose (R row-major, t) [B, 4H, 12]
    and its (preemptive count times ok, ok) [B, 4H, 2] int32."""

    poses: torch.Tensor
    counts: torch.Tensor


class Best(NamedTuple):
    """The second scoring's result, a frame each: the best pose as launch B
    reads it (R row-major, t in scaled units) [B, 12], its inlier mask
    [B, N] (without ok) and its count times ok [B] int32."""

    pose: torch.Tensor
    inliers: torch.Tensor
    count: torch.Tensor

    @property
    def R(self) -> torch.Tensor:
        return self.pose[:, :9].reshape(-1, 3, 3)

    @property
    def t(self) -> torch.Tensor:
        return self.pose[:, 9:]


def check_inputs(pts2d, pts3d, K, mask, draws) -> tuple[int, int, int]:
    """(B, N, H) of the inputs the kernels take: fp32 pts2d [B, N, 2],
    pts3d [B, N, 3], K [B, 3, 3] and draws [B, H, 3], a bool mask [B, N], all
    contiguous on one CUDA device and needing no gradient. Raises ValueError
    on anything else (types and shapes first, then the device), before any
    launch."""
    for t, what, dtype, rank in ((pts2d, "pts2d", torch.float32, 3),
                                 (pts3d, "pts3d", torch.float32, 3),
                                 (K, "K", torch.float32, 3), (mask, "mask", torch.bool, 2),
                                 (draws, "draws", torch.float32, 3)):
        if t.dtype != dtype:
            raise ValueError(f"ransac_pnp kernel: {what} must be {dtype}, got {t.dtype}")
        if t.dim() != rank:
            raise ValueError(f"ransac_pnp kernel: {what} must have rank {rank}, "
                             f"got shape {tuple(t.shape)}")
    B, N = pts2d.shape[:2]
    H = draws.shape[1]
    want = {"pts2d": (B, N, 2), "pts3d": (B, N, 3), "K": (B, 3, 3), "mask": (B, N),
            "draws": (B, H, 3)}
    for what, t in (("pts2d", pts2d), ("pts3d", pts3d), ("K", K), ("mask", mask),
                    ("draws", draws)):
        if tuple(t.shape) != want[what]:
            raise ValueError(f"ransac_pnp kernel: {what} must be {list(want[what])}, got "
                             f"{list(t.shape)}")
    if not (1 <= B <= MAX_FRAMES and 1 <= N <= MAX_POINTS and 1 <= H):
        raise ValueError(f"ransac_pnp kernel takes 1 to {MAX_FRAMES} frames of 1 to "
                         f"{MAX_POINTS} matches and at least one hypothesis, got "
                         f"[{B}, {N}, {H}]")
    dev = pts2d.device
    for what, t in (("pts2d", pts2d), ("pts3d", pts3d), ("K", K), ("mask", mask),
                    ("draws", draws)):
        if t.device.type != "cuda" or t.device != dev:
            raise ValueError(f"ransac_pnp kernel: expected CUDA tensors on one device, got "
                             f"{what} on {t.device} (pts2d on {dev})")
        if not t.is_contiguous():
            raise ValueError(f"ransac_pnp kernel: {what} must be contiguous")
    _build.require_inference("ransac_pnp kernel", pts2d, pts3d, K, draws)
    return B, N, H


def hypotheses(pts2d, pts3d, K, mask, draws, reproj_threshold: float,
               scale: float) -> Hypotheses:
    """Launch A: every sample's P3P poses and their preemptive counts."""
    B, N, H = check_inputs(pts2d, pts3d, K, mask, draws)
    dev = pts2d.device
    hyp = Hypotheses(torch.empty((B, 4 * H, 12), dtype=torch.float32, device=dev),
                     torch.empty((B, 4 * H, 2), dtype=torch.int32, device=dev))
    lib = _build.load("ransac_pnp")
    err = lib.ransac_pnp_hypotheses_launch(
        *(_build.ptr(t) for t in (pts2d, pts3d, K, mask, draws)), B, N, H,
        float(reproj_threshold), float(scale), _build.ptr(hyp.poses), _build.ptr(hyp.counts),
        _build.stream(dev))
    _build.check(lib, err, "ransac_pnp hypotheses kernel")
    global launches
    launches += 1
    return hyp


def _launch_b(hyp, pts2d, pts3d, K, mask, reproj_threshold, refine_iters, scale, mode,
              start, inl, count) -> dict:
    B, N = pts2d.shape[:2]
    H = hyp.poses.shape[1] // 4
    dev = pts2d.device
    out = {"pose": torch.empty((B, 4, 4), dtype=torch.float32, device=dev),
           "R": torch.empty((B, 3, 3), dtype=torch.float32, device=dev),
           "t": torch.empty((B, 3), dtype=torch.float32, device=dev),
           "inliers": torch.empty((B, N), dtype=torch.bool, device=dev),
           "num_inliers": torch.empty((B,), dtype=torch.int64, device=dev),
           "ok": torch.empty((B,), dtype=torch.bool, device=dev)}
    lib = _build.load("ransac_pnp")
    err = lib.ransac_pnp_refine_launch(
        *(_build.ptr(t) for t in (hyp.poses, hyp.counts, pts2d, pts3d, K, mask)), B, N, H,
        float(reproj_threshold), float(scale), int(refine_iters), mode,
        *(_build.ptr(t) for t in (start, inl, count, out["pose"], out["R"], out["t"],
                                  out["inliers"], out["num_inliers"], out["ok"])),
        _build.stream(dev))
    _build.check(lib, err, "ransac_pnp refine kernel")
    global launches
    launches += 1
    return out


def _scratch(B: int, N: int, dev) -> tuple:
    return (torch.empty((B, 12), dtype=torch.float32, device=dev),
            torch.empty((B, N), dtype=torch.bool, device=dev),
            torch.empty((B,), dtype=torch.int32, device=dev))


def refine(hyp: Hypotheses, pts2d, pts3d, K, mask, reproj_threshold: float,
           refine_iters: int, scale: float, start: Optional[Best] = None) -> dict:
    """Launch B: the outputs of `ransac_pnp` (pose [B, 4, 4], R, t,
    inliers [B, N], num_inliers [B] int64, ok [B]). From launch A's
    hypotheses (the keep and the second scoring first), or with `start`
    from its pose, inlier mask and count (the refine and the final stage
    only)."""
    B, N = pts2d.shape[:2]
    if start is None:
        return _launch_b(hyp, pts2d, pts3d, K, mask, reproj_threshold, refine_iters, scale,
                         _FULL, *_scratch(B, N, pts2d.device))
    return _launch_b(hyp, pts2d, pts3d, K, mask, reproj_threshold, refine_iters, scale,
                     _FROM_START, start.pose.contiguous(), start.inliers.contiguous(),
                     start.count.contiguous())


def score(hyp: Hypotheses, pts2d, pts3d, K, mask, reproj_threshold: float,
          scale: float) -> Best:
    """Launch B's second scoring alone (epnp_refit's first half): the best
    kept pose, its inlier mask and its count."""
    B, N = pts2d.shape[:2]
    pose, inl, count = _scratch(B, N, pts2d.device)
    _launch_b(hyp, pts2d, pts3d, K, mask, reproj_threshold, 0, scale, _SCORE, pose, inl, count)
    return Best(pose, inl, count)


def start_from(R: torch.Tensor, t: torch.Tensor, best: Best) -> Best:
    """`best` with the refine's start pose replaced by R [B, 3, 3], t [B, 3]."""
    return best._replace(pose=torch.cat([R.reshape(-1, 9), t], dim=1).to(torch.float32))
