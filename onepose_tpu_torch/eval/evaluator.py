"""cm-degree recall evaluator.

Port of onepose_tpu/eval/evaluator.py (numpy on the host): per-frame
booleans trans < X cm AND rot < X deg for X in {1, 3, 5}; `summarize`
returns mean recalls and resets; `counts` / `combine_counts` give the
fixed-size sufficient statistics that merge exactly across processes.

The errors come from the port's `geometry.metrics.query_pose_error` in
float32, as the JAX package computes them (its float64 inputs become
float32 under JAX's default configuration): near the identity the
rotation error's arccos then reads about 0.02 degrees of rounding.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from onepose_tpu_torch.geometry.metrics import query_pose_error


def _pose_errors(pred, gt) -> tuple[np.ndarray, np.ndarray]:
    """(rotation deg, translation cm) of [..., 3|4, 4] poses, in float32."""
    as32 = lambda x: torch.as_tensor(np.asarray(x, np.float64)).float()  # noqa: E731
    r, t = query_pose_error(as32(pred), as32(gt))
    return r.numpy(), t.numpy()


class Evaluator:
    def __init__(self, thresholds=(1, 3, 5)):
        self.thresholds = tuple(thresholds)
        self.reset()

    def reset(self) -> None:
        self.r_errs: list[float] = []
        self.t_errs: list[float] = []

    def evaluate(self, pose_pred, pose_gt) -> None:
        """Accumulate one pose or a batch ([..., 4, 4] or [..., 3, 4]; numpy
        or tensors). pose_pred=None records a failed frame (counts against
        recall)."""
        if pose_pred is None:
            self.r_errs.append(np.inf)
            self.t_errs.append(np.inf)
            return
        if isinstance(pose_pred, torch.Tensor):
            pose_pred = pose_pred.detach().cpu().numpy()
        if isinstance(pose_gt, torch.Tensor):
            pose_gt = pose_gt.detach().cpu().numpy()
        r, t = _pose_errors(pose_pred, pose_gt)
        self.r_errs.extend(np.atleast_1d(r).tolist())
        self.t_errs.extend(np.atleast_1d(t).tolist())

    def summarize(self, reset: bool = True) -> dict:
        r = np.asarray(self.r_errs)
        t = np.asarray(self.t_errs)
        out = {}
        for x in self.thresholds:
            out[f"cmd{x}"] = float(np.mean((r < x) & (t < x))) if len(r) else 0.0
        out["mean_rot_deg"] = (float(np.mean(r[np.isfinite(r)])) if np.any(np.isfinite(r))
                               else float("inf"))
        out["mean_trans_cm"] = (float(np.mean(t[np.isfinite(t)])) if np.any(np.isfinite(t))
                                else float("inf"))
        out["num_frames"] = int(len(r))
        if reset:
            self.reset()
        return out

    def counts(self) -> dict:
        """Fixed-size sufficient statistics for cross-process aggregation."""
        r = np.asarray(self.r_errs)
        t = np.asarray(self.t_errs)
        out = {f"hits_{x}": float(np.sum((r < x) & (t < x))) if len(r) else 0.0
               for x in self.thresholds}
        out["n"] = float(len(r))
        fin = np.isfinite(r)
        out["rot_sum"] = float(np.sum(r[fin])) if fin.any() else 0.0
        out["rot_cnt"] = float(fin.sum())
        fin = np.isfinite(t)
        out["trans_sum"] = float(np.sum(t[fin])) if fin.any() else 0.0
        out["trans_cnt"] = float(fin.sum())
        return out

    @staticmethod
    def combine_counts(counts: list) -> dict:
        """Merge per-process `counts()` dicts into summarize()-format
        metrics; recalls weight every frame equally however the frames
        were shared out."""
        tot = {k: sum(float(c[k]) for c in counts) for k in counts[0]}
        n = tot["n"]
        out = {}
        for k in tot:
            if k.startswith("hits_"):
                out["cmd" + k[5:]] = tot[k] / n if n else 0.0
        out["mean_rot_deg"] = tot["rot_sum"] / tot["rot_cnt"] if tot["rot_cnt"] else float("inf")
        out["mean_trans_cm"] = (tot["trans_sum"] / tot["trans_cnt"] if tot["trans_cnt"]
                                else float("inf"))
        out["num_frames"] = int(n)
        return out


def record_eval_result(out_dir: str, name: str, metrics: dict) -> str:
    """Write per-sequence eval results as a text file, one `key: value` a line."""
    os.makedirs(out_dir, exist_ok=True)
    path = os.path.join(out_dir, f"{name}.txt")
    with open(path, "w") as f:
        for k, v in metrics.items():
            f.write(f"{k}: {v}\n")
    return path
