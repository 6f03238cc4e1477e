"""Training callbacks.

Port of onepose_tpu/train/callbacks.py, every class and function: the
reference's callback suite (src/callbacks/wandb_callbacks.py:17-234 and
PL's ModelCheckpoint) on local artifacts:

- TensorBoardLogger      <- TB / W&B scalar logging (train_GATsSPG.yaml:95-99)
- BestMetricTracker      <- LogBestMetricScoresToWandb
- CodeSnapshot           <- UploadCodeToWandbAsArtifact
- BestCheckpoint         <- ModelCheckpoint(monitor='val/loss')
- MatchPRCurve           <- LogF1PrecisionRecallHeatmapToWandb (a threshold
                            sweep of the dual-softmax confidence matrix)
- ConfusionMatrixLogger  <- LogConfusionMatrixToWandb
- GradientWatch          <- WatchModelWithWandb (gradient and parameter norms)
- log_hyperparameters    <- template_utils.log_hparams_to_all_loggers

The loop calls them with plain dicts and the `TrainState`. A callback that
runs the model takes the state's parameters into its own `model` first
(the JAX package applies its model to `state.params`). None writes from a
process of rank above 0.
"""

from __future__ import annotations

import json
import os
import os.path as osp
import zipfile
from typing import Optional, Sequence

import numpy as np
import torch

from onepose_tpu_torch.utils.checkpoint import msgpack_serialize
from onepose_tpu_torch.utils.precision import fp32_matmuls

SNAPSHOT_SUFFIXES = (".py", ".cu", ".cuh", ".cpp")  # the port's sources, kernels included


class Callback:
    def on_train_start(self, run_dir: str, config: dict) -> None: ...

    def on_epoch_end(self, epoch: int, record: dict, state) -> None: ...

    def on_train_end(self, history: list) -> None: ...


def _is_main_process() -> bool:
    dist = torch.distributed
    return not (dist.is_available() and dist.is_initialized()) or dist.get_rank() == 0


def _batch_on(batch: dict, device: torch.device) -> dict:
    return {k: (v if isinstance(v, torch.Tensor) else torch.from_numpy(np.asarray(v))).to(device)
            for k, v in batch.items()}


def _conf_matrix(model, state, batch: dict) -> np.ndarray:
    """The dense confidence matrix of `batch` under the state's parameters."""
    model.load_state_dict(state.model.state_dict())
    dev = next(model.parameters()).device
    b = _batch_on(batch, dev)
    with torch.no_grad(), fp32_matmuls():
        out = model(b["desc2d"], b["desc3d"], b["leaf_desc"], b.get("mask2d"), b.get("mask3d"),
                    b.get("leaf_mask"))
    return out["conf_matrix"].cpu().numpy()


class TensorBoardLogger(Callback):
    """Scalar logging to TensorBoard event files (torch.utils.tensorboard,
    imported here; a no-op where it cannot be imported, as in the JAX
    package)."""

    def __init__(self, log_dir: str):
        self.log_dir = log_dir
        self._writer = None

    def on_train_start(self, run_dir: str, config: dict) -> None:
        if not _is_main_process():
            return
        try:
            from torch.utils.tensorboard import SummaryWriter

            self._writer = SummaryWriter(self.log_dir)
            self._writer.add_text("config", json.dumps(config, default=str))
        except Exception:  # no tensorboard package, or it fails to start: log nothing
            self._writer = None

    def on_epoch_end(self, epoch: int, record: dict, state) -> None:
        if self._writer is None:
            return
        for k, v in record.items():
            if isinstance(v, (int, float)) and k != "epoch":
                self._writer.add_scalar(k, v, epoch)
        self._writer.flush()

    def on_train_end(self, history: list) -> None:
        if self._writer is not None:
            self._writer.close()


class BestMetricTracker(Callback):
    """The best value of each metric so far, written to best_metrics.json at
    every improvement (LogBestMetricScoresToWandb, wandb_callbacks.py:205-234);
    a key containing one of `minimize` is better lower."""

    def __init__(self, run_dir: Optional[str] = None, minimize=("loss",)):
        self.run_dir = run_dir
        self.minimize_keys = tuple(minimize)
        self.best: dict = {}

    def on_train_start(self, run_dir: str, config: dict) -> None:
        self.run_dir = self.run_dir or run_dir

    def _better(self, key: str, value: float) -> bool:
        if key not in self.best:
            return True
        lo = any(m in key for m in self.minimize_keys)
        return value < self.best[key] if lo else value > self.best[key]

    def on_epoch_end(self, epoch: int, record: dict, state) -> None:
        improved = False
        for k, v in record.items():
            if isinstance(v, (int, float)) and k != "epoch" and self._better(k, v):
                self.best[k] = v
                improved = True
        if improved and _is_main_process() and self.run_dir:
            os.makedirs(self.run_dir, exist_ok=True)
            with open(osp.join(self.run_dir, "best_metrics.json"), "w") as f:
                json.dump(self.best, f, indent=1)


class CodeSnapshot(Callback):
    """Zip the onepose_tpu_torch sources (Python and the kernels' CUDA and
    C++) into the run directory, so that a run can be rebuilt from its
    artifacts (UploadCodeToWandbAsArtifact, wandb_callbacks.py:32-56)."""

    def on_train_start(self, run_dir: str, config: dict) -> None:
        if not _is_main_process():
            return
        import onepose_tpu_torch

        pkg_dir = osp.dirname(onepose_tpu_torch.__file__)
        os.makedirs(run_dir, exist_ok=True)
        out = osp.join(run_dir, "code_snapshot.zip")
        with zipfile.ZipFile(out, "w", zipfile.ZIP_DEFLATED) as zf:
            for root, _, files in os.walk(pkg_dir):
                for fn in sorted(files):
                    if fn.endswith(SNAPSHOT_SUFFIXES):
                        p = osp.join(root, fn)
                        zf.write(p, osp.relpath(p, osp.dirname(pkg_dir)))


class BestCheckpoint(Callback):
    """Write best.msgpack, the whole train state in the checkpoint format,
    and best.json whenever the monitored metric improves (ModelCheckpoint's
    monitor, train_GATsSPG.yaml:83-91)."""

    def __init__(self, ckpt_dir: str, monitor: str = "val_loss", mode: str = "min"):
        self.ckpt_dir = ckpt_dir
        self.monitor = monitor
        self.mode = mode
        self.best_value: Optional[float] = None

    def on_epoch_end(self, epoch: int, record: dict, state) -> None:
        if self.monitor not in record or not _is_main_process():
            return
        v = float(record[self.monitor])
        better = self.best_value is None or (
            v < self.best_value if self.mode == "min" else v > self.best_value)
        if better:
            self.best_value = v
            os.makedirs(self.ckpt_dir, exist_ok=True)
            path = osp.join(self.ckpt_dir, "best.msgpack")
            with open(path + ".tmp", "wb") as f:
                f.write(msgpack_serialize(state.state_dict()))
            os.replace(path + ".tmp", path)
            with open(osp.join(self.ckpt_dir, "best.json"), "w") as f:
                json.dump({"epoch": epoch, self.monitor: v}, f)


def match_pr_curve(
    conf_matrix: np.ndarray,
    conf_gt: np.ndarray,
    thresholds: Sequence[float] = (0.05, 0.1, 0.2, 0.3, 0.5, 0.7),
) -> dict:
    """Precision, recall and F1 of thresholded dual-softmax confidences
    against the ground-truth assignment (wandb_callbacks.py:96-157)."""
    gt = conf_gt > 0.5
    out = {"thresholds": list(thresholds), "precision": [], "recall": [], "f1": []}
    for t in thresholds:
        pred = conf_matrix > t
        tp = float(np.sum(pred & gt))
        p = tp / max(float(np.sum(pred)), 1.0)
        r = tp / max(float(np.sum(gt)), 1.0)
        out["precision"].append(p)
        out["recall"].append(r)
        out["f1"].append(2 * p * r / max(p + r, 1e-9))
    return out


def match_confusion(conf_matrix: np.ndarray, conf_gt: np.ndarray, threshold: float = 0.2) -> dict:
    """2 x 2 confusion of thresholded match confidences against the
    ground-truth assignment (wandb_callbacks.py:159-203), per cell of the
    confidence matrix."""
    pred = conf_matrix > threshold
    gt = conf_gt > 0.5
    tp = int(np.sum(pred & gt))
    fp = int(np.sum(pred & ~gt))
    fn = int(np.sum(~pred & gt))
    tn = int(np.sum(~pred & ~gt))
    return {
        "tp": tp, "fp": fp, "fn": fn, "tn": tn,
        "accuracy": (tp + tn) / max(tp + fp + fn + tn, 1),
        "threshold": threshold,
    }


class ConfusionMatrixLogger(Callback):
    """The match confusion matrix on a held-out batch each epoch."""

    def __init__(self, val_batch: dict, model, threshold: float = 0.2,
                 run_dir: Optional[str] = None):
        self.batch = val_batch
        self.model = model
        self.threshold = threshold
        self.run_dir = run_dir
        self._started = False

    def on_train_start(self, run_dir: str, config: dict) -> None:
        self.run_dir = self.run_dir or run_dir
        self._started = True

    def on_epoch_end(self, epoch: int, record: dict, state) -> None:
        if not _is_main_process() or not self._started:
            return
        conf = _conf_matrix(self.model, state, self.batch)
        cm = match_confusion(conf, np.asarray(self.batch["conf_gt"]), self.threshold)
        record.update(confusion_tp=cm["tp"], confusion_fp=cm["fp"], confusion_fn=cm["fn"],
                      confusion_accuracy=cm["accuracy"])
        if self.run_dir:
            os.makedirs(self.run_dir, exist_ok=True)
            with open(osp.join(self.run_dir, f"confusion_epoch{epoch}.json"), "w") as f:
                json.dump(cm, f)


class GradientWatch(Callback):
    """Gradient observability (WatchModelWithWandb, wandb_callbacks.py:59-71):
    at each epoch end, the focal loss's gradient on a fixed watch batch by
    autograd; the global gradient norm and the norms of each top-level
    module's gradients and parameters."""

    def __init__(self, watch_batch: dict, model, run_dir: Optional[str] = None):
        self.batch = watch_batch
        self.model = model
        self.run_dir = run_dir
        self._started = False

    def on_train_start(self, run_dir: str, config: dict) -> None:
        self.run_dir = self.run_dir or run_dir
        self._started = True

    @staticmethod
    def _module_norms(named: dict, prefix: str) -> dict:
        """{prefix/module: norm} over the tensors of each top-level module."""
        sq: dict = {}
        for name, t in named.items():
            mod = name.split(".")[0]
            sq[mod] = sq.get(mod, 0.0) + float(t.detach().double().square().sum())
        return {f"{prefix}/{mod}": float(np.sqrt(v)) for mod, v in sq.items()}

    def on_epoch_end(self, epoch: int, record: dict, state) -> None:
        if not _is_main_process() or not self._started:
            return
        from onepose_tpu_torch.train.train_step import TrainConfig, loss_fn

        self.model.load_state_dict(state.model.state_dict())
        names, params = zip(*self.model.named_parameters())
        batch = _batch_on(self.batch, params[0].device)
        with fp32_matmuls():
            loss = loss_fn(self.model, batch, TrainConfig())[0]
            grads = torch.autograd.grad(loss, params)
        gnorms = self._module_norms(dict(zip(names, grads)), "grad_norm")
        pnorms = self._module_norms(dict(zip(names, params)), "param_norm")
        global_norm = float(np.sqrt(sum(v * v for v in gnorms.values())))
        record["grad_global_norm"] = global_norm
        if self.run_dir:
            os.makedirs(self.run_dir, exist_ok=True)
            with open(osp.join(self.run_dir, f"watch_epoch{epoch}.json"), "w") as f:
                json.dump({"global_grad_norm": global_norm, **gnorms, **pnorms}, f)


def count_parameters(params) -> int:
    """Elements in a module's parameters, a train state's, or a tree of
    arrays (the JAX package's layout)."""
    if hasattr(params, "model"):
        params = params.model
    if isinstance(params, torch.nn.Module):
        return sum(p.numel() for p in params.parameters())
    if isinstance(params, dict):
        return sum(count_parameters(v) for v in params.values())
    return int(np.prod(np.shape(params)))


def log_hyperparameters(run_dir: str, config: dict, state=None) -> dict:
    """Write hparams.json with the resolved config and the model's parameter
    count (template_utils.log_hparams_to_all_loggers,
    src/utils/template_utils.py:76-129)."""
    rec = {"config": config}
    if state is not None:
        rec["model/params_total"] = count_parameters(state)
    if _is_main_process():
        os.makedirs(run_dir, exist_ok=True)
        with open(osp.join(run_dir, "hparams.json"), "w") as f:
            json.dump(rec, f, indent=1, default=str)
    return rec


class MatchPRCurve(Callback):
    """The precision / recall sweep on a held-out batch each epoch."""

    def __init__(self, val_batch: dict, model, run_dir: Optional[str] = None):
        self.batch = val_batch
        self.model = model
        self.run_dir = run_dir
        self._started = False

    def on_train_start(self, run_dir: str, config: dict) -> None:
        self.run_dir = self.run_dir or run_dir
        self._started = True

    def on_epoch_end(self, epoch: int, record: dict, state) -> None:
        if not _is_main_process() or not self._started:
            return
        conf = _conf_matrix(self.model, state, self.batch)
        curve = match_pr_curve(conf, np.asarray(self.batch["conf_gt"]))
        best = curve["f1"].index(max(curve["f1"]))
        record.update(match_f1=max(curve["f1"]), match_precision=curve["precision"][best])
        if self.run_dir:
            os.makedirs(self.run_dir, exist_ok=True)
            with open(osp.join(self.run_dir, f"pr_curve_epoch{epoch}.json"), "w") as f:
                json.dump(curve, f)
