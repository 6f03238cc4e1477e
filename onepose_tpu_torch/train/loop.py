"""Training loop of the GATsSPG matcher.

Port of onepose_tpu/train/loop.py, the reference's recipe (train.py,
configs/experiment/train_GATsSPG.yaml: Adam 1e-3, MultiStepLR [5, 10, 15,
20] x 0.5, batch 8, accumulate 2, clip 0.5, 10 epochs, focal loss) on one
card: batches staged on the device ahead of the step, metrics kept on the
device until an epoch ends, one checkpoint an epoch (`ckpt_<epoch>.msgpack`,
the JAX package's format). Validation computes real pose errors (matcher
-> RANSAC-PnP -> cm-degree recall), as the reference's validation step
does (GATsSPG_lightning_model.py:53-73).

Over several ranks (`torchrun --nproc-per-node N -m onepose_tpu_torch
train ...`): data parallelism over every rank. Each rank draws the same
global batch stream (the same seeds), takes its slice of each batch, and
holds the same parameters and optimizer state (seeded alike, or loaded
from the same checkpoint, then broadcast from rank 0); the train step
normalises the loss over the global batch and sums the gradients
(`train_step.make_train_step(group=)`). A batch size that the world size
does not divide raises (the JAX package shrinks its mesh to a divisor,
which leaves some processes' devices out of it). Rank 0 writes the
metrics and checkpoints. Validation gives each rank a strided share of the
items and combines the counts exactly.
"""

from __future__ import annotations

import dataclasses
import json
import os
import os.path as osp
import time
from typing import Callable, Optional

import numpy as np
import torch

from onepose_tpu_torch._device import resolve_device
from onepose_tpu_torch.data.dataset import batch_iterator, prefetch_to_device
from onepose_tpu_torch.eval import Evaluator
from onepose_tpu_torch.geometry.ransac import ransac_pnp
from onepose_tpu_torch.models.gats_spg import GATsSPG
from onepose_tpu_torch.train.train_step import (
    TrainConfig,
    create_train_state,
    make_train_step,
)
from onepose_tpu_torch.utils.checkpoint import (
    checkpoint_step,
    latest_checkpoint,
    load_checkpoint,
    save_checkpoint,
)
from onepose_tpu_torch.utils import comm
from onepose_tpu_torch.utils.precision import fp32_matmuls


@dataclasses.dataclass
class LoopConfig:
    max_epochs: int = 10
    batch_size: int = 8
    log_every: int = 50
    ckpt_dir: str = "runs/ckpt"
    metrics_file: str = "runs/metrics.jsonl"
    resume: bool = True
    seed: int = 12345
    # Name of the history metric returned to sweep tooling (the reference's
    # `optimized_metric`, train.py:92-94), e.g. "val_cmd5" or "train_loss".
    optimized_metric: Optional[str] = None
    device: str = "cuda"  # the card unless the caller names the CPU


def _log(metrics_file: str, record: dict) -> None:
    if not comm.is_main_process():
        return
    os.makedirs(osp.dirname(metrics_file) or ".", exist_ok=True)
    with open(metrics_file, "a") as f:
        f.write(json.dumps(record) + "\n")


def adapt_batch(batch: dict) -> dict:
    """Dataset batch -> train-step batch naming."""
    keys = ("desc2d", "desc3d", "leaf_desc", "mask2d", "mask3d", "leaf_mask", "conf_gt")
    return {k: batch[k] for k in keys}


def _rank_slice(batch: dict, rank: int, world: int) -> dict:
    """This rank's rows of a global batch."""
    n = len(next(iter(batch.values()))) // world
    return {k: v[rank * n:(rank + 1) * n] for k, v in batch.items()}


def train(
    dataset,
    model: Optional[GATsSPG] = None,
    train_cfg: Optional[TrainConfig] = None,
    loop_cfg: LoopConfig = LoopConfig(),
    batch_iterator_fn: Optional[Callable] = None,
    val_fn: Optional[Callable] = None,
    callbacks: Optional[list] = None,
) -> dict:
    """Train; returns {"state": the final TrainState, "history": [...]}.

    dataset: indexable, yielding padded items (`data.dataset`).
    batch_iterator_fn(dataset, batch_size, seed=...) -> iterator of numpy
      batches.
    val_fn(state) -> dict of validation metrics (optional).
    callbacks: `train.callbacks.Callback`s (TensorBoard, best metrics, code
      snapshot, best checkpoint, ...).
    """
    dev = resolve_device(loop_cfg.device)
    world, rank = comm.get_world_size(), comm.get_rank()
    if loop_cfg.batch_size % world:
        raise ValueError(f"batch_size {loop_cfg.batch_size} must divide over the {world} ranks: "
                         "every rank takes an equal slice of each batch")
    group = torch.distributed.group.WORLD if world > 1 else None
    model = model or GATsSPG(gats_kernel=True, fused_match=False)
    batch_iterator_fn = batch_iterator_fn or batch_iterator
    steps_per_epoch = max(len(dataset) // loop_cfg.batch_size, 1)
    train_cfg = train_cfg or TrainConfig(steps_per_epoch=steps_per_epoch)

    # The JAX package draws an example batch to initialise its model. The
    # draw advances the dataset's generator and fills its 3D cache, so it is
    # made here too, and every later padding draw matches.
    next(batch_iterator_fn(dataset, loop_cfg.batch_size, seed=0))
    state = create_train_state(loop_cfg.seed, model, train_cfg, dev)

    start_epoch = 0
    if loop_cfg.resume:
        ckpt = latest_checkpoint(loop_cfg.ckpt_dir)
        if ckpt is not None:
            state.load_state_dict(load_checkpoint(ckpt, state.state_dict()))
            start_epoch = checkpoint_step(ckpt) + 1
    if group is not None:
        with torch.no_grad():
            for p in state.model.parameters():
                p.copy_(comm.broadcast(p, group))

    callbacks = callbacks or []
    run_dir = osp.dirname(loop_cfg.metrics_file) or "."
    for cb in callbacks:
        cb.on_train_start(run_dir, dataclasses.asdict(loop_cfg))

    step_fn = make_train_step(model, train_cfg, group=group)
    history = []
    global_step = start_epoch * steps_per_epoch
    for epoch in range(start_epoch, loop_cfg.max_epochs):
        t0 = time.time()
        epoch_metrics = []
        batches = map(adapt_batch, batch_iterator_fn(dataset, loop_cfg.batch_size,
                                                     seed=loop_cfg.seed + epoch))
        if group is not None:
            batches = (_rank_slice(b, rank, world) for b in batches)
        for i, batch in enumerate(prefetch_to_device(batches, device=dev)):
            state, metrics = step_fn(state, batch)
            global_step += 1
            if (i + 1) % loop_cfg.log_every == 0 or i == 0:
                m = {k: float(v) for k, v in metrics.items()}
                m.update(epoch=epoch, step=global_step)
                _log(loop_cfg.metrics_file, m)
            epoch_metrics.append(metrics)

        mean_loss = float(torch.stack([m["loss"] for m in epoch_metrics]).mean())
        record = {"epoch": epoch, "train_loss": mean_loss, "epoch_seconds": time.time() - t0}
        if val_fn is not None:
            record.update(val_fn(state))
        for cb in callbacks:
            cb.on_epoch_end(epoch, record, state)
        _log(loop_cfg.metrics_file, record)
        history.append(record)
        if comm.is_main_process():
            save_checkpoint(loop_cfg.ckpt_dir, state.state_dict(), epoch)
    for cb in callbacks:
        cb.on_train_end(history)
    result = {"state": state, "history": history}
    if loop_cfg.optimized_metric is not None:
        # The monitored metric's last value (the trainer's callback_metrics
        # entry after fit, reference train.py:92-94).
        vals = [r[loop_cfg.optimized_metric] for r in history
                if loop_cfg.optimized_metric in r]
        result["optimized_metric_value"] = float(vals[-1]) if vals else None
    return result


def make_pose_val_fn(
    val_dataset,
    model: GATsSPG,
    n_hyp: int = 256,
) -> Callable:
    """Validation that closes the loop to metric pose accuracy: matcher ->
    mutual matches -> RANSAC-PnP -> cm-degree recall (the reference's
    validation, GATsSPG_lightning_model.py:53-73). val_dataset items hold
    kpts2d, points3d, pose_gt and K. `model` takes the state's parameters
    at each call. Item i's RANSAC draws come from a CPU generator seeded
    with i (the JAX package keys them PRNGKey(i)), so the card and the CPU
    draw alike. Over several ranks each rank evaluates a strided share of
    the items and the counts are combined exactly (`Evaluator.counts`,
    `combine_counts`): every rank returns the whole set's metrics."""

    def val_fn(state) -> dict:
        world, rank = comm.get_world_size(), comm.get_rank()
        model.load_state_dict(state.model.state_dict())
        dev = next(model.parameters()).device
        ev = Evaluator()
        with torch.no_grad(), fp32_matmuls():
            for i in range(rank, len(val_dataset), world):
                item = val_dataset[i]
                b = {k: torch.from_numpy(np.asarray(v))[None].to(dev) for k, v in item.items()
                     if k not in ("pose_gt", "K")}
                out = model(b["desc2d"], b["desc3d"], b["leaf_desc"], b["mask2d"], b["mask3d"],
                            b["leaf_mask"])
                m0 = out["matches0"][0].long()
                pts3d = b["points3d"][0][m0.clamp(min=0)]
                g = torch.Generator().manual_seed(i)
                draws = torch.rand((1, n_hyp, 3), generator=g).to(dev)
                res = ransac_pnp(b["kpts2d"], pts3d[None],
                                 torch.from_numpy(np.asarray(item["K"]))[None].to(dev),
                                 (m0 >= 0)[None], draws=draws, n_hyp=n_hyp)
                ev.evaluate(res["pose"][0].cpu().numpy(), np.asarray(item["pose_gt"]))
        metrics = (Evaluator.combine_counts(comm.all_gather_pytree(ev.counts())) if world > 1
                   else ev.summarize())
        return {f"val_{k}": v for k, v in metrics.items()}

    return val_fn
