"""`train` command: GATsSPG matcher training from an annotation index.

Port of onepose_tpu/cli/train_cmd.py (the reference's `python train.py
+experiment=train_GATsSPG`, train.py:14-101, with the shipped recipe): the
same defaults and the same summary line (the last epoch's record as JSON).
It runs on the card unless device=cpu is given; without CUDA and without
device=cpu it raises before any work. As in the JAX package,
`val_anno_index` is accepted and not read (ROADMAP C, watch item 5). Over
several ranks (`torchrun --nproc-per-node N -m onepose_tpu_torch train
...`) it trains data-parallel (`train.loop`); batch_size must divide over
the ranks.
"""

from __future__ import annotations

import json

DEFAULTS = {
    "anno_index": None,
    "val_anno_index": None,
    "run_dir": "runs/train",
    "num_leaf": 8,
    "shape2d": 1000,
    "shape3d": 2000,
    "batch_size": 8,
    "max_epochs": 10,
    "lr": 1e-3,
    "accumulate": 2,
    "seed": 12345,
    "num_workers": 4,
    "tensorboard": True,
    "code_snapshot": True,
    # Sweep hook: the history metric to return for a hyperparameter search
    # (the reference's `optimized_metric`, train.py:92-94).
    "optimized_metric": "train_loss",
    "device": "cuda",
}


def run(cfg: dict) -> dict:
    import os.path as osp
    from functools import partial

    from onepose_tpu_torch._device import resolve_device
    from onepose_tpu_torch.data.dataset import GATsSPGDataset, batch_iterator
    from onepose_tpu_torch.models.gats_spg import GATsSPG
    from onepose_tpu_torch.train.callbacks import (
        BestCheckpoint,
        BestMetricTracker,
        CodeSnapshot,
        TensorBoardLogger,
    )
    from onepose_tpu_torch.train.loop import LoopConfig, train
    from onepose_tpu_torch.train.train_step import TrainConfig
    from onepose_tpu_torch.utils import comm
    from onepose_tpu_torch.utils.seeding import seed_everything

    dev = resolve_device(cfg["device"])  # no CUDA and no device=cpu: raise before any work
    comm.init_distributed(device=dev)
    dev = comm.rank_device(dev)
    assert cfg["anno_index"], "train: anno_index is required"
    seed_everything(cfg["seed"])
    ds = GATsSPGDataset(cfg["anno_index"], num_leaf=cfg["num_leaf"], shape2d=cfg["shape2d"],
                        shape3d=cfg["shape3d"], seed=cfg["seed"])
    callbacks = [BestMetricTracker()]
    if cfg["tensorboard"]:
        callbacks.append(TensorBoardLogger(osp.join(cfg["run_dir"], "tb")))
    if cfg["code_snapshot"]:
        callbacks.append(CodeSnapshot())
    callbacks.append(BestCheckpoint(osp.join(cfg["run_dir"], "ckpt"), monitor="train_loss"))
    steps_per_epoch = max(len(ds) // cfg["batch_size"], 1)
    out = train(
        ds,
        model=GATsSPG(gats_kernel=True, fused_match=False),
        train_cfg=TrainConfig(lr=cfg["lr"], accumulate=cfg["accumulate"],
                              steps_per_epoch=steps_per_epoch),
        loop_cfg=LoopConfig(
            max_epochs=cfg["max_epochs"],
            batch_size=cfg["batch_size"],
            ckpt_dir=osp.join(cfg["run_dir"], "ckpt"),
            metrics_file=osp.join(cfg["run_dir"], "metrics.jsonl"),
            seed=cfg["seed"],
            optimized_metric=cfg["optimized_metric"],
            device=str(dev),
        ),
        batch_iterator_fn=partial(batch_iterator, num_workers=cfg["num_workers"]),
        callbacks=callbacks,
    )
    summary = dict(out["history"][-1]) if out["history"] else {}
    if cfg["optimized_metric"]:
        summary["optimized_metric"] = cfg["optimized_metric"]
        summary["optimized_metric_value"] = out.get("optimized_metric_value")
    print(json.dumps(summary))
    return summary


def add_parser(subparsers):
    p = subparsers.add_parser("train", help="train the GATsSPG matcher")
    p.add_argument("--config", default=None)
    p.add_argument("overrides", nargs="*")
    p.set_defaults(_defaults=DEFAULTS, _run=run)
