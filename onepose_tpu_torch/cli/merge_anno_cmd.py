"""`merge-anno` command: merge per-object annotation indices.

Port of onepose_tpu/cli/merge_anno_cmd.py (the reference's `python run.py
+preprocess=merge_anno`, run.py:46-93): every object's per-frame
annotation entries in one training index, ids renumbered from 1;
`coco_out` also writes the reference-layout COCO-style JSON. Host work
only (JSON files): it runs on no device.
"""

from __future__ import annotations

import json

DEFAULTS = {
    "indices": [],  # list of per-object anno_index.json paths
    "out": "data/train_anno.json",
    "coco_out": None,  # optional COCO-format export path
}


def run(cfg: dict) -> dict:
    from onepose_tpu_torch.data.anno_io import export_coco_anno, merge_anno_indices

    indices = cfg["indices"]
    if isinstance(indices, str):
        indices = [p for p in indices.split(",") if p]
    assert indices, "merge-anno: indices is required (comma-separated)"

    n = merge_anno_indices(indices, cfg["out"])
    summary = {"num_annotations": n, "out": cfg["out"]}
    if cfg["coco_out"]:
        export_coco_anno(cfg["out"], cfg["coco_out"])
        summary["coco_out"] = cfg["coco_out"]
    print(json.dumps(summary))
    return summary


def add_parser(subparsers):
    p = subparsers.add_parser("merge-anno", help="merge per-object annotation indices")
    p.add_argument("--config", default=None)
    p.add_argument("overrides", nargs="*")
    p.set_defaults(_defaults=DEFAULTS, _run=run)
