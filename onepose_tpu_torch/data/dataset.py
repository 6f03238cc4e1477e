"""Training and evaluation dataset of the GATsSPG matcher.

Port of onepose_tpu/data/dataset.py (the reference's
src/datasets/GATs_spg_dataset.py): items are the images of an annotation
index; an item loads the image's 2D annotation (keypoints, descriptors,
scores, ground-truth assign matrix) and its object's 3D annotation
(average descriptors and the leaf collection), pads every array to a
static shape (shape2d 1000, shape3d 2000, num_leaf 8) with a mask beside
it, and builds the ground-truth confidence matrix. The 3D annotation is
built once per object. Every random draw (2D and 3D padding, leaf slots)
comes from the dataset's one numpy generator, in the JAX package's order,
so one seed gives both packages the same items.

Items and batches are numpy; `prefetch_to_device` moves batches to the
card (pinned host memory, then copies that do not block the host).
"""

from __future__ import annotations

import collections
import os.path as osp
from typing import Iterator

import numpy as np
import torch

from onepose_tpu_torch.data import paths as path_utils
from onepose_tpu_torch.data.anno_io import load_anno2d, load_annotation_npz, read_anno_index
from onepose_tpu_torch.data.padding import assign_to_conf_matrix, pad_keypoints2d, pad_points3d
from onepose_tpu_torch.sfm.aggregate import build_leaf_slots


class GATsSPGDataset:
    def __init__(
        self,
        anno_index_file: str,
        num_leaf: int = 8,
        shape2d: int = 1000,
        shape3d: int = 2000,
        load_pose_gt: bool = False,
        seed: int = 0,
    ):
        self.entries = read_anno_index(anno_index_file)
        self.num_leaf = num_leaf
        self.shape2d = shape2d
        self.shape3d = shape3d
        self.load_pose_gt = load_pose_gt
        self.rng = np.random.default_rng(seed)
        self._anno3d_cache: dict[str, dict] = {}

    def __len__(self) -> int:
        return len(self.entries)

    def _anno3d(self, anno_dir: str) -> dict:
        if anno_dir not in self._anno3d_cache:
            raw = load_annotation_npz(anno_dir)
            padded = pad_points3d(raw["keypoints3d"], raw["desc_avg"], raw["scores_avg"],
                                  self.shape3d, rng=self.rng)
            leaves = build_leaf_slots(raw["desc_concat"], raw["scores_concat"], raw["idxs"],
                                      self.num_leaf, rng=self.rng)
            C = raw["desc_avg"].shape[-1]
            leaf_desc = np.ones((self.shape3d, self.num_leaf, C), np.float32)
            leaf_mask = np.zeros((self.shape3d, self.num_leaf), bool)
            k = min(len(raw["idxs"]), self.shape3d)
            leaf_desc[:k] = leaves["leaf_desc"][:k]
            leaf_mask[:k] = leaves["leaf_mask"][:k]
            self._anno3d_cache[anno_dir] = {
                "padded": padded,
                "leaf_desc": leaf_desc,
                "leaf_mask": leaf_mask,
                "num_3d": len(raw["idxs"]),
            }
        return self._anno3d_cache[anno_dir]

    def __getitem__(self, index: int) -> dict:
        entry = self.entries[index]
        anno2d = load_anno2d(entry["anno_file"])
        # The object's 3D annotation sits beside the 2D one unless the entry
        # names its directory.
        a3 = self._anno3d(entry.get("anno3d_dir", osp.dirname(entry["anno_file"])))

        # The image size, for the random keypoint padding: stored, or read.
        if "height" in entry:
            h, w = int(entry["height"]), int(entry["width"])
        else:
            import cv2

            h, w = cv2.imread(entry["img_file"], cv2.IMREAD_GRAYSCALE).shape

        n2d = len(anno2d["keypoints2d"])
        p2 = pad_keypoints2d(anno2d["keypoints2d"], anno2d["descriptors2d"], anno2d["scores2d"],
                             h, w, self.shape2d, rng=self.rng)
        conf_gt = assign_to_conf_matrix(anno2d["assign_matrix"], n2d, a3["num_3d"],
                                        self.shape2d, self.shape3d)
        item = {
            "desc2d": p2["descriptors"],
            "kpts2d": p2["keypoints"],
            "scores2d": p2["scores"],
            "mask2d": p2["mask"],
            "desc3d": a3["padded"]["descriptors"],
            "points3d": a3["padded"]["points3d"],
            "mask3d": a3["padded"]["mask"],
            "leaf_desc": a3["leaf_desc"],
            "leaf_mask": a3["leaf_mask"],
            "conf_gt": conf_gt,
        }
        if self.load_pose_gt:
            item["pose_gt"] = np.loadtxt(entry["pose_file"]).astype(np.float32)
            item["K"] = np.loadtxt(
                path_utils.intrin_path_by_color(entry["img_file"])).astype(np.float32)
        return item


def batch_iterator(
    dataset: GATsSPGDataset,
    batch_size: int,
    shuffle: bool = True,
    seed: int = 0,
    drop_last: bool = True,
    num_workers: int = 0,
) -> Iterator[dict]:
    """Stacked numpy batches ({key: [B, ...]}), in an order shuffled by
    `seed`.

    num_workers > 0 assembles the batches in a thread pool (the reference
    trains with a 16-worker DataLoader, GATs_spg_datamodule.py:56-60); every
    batch is submitted at once, as in the JAX package, and the items then
    take the dataset's one generator in the order the threads reach it."""
    order = np.arange(len(dataset))
    rng = np.random.default_rng(seed)
    if shuffle:
        rng.shuffle(order)
    end = len(order) - (len(order) % batch_size if drop_last else 0)

    def assemble(idx):
        items = [dataset[int(i)] for i in idx]
        return {k: np.stack([it[k] for it in items]) for k in items[0]}

    starts = [
        order[s:s + batch_size]
        for s in range(0, end, batch_size)
        if not (drop_last and len(order[s:s + batch_size]) < batch_size)
    ]
    if num_workers <= 0:
        for idx in starts:
            yield assemble(idx)
        return

    from concurrent.futures import ThreadPoolExecutor

    with ThreadPoolExecutor(max_workers=num_workers) as pool:
        futures = [pool.submit(assemble, idx) for idx in starts]
        for fut in futures:
            yield fut.result()


PREFETCH = 2  # batches staged on the device ahead of the step


def prefetch_to_device(iterator: Iterator[dict],
                       device: str | torch.device = "cuda") -> Iterator[dict]:
    """Stage the next batches on `device` while the current step runs: each
    array is pinned on the host (on CUDA) and copied without blocking the
    host, PREFETCH batches ahead."""
    dev = torch.device(device)
    pin = dev.type == "cuda"
    queue = collections.deque()

    def put(batch):
        out = {}
        for k, v in batch.items():
            t = torch.from_numpy(np.ascontiguousarray(v))
            out[k] = (t.pin_memory() if pin else t).to(dev, non_blocking=pin)
        queue.append(out)

    for batch in iterator:
        put(batch)
        if len(queue) >= PREFETCH:
            yield queue.popleft()
    while queue:
        yield queue.popleft()
