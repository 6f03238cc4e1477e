"""Pipeline (stage) parallelism for serving: extract, match and solve on
their own devices with micro-batches in flight together.

Port of onepose_tpu/parallel/stage_pipeline.py, in one process as there.
Stage 1 (SuperPoint and keypoint extraction) holds its weights on
devices[0], stage 2 (GATsSPG) on devices[1], stage 3 (the correspondence
gather and RANSAC-PnP) on devices[2]; the list wraps when it is shorter
than three. Each stage on the card issues its work on a CUDA stream of its
own, and an event recorded at the end of a stage's micro-batch is what the
next stage's stream waits for: the counterpart of the JAX package's
asynchronous dispatch, so the host issues micro-batch i + 1's extraction
while micro-batch i's matching runs. The host waits only at the end of
`run`, which holds every micro-batch's intermediate tensors until then (no
memory is reused while another stream may still read it).

Numerical contract: each micro-batch's outputs equal
`PosePipeline.__call__`'s on it with the same RANSAC draws (the same
modules; only placement and issue order differ).
"""

from __future__ import annotations

import contextlib
import copy
from typing import Optional, Sequence

import torch

from onepose_tpu_torch.geometry.ransac import ransac_pnp
from onepose_tpu_torch.models.superpoint import extract_keypoints
from onepose_tpu_torch.runtime.pipeline import ObjectAnnotation, PosePipeline


def _on(module: torch.nn.Module, device: torch.device) -> torch.nn.Module:
    """`module` when it lives on `device`, else a copy there."""
    if next(module.parameters()).device == device:
        return module
    return copy.deepcopy(module).to(device).eval()


class StagePipeline:
    """Three-stage pipeline-parallel executor around a PosePipeline."""

    def __init__(
        self,
        pipe: PosePipeline,
        anno: ObjectAnnotation,
        devices: Optional[Sequence] = None,
    ):
        devs = [torch.device(d) for d in devices] if devices else [pipe.device]
        devs = [torch.device("cuda", torch.cuda.current_device())
                if d.type == "cuda" and d.index is None else d for d in devs]
        while len(devs) < 3:
            devs = devs + devs
        self.devices = devs[:3]
        d0, d1, d2 = self.devices
        self.pipe = pipe
        self.superpoint = _on(pipe.superpoint, d0)
        self.matcher = _on(pipe.matcher, d1)
        self.anno = anno.to(d1)
        self.points3d = torch.as_tensor(anno.points3d).to(d2)
        self.streams = [torch.cuda.Stream(device=d) if d.type == "cuda" else None
                        for d in self.devices]

    def _stage(self, s: int):
        stream = self.streams[s]
        return torch.cuda.stream(stream) if stream is not None else contextlib.nullcontext()

    def _hand_off(self, s: int, event) -> None:
        """Stage s's stream waits for the previous stage's event."""
        if self.streams[s] is not None and event is not None:
            self.streams[s].wait_event(event)

    def _event(self, s: int):
        if self.streams[s] is None:
            return None
        ev = torch.cuda.Event()
        ev.record(self.streams[s])
        return ev

    @torch.inference_mode()
    def run(self, micro_batches, Ks, draws: Optional[Sequence] = None,
            generator: Optional[torch.Generator] = None) -> list:
        """Drive micro-batches through the three stages.

        micro_batches: [b, H, W, 1] images each; Ks: a [b, 3, 3] each.
        draws: a [b, n_hyp, 3] uniform tensor per micro-batch, or None to
        draw them from `generator`. Returns each micro-batch's dict(pose,
        num_inliers, pnp_ok, matches0), in order."""
        pipe = self.pipe
        d0, d1, d2 = self.devices
        outs, keep = [], []
        for i, (imgs, K) in enumerate(zip(micro_batches, Ks)):
            with self._stage(0):
                dense = self.superpoint(torch.as_tensor(imgs).to(d0))
                feats = extract_keypoints(
                    dense["score_map"], dense["descriptor_map"],
                    max_keypoints=pipe.max_keypoints,
                    keypoint_threshold=pipe.keypoint_threshold, border=pipe.border)
                ev0 = self._event(0)
            with self._stage(1):
                self._hand_off(1, ev0)
                desc, mask = feats["descriptors"].to(d1), feats["mask"].to(d1)
                b = desc.shape[0]
                anno = self.anno

                def per_frame(x):
                    return x if anno.batched else x[None].expand((b,) + x.shape).contiguous()

                match = self.matcher(desc, per_frame(anno.desc3d), per_frame(anno.leaf_desc),
                                     mask, per_frame(anno.mask3d), per_frame(anno.leaf_mask))
                ev1 = self._event(1)
            with self._stage(2):
                self._hand_off(2, ev1)
                kpts, m0 = feats["keypoints"].to(d2), match["matches0"].to(d2)
                K2 = torch.as_tensor(K).to(d2)
                pts = self.points3d if self.anno.batched else self.points3d[None].expand(b, -1, -1)
                idx = m0.clamp(min=0).long()
                pts3d = torch.gather(pts.to(d2), 1, idx[..., None].expand(-1, -1, 3))
                dr = None if draws is None else torch.as_tensor(draws[i]).to(d2)
                pnp = ransac_pnp(kpts, pts3d, K2, m0 >= 0, draws=dr, generator=generator,
                                 n_hyp=pipe.ransac_hypotheses,
                                 reproj_threshold=pipe.reproj_threshold)
            keep.append((dense, feats, desc, mask, match, kpts, m0, pts3d))
            outs.append({"pose": pnp["pose"], "num_inliers": pnp["num_inliers"],
                         "pnp_ok": pnp["ok"], "matches0": m0})
        for stream in self.streams:
            if stream is not None:
                stream.synchronize()
        del keep
        return outs
