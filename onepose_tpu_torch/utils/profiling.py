"""Per-stage timing and device trace capture.

Port of onepose_tpu/utils/profiling.py. `StageTimer` is the same tick /
tock accumulator with the same `report()` keys; with `sync=True` each
stage boundary waits for the card (`torch.cuda.synchronize()`, where the
JAX package drains its effects). `device_trace` records a `torch.profiler`
trace of CPU and CUDA activity and exports it to `log_dir` (Chrome trace
format, viewable in TensorBoard or Perfetto).
"""

from __future__ import annotations

import contextlib
import os
import time
from collections import defaultdict

import torch


class StageTimer:
    """tick/tock accumulator with per-stage means, device-sync aware."""

    def __init__(self, sync: bool = False):
        self.sync = sync
        self._start: dict[str, float] = {}
        self._acc: dict[str, list] = defaultdict(list)

    def _barrier(self) -> None:
        if self.sync and torch.cuda.is_available() and torch.cuda.is_initialized():
            torch.cuda.synchronize()

    def tick(self, name: str) -> None:
        self._barrier()  # pending device work belongs to the stage before
        self._start[name] = time.perf_counter()

    def tock(self, name: str) -> None:
        self._barrier()
        self._acc[name].append(time.perf_counter() - self._start[name])

    @contextlib.contextmanager
    def stage(self, name: str):
        self.tick(name)
        try:
            yield
        finally:
            self.tock(name)

    def report(self, reset: bool = False) -> dict:
        out = {}
        for name, v in self._acc.items():
            s = sorted(v)
            out[name] = {
                "mean_ms": 1000 * sum(v) / len(v),
                # Steady state: the mean includes first calls (kernel builds,
                # cuDNN autotuning).
                "p50_ms": 1000 * s[len(s) // 2],
                "total_ms": 1000 * sum(v),
                "count": len(v),
            }
        if reset:
            self._acc.clear()
        return out

    def pretty(self) -> str:
        return " | ".join(
            f"{k}: {v['mean_ms']:.2f}ms x{v['count']}"
            for k, v in self.report().items()
        )


@contextlib.contextmanager
def device_trace(log_dir: str):
    """Record a torch.profiler trace (CPU, and CUDA where present) of the
    block and write it to <log_dir>/trace.json."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))
