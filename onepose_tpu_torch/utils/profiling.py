"""Per-stage timing and device trace capture.

Port of onepose_tpu/utils/profiling.py. `StageTimer` is the same tick /
tock accumulator with the same `report()` keys; with `sync=True` each
stage boundary waits for the card (`torch.cuda.synchronize()`, where the
JAX package drains its effects). `device_trace` records a `torch.profiler`
trace of CPU and CUDA activity and exports it to `log_dir` (Chrome trace
format, viewable in TensorBoard or Perfetto). `device_busy` sums the CUDA
kernel time of a block under torch.profiler over the span the kernels
cover; `host_syncs` lists where a block made the host wait for the card;
`card_line` is the card's name and power limit as nvidia-smi prints
them, which every measurement of the card is printed beside;
`time_windows` times a call by CUDA events in windows of calls and
reports the median window and the spread; `FlushTimer` times single calls,
each after an L2 flush, and reports the median.
"""

from __future__ import annotations

import contextlib
import os
import statistics
import subprocess
import time
import traceback
import warnings
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


def card_line() -> str:
    """`nvidia-smi --query-gpu=name,power.limit --format=csv,noheader` for
    the first card, e.g. "NVIDIA H100 80GB HBM3, 700.00 W"."""
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60, check=True).stdout
    return out.strip().splitlines()[0]


def device_busy(fn, tries: int = 3) -> dict | None:
    """Run fn() once under torch.profiler (CUDA activity) and synchronize:
    {kernels, kernel_ms, span_ms, share}, the CUDA kernels' count, their
    summed time, the span from the first kernel's start to the last one's
    end, and kernel_ms / span_ms; None if the profiler recorded no kernel
    (then the share is not measured).
    CUPTI now and then hands back no activity for a short window of
    kernels, so a trace with no kernel is taken again, up to `tries` runs
    of fn() in all."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    for _ in range(tries):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        kernels = [e.time_range for e in prof.events() if e.device_type == DeviceType.CUDA]
        if kernels:
            break
    else:
        return None
    kernel_ms = sum(r.elapsed_us() for r in kernels) / 1e3
    span_ms = (max(r.end for r in kernels) - min(r.start for r in kernels)) / 1e3
    return {"kernels": len(kernels), "kernel_ms": kernel_ms, "span_ms": span_ms,
            "share": kernel_ms / span_ms}


def host_syncs(fn) -> list[str]:
    """Run fn() once under torch.cuda's sync debug mode ("warn") and return
    where each synchronizing call was made, as "file:line" (from the
    repository's root) of the innermost frame in this package, else the
    innermost frame of the caller, one entry a sync.
    Work queued before the call is drained first, so it is not counted."""
    here = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    found, running = [], [False]

    def record(message, category, filename, lineno, file=None, line=None):
        if not running[0] or "synchroniz" not in str(message):
            return
        frames = [f for f in traceback.extract_stack()[:-1]
                  if not f.filename.endswith(("warnings.py", "profiling.py"))]
        ours = [f for f in frames if f.filename.startswith(here)]
        f = (ours or frames)[-1]
        found.append(f"{os.path.relpath(f.filename, os.path.dirname(here))}:{f.lineno}")

    torch.cuda.synchronize()
    with warnings.catch_warnings():
        warnings.simplefilter("always")
        warnings.showwarning = record
        torch.cuda.set_sync_debug_mode("warn")
        running[0] = True  # a sync outside fn (the mode's own calls) is not fn's
        try:
            fn()
        finally:
            running[0] = False
            torch.cuda.set_sync_debug_mode(0)
    return found


def time_windows(fn, device: torch.device, iters: int, windows: int, warmup: int = 3) -> dict:
    """ms a call of fn(): `warmup` calls, then `windows` windows of `iters`
    calls, each window timed by CUDA events on the current stream (on the
    CPU by the host clock: not a card time). {ms: the median window's ms a
    call, min_ms, max_ms, windows: each window's}."""
    cuda = device.type == "cuda"
    for _ in range(warmup):
        fn()
    if cuda:
        torch.cuda.synchronize(device)
    per_call = []
    for _ in range(windows):
        if cuda:
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(iters):
                fn()
            end.record()
            end.synchronize()
            ms = start.elapsed_time(end)
        else:
            t0 = time.perf_counter()
            for _ in range(iters):
                fn()
            ms = (time.perf_counter() - t0) * 1e3
        per_call.append(ms / iters)
    return {"ms": statistics.median(per_call), "min_ms": min(per_call), "max_ms": max(per_call),
            "windows": per_call}


class FlushTimer:
    """Median device time (ms) of single calls of fn(), each run after a
    256 MB write that flushes the L2, between CUDA events."""

    def __init__(self, device):
        self.flush = torch.empty(64 * 2**20, dtype=torch.int32, device=device)  # 256 MB

    def __call__(self, fn, reps: int = 20, warmup: int = 3) -> float:
        for _ in range(warmup):
            fn()
        times = []
        for _ in range(reps):
            self.flush.zero_()
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            fn()
            end.record()
            torch.cuda.synchronize()
            times.append(start.elapsed_time(end))
        return statistics.median(times)
