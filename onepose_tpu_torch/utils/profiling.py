"""Per-stage timing, the program's profiler spans, and device trace capture.

Port of onepose_tpu/utils/profiling.py. `span(name)` marks a stage of the
program for `torch.profiler`: while a profiler records it is a
`record_function` range, on the host and on the card, on the same clock
as the kernels and the CUDA runtime calls it encloses; otherwise it is a
shared null context and costs a flag check. `StageTimer` is the same
tick / tock accumulator with the same `report()` keys, and each of its
stages is a span too; with `sync=True` each stage boundary waits for the
card (`torch.cuda.synchronize()`, where the JAX package drains its
effects). `cuda_trace` runs a block under torch.profiler and returns its
CUDA kernels (by name, device ms, the span they cover) and its host ms,
taking an empty trace again and raising if every try came back empty;
`device_busy` sums the CUDA kernel time of a block over the span the
kernels cover (through `cuda_trace`); `host_syncs` lists where a block
made the host wait for the card; `card_line` is the card's name and
power limit as nvidia-smi prints them, which every measurement of the
card is printed beside; `time_windows` times a call by CUDA events in
windows of calls and reports the median window and the spread;
`FlushTimer` times single calls, each after an L2 flush, and reports the
median.
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
from typing import NamedTuple

import torch


_NO_SPAN = contextlib.nullcontext()


def span(name: str):
    """A context that marks a stage of the program as `name` in a
    torch.profiler trace: `record_function(name)` while a profiler records
    on this thread, else a shared null context. A span's parent is the
    span that encloses it on the thread."""
    if torch.autograd._profiler_enabled():
        return torch.profiler.record_function(name)
    return _NO_SPAN


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
        """Times the block as stage `name`, and marks it as `span(name)`."""
        self.tick(name)
        try:
            with span(name):
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


def card_line() -> str:
    """`nvidia-smi --query-gpu=name,power.limit --format=csv,noheader` for
    the first card, e.g. "NVIDIA H100 80GB HBM3, 700.00 W"."""
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60, check=True).stdout
    return out.strip().splitlines()[0]


class EmptyTrace(RuntimeError):
    """torch.profiler recorded no CUDA kernel in any try of a block."""


class CudaTrace(NamedTuple):
    """The CUDA kernels torch.profiler recorded in one run of a block, as
    (name, start us, end us), and that run's host ms (the block and its
    synchronize, under the profiler)."""

    kernels: list
    wall_ms: float
    tries: int  # runs of the block it took to record a kernel

    @property
    def kernel_ms(self) -> float:
        return sum(end - start for _, start, end in self.kernels) / 1e3

    @property
    def span_ms(self) -> float:
        """From the first kernel's start to the last one's end."""
        return (max(e for _, _, e in self.kernels) - min(s for _, s, _ in self.kernels)) / 1e3

    def by_name(self) -> dict[str, tuple[int, float]]:
        """{kernel name: (launches, device ms)}."""
        out: dict[str, tuple[int, float]] = {}
        for name, start, end in self.kernels:
            n, ms = out.get(name, (0, 0.0))
            out[name] = (n + 1, ms + (end - start) / 1e3)
        return out


def cuda_trace(fn, tries: int = 3, cpu: bool = True) -> CudaTrace:
    """Run fn() once under torch.profiler (CPU and CUDA activity; CUDA alone
    with cpu=False), the card synchronized before and after, and return its
    CUDA kernels and host ms. CUPTI now and then hands back no activity for
    a window of kernels, so a trace with no kernel is taken again, up to
    `tries` runs of fn() in all; EmptyTrace if every one was empty (a block
    that launches nothing cannot be told from a lost trace)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CUDA]
    if cpu:
        activities.insert(0, ProfilerActivity.CPU)
    for run in range(1, tries + 1):
        torch.cuda.synchronize()
        with profile(activities=activities) as prof:
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3
        kernels = [(e.name, e.time_range.start, e.time_range.end) for e in prof.events()
                   if e.device_type == DeviceType.CUDA]
        if kernels:
            return CudaTrace(kernels, wall_ms, run)
    raise EmptyTrace(f"torch.profiler recorded no CUDA kernel in {tries} runs of the block")


def device_busy(fn, tries: int = 3) -> dict | None:
    """Run fn() once under torch.profiler (CUDA activity) and synchronize:
    {kernels, kernel_ms, span_ms, share}, the CUDA kernels' count, their
    summed time, the span from the first kernel's start to the last one's
    end, and kernel_ms / span_ms; None if the profiler recorded no kernel
    in `tries` runs (`cuda_trace`; then the share is not measured)."""
    try:
        t = cuda_trace(fn, tries, cpu=False)
    except EmptyTrace:
        return None
    return {"kernels": len(t.kernels), "kernel_ms": t.kernel_ms, "span_ms": t.span_ms,
            "share": t.kernel_ms / t.span_ms}


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
