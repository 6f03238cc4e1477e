"""What every cell shares: the manifest and the files found by name, the
statistics, the device trace and its reduction, and the result line.

Nothing here knows a configuration, a traffic mix or a metric by name:
`cell()` reads the cell's entry in `BENCHMARK.json` and loads
`configs/<config>.json`, `traffic/<traffic>.json` and
`limits/<workload>.json`; `reader()` loads `metrics/<metric>.py`.
"""

from __future__ import annotations

import contextlib
import dataclasses
import importlib.util
import json
import math
import os
import statistics
import sys
import time
from typing import Optional

HERE = os.path.dirname(os.path.abspath(__file__))
FORBIDDEN = ("jax", "jaxlib", "flax", "onepose_tpu")


def load_json(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def manifest(root: str) -> dict:
    return load_json(os.path.join(root, "BENCHMARK.json"))


@dataclasses.dataclass
class Cell:
    """One run of one cell: its manifest entry, its files, the run's flags."""

    name: str
    entry: dict
    cfg: dict
    traffic: dict
    limits: dict
    metrics: list  # the manifest's metric entries this run reports
    seed: int
    seconds: float
    trace: bool


def cell(man: dict, name: str, seed: int, seconds: float, trace: bool) -> Cell:
    """The cell `name` of the manifest, with its configuration, traffic
    and limits loaded; KeyError if the manifest has no such cell."""
    entry = next((w for w in man["workloads"] if w["name"] == name), None)
    if entry is None:
        raise KeyError(f"BENCHMARK.json has no workload {name!r}")
    conf = next(c for c in man["configs"] if c["name"] == entry["config"])
    root = os.path.dirname(HERE)
    kind = "per_layer" if trace else "end_to_end"
    metrics = [m for m in man[kind] if name in m.get("workloads", [name])]
    return Cell(name=name, entry=entry, cfg=load_json(os.path.join(root, conf["file"])),
                traffic=load_json(os.path.join(HERE, "traffic", f"{entry['traffic']}.json")),
                limits=load_json(os.path.join(HERE, "limits", f"{name}.json")),
                metrics=metrics, seed=seed, seconds=seconds, trace=trace)


def reader(metric: str):
    """The module `metrics/<metric>.py`: its read(trace) gives the metric
    or None where the trace holds nothing to read."""
    path = os.path.join(HERE, "metrics", f"{metric}.py")
    spec = importlib.util.spec_from_file_location(f"portbench_metric_{metric}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


# -------------------------------------------------------------- statistics

def percentile(values: list, p: float) -> float:
    """The p-th percentile (0 to 100) by linear interpolation between
    closest ranks (numpy's default)."""
    s = sorted(values)
    if not s:
        raise ValueError("no values")
    at = (len(s) - 1) * p / 100.0
    lo = math.floor(at)
    hi = min(lo + 1, len(s) - 1)
    return s[lo] + (s[hi] - s[lo]) * (at - lo)


def spread(values: list) -> float:
    """Distance between the first and third quartiles over the median
    (`statistics.quantiles(values, n=4)`, as the bounds are set)."""
    q1, q2, q3 = statistics.quantiles(values, n=4)
    return (q3 - q1) / q2


def union_seconds(intervals: list) -> float:
    """Seconds covered by (start_us, end_us) intervals, overlaps once."""
    total, end = 0.0, -math.inf
    for s, e in sorted(intervals):
        if e <= end:
            continue
        total += e - max(s, end)
        end = e
    return total / 1e6


class Reservoir:
    """A uniform sample of k of the items offered, drawn from `rng`."""

    def __init__(self, k: int, rng):
        self.k, self.rng, self.seen, self.items = k, rng, 0, []

    def offer(self, item) -> None:
        self.seen += 1
        if len(self.items) < self.k:
            self.items.append(item)
        else:
            j = self.rng.randrange(self.seen)
            if j < self.k:
                self.items[j] = item


# ------------------------------------------------------------------ tracing

class Spans:
    """CUDA-event spans a call and host spans, named; `mark` places them
    around a function, `hooks` around a module's forward."""

    def __init__(self, torch):
        self.torch = torch
        self.events: dict[str, list] = {}
        self.host: dict[str, list] = {}

    def mark(self, name: str, fn, host: bool = False):
        torch = self.torch

        def wrapped(*a, **k):
            start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            with torch.profiler.record_function(name):
                t0 = time.perf_counter()
                start.record()
                out = fn(*a, **k)
                end.record()
                if host:
                    self.host.setdefault(name, []).append((time.perf_counter() - t0) * 1e3)
            self.events.setdefault(name, []).append((start, end))
            return out

        return wrapped

    def hooks(self, name: str, module) -> list:
        torch = self.torch
        pending = []

        def pre(mod, args):
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            pending.append(ev)

        def post(mod, args, out):
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            self.events.setdefault(name, []).append((pending.pop(), ev))

        return [module.register_forward_pre_hook(pre), module.register_forward_hook(post)]

    def clear(self) -> None:
        self.events.clear()
        self.host.clear()

    def ms(self) -> dict:
        """{name: [device ms a call]}, after a synchronize."""
        self.torch.cuda.synchronize()
        return {k: [s.elapsed_time(e) for s, e in v] for k, v in self.events.items()}


@dataclasses.dataclass
class Trace:
    """What a traced run hands each per-layer reader."""

    spans: dict  # name -> device ms per call (CUDA events)
    host: dict  # name -> host ms per call
    kernels: list  # (name, start us, end us) of the profiled calls
    ranges: list  # (name, start us, end us): record_function ranges on the device
    host_ops: list  # (name, start us, end us): host operations and record_function ranges
    profiled_calls: int
    busy_s: float  # device busy time of the profiled calls
    window_s: float  # host time of the profiled calls
    calls: int  # calls in the whole traced window
    wall_s: float  # the whole traced window's host time
    work: dict  # counts of a call: name -> counts.Work

    def kernel_seconds(self, pattern) -> Optional[float]:
        """Device seconds of the profiled kernels whose name `pattern`
        (a compiled regex) matches at its start; None if none did."""
        hit = [(s, e) for n, s, e in self.kernels if pattern.match(n)]
        return sum(e - s for s, e in hit) / 1e6 if hit else None

    def range_ms(self, name: str, device: bool = True) -> Optional[float]:
        """Ms a profiled call spends in the ranges called `name`: the
        record_function ranges on the device (device=True) or the host
        operations of that name; None if the trace has none."""
        hit = [e - s for n, s, e in (self.ranges if device else self.host_ops) if n == name]
        return sum(hit) / 1e3 / self.profiled_calls if hit else None


def closed_loop(step, seconds: float) -> tuple:
    """One client: step() again as soon as it returns, until a call ends
    `seconds` after the first began. (each call's host seconds, the
    window's host seconds, from the first call's start to the last's end)."""
    lat = []
    start = time.perf_counter()
    while True:
        c0 = time.perf_counter()
        step()
        c1 = time.perf_counter()
        lat.append(c1 - c0)
        if c1 - start >= seconds:
            return lat, c1 - start


def profile_calls(torch, step, n: int, annotations=(), host: bool = True,
                  tries: int = 3) -> tuple:
    """Run step() n times under torch.profiler, the card synchronized
    before and after: (kernels, device ranges, host ops, host seconds,
    calls). With host False only the card is traced (CUDA activity alone):
    the host then pays no profiler record per operation, only CUPTI's cost
    per launch, so the idle share reads nearer the untraced one; the host
    ops and ranges are then empty. A device-side range of a
    record_function (a user annotation, or one of the spans'
    `annotations`) is not a kernel. A trace without a CUDA kernel (CUPTI
    now and then returns none) is taken again, up to `tries` times;
    ([], [], [], s, n) if all were empty."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CUDA] + ([ProfilerActivity.CPU] if host else [])
    for _ in range(tries):
        torch.cuda.synchronize()
        with profile(activities=activities) as prof:
            t0 = time.perf_counter()
            for _ in range(n):
                step()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        kernels, ranges, host_ops = [], [], []
        for e in prof.events():
            item = (e.name, e.time_range.start, e.time_range.end)
            if e.device_type != DeviceType.CUDA:
                host_ops.append(item)
            elif getattr(e, "is_user_annotation", False) or e.name in annotations:
                ranges.append(item)
            else:
                kernels.append(item)  # a kernel, copy or fill
        if kernels:
            return kernels, ranges, host_ops, wall, n
    return [], [], [], wall, n


def traced_window(torch, step, n: int, seconds: float, spans: Spans, annotations,
                  work) -> tuple:
    """A traced run's window: n calls traced on the card alone (the
    kernels, busy time and host seconds that the rooflines and the idle
    share read), n more traced on the card and the host (the breakdown's
    gaps by host operation, the device ranges and the host ops), then
    `seconds` of calls with the spans on. `work()` gives the counts of a
    call. (Trace, breakdown, calls made)."""
    kernels, _, _, wall_n, n_dev = profile_calls(torch, step, n, annotations, host=False)
    k_host, ranges, host_ops, _, _ = profile_calls(torch, step, n, annotations)
    spans.clear()
    lat, wall = closed_loop(step, seconds)
    trace = Trace(spans=spans.ms(), host=dict(spans.host), kernels=kernels, ranges=ranges,
                  host_ops=host_ops, profiled_calls=n_dev,
                  busy_s=union_seconds([(s, e) for _, s, e in kernels]), window_s=wall_n,
                  calls=len(lat), wall_s=wall, work=work())
    return trace, breakdown(k_host, host_ops), 2 * n + len(lat)


def breakdown(kernels: list, host: list, top: int = 10) -> dict:
    """The device operations that took most time, and the longest idle
    gaps between kernels, each named by the innermost host operation
    running at the gap's midpoint (`host:none` where none was)."""
    by_name: dict = {}
    for n, s, e in kernels:
        by_name[n] = by_name.get(n, 0.0) + (e - s) / 1e6
    ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
    gaps, end = [], None
    for n, s, e in sorted(kernels, key=lambda k: k[1]):
        if end is not None and s > end:
            gaps.append((end, s))
        end = e if end is None else max(end, e)
    named: dict = {}
    hs = sorted(host, key=lambda h: h[1])
    stack, i = [], 0  # open host ops, outermost first (a thread's ops nest)
    for s, e in sorted(gaps, key=lambda g: g[0] + g[1]):
        mid = (s + e) / 2
        while i < len(hs) and hs[i][1] <= mid:
            while stack and stack[-1][2] < hs[i][1]:
                stack.pop()
            stack.append(hs[i])
            i += 1
        while stack and stack[-1][2] < mid:
            stack.pop()
        name = stack[-1][0] if stack else "host:none"
        named[name] = named.get(name, 0.0) + (e - s) / 1e6
    idle = sorted(named.items(), key=lambda kv: -kv[1])[:top]
    return {"device_ops": [[n, v] for n, v in ops], "idle_gaps": [[n, v] for n, v in idle]}


def sync(torch, device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def peak_memory(torch, device) -> int:
    """Peak bytes allocated on the device (0 off the card)."""
    return torch.cuda.max_memory_allocated(device) if device.type == "cuda" else 0


# ------------------------------------------------------------------ checks

@contextlib.contextmanager
def matmul_precision(torch, tf32: bool):
    """TF32 on or off for matmuls and cuDNN convolutions, restored after."""
    old = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = tf32
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = old


def verdict(readings: dict, limits: dict) -> tuple:
    """(correct, [[name, value, limit]]): each number against its limit
    (correct when value <= limit; a number that is not finite fails)."""
    rows = [[k, float(readings[k]), float(limits[k])] for k in limits]
    ok = all(math.isfinite(v) and v <= lim for _, v, lim in rows)
    return ok, rows


def forbidden_modules() -> list:
    """Top-level names of loaded modules that a benchmark run may not load."""
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))
