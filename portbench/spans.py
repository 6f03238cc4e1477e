"""The host records of a traced run attributed to the program's spans.

The port marks its stages with `record_function` ranges while a profiler
records (`onepose_tpu_torch.utils.profiling.span`: `pose.call`,
`pose.pnp`, `attention.softmax`, ...). The host profile holds those
ranges and, on the same clock, the CUDA API calls (cuda* and cu*) that
CUPTI records on the host. A call made while a range was open belongs to
it: a record is inside a range when the record starts inside it.

`LAUNCHES` are the calls that put one operation on the card's queue (a
kernel, a memset or a whole CUDA graph); `SYNCS` the calls that make the
host wait for the card (PyTorch's blocking copies and `.item()` end in
`cudaStreamSynchronize`). A serving call on an H100 (torch 2.11, CUDA
12.8) records cudaLaunchKernel, cuLaunchKernel (cuBLAS),
cudaLaunchKernelExC, cuLaunchKernelEx, cudaLaunchCooperativeKernel and
cudaMemsetAsync, as many as the card-only trace's kernels and memsets,
and cudaStreamSynchronize; the rest of each set is named for the paths
that would call them.
"""

from __future__ import annotations

import bisect
from typing import Optional

LAUNCHES = frozenset({"cudaLaunchKernel", "cudaLaunchKernelExC", "cudaLaunchCooperativeKernel",
                      "cuLaunchKernel", "cuLaunchKernelEx", "cudaMemsetAsync", "cudaMemset",
                      "cudaGraphLaunch"})
SYNCS = frozenset({"cudaStreamSynchronize", "cudaDeviceSynchronize", "cudaEventSynchronize",
                   "cudaMemcpy"})


def host_ranges(trace, span: str) -> list:
    """(start us, end us) of the host ranges called `span`, in order."""
    return sorted((s, e) for n, s, e in trace.host_ops if n == span)


def inside(trace, span: str, names) -> Optional[list]:
    """The host records whose name is in `names` that start inside a host
    range called `span`, as (name, start us, end us); None where the trace
    has no such range (the program opened no such span)."""
    ranges = host_ranges(trace, span)
    if not ranges:
        return None
    starts = [s for s, _ in ranges]
    hit = []
    for n, s, e in trace.host_ops:
        if n in names:
            i = bisect.bisect_right(starts, s) - 1
            if i >= 0 and s <= ranges[i][1]:
                hit.append((n, s, e))
    return hit


def count_per_call(trace, span: str, names) -> Optional[float]:
    """Records named in `names` inside `span` a profiled call."""
    hit = inside(trace, span, names)
    return None if hit is None else len(hit) / trace.profiled_calls


def ms_per_call(trace, span: str, names) -> Optional[float]:
    """Summed host ms of the records named in `names` inside `span`, a
    profiled call."""
    hit = inside(trace, span, names)
    return None if hit is None else sum(e - s for _, s, e in hit) / 1e3 / trace.profiled_calls
