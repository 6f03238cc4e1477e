"""The profiler helper of `onepose_tpu_torch/utils/profiling.py` on the CPU,
with torch.profiler stubbed: `cuda_trace` takes an empty trace again, up to
`tries` runs of the block, returns the first trace that holds a CUDA kernel
and raises `EmptyTrace` when none does; `device_busy` and chip_smoke's
profiled rows go through it, so a row whose trace never holds a kernel
fails instead of logging 0."""

import re
from pathlib import Path
from types import SimpleNamespace

import pytest
import torch
from torch.autograd import DeviceType

import chip_smoke
from onepose_tpu_torch.utils import profiling

torch.set_num_threads(2)


def _event(name, start, end, device=DeviceType.CUDA):
    return SimpleNamespace(name=name, device_type=device,
                           time_range=SimpleNamespace(start=start, end=end))


class _Profiler:
    """A stand-in for torch.profiler.profile whose runs record the next of
    `traces` (lists of events; the last repeats)."""

    def __init__(self, traces):
        self.traces, self.runs, self.activities = traces, 0, []

    def __call__(self, activities):
        self.activities.append(list(activities))
        events = self.traces[min(self.runs, len(self.traces) - 1)]
        self.runs += 1

        class Run:
            def __enter__(self):
                return self

            def __exit__(self, *exc):
                return False

            def events(self):
                return events

        return Run()


@pytest.fixture
def stub(monkeypatch):
    def install(traces):
        prof = _Profiler(traces)
        monkeypatch.setattr(torch.profiler, "profile", prof)
        monkeypatch.setattr(torch.cuda, "synchronize", lambda *a, **k: None)
        return prof

    return install


FILLED = [_event("gemm", 10.0, 40.0), _event("cpu op", 0.0, 50.0, DeviceType.CPU),
          _event("gemm", 60.0, 70.0), _event("softmax", 45.0, 55.0)]


def test_cuda_trace_retries_an_empty_trace(stub):
    prof = stub([[], FILLED])
    calls = []
    trace = profiling.cuda_trace(lambda: calls.append(1))
    assert len(calls) == prof.runs == trace.tries == 2
    assert [k[0] for k in trace.kernels] == ["gemm", "gemm", "softmax"]  # CUDA only
    assert trace.kernel_ms == pytest.approx(0.05)
    assert trace.span_ms == pytest.approx(0.06)
    assert trace.by_name() == {"gemm": (2, pytest.approx(0.04)),
                               "softmax": (1, pytest.approx(0.01))}
    assert trace.wall_ms >= 0.0
    assert len(prof.activities[0]) == 2  # CPU and CUDA activity


def test_cuda_trace_raises_when_every_try_is_empty(stub):
    prof = stub([[_event("cpu op", 0.0, 5.0, DeviceType.CPU)]])
    calls = []
    with pytest.raises(profiling.EmptyTrace, match="no CUDA kernel in 3 runs"):
        profiling.cuda_trace(lambda: calls.append(1))
    assert len(calls) == prof.runs == 3
    with pytest.raises(profiling.EmptyTrace, match="in 5 runs"):
        profiling.cuda_trace(lambda: None, tries=5)


def test_device_busy_goes_through_cuda_trace(stub):
    prof = stub([[], [], FILLED])
    busy = profiling.device_busy(lambda: None)
    assert prof.runs == 3 and len(prof.activities[0]) == 1  # CUDA activity alone
    assert busy["kernels"] == 3 and busy["share"] == pytest.approx(0.05 / 0.06)
    stub([[]])
    assert profiling.device_busy(lambda: None) is None


def test_chip_smoke_rows_fail_without_a_kernel(stub):
    """chip_smoke's per-stage rows: filled traces give (launches, device ms)
    each; a stage whose trace stays empty fails the phase (raises) after
    its tries instead of logging 0 kernels."""
    stub([FILLED])
    calls = []
    rows = chip_smoke._profile_stages(torch, [("a", lambda: calls.append("a")),
                                              ("b", lambda: calls.append("b"))])
    assert rows == {"a": (3, pytest.approx(0.05)), "b": (3, pytest.approx(0.05))}
    assert calls == ["a", "b"]
    stub([FILLED, [], [], []])
    calls.clear()
    with pytest.raises(profiling.EmptyTrace):
        chip_smoke._profile_stages(torch, [("a", lambda: calls.append("a")),
                                           ("b", lambda: calls.append("b"))])
    assert calls == ["a", "b", "b", "b"]
    stub([[], FILLED])
    assert chip_smoke._kernel_breakdown(torch, lambda: None, calls=1) == {
        "gemm": (2, pytest.approx(0.04)), "softmax": (1, pytest.approx(0.01))}


def test_chip_smoke_opens_the_profiler_only_through_the_helper():
    text = Path(chip_smoke.__file__).read_text()
    assert not re.search(r"^\s*(from torch\.profiler|import torch\.profiler)|"
                         r"torch\.profiler\.profile|ProfilerActivity|\bprofile\(", text, re.M)
    assert text.count("cuda_trace(") >= 7  # the seven profiled blocks
