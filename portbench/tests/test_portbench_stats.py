"""The harness's arithmetic: percentiles, spreads, busy time, the
reservoir, the verdict, and the readers' rate, idle, roofline and mfu."""

import random
import re
import statistics

import pytest

from portbench import counts, harness


def _trace(**kw):
    base = dict(spans={}, host={}, kernels=[], ranges=[], host_ops=[], profiled_calls=1,
                busy_s=0.0, window_s=1.0, calls=0, wall_s=1.0, work={})
    base.update(kw)
    return harness.Trace(**base)


def test_percentile_interpolates_like_numpy():
    v = list(range(1, 101))
    assert harness.percentile(v, 95) == pytest.approx(95.05)
    assert harness.percentile([3.0], 95) == 3.0
    assert harness.percentile([1.0, 2.0], 50) == 1.5


def test_spread_is_iqr_over_median():
    v = [1.0, 2.0, 3.0, 4.0, 5.0, 6.0]
    q1, q2, q3 = statistics.quantiles(v, n=4)
    assert harness.spread(v) == pytest.approx((q3 - q1) / q2)


def test_union_counts_overlaps_once():
    assert harness.union_seconds([(0, 10), (5, 15), (20, 30)]) == pytest.approx(25e-6)
    assert harness.union_seconds([]) == 0.0


def test_reservoir_keeps_k_and_samples_evenly():
    hits = [0] * 10
    for s in range(2000):
        r = harness.Reservoir(2, random.Random(s))
        for i in range(10):
            r.offer(i)
        assert len(r.items) == 2
        for i in r.items:
            hits[i] += 1
    assert min(hits) > 300 and max(hits) < 500


def test_verdict():
    ok, rows = harness.verdict({"a": 0.1, "b": 2.0}, {"a": 0.2, "b": 1.0})
    assert not ok and rows == [["a", 0.1, 0.2], ["b", 2.0, 1.0]]
    assert harness.verdict({"a": 0.1}, {"a": 0.2})[0]
    assert not harness.verdict({"a": float("nan")}, {"a": 0.2})[0]


def test_idle_and_mfu_readers():
    t = _trace(kernels=[("k", 0, 1)], busy_s=0.25, window_s=1.0, calls=10, wall_s=2.0,
               work={"call": counts.Work(989e12 * 0.02, 0, 0)})
    assert harness.reader("serve.idle_pct").read(t) == pytest.approx(75.0)
    assert harness.reader("serve.mfu_pct").read(t) == pytest.approx(10.0)
    assert harness.reader("serve.idle_pct").read(_trace()) is None


def test_roofline_reader_is_silent_without_its_kernel():
    w = counts.vgg_stages(8, 64, 64)
    t = _trace(kernels=[("void vgg_stage_kernel<1>(float const*)", 0, 10 * w.seconds() * 1e6)],
               work={"vgg_stage": w}, profiled_calls=1)
    assert harness.reader("serve.vgg_stage_roofline_pct").read(t) == pytest.approx(10.0)
    t = _trace(kernels=[("other_kernel", 0, 5)], work={"vgg_stage": w})
    assert harness.reader("serve.vgg_stage_roofline_pct").read(t) is None


def test_span_readers_take_the_median():
    t = _trace(spans={"superpoint": [1.0, 2.0, 9.0], "extract": [1.0, 1.0, 1.0],
                      "matcher": [3.0, 4.0, 5.0]}, host={"ransac": [7.0, 8.0]})
    assert harness.reader("serve.superpoint_ms").read(t) == 3.0
    assert harness.reader("serve.matcher_ms").read(t) == 4.0
    assert harness.reader("serve.ransac_host_ms").read(t) == 7.5
    assert harness.reader("map.gnn_ms").read(t) is None


def test_kernel_seconds_matches_at_the_start():
    t = _trace(kernels=[("sinkhorn_stream(float const*)", 0, 100),
                        ("void sinkhorn_stream_cluster<2>()", 100, 300),
                        ("at::native::sinkhorn_stream_like", 0, 1000)])
    assert t.kernel_seconds(re.compile(r"^(void\s+)?sinkhorn_stream(_cluster|_wide)?\b")) \
        == pytest.approx(300e-6)


def test_range_ms_reads_any_record_function_by_name():
    t = _trace(ranges=[("ransac.refine", 0, 400), ("ransac.refine", 1000, 1200),
                       ("other", 0, 50)],
               host_ops=[("ransac.refine", 0, 900)], profiled_calls=2)
    assert t.range_ms("ransac.refine") == pytest.approx(0.3)
    assert t.range_ms("ransac.refine", device=False) == pytest.approx(0.45)
    assert t.range_ms("absent") is None


def test_breakdown_names_gaps_by_host_op():
    kernels = [("a", 0, 10), ("b", 20, 30), ("a", 100, 110)]
    host = [("outer", 0, 200), ("ransac", 40, 90)]
    b = harness.breakdown(kernels, host)
    assert b["device_ops"][0] == ["a", pytest.approx(20e-6)]
    assert b["idle_gaps"][0] == ["ransac", pytest.approx(70e-6)]
    assert ["outer", pytest.approx(10e-6)] in b["idle_gaps"]
