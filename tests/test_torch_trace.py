"""The port's profiler spans (`utils.profiling.span`) on the CPU, and the
benchmark's readers of the counters attributed to them.

Under torch.profiler a `PosePipeline` call records `pose.call` holding
its stages, with RANSAC-PnP's sub-stages inside `pose.pnp`, each once; a
`SuperGlue.forward` records `superglue.gnn` holding four
`attention.softmax` spans a layer, then `superglue.sinkhorn` and
`superglue.extract`. The outputs are bit-equal with the profiler on and
off, and with no profiler a span never enters `record_function`. The
readers (`portbench/metrics/`) count only the records inside their span,
a profiled call, and read None where the program opened no such span.
"""

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from onepose_tpu_torch.models.gats_spg import GATsSPG
from onepose_tpu_torch.models.superglue import SuperGlue
from onepose_tpu_torch.models.superpoint import SuperPoint, extract_keypoints
from onepose_tpu_torch.runtime.pipeline import ObjectAnnotation, PosePipeline
from onepose_tpu_torch.utils import profiling
from portbench import harness
from portbench import spans as pspans

torch.set_num_threads(2)

# The pipeline tests' cut shapes (tests/test_torch_pipeline.py).
B, S, KPTS, N3, L, BLOCKS, HYP = 2, 64, 64, 32, 4, 2, 32
SG_LAYERS, SG_N = 2, 24
CALL_STAGES = ("pose.superpoint", "pose.extract", "pose.matcher", "pose.pnp")
PNP_STAGES = ("pnp.sample", "pnp.p3p", "pnp.preempt", "pnp.score", "pnp.refine", "pnp.final")
SG_STAGES = ("superglue.gnn", "superglue.sinkhorn", "superglue.extract")


@pytest.fixture(scope="module")
def serving():
    torch.manual_seed(0)
    pipe = PosePipeline(superpoint=SuperPoint(nms_kernel=True),
                        matcher=GATsSPG(num_blocks=BLOCKS, gats_kernel=True, fused_match=True,
                                        match_threshold=0.02),
                        max_keypoints=KPTS, ransac_hypotheses=HYP, compute_dtype=torch.float32,
                        device="cpu")
    g = torch.Generator().manual_seed(1)
    unit = torch.nn.functional.normalize
    anno = ObjectAnnotation(
        points3d=(torch.rand((N3, 3), generator=g) - 0.5) * 0.2,
        desc3d=unit(torch.randn((N3, 256), generator=g), dim=-1),
        leaf_desc=unit(torch.randn((N3, L, 256), generator=g), dim=-1),
        mask3d=torch.arange(N3) < N3 - 4,
        leaf_mask=torch.rand((N3, L), generator=g) < 0.8)
    images = torch.rand((B, S, S, 1), generator=g)
    K = torch.tensor([[60.0, 0, 32], [0, 60.0, 32], [0, 0, 1]]).expand(B, 3, 3).contiguous()
    draws = torch.rand((B, HYP, 3), generator=g)
    return dict(pipe=pipe, anno=anno, images=images, K=K, draws=draws)


@pytest.fixture(scope="module")
def superglue():
    torch.manual_seed(2)
    sg = SuperGlue(num_layers=SG_LAYERS, sinkhorn_iterations=10, match_threshold=0.0).eval()
    g = torch.Generator().manual_seed(3)
    kpts = [torch.rand((1, SG_N, 2), generator=g) * 64 for _ in range(2)]
    desc = [torch.nn.functional.normalize(torch.randn((1, SG_N, 256), generator=g), dim=-1)
            for _ in range(2)]
    scores = [torch.rand((1, SG_N), generator=g) for _ in range(2)]
    masks = [torch.arange(SG_N)[None] < SG_N - 3, torch.ones((1, SG_N), dtype=torch.bool)]
    args = (kpts[0], kpts[1], desc[0], desc[1], scores[0], scores[1], (64, 64), (64, 64),
            masks[0], masks[1])
    return sg, args


def _call(s):
    return s["pipe"](s["images"], s["K"], s["anno"], draws=s["draws"])


def _features(s):
    with torch.inference_mode():
        dense = s["pipe"].superpoint(s["images"])
        return extract_keypoints(dense["score_map"], dense["descriptor_map"],
                                 max_keypoints=KPTS)


def _sg_call(sg, args):
    with torch.inference_mode():
        return sg(*args)


def _traced(fn):
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        out = fn()
    return out, [(e.name, e.time_range.start, e.time_range.end) for e in prof.events()]


def _named(events, name):
    return [(s, e) for n, s, e in events if n == name]


def _within(inner, outer):
    return outer[0] <= inner[0] and inner[1] <= outer[1]


def _equal(a, b):
    assert a.keys() == b.keys()
    for k in a:
        assert torch.equal(a[k], b[k]), k


def test_serving_call_records_each_span_once_inside_its_parent(serving):
    _, ev = _traced(lambda: _call(serving))
    (call,) = _named(ev, "pose.call")
    for name in CALL_STAGES:
        (r,) = _named(ev, name)
        assert _within(r, call), name
    (pnp,) = _named(ev, "pose.pnp")
    starts = []
    for name in PNP_STAGES:
        (r,) = _named(ev, name)
        assert _within(r, pnp), name
        starts.append(r[0])
    assert starts == sorted(starts)
    assert [_named(ev, n)[0][0] for n in CALL_STAGES] == sorted(
        _named(ev, n)[0][0] for n in CALL_STAGES)


def test_from_features_records_the_call_without_superpoint(serving):
    feats = _features(serving)
    s = serving
    _, ev = _traced(lambda: s["pipe"].from_features(feats, s["K"], s["anno"], draws=s["draws"]))
    (call,) = _named(ev, "pose.call")
    for name in ("pose.matcher", "pose.pnp") + PNP_STAGES:
        (r,) = _named(ev, name)
        assert _within(r, call), name
    assert not _named(ev, "pose.superpoint") and not _named(ev, "pose.extract")


def test_superglue_forward_records_attention_inside_the_gnn(superglue):
    sg, args = superglue
    _, ev = _traced(lambda: _sg_call(sg, args))
    (gnn,) = _named(ev, "superglue.gnn")
    attn = _named(ev, "attention.softmax")
    assert len(attn) == SG_LAYERS * 4
    assert all(_within(a, gnn) for a in attn)
    stages = [_named(ev, n) for n in SG_STAGES]
    assert all(len(r) == 1 for r in stages)
    (_, g_end), (s_start, s_end), (e_start, _) = (r[0] for r in stages)
    assert g_end <= s_start and s_end <= e_start


def test_outputs_are_bit_equal_with_the_profiler_on_and_off(serving, superglue):
    on, _ = _traced(lambda: _call(serving))
    _equal(on, _call(serving))
    sg, args = superglue
    on, _ = _traced(lambda: _sg_call(sg, args))
    _equal(on, _sg_call(sg, args))


def test_without_a_profiler_a_span_never_enters_record_function(serving, superglue,
                                                                  monkeypatch):
    def refuse(*a, **k):
        raise AssertionError("record_function entered with no profiler")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    with profile(activities=[ProfilerActivity.CPU]):
        with pytest.raises(AssertionError, match="no profiler"):
            profiling.span("x")  # the stub is what a span reaches under a profiler
    _call(serving)
    _sg_call(*superglue)
    timer = profiling.StageTimer()
    with timer.stage("a"):
        pass
    assert profiling.span("x") is profiling.span("y")  # one shared null context


def test_stage_timer_stages_are_spans_and_keep_their_report():
    timer = profiling.StageTimer()

    def stages():
        with timer.stage("outer"):
            with timer.stage("inner"):
                torch.ones(4).sum()

    _, ev = _traced(stages)
    (outer,), (inner,) = _named(ev, "outer"), _named(ev, "inner")
    assert _within(inner, outer)
    rep = timer.report()
    assert set(rep) == {"outer", "inner"}
    assert all(set(v) == {"mean_ms", "p50_ms", "total_ms", "count"} and v["count"] == 1
               for v in rep.values())


def test_device_trace_is_gone():
    assert not hasattr(profiling, "device_trace")


# ------------------------------------------------------------ the readers

def _trace(host_ops=(), ranges=(), calls=2):
    return harness.Trace(spans={}, host={}, kernels=[], ranges=list(ranges),
                         host_ops=list(host_ops), profiled_calls=calls, busy_s=0.0,
                         window_s=1.0, calls=0, wall_s=1.0, work={})


# Two profiled calls, 0-1000 us and 2000-3000 us, RANSAC-PnP at 500-900
# and 2500-2900; records between the calls (the benchmark's own copies)
# belong to no span.
SERVING = [
    ("pose.call", 0, 1000), ("pose.call", 2000, 3000),
    ("pose.pnp", 500, 900), ("pose.pnp", 2500, 2900),
    ("aten::mul", 90, 120),
    ("cudaLaunchKernel", 100, 105), ("cudaMemsetAsync", 550, 552),
    ("cudaLaunchKernel", 600, 604), ("cudaStreamSynchronize", 700, 750),
    ("cudaLaunchKernel", 1500, 1504), ("cudaStreamSynchronize", 1200, 1300),
    ("cuLaunchKernel", 2100, 2104), ("cudaStreamSynchronize", 2050, 2090),
    ("cudaLaunchKernelExC", 2600, 2605), ("cudaLaunchKernel", 2700, 2703),
    ("cudaMemcpyAsync", 2800, 2810),
]


@pytest.mark.parametrize("metric, want", [
    ("serve.launches_per_call", 3.0),  # 100, 550, 600; 2100, 2600, 2700
    ("serve.pnp_launches_per_call", 2.0),  # 550, 600; 2600, 2700
    ("serve.host_syncs_per_call", 1.0),  # 700 and 2050, not 1200
    ("serve.sync_wait_ms", 0.045),  # (50 + 40) us over 2 calls
    ("serve.pnp_enqueue_ms", 0.375),  # (800 - 50) us over 2 calls
])
def test_serving_readers_count_inside_their_span_a_call(metric, want):
    assert harness.reader(metric).read(_trace(SERVING)) == pytest.approx(want)
    assert harness.reader(metric).read(_trace(SERVING, calls=1)) == pytest.approx(2 * want)


@pytest.mark.parametrize("metric", ["serve.launches_per_call", "serve.pnp_launches_per_call",
                                    "serve.host_syncs_per_call", "serve.sync_wait_ms",
                                    "serve.pnp_enqueue_ms", "map.attention_ms"])
def test_readers_read_none_without_the_span(metric):
    t = _trace([r for r in SERVING if not r[0].startswith("pose.")],
               ranges=[("gnn", 0, 100)])
    assert harness.reader(metric).read(t) is None


def test_attention_reader_sums_the_device_ranges_a_chunk():
    t = _trace(host_ops=[("attention.softmax", 0, 5000)],
               ranges=[("attention.softmax", 0, 100), ("attention.softmax", 200, 400),
                       ("superglue.gnn", 0, 1000)])
    assert harness.reader("map.attention_ms").read(t) == pytest.approx(0.15)


def test_a_record_counts_where_it_starts():
    t = _trace([("pose.call", 0, 100), ("cudaStreamSynchronize", 90, 180),
                ("cudaLaunchKernel", 100, 104), ("cudaLaunchKernel", 101, 104)], calls=1)
    hit = pspans.inside(t, "pose.call", pspans.LAUNCHES | pspans.SYNCS)
    assert [n for n, _, _ in hit] == ["cudaStreamSynchronize", "cudaLaunchKernel"]
    assert pspans.inside(t, "pose.pnp", pspans.LAUNCHES) is None
