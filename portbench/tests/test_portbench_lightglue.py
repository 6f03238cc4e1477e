"""The LightGlue cell (`map_lg4096`) on the CPU: the manifest finds its
files, the counts match sums by hand, the readers read the runner's
counts, the control and each fault read 3x a sound run or more and fail,
and the benchmark's frozen reference is the tests' reference, byte for
byte. A run is cut to a size a test run holds (128-pixel frames, 64
keypoints, chunks of 3, the pruning floor at 20); the port's plain paths
stand in for K8."""

import filecmp
import os
import time

import pytest
import torch

from portbench import counts_lightglue as cl
from portbench import harness
from portbench.runners import lightglue_pairs as lgp

torch.set_num_threads(2)
ROOT = os.path.dirname(harness.HERE)
MAN = harness.manifest(ROOT)
CPU = torch.device("cpu")
METRICS = ["lg.attention_ms", "lg.assign_ms", "lg.layers_per_pair", "lg.kept_points_pct",
           "lg.host_syncs_per_chunk", "lg.flash_roofline_pct", "lg.idle_pct", "lg.mfu_pct",
           "lg.left_early_pct"]


def _cell(seed=12):
    c = harness.cell(MAN, "map_lg4096", seed, 0.5, False)
    c.cfg.update(image_size=128, max_keypoints=64, pair_chunk_asked=3, pruning_min_keypoints=20)
    c.traffic.update(frames=6, covis=2, pairs=6)
    return c


def _worst_ratio(bad: dict, good: dict, limits: dict) -> float:
    return max(bad[k] / max(good[k], 0.1 * limits[k], 1e-12) for k in limits)


@pytest.fixture(scope="module")
def sound():
    c = _cell()
    return c, lgp.run(c, CPU, time.perf_counter())


@pytest.mark.parametrize("trace", [False, True])
def test_cell_is_listed_and_read(trace):
    cell = harness.cell(MAN, "map_lg4096", 1, 1.0, trace)
    assert cell.cfg["entry"] == "lightglue_pairs" and cell.entry["chips"] == 1
    assert cell.entry["config"] == "lightglue_map" and cell.entry["traffic"] == "scan48_covis10"
    names = [m["name"] for m in cell.metrics]
    if trace:
        assert names == METRICS
        assert all(callable(harness.reader(n).read) for n in names)
    else:
        assert names == ["map_pairs_per_s", "setup_s"]
    assert set(cell.limits) == {"lg_stop_gap", "lg_kept_gap", "lg_score_err", "lg_match_gap"}
    assert cell.limits["lg_stop_gap"] == cell.limits["lg_kept_gap"] == 0
    conf = next(c for c in MAN["configs"] if c["name"] == "lightglue_map")
    assert conf["reduced"] == []
    assert {k: cell.cfg[k] for k in ("descriptor_dim", "n_layers", "num_heads", "max_keypoints",
                                     "pruning_min_keypoints")} == {
        "descriptor_dim": 256, "n_layers": 9, "num_heads": 4, "max_keypoints": 4096,
        "pruning_min_keypoints": 1536}


def test_reference_is_the_tests_reference():
    tests = os.path.join(ROOT, "tests", "lightglue_reference.py")
    frozen = os.path.join(harness.HERE, "reference", "lightglue.py")
    assert filecmp.cmp(tests, frozen, shallow=False)


def test_counts_match_hand_sums():
    c, h = 8, 2
    a = cl.attention(3, 5, c, h)
    assert (a.mm, a.elem) == (4 * 3 * 5 * 8, 2 * 3 * 5)
    w = cl.layer(3, 5, c, h)
    per_point = 2 * (c * 3 * c + c * c + 2 * c * 2 * c + 2 * c * c) + 2 * (3 * c * c + 2 * c * 2 * c
                                                                           + 2 * c * c)
    attn = 4 * c * (9 + 25 + 15 + 15)
    assert w.mm == per_point * 8 + attn
    assert w.elem == h * (9 + 25 + 15 + 15)
    asg = cl.assignment(3, 5, c)
    assert asg.mm == 2 * 8 * c * c + 2 * 15 * c + 2 * 8 * c and asg.elem == 2 * 15
    stats = {"attention_points": [(0, 0, 3, 5), (0, 1, 4, 4), (1, 1, 2, 2)], "layers": [1, 2],
             "valid": [(3, 5), (4, 4)]}
    total = cl.chunk(stats, c, h, 9)
    want = (cl.layer(3, 5, c, h) + cl.layer(4, 4, c, h) + cl.layer(2, 2, c, h)
            + cl.heads_after(3, 5, c) + cl.heads_after(4, 4, c) + cl.heads_after(2, 2, c)
            + cl.assignment(3, 5, c) + cl.assignment(2, 2, c))
    assert total == want
    assert cl.flash_seconds(stats, c) == pytest.approx(
        3 * 4 * c * (64 + 64 + 16) / cl.TF32_FLOPS)
    assert cl.layers_per_pair(stats) == 1.5
    assert cl.kept_points(stats) == (3 + 5 + 4 + 4 + 2 + 2, 8 + 8 + 8)
    chunks = [{"layers": [1, 2, 0], "left_early": 1}, {"layers": [2, 2], "left_early": 0}]
    assert cl.left_early_share(chunks) == pytest.approx(1 / 4)
    assert cl.layer_counts(chunks) == {0: 1, 1: 1, 2: 3}


def test_work_splits_the_profiled_chunks():
    st = {"attention_points": [(0, 0, 4, 4)], "layers": [1], "valid": [(8, 8)], "syncs": 1,
          "left_early": 1}
    big = {"attention_points": [(0, 0, 8, 8), (1, 0, 8, 8)], "layers": [2], "valid": [(8, 8)],
           "syncs": 2, "left_early": 0}
    log = [(True, big), (True, st), (True, st), (True, big), (True, big), (False, st),
           (False, big)]
    w = lgp._work({"descriptor_dim": 8, "num_heads": 2, "n_layers": 9}, log, 2)
    assert w["flash"] == pytest.approx(cl.flash_seconds(st, 8))
    assert w["layers_per_pair"] == 1.5
    assert w["kept_points_pct"] == pytest.approx(100 * (8 + 32) / 48)
    assert w["left_early_pct"] == pytest.approx(50.0)
    assert w["call"] == (cl.chunk(st, 8, 2, 9) + cl.chunk(big, 8, 2, 9)).scaled(0.5)


def _trace(**kw):
    base = dict(spans={}, host={}, kernels=[], ranges=[], host_ops=[], profiled_calls=2,
                busy_s=0.5, window_s=1.0, calls=10, wall_s=2.0, work={})
    base.update(kw)
    return harness.Trace(**base)


def test_readers():
    from portbench.counts import Work

    t = _trace(kernels=[("(anonymous namespace)::flash_fwd_ws(float const*, CUtensorMap_st)",
                         0, 400), ("flash_fwd_like_other", 0, 1000)],
               ranges=[("attention.softmax", 0, 300), ("lightglue.assign", 0, 100)],
               host_ops=[("lightglue.forward", 0, 100), ("cudaStreamSynchronize", 10, 20),
                         ("cudaStreamSynchronize", 150, 160), ("lightglue.forward", 200, 300),
                         ("cudaStreamSynchronize", 250, 260)],
               work={"flash": 1e-4, "call": Work(989e12 * 0.01, 0.0, 0.0), "layers_per_pair": 5.0,
                     "kept_points_pct": 57.5, "left_early_pct": 40.0})
    read = {m: harness.reader(m).read(t) for m in METRICS}
    assert read["lg.attention_ms"] == pytest.approx(0.2)  # 400 us over 2 chunks
    assert read["lg.assign_ms"] == pytest.approx(0.05)
    assert read["lg.layers_per_pair"] == 5.0 and read["lg.kept_points_pct"] == 57.5
    assert read["lg.left_early_pct"] == 40.0
    assert read["lg.host_syncs_per_chunk"] == 1.0
    assert read["lg.flash_roofline_pct"] == pytest.approx(100 * 1e-4 * 2 / 400e-6)
    assert read["lg.idle_pct"] == pytest.approx(50.0)
    assert read["lg.mfu_pct"] == pytest.approx(100 * 0.01 * 10 / 2.0)
    empty = _trace()
    assert all(harness.reader(m).read(empty) is None
               for m in METRICS if m not in ("lg.idle_pct",))


def test_sound_run_reads_correct(sound):
    c, res = sound
    assert res["attempted"] >= 1 and res["failed"] == 0
    assert harness.verdict(res["readings"], c.limits)[0]
    # The init spreads the pairs' stop layers (judges/lightglue_pairs.py):
    # of the 6 pairs, two stop after 6 layers, one after 7, one after 8,
    # two run all 9; any 3 of them hold pairs that stop at different layers.
    assert len(res["stats"]["layers_seen"]) >= 2 and min(res["stats"]["layers_seen"]) < 9
    assert res["stats"]["window_left_early_pct"] > 0
    assert res["stats"]["kept_share"] < 1.0 and res["stats"]["reference_matches"] > 0


def test_control_fails(sound):
    c, good = sound
    bad = lgp.run(_cell(), CPU, time.perf_counter(), control=lgp.CONTROLS["tf32"])
    assert _worst_ratio(bad["readings"], good["readings"], c.limits) >= 3
    assert harness.verdict(bad["readings"], c.limits)[0] is False


@pytest.mark.parametrize("name", sorted(lgp.FAULTS))
def test_faults_fail(sound, name):
    c, good = sound
    bad = lgp.run(_cell(), CPU, time.perf_counter(), fault=lgp.FAULTS[name])
    assert _worst_ratio(bad["readings"], good["readings"], c.limits) >= 3
    assert harness.verdict(bad["readings"], c.limits)[0] is False


def test_init_spreads_stop_layers_by_the_schedule():
    """On every pair of the scan the reference stops as the init's
    `stop_shares` say: none before layer 7, then 55% of the pairs
    (rounded), the rest all 9 layers."""
    from portbench import scenes, weights
    from portbench.judges import lightglue_pairs as judge

    c = _cell()
    sp = weights.superpoint(c.cfg, scenes.sub_seed(c.seed, "superpoint"), CPU)
    scan = scenes.scan(sp, c.cfg, c.traffic, c.seed, CPU, 3)
    w = judge.weights_for(c.cfg, c.seed, CPU, scan)
    seen = sorted(judge.reference_pair(c.cfg, w, scan["feats"], scan["image_hw"], i, j)["layers"]
                  for i, j in scan["pairs"])
    want, running = [], len(scan["pairs"])
    for layer, share in enumerate(c.cfg["init"]["stop_shares"]):
        k = round(share * running)
        want += [layer + 1] * k
        running -= k
    assert seen == sorted(want + [9] * running) == [8, 8, 8, 9, 9, 9]
