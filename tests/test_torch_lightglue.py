"""The port's LightGlue (`models/lightglue.py`) against the plain reference
(`tests/lightglue_reference.py`, b = 1), on the CPU.

Seeded random weights at a small size: d = 64, 2 heads of 32, all 9
layers, 40 to 120 keypoints, the pruning floor lowered from 1536 to 30.
A chunk of 3 pairs, each with its own valid slots; image 1 of a pair is
image 0's points in another slot order, some dropped, so that the final
projection (at 16 times its bound, its input channel 0 zeroed) finds
mutual matches. For the adaptive case the init makes each pair stop at
its own layer and prune: the token-confidence head reads channel 0 (a
per-pair offset of 8, 5 or 3 in the descriptors) and channel 2 (each
point's own), its bias rising a unit a layer from -6; the matchability
head reads channel 1 at 40 times; the FFNs' outputs are cut to 1/20 so
that the descriptors carry through the layers.

Tolerance: the log assignment within ATOL of the reference's (fp32 sums
in another order, over 9 layers; the gaps seen are about 1e-5); stop
layers, every layer's kept set and matches0 equal.
"""

import math
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent))
import lightglue_reference as ref  # noqa: E402

from onepose_tpu_torch.models import convert  # noqa: E402
from onepose_tpu_torch.models.lightglue import LightGlue  # noqa: E402
from onepose_tpu_torch.parallel import sfm_parallel  # noqa: E402

torch.set_num_threads(2)

C, HEADS, LAYERS, FLOOR, N, SIZE = 64, 2, 9, 30, 120, (100, 100)
ATOL = 1e-4
ADAPTIVE = {"depth_confidence": 0.95, "width_confidence": 0.99}
FULL = {"depth_confidence": 0.0, "width_confidence": 0.0}


def upstream_weights(seed: int = 1, shaped: bool = True) -> dict:
    """A state dict in upstream's names and layout (`ref.specs`), drawn
    from the seed; `shaped` gives the init of the module docstring."""
    g = torch.Generator().manual_seed(seed)
    w = {}
    for name, shape, bound in ref.specs(C, HEADS, LAYERS):
        w[name] = (torch.ones(shape) if bound is None
                   else (torch.rand(shape, generator=g) * 2 - 1) * bound)
    if not shaped:
        return w
    for k in list(w):
        if k.endswith(("ffn.3.weight", "ffn.3.bias")):
            w[k] = w[k] * 0.05
    for layer in range(LAYERS - 1):
        tok = torch.zeros(1, C)
        tok[0, 0], tok[0, 2] = 1.0, 8.0
        w[f"token_confidence.{layer}.token.0.weight"] = tok
        w[f"token_confidence.{layer}.token.0.bias"] = torch.tensor([-6.0 + layer])
    for layer in range(LAYERS):
        mat = torch.zeros(1, C)
        mat[0, 1] = 40.0
        w[f"log_assignment.{layer}.matchability.weight"] = mat
        w[f"log_assignment.{layer}.matchability.bias"] = torch.tensor([2.0])
        fp = w[f"log_assignment.{layer}.final_proj.weight"] * 16
        fp[:, 0] = 0
        w[f"log_assignment.{layer}.final_proj.weight"] = fp
    return w


def chunk(seed: int = 2, valid=(120, 80, 40)) -> dict:
    g = torch.Generator().manual_seed(seed)
    b = len(valid)
    kp0 = torch.rand(b, N, 2, generator=g) * 100
    d0 = torch.nn.functional.normalize(torch.randn(b, N, C, generator=g), dim=-1)
    for p, off in enumerate((8.0, 5.0, 3.0)[:b]):
        d0[p, :, 0] += off
    m0 = torch.zeros(b, N, dtype=torch.bool)
    for p in range(b):
        m0[p, torch.randperm(N, generator=g)[:valid[p]]] = True
    perm = torch.stack([torch.randperm(N, generator=g) for _ in range(b)])
    kp1 = kp0.gather(1, perm[..., None].expand(-1, -1, 2))
    d1 = d0.gather(1, perm[..., None].expand(-1, -1, C))
    m1 = m0.gather(1, perm) & (torch.rand(b, N, generator=g) > 0.15)
    return {"kp0": kp0, "kp1": kp1, "d0": d0, "d1": d1, "m0": m0, "m1": m1}


def port_model(w: dict, conf: dict, attention_kernel=None, **kw) -> LightGlue:
    lg = LightGlue(C, HEADS, LAYERS, conf["depth_confidence"], conf["width_confidence"], 0.1,
                   FLOOR, attention_kernel=attention_kernel, **kw)
    lg.load_state_dict({k: torch.from_numpy(v)
                        for k, v in convert.lightglue_from_torch(w, HEADS).items()})
    return lg.eval()


def run_port(lg: LightGlue, x: dict) -> dict:
    with torch.no_grad():
        return lg(x["kp0"], x["kp1"], x["d0"], x["d1"], x["m0"], x["m1"], SIZE, SIZE)


def run_reference(w: dict, conf: dict, x: dict, p: int) -> dict:
    v0, v1 = x["m0"][p].nonzero()[:, 0], x["m1"][p].nonzero()[:, 0]
    full = dict(ref.CONF, descriptor_dim=C, num_heads=HEADS, n_layers=LAYERS,
                pruning_min_keypoints=FLOOR, **conf)
    r = ref.match_pair(w, x["kp0"][p][v0], x["kp1"][p][v1], x["d0"][p][v0], x["d1"][p][v1],
                       SIZE, SIZE, full)
    m0 = torch.full((N,), -1, dtype=torch.long)
    if len(v1):
        m0[v0] = torch.where(r["matches0"] >= 0, v1[r["matches0"].clamp(min=0)], -1)
    pa0 = torch.full((N,), -1, dtype=torch.long)
    pa0[v0] = r["pruned_at0"]
    pa1 = torch.full((N,), -1, dtype=torch.long)
    pa1[v1] = r["pruned_at1"]
    return {**r, "slot_matches0": m0, "slot_pruned0": pa0, "slot_pruned1": pa1,
            "slots0": v0[r["ind0"]], "slots1": v1[r["ind1"]]}


def port_scores(out: dict, p: int) -> tuple:
    """(scores over the kept points and the dustbins, kept slots 0, 1)."""
    g = next(g for g in out["assignments"] if p in g["rows"])
    k = g["rows"].index(p)
    l0, l1 = int(g["len0"][k]), int(g["len1"][k])
    s = g["scores"][k]
    rows, cols = list(range(l0)) + [s.shape[0] - 1], list(range(l1)) + [s.shape[1] - 1]
    return s[rows][:, cols], g["ind0"][k][:l0], g["ind1"][k][:l1]


@pytest.mark.parametrize("attention_kernel", [False, True], ids=["plain", "k8_plain"])
@pytest.mark.parametrize("case", ["full_depth", "adaptive"])
def test_matches_reference_pair_by_pair(case, attention_kernel):
    conf = FULL if case == "full_depth" else ADAPTIVE
    w = upstream_weights()
    x = chunk()
    out = run_port(port_model(w, conf, attention_kernel), x)
    stops = []
    for p in range(3):
        r = run_reference(w, conf, x, p)
        assert out["layers"][p] == r["layers"]
        assert out["stopped_at"][p] == r["stopped_at"]
        assert torch.equal(out["pruned_at0"][p], r["slot_pruned0"])
        assert torch.equal(out["pruned_at1"][p], r["slot_pruned1"])
        scores, s0, s1 = port_scores(out, p)
        assert torch.equal(s0, r["slots0"]) and torch.equal(s1, r["slots1"])
        assert (scores - r["scores"]).abs().max() <= ATOL
        assert torch.equal(out["matches0"][p], r["slot_matches0"])
        assert int((r["slot_matches0"] >= 0).sum()) >= 5
        stops.append(r["layers"])
    if case == "full_depth":
        assert stops == [LAYERS] * 3
    else:  # every pair leaves at its own layer, and every pair pruned
        assert len(set(stops)) == 3 and max(stops) < LAYERS
        assert all(int((out["pruned_at0"][p] >= 0).sum()) > 0 for p in range(3))


def test_empty_side_gives_no_match():
    w = upstream_weights()
    x = chunk()
    x["m1"][1] = False
    out = run_port(port_model(w, ADAPTIVE), x)
    assert bool((out["matches0"][1] == -1).all()) and bool((out["matches1"][1] == -1).all())
    assert out["layers"][1] == 0 and out["stopped_at"][1] == -1
    r = run_reference(w, ADAPTIVE, x, 1)
    assert r["layers"] == 0 and bool((r["matches0"] == -1).all())
    for p in (0, 2):  # the others are untouched by their neighbour
        assert torch.equal(out["matches0"][p], run_reference(w, ADAPTIVE, x, p)["slot_matches0"])


def test_from_torch_reads_upstream_layout():
    """An upstream state dict (Wqkv interleaved, the thresholds buffer)
    into the port gives the reference's result on that dict."""
    w = upstream_weights(seed=3, shaped=False)
    sd = {**w, "confidence_thresholds": torch.tensor([ref.confidence_threshold(i, LAYERS)
                                                      for i in range(LAYERS)])}
    tree = convert.lightglue_from_torch(sd, HEADS)
    assert "confidence_thresholds" not in tree and set(tree) == set(w)
    qkv = w["transformers.0.self_attn.Wqkv.weight"]
    port = torch.from_numpy(tree["transformers.0.self_attn.Wqkv.weight"])
    d = C // HEADS
    for s, h, j in ((0, 0, 0), (1, 1, 5), (2, 1, d - 1)):
        assert torch.equal(port[s * C + h * d + j], qkv[3 * (d * h + j) + s])
    x = chunk(seed=4)
    lg = port_model(w, FULL)
    out = run_port(lg, x)
    for p in range(3):
        r = run_reference(w, FULL, x, p)
        assert (port_scores(out, p)[0] - r["scores"]).abs().max() <= ATOL
        assert torch.equal(out["matches0"][p], r["slot_matches0"])


def test_k8_plain_version_matches_the_plain_route():
    """K8's plain version (attention_kernel True on the CPU) against the
    plain masked-softmax route inside LightGlue, on the adaptive chunk."""
    w, x = upstream_weights(), chunk()
    a = run_port(port_model(w, ADAPTIVE, True), x)
    b = run_port(port_model(w, ADAPTIVE, False), x)
    assert a["layers"] == b["layers"]
    assert torch.equal(a["matches0"], b["matches0"])
    for p in range(3):
        assert (port_scores(a, p)[0] - port_scores(b, p)[0]).abs().max() <= ATOL


def test_profiled_chunk_records_spans_and_counters():
    from torch.profiler import ProfilerActivity, profile

    w, x = upstream_weights(), chunk()
    lg = port_model(w, ADAPTIVE)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        out = run_port(lg, x)
    names = [e.name for e in prof.events()]
    st = lg.stats
    # The chunk runs as two interleaved groups, pairs {0, 1} and {2}; a
    # group runs the layers of its deepest pair. Every pair stops before
    # the last layer, so each layer a group runs ends with the stop test
    # and one host sync; two attention calls a layer (self on both images,
    # cross both ways); an assignment for each pair, as each leaves at its
    # own layer.
    runs = max(out["layers"][:2]) + out["layers"][2]
    assert names.count("lightglue.forward") == 1
    assert names.count("lightglue.layer") == names.count("lightglue.prune") == runs
    assert names.count("attention.softmax") == 2 * runs
    assert names.count("lightglue.assign") == 3
    assert st["syncs"] == runs
    assert st["layers"] == out["layers"] and st["stopped_early"] == 3
    assert st["left_early"] == 1  # pair 0 or 1, whichever leaves first; pair 2 is alone
    for p in range(3):  # each pair's points at each layer it ran
        assert sorted(i for i, r, _, _ in st["attention_points"] if r == p) == list(
            range(out["layers"][p]))
    assert st["valid"] == [(int(x["m0"][p].sum()), int(x["m1"][p].sum())) for p in range(3)]
    held = sum(a + b for _, _, a, b in st["attention_points"])
    full = sum(sum(st["valid"][r]) for _, r, _, _ in st["attention_points"])
    assert held < full  # pruning took points out of attention


@pytest.mark.parametrize("case", ["full_depth", "adaptive"])
def test_graph_cache_stays_bounded_and_its_pools_safe(case, monkeypatch):
    """The CUDA graphs, stood in for on the CPU: a capture records the
    function, and a replay first overwrites the outputs of every other
    graph of its pool (the most that a shared pool may do) before it runs
    the function eagerly into its own outputs. Over chunks of varied
    widths, a LightGlue holding at most 5 graphs keeps at most 5, captures
    again what it dropped, and gives what the eager path gives."""
    from onepose_tpu_torch.models import lightglue as mod

    conf = FULL if case == "full_depth" else ADAPTIVE
    w = upstream_weights()
    chunks = [chunk(seed=s, valid=v) for s, v in
              ((2, (120, 80, 40)), (5, (60, 110, 90)), (7, (100, 50, 120)), (2, (120, 80, 40)))]
    eager = [run_port(port_model(w, conf), x) for x in chunks]

    lg = port_model(w, conf, max_graphs=5)
    graphs = {}  # id(outputs) -> (pool, storages of its static inputs)

    def scribble(t):
        if t.is_floating_point():
            t.fill_(float("nan"))
        elif t.dtype == torch.bool:
            t.logical_not_()
        else:
            t.fill_(-(2 ** 40))

    def capture(fn, static, pool):
        out = fn(*static)
        graphs[id(out)] = (pool, {t.untyped_storage().data_ptr() for t in static})

        def replay():
            for _, _, other in lg.graphs.entries.values():
                theirs, inputs = graphs[id(other)]
                if other is not out and theirs is pool and pool is not None:
                    for t in other:
                        if t.untyped_storage().data_ptr() not in inputs:
                            scribble(t)
            for o, r in zip(out, fn(*static)):
                o.copy_(r)

        return replay, out

    monkeypatch.setattr(mod, "_graphs_on", lambda t: True)
    monkeypatch.setattr(mod, "_new_pool", object)
    monkeypatch.setattr(mod, "_capture", capture)
    for x, want in zip(chunks, eager):
        out = run_port(lg, x)
        assert len(lg.graphs) <= 5
        assert out["layers"] == want["layers"] and out["stopped_at"] == want["stopped_at"]
        for key in ("matches0", "matches1", "pruned_at0", "pruned_at1", "matching_scores0"):
            assert torch.equal(out[key], want[key]), key
        for p in range(3):
            assert all(torch.equal(a, b) for a, b in zip(port_scores(out, p), port_scores(want, p)))
    assert lg.graphs.captures > 2 * 5  # graphs dropped past the bound were captured again
    assert len({t for t, _ in graphs.values()}) == 3  # a pool a group, the prologue its own


def test_pair_matcher_runs_lightglue_in_chunks():
    w, x = upstream_weights(), chunk()
    lg = port_model(w, ADAPTIVE)
    feats = {"keypoints": torch.cat([x["kp0"], x["kp1"]]).numpy(),
             "descriptors": torch.cat([x["d0"], x["d1"]]).numpy(),
             "scores": np.ones((6, N), np.float32),
             "mask": torch.cat([x["m0"], x["m1"]]).numpy(), "image_hw": SIZE[::-1]}
    match = sfm_parallel.make_lightglue_pair_matcher(lg, feats, pair_chunk=2, device="cpu")
    assert match.chunk == 2
    rows = match(np.array([[0, 3], [1, 4], [2, 5]]))
    want = run_port(lg, x)["matches0"].numpy()
    np.testing.assert_array_equal(rows, want)
    assert sfm_parallel.lightglue_chunk(4096, 8) == 7
    assert sfm_parallel.lightglue_chunk(1024, 8) == 8


def test_confidence_threshold_schedule():
    from onepose_tpu_torch.models.lightglue import confidence_threshold

    assert confidence_threshold(0, 9) == pytest.approx(0.9)
    assert confidence_threshold(8, 9) == pytest.approx(0.8 + 0.1 * math.exp(-32 / 9))
    assert all(confidence_threshold(i, 9) == ref.confidence_threshold(i, 9) for i in range(9))


def test_map_command_with_lightglue(tmp_path, capsys, monkeypatch):
    """`map` with matcher=lightglue on the tiny CPU scan runs LightGlue
    through make_lightglue_pair_matcher and the chunked runner, reads an
    upstream weight file (weights.lightglue), and keys its match cache by
    the matcher and its conf. The file's LightGlue is a descriptor
    matcher: no FFN update, the final projection 1000 x the identity after
    its d^(1/4) (random SuperPoint descriptors lie close together), every point matchable and confident (one layer)."""
    import json

    from test_cli import build_sequence

    from onepose_tpu_torch.__main__ import main as port_main
    from onepose_tpu_torch.sfm import cache as sfm_cache

    g = torch.Generator().manual_seed(5)
    sd = {name: (torch.ones(shape) if bound is None
                 else (torch.rand(shape, generator=g) * 2 - 1) * bound)
          for name, shape, bound in ref.specs(256, 4, LAYERS)}
    for name in sd:
        if ".ffn.3." in name:
            sd[name] = torch.zeros_like(sd[name])
        elif name.endswith("final_proj.weight"):
            sd[name] = 4000.0 * torch.eye(256)
        elif name.endswith(("matchability.weight", "token.0.weight")):
            sd[name] = torch.zeros_like(sd[name])
        elif name.endswith(("matchability.bias", "token.0.bias")):
            sd[name] = torch.full_like(sd[name], 10.0)
    weights = tmp_path / "superpoint_lightglue.pth"
    torch.save(sd, weights)
    calls = []
    real = sfm_parallel.make_lightglue_pair_matcher

    def spy(lg, feats, **kw):
        calls.append(type(lg).__name__)
        return real(lg, feats, **kw)

    monkeypatch.setattr(sfm_parallel, "make_lightglue_pair_matcher", spy)
    seq = build_sequence(tmp_path, np.random.default_rng(3), n_frames=6, img=96, n_pts=40)
    out = tmp_path / "out"
    assert port_main(["map", f"data_dir={seq}", f"out_dir={out}", "max_keypoints=128",
                      "num_covis=3", "max_points3d=200", "device=cpu", "matcher=lightglue",
                      f"weights.lightglue={weights}", "lightglue.filter_threshold=0.0",
                      "pair_chunk=4"]) == 0
    stats = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert calls == ["LightGlue"]
    assert stats["num_pairs"] > 0 and stats["num_points3d"] > 0
    assert "pair_matching" in stats["stage_s"]
    fp = json.loads(sfm_cache.read_fingerprint(str(out / "matches.h5")))
    assert fp["matcher"] == "lightglue" and fp["conf"]["filter_threshold"] == 0.0
    assert fp["weights"] != "random-init"
