"""LightGlue mapping cells: the port's LightGlue over a scan's covisible
pairs, in the chunks the port's pair matcher runs.

Set-up asks the port's chunking (`lightglue_chunk`) how many pairs a chunk
holds at the configuration's keypoints and pair budget, makes the scan on
the card from the seed (`scenes.scan`, the frames' features from the
reference SuperPoint) and the weights (`judges.lightglue_pairs.
weights_for`, in upstream's layout, read into the port through its
converter, `models.convert.lightglue_from_torch`), builds LightGlue as the
configuration states it, and warms up on every chunk once (each width a
layer meets, and its CUDA graph in the port). The window calls
`LightGlue.forward` on the chunks in order, cycling through the pair
list, indexing the features as `make_lightglue_pair_matcher` does, and
brings each chunk's matches0 to the host; it ends with the first chunk to
end after `seconds`. The rate counts the real pairs over the whole
window. `forward` is timed, not `match_pairs`, because it returns the
decisions and the log assignment the judge compares.

With trace, the window is `harness.traced_window`'s; the per-layer
readers take the port's spans (`lightglue.*`, `attention.softmax`) from
the trace and the program's counters of each chunk (`LightGlue.stats`)
from `work()`: K8's least time and the work of the chunks profiled on the
card alone (the n before the last n chunks run under a profiler), the
work, the layers a pair and the share of keypoints kept in attention over
the chunks of the window after the profiled ones.

Besides the judge's, the stats line gives the port's graphs after the run,
those captured inside the window (0 where the warm-up met every shape),
the card's reserved memory, and over the window's chunks the pairs by
layers run and the share that left before their group.

`CONTROLS` and `FAULTS` are for `calibrate.py` and the tests alone: the
control takes the program's place in the judged outputs, and a fault
breaks the timed path underneath while the window runs.
"""

from __future__ import annotations

import contextlib
import itertools
import random
import time

import torch

from portbench import counts_lightglue as counts
from portbench import harness, scenes, weights
from portbench.judges import lightglue_pairs as judge
from portbench.reference import nets

# The control: the reference with TF32 products, the next precision below fp32.
CONTROLS = {"tf32": nets.tf32_round}


@contextlib.contextmanager
def _patched(module, name: str, value):
    old = getattr(module, name)
    setattr(module, name, value)
    try:
        yield
    finally:
        setattr(module, name, old)


def _rotary_dropped(lg):
    """Self-attention without the rotary encoding."""
    from onepose_tpu_torch.models import lightglue as mod

    return _patched(mod, "apply_rotary", lambda cos, sin, t: t)


def _cross_one_way(lg):
    """Image 1's cross message from the row softmax of S (transposed), not
    from its column softmax."""
    from onepose_tpu_torch.models import lightglue as mod

    def one_way(qk, v, mask, b, flash):
        s = torch.einsum("bnhd,bmhd->bhnm", qk[:b], qk[b:]) / qk.shape[-1] ** 0.5
        a = torch.softmax(s.masked_fill(~mask[b:, None, None, :], -1e30), dim=-1)
        a = a * mask[:b, None, :, None]
        return torch.cat([torch.einsum("bhnm,bmhd->bnhd", a, v[b:]),
                          torch.einsum("bhnm,bnhd->bmhd", a, v[:b])])

    return _patched(mod, "cross_messages", one_way)


def _pruning_off(lg):
    return _patched(lg, "width_confidence", 0.0)


def _exit_off(lg):
    """No pair stops: the stop test's share can never pass 1."""
    return _patched(lg, "depth_confidence", 1.0)


FAULTS = {"rotary_dropped": _rotary_dropped, "cross_one_way": _cross_one_way,
          "pruning_off": _pruning_off, "exit_off": _exit_off}


def _chunk(cfg: dict) -> int:
    """Pairs a chunk, as the port's pair matcher cuts them."""
    from onepose_tpu_torch.parallel.sfm_parallel import lightglue_chunk

    return lightglue_chunk(cfg["max_keypoints"], cfg["pair_chunk_asked"])


def _program(cfg: dict, w: dict, device):
    from onepose_tpu_torch.models import convert
    from onepose_tpu_torch.models.lightglue import LightGlue

    lg = LightGlue(descriptor_dim=cfg["descriptor_dim"], num_heads=cfg["num_heads"],
                   n_layers=cfg["n_layers"], depth_confidence=cfg["depth_confidence"],
                   width_confidence=cfg["width_confidence"],
                   filter_threshold=cfg["filter_threshold"],
                   pruning_min_keypoints=cfg["pruning_min_keypoints"])
    sd = convert.lightglue_from_torch(w, cfg["num_heads"])
    lg.load_state_dict({k: torch.from_numpy(v) for k, v in sd.items()})
    return lg.to(device).eval()


def _work(cfg: dict, log: list, n: int) -> dict:
    """Counts from the chunks' counters `log` ((profiled, stats) a chunk,
    in order): K8's least time and the work a chunk of the n chunks traced
    on the card alone; the work, layers a pair, kept share and share of
    pairs that left before their group, of the window after the profiled
    chunks."""
    c, heads, layers = cfg["descriptor_dim"], cfg["num_heads"], cfg["n_layers"]
    profiled = [i for i, (on, _) in enumerate(log) if on]
    card = [log[i][1] for i in profiled[-2 * n:-n]] if len(profiled) >= 2 * n else []
    window = [st for _, st in log[profiled[-1] + 1:]] if profiled else []
    out = {}
    if card:
        out["flash"] = sum(counts.flash_seconds(st, c) for st in card) / len(card)
    if window:
        total = counts.Work(0.0, 0.0, 0.0)
        for st in window:
            total = total + counts.chunk(st, c, heads, layers)
        out["call"] = total.scaled(1.0 / len(window))
        out["layers_per_pair"] = (sum(counts.layers_per_pair(st) for st in window)
                                  / len(window))
        out["left_early_pct"] = 100.0 * counts.left_early_share(window)
        held = sum(counts.kept_points(st)[0] for st in window)
        valid = sum(counts.kept_points(st)[1] for st in window)
        out["kept_points_pct"] = 100.0 * held / max(valid, 1)
    return out


def run(cell: harness.Cell, device, t0: float, control=None, fault=None) -> dict:
    cfg, tr = cell.cfg, cell.traffic
    chunk = _chunk(cfg)
    with harness.matmul_precision(torch, False):
        sp = weights.superpoint(cfg, scenes.sub_seed(cell.seed, "superpoint"), device)
        scan = scenes.scan(sp, cfg, tr, cell.seed, device, chunk)
        w = judge.weights_for(cfg, cell.seed, device, scan)
    del sp
    lg = _program(cfg, w, device)
    broken = contextlib.ExitStack()
    if fault is not None:
        broken.enter_context(fault(lg))
    f, hw, chunks = scan["feats"], scan["image_hw"], scan["chunks"]
    k, d, m = (f[x] for x in ("keypoints", "descriptors", "mask"))
    size = (hw[1], hw[0])

    count, pairs, log = itertools.count(), [0], []

    def step():
        j = next(count) % len(chunks)
        ii, jj, real = chunks[j]
        with torch.inference_mode():
            out = lg(k[ii], k[jj], d[ii], d[jj], m[ii], m[jj], size, size)
        out["matches0"].cpu()
        pairs[0] += real
        log.append((torch.autograd._profiler_enabled(), lg.stats))
        reservoir.offer((j, out))

    reservoir = harness.Reservoir(0, random.Random(0))  # keeps no warm-up output
    for _ in range(len(chunks)):  # every chunk's widths, and their CUDA graphs
        step()
    harness.sync(torch, device)
    reservoir = harness.Reservoir(tr["sample_calls"], random.Random(scenes.sub_seed(cell.seed,
                                                                                    "sample")))
    pairs[0] = 0
    log.clear()
    captured = lg.graphs.captures
    setup_s = time.perf_counter() - t0
    result = {}
    if not cell.trace:
        _, window = harness.closed_loop(step, cell.seconds)
        result["metrics"] = {"map_pairs_per_s": (pairs[0] / window, "pairs/s"),
                             "setup_s": (setup_s, "s")}
    else:
        n = tr["profile_calls"]
        result["trace"], result["breakdown"], _ = harness.traced_window(
            torch, step, n, cell.seconds, harness.Spans(torch), (),
            lambda: _work(cfg, log, n))
    broken.close()
    result["attempted"] = pairs[0]
    result["failed"] = 0
    result["memory_peak"] = harness.peak_memory(torch, device)
    chunk_stats = [st for _, st in log]
    graph_stats = {"graphs": len(lg.graphs), "window_captures": lg.graphs.captures - captured,
                   "memory_reserved": (torch.cuda.memory_reserved(device)
                                       if device.type == "cuda" else 0),
                   "window_layers": counts.layer_counts(chunk_stats),
                   "window_left_early_pct": 100.0 * counts.left_early_share(chunk_stats)}

    items = reservoir.items
    del lg
    if device.type == "cuda":
        torch.cuda.empty_cache()
    with harness.matmul_precision(torch, False):
        if control is not None:
            items = [(ci, judge.control_outputs(cfg, w, f, hw, chunks[ci], control))
                     for ci, _ in items]
        read, stats = judge.judge(cfg, scan, items, w)
    result["readings"] = read
    result["stats"] = {**stats, "pair_chunk": chunk, "pairs_in_scan": len(scan["pairs"]),
                       "keypoints_mean": float(m.float().sum(-1).mean()), **graph_stats}
    return result
