"""LightGlue 2D-2D matcher, batched over a chunk of pairs, each pair with its
own depth and width.

LightGlue (Lindenberger, Sarlin, Pollefeys, ICCV 2023, arXiv 2306.13643;
cvg/LightGlue `lightglue/lightglue.py`, `LightGlue.default_conf` for
SuperPoint features: 256-d descriptors, 9 layers, 4 heads of 64,
depth_confidence 0.95, width_confidence 0.99, filter_threshold 0.1, and
1536 keypoints as the pruning floor of upstream's flash route). A layer
is a self block on each image (shared weights; rotary encoding of the
keypoints inside the attention) and a bidirectional cross block; after
each layer but the last a per-pair token-confidence test may stop the
pair (adaptive depth), and a matchability test prunes the keypoints of
an image above the floor (adaptive width); the last layer run gives the
double-log-softmax-plus-sigmoid assignment and the mutual filter. The
equations are in `tests/lightglue_reference.py`, which holds this module
to them pair by pair.

Parameters carry upstream's state-dict names (`models.convert.
lightglue_from_torch` reads upstream's files) with one change of layout:
`Wqkv`'s output channels are [q | k | v], each head-major (h * D + j),
where upstream interleaves them as 3 * (D * h + j) + s. The cross block
is already head-major upstream.

The chunk. Upstream decides exit and pruning for one pair at a time (b =
1, pruning through `torch.where`). Here a chunk of pairs runs together,
both images of a pair stacked on the batch axis (rows [:b] image 0, [b:]
image 1), so that one launch serves both:
- each image of each pair keeps its own set of points, held at the front
  of its row of the [2b, L, C] state in their original order (a stable
  argsort of the dropped flags compacts them after each pruning test; the
  keypoint slots they came from ride along), padded to the longest live
  image (rounded up to WIDTH_QUANTUM), with a key mask for the padding
  in every attention;
- the stop test and the pruning test run for every pair on the card,
  with upstream's counts (the pair's valid keypoints at the start, m +
  n, so pruned points count as confident); each pair's lengths and stop
  flag come to the host in one copy a layer, the layer's only host sync;
- a pair that stops (or whose pruning empties an image) leaves with the
  assignment of its own stop layer; the rest go on, cut to the longest
  that is left;
- the chunk's pairs run as GROUPS groups, interleaved: the host waits for
  one group's copy while the card computes the other's layer;
- on the card each step (a layer with its stop and pruning tests), each
  assignment and the prologue (position encoding, stacking) is a CUDA
  graph, one for each shape (`_graphed`), captured the first time the
  shape comes: a step's ~70 launches cost the host one. The graphs are
  bounded (`_Graphs`): at most `max_graphs` of them, the least recently
  used dropped past it, and a group's steps and assignments share one
  memory pool, so that their intermediates take the memory of the
  largest alone; a graph's outputs are read before the next replay in
  its pool.
Results are upstream's b = 1 results, pair by pair: matches0 [B, N0] and
matches1 over the chunk's keypoint slots, -1 for pruned and unmatched
points and for a pair with no valid keypoint on one side (such a pair
runs no layer upstream; here it rides through layer 0 and its outputs
are discarded).

Departures from upstream: fp32 throughout, where upstream's flash route
casts the attention's operands to fp16 (the port's `map` runs fp32 with
TF32 off, as for SuperGlue); every attention goes through
`models.common.masked_softmax_attention`, on K8 (`ops.kernels.
flash_attention`, 3xTF32, fp32-accurate) on the card by default
(`attention_kernel`, as in `models.common.softmax_attention_kernel`), its
plain route otherwise; the self attention of both images is one call,
and so is the cross attention both ways (q and k swapped by swapping the
halves of the keys: upstream's flash route makes two calls); keypoints
are given as the chunk's slots with a validity mask, not as the valid
points alone.

Spans (`utils.profiling.span`): `lightglue.forward` for the chunk, one
`lightglue.layer` a layer a group runs (off the card holding its two
`attention.softmax` and its `lightglue.prune`, the confidence, the stop
test, the pruning and the compaction; on the card the step's graph, in
which spans leave no range), `lightglue.assign` for each assignment and
filter. Counters of the last forward are in `LightGlue.stats`: the layers
each pair ran, the keypoints each pair had in attention at each layer it
ran against its valid keypoints, the pairs that stopped before the last
layer, the pairs that left while others of their group went on, the host
syncs inside `forward`, and the graphs held and captured so far.
"""

from __future__ import annotations

import math
from collections import OrderedDict
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from onepose_tpu_torch.models.common import masked_softmax_attention, softmax_attention_kernel
from onepose_tpu_torch.utils.profiling import span

# Masked logits of the assignment: finite, so a row or column with no valid
# entry stays finite, and far enough below any score that exp() is 0.
_MASKED = -1e30
# Groups a chunk's pairs run in, interleaved (see `LightGlue._forward`).
GROUPS = 2
# A chunk's width (its longest image's points) is rounded up to a multiple
# of this, so that few layer shapes recur and each has its CUDA graph.
WIDTH_QUANTUM = 64
# CUDA graphs a LightGlue holds at most (`_Graphs`).
MAX_GRAPHS = 256


def confidence_threshold(layer: int, n_layers: int) -> float:
    """tau_l = clip(0.8 + 0.1 exp(-4 l / L), 0, 1)."""
    return min(max(0.8 + 0.1 * math.exp(-4.0 * layer / n_layers), 0.0), 1.0)


def normalize_keypoints(kpts: torch.Tensor, size) -> torch.Tensor:
    """kpts [..., 2] (x, y) pixels, size (w, h): centred, over half the
    larger side. The sizes stay Python numbers: a tensor made from them on
    the card would cost a host sync."""
    w, h = (float(v) for v in size)
    scale = max(w, h) / 2
    return torch.stack([(kpts[..., 0] - w / 2) / scale, (kpts[..., 1] - h / 2) / scale], dim=-1)


def apply_rotary(cos: torch.Tensor, sin: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """t [B, n, H, D] rotated: t cos + rotate_half(t) sin, with cos and sin
    [B, n, 1, D] the same for every head. `sin` comes with rotate_half's
    signs (`rotary_tables`), so rotate_half is a swap of each channel
    pair: (t1, t2) -> (t2, t1)."""
    swapped = t.unflatten(-1, (-1, 2)).flip(-1).flatten(start_dim=-2)
    return t * cos + swapped * sin


def rotary_tables(enc: torch.Tensor) -> tuple:
    """(cos, sin) [B, n, 1, D] of `PositionEncoding`'s [B, n, 2, D], sin
    negated on the even channels (rotate_half's minus)."""
    sign = torch.ones(enc.shape[-1], device=enc.device)
    sign[0::2] = -1.0
    return enc[:, :, 0, None].contiguous(), (enc[:, :, 1, None] * sign).contiguous()


def cross_messages(qk: torch.Tensor, v: torch.Tensor, mask: torch.Tensor, b: int,
                   flash: bool) -> torch.Tensor:
    """The cross block's messages, rows [:b] image 0 and [b:] image 1 of b
    pairs: S = qk0 qk1^T / sqrt(D) softmaxed along its rows for image 0
    (over image 1's keys) and along its columns for image 1. Both are one
    attention call: q and k swapped by swapping the halves of the keys,
    the values and the key mask. [2b, n, H, D]."""
    def swap(t):
        return torch.roll(t, b, dims=0)

    return masked_softmax_attention(qk, swap(qk), swap(v), swap(mask), use_flash=flash)


def _ffn(c: int) -> nn.Sequential:
    return nn.Sequential(nn.Linear(2 * c, 2 * c), nn.LayerNorm(2 * c), nn.GELU(),
                         nn.Linear(2 * c, c))


class PositionEncoding(nn.Module):
    """Learned Fourier features: p = k Wr^T, (cos p, sin p) each channel twice."""

    def __init__(self, head_dim: int):
        super().__init__()
        self.Wr = nn.Linear(2, head_dim // 2, bias=False)

    def forward(self, kn: torch.Tensor) -> torch.Tensor:
        p = self.Wr(kn)
        return torch.stack([p.cos(), p.sin()], dim=-2).repeat_interleave(2, dim=-1)


class SelfBlock(nn.Module):
    def __init__(self, c: int, heads: int):
        super().__init__()
        self.heads = heads
        self.Wqkv = nn.Linear(c, 3 * c)
        self.out_proj = nn.Linear(c, c)
        self.ffn = _ffn(c)

    def forward(self, x, cos, sin, mask, flash: bool) -> torch.Tensor:
        bb, n, c = x.shape
        qkv = self.Wqkv(x).view(bb, n, 3, self.heads, c // self.heads)
        q, k = apply_rotary(cos, sin, qkv[:, :, 0]), apply_rotary(cos, sin, qkv[:, :, 1])
        ctx = masked_softmax_attention(q, k, qkv[:, :, 2].contiguous(), mask, use_flash=flash)
        msg = self.out_proj(ctx.reshape(bb, n, c))
        return x + self.ffn(torch.cat([x, msg], -1))


class CrossBlock(nn.Module):
    def __init__(self, c: int, heads: int):
        super().__init__()
        self.heads = heads
        self.to_qk = nn.Linear(c, c)
        self.to_v = nn.Linear(c, c)
        self.to_out = nn.Linear(c, c)
        self.ffn = _ffn(c)

    def forward(self, x, mask, b: int, flash: bool) -> torch.Tensor:
        bb, n, c = x.shape
        qk = self.to_qk(x).view(bb, n, self.heads, c // self.heads)
        v = self.to_v(x).view(bb, n, self.heads, c // self.heads)
        m = self.to_out(cross_messages(qk, v, mask, b, flash).reshape(bb, n, c))
        return x + self.ffn(torch.cat([x, m], -1))


class TransformerLayer(nn.Module):
    def __init__(self, c: int, heads: int):
        super().__init__()
        self.self_attn = SelfBlock(c, heads)
        self.cross_attn = CrossBlock(c, heads)

    def forward(self, x, cos, sin, mask, b: int, flash: bool) -> torch.Tensor:
        """x [2b, n, C]: rows [:b] image 0 of each pair, [b:] image 1."""
        return self.cross_attn(self.self_attn(x, cos, sin, mask, flash), mask, b, flash)


class MatchAssignment(nn.Module):
    def __init__(self, c: int):
        super().__init__()
        self.matchability = nn.Linear(c, 1)
        self.final_proj = nn.Linear(c, c)


class TokenConfidence(nn.Module):
    def __init__(self, c: int):
        super().__init__()
        self.token = nn.Sequential(nn.Linear(c, 1), nn.Sigmoid())


def _graphs_on(t: torch.Tensor) -> bool:
    """Whether a function of t runs as a CUDA graph: on the card."""
    return t.device.type == "cuda"


def _new_pool():
    return torch.cuda.graph_pool_handle()


def _capture(fn, static: list, pool) -> tuple:
    """(replay, outputs) of fn(*static) captured as a CUDA graph whose
    memory comes from `pool` (None: a pool of its own), after a first run
    that builds cuBLAS's and K8's state."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn(*static)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, pool=pool):
        out = fn(*static)
    return graph.replay, out


class _Graphs:
    """A LightGlue's CUDA graphs by key, at most `limit`: a capture past it
    drops the least recently replayed graph. Graphs given the same `pool`
    name share one memory pool, so a replay may overwrite the outputs of
    any other graph of that pool: read a graph's outputs before the next
    replay in its pool. `captures` counts the captures so far."""

    def __init__(self, limit: int):
        self.limit, self.entries, self.pools, self.captures = limit, OrderedDict(), {}, 0

    def __len__(self) -> int:
        return len(self.entries)

    def run(self, key: tuple, fn, inputs: tuple, pool=None, name: Optional[str] = None) -> tuple:
        entry = self.entries.get(key)
        if entry is None:
            if pool is not None and pool not in self.pools:
                self.pools[pool] = _new_pool()
            static = [t.clone() for t in inputs]
            replay, out = _capture(fn, static, self.pools.get(pool))
            entry = self.entries[key] = (static, replay, out)
            self.captures += 1
            while len(self.entries) > self.limit:
                self.entries.popitem(last=False)
        else:
            self.entries.move_to_end(key)
        static, replay, out = entry
        for dst, src in zip(static, inputs):
            dst.copy_(src)
        if name is None:
            replay()
        else:
            with span(name):
                replay()
        return out


class _State:
    """Live pairs, both images stacked (rows [:b] image 0 of each pair,
    [b:] image 1): x [2b, L, C], the rotary tables cos and sin [2b, L, 1,
    D], each row's keypoint slot (ind [2b, L]) and the valid rows (mask),
    held at the front of each row after the first pruning step."""

    def __init__(self, x, cos, sin, ind, mask):
        self.x, self.cos, self.sin, self.ind, self.mask = x, cos, sin, ind, mask

    def select(self, pairs, lengths: torch.Tensor, width: int) -> "_State":
        """The pairs `pairs` (a [g] index into the b pairs, or None for all)
        of a compacted state, `lengths` [2b] valid rows each, cut to
        `width` rows (rounded up to WIDTH_QUANTUM)."""
        width = min(self.x.shape[1], -(-width // WIDTH_QUANTUM) * WIDTH_QUANTUM)
        x, cos, sin, ind = (t[:, :width] for t in (self.x, self.cos, self.sin, self.ind))
        if pairs is not None:
            rows = torch.cat([pairs, pairs + self.x.shape[0] // 2])
            x, cos, sin, ind, lengths = (t.index_select(0, rows)
                                         for t in (x, cos, sin, ind, lengths))
        mask = torch.arange(width, device=lengths.device)[None, :] < lengths[:, None]
        return _State(x, cos, sin, ind, mask)


class LightGlue(nn.Module):
    def __init__(
        self,
        descriptor_dim: int = 256,
        num_heads: int = 4,
        n_layers: int = 9,
        depth_confidence: float = 0.95,
        width_confidence: float = 0.99,
        filter_threshold: float = 0.1,
        pruning_min_keypoints: int = 1536,
        attention_kernel: Optional[bool] = None,
        max_graphs: int = MAX_GRAPHS,
    ):
        super().__init__()
        if n_layers < 2:
            raise ValueError(f"LightGlue needs at least 2 layers, got {n_layers}")
        c = descriptor_dim
        self.n_layers = n_layers
        self.depth_confidence = depth_confidence
        self.width_confidence = width_confidence
        self.filter_threshold = filter_threshold
        self.pruning_min_keypoints = pruning_min_keypoints
        self.attention_kernel = attention_kernel
        self.posenc = PositionEncoding(c // num_heads)
        self.transformers = nn.ModuleList(TransformerLayer(c, num_heads) for _ in range(n_layers))
        self.log_assignment = nn.ModuleList(MatchAssignment(c) for _ in range(n_layers))
        self.token_confidence = nn.ModuleList(TokenConfidence(c) for _ in range(n_layers - 1))
        self.stats: dict = {}
        self.max_graphs = max_graphs
        self.graphs = _Graphs(max_graphs)  # see `_graphed`

    def _apply(self, fn, *args, **kwargs):
        self.graphs = _Graphs(self.max_graphs)  # graphs hold the parameters' old storage
        return super()._apply(fn, *args, **kwargs)

    def _step(self, i: int, x, cos, sin, ind, mask, total, b: int, flash: bool) -> tuple:
        """Layer i on b pairs' state and, before the last layer, the stop
        test and the pruning, the kept points compacted to the front of
        each row: a function of tensors alone, so that a CUDA graph can
        hold it. Returns (x, cos, sin, ind, mask, dropped, info, order):
        dropped [2b, L] the slot of each point pruned here (-1 elsewhere),
        info [6, b] each pair's (leaves, stopped, kept0, kept1, live0,
        live1), order [b] the staying pairs first; after the last layer
        (x, ind)."""
        with span("lightglue.layer"):
            x = self.transformers[i](x, cos, sin, mask, b, flash)
        if i == self.n_layers - 1:
            return x, ind
        with span("lightglue.prune"):
            tau = confidence_threshold(i, self.n_layers)
            live = mask.sum(1)
            conf = None
            stop = torch.zeros_like(total, dtype=torch.bool)
            if self.depth_confidence > 0:
                conf = self.token_confidence[i].token(x)[..., 0]
                unconf = ((conf < tau) & mask).float().sum(1)
                stop = (1.0 - (unconf[:b] + unconf[b:]) / total) > self.depth_confidence
            keep = mask
            if self.width_confidence > 0:
                # A pair that stops, or that has an empty image (it runs no
                # layer upstream), keeps every point.
                hold = stop | (live.view(2, b) == 0).any(0)
                scores = torch.sigmoid(self.log_assignment[i].matchability(x)[..., 0])
                rule = scores > 1 - self.width_confidence
                if conf is not None:
                    rule = rule | (conf <= tau)
                allow = (live > self.pruning_min_keypoints) & ~hold.repeat(2)
                keep = keep & (rule | ~allow[:, None])
            dropped = torch.where(mask & ~keep, ind, -1)
            rows = torch.argsort((~keep).to(torch.uint8), dim=1, stable=True)
            x = x.gather(1, rows[..., None].expand_as(x))
            cos = cos.gather(1, rows[..., None, None].expand_as(cos))
            sin = sin.gather(1, rows[..., None, None].expand_as(sin))
            ind = ind.gather(1, rows)
            kept = keep.sum(1)
            mask = torch.arange(x.shape[1], device=x.device)[None, :] < kept[:, None]
            leave = stop | (kept.view(2, b) == 0).any(0)
            order = torch.argsort(leave.to(torch.uint8), stable=True)
            info = torch.stack([leave.long(), stop.long(), kept[:b], kept[b:], live[:b],
                                live[b:]])
        return x, cos, sin, ind, mask, dropped, info, order

    def _graphed(self, key: tuple, fn, inputs: tuple, name: Optional[str] = None,
                 pool=None) -> tuple:
        """fn(*inputs), tensors in and a tuple of tensors out: eager off the
        card; on the card a CUDA graph for each `key` (the shapes and
        settings fn's launches depend on) in `self.graphs`, captured the
        first time the key comes and replayed after, its launches as one (a
        span `name` around the replay), its memory from the pool named
        `pool` (see `_Graphs`). The outputs are the graph's own buffers."""
        if not _graphs_on(inputs[0]):
            return fn(*inputs)
        return self.graphs.run(key, fn, inputs, pool, name)

    def step(self, i: int, st: "_State", total, b: int, flash: bool, group: int = 0) -> tuple:
        """`_step` on `st`, graphed on the card (`_graphed`) for each
        (group, layer, pairs, width), in the group's pool."""
        key = ("step", group, i, b, st.x.shape[1], self.depth_confidence, self.width_confidence)
        return self._graphed(key, lambda *t: self._step(i, *t, b, flash),
                             (st.x, st.cos, st.sin, st.ind, st.mask, total), "lightglue.layer",
                             ("group", group))

    def _assign(self, layer: int, x, ind, mask, n: int) -> tuple:
        """The log assignment of layer `layer`'s head over g pairs' kept
        points and the mutual filter: (scores [g, L + 1, L + 1], the
        dustbins last; the pairs' matches over their keypoint slots [2g, n
        + 1], image 0's rows then image 1's, -1 unmatched; image 0's match
        scores [g, n + 1]; the kept counts of image 0 and 1), the last
        column of the slot rows taking the padding's writes."""
        with span("lightglue.assign"):
            la = self.log_assignment[layer]
            g, w = x.shape[0] // 2, x.shape[1]
            f = la.final_proj(x) / x.shape[-1] ** 0.25
            z = la.matchability(x)
            mask0, mask1 = mask[:g], mask[g:]
            sim = torch.bmm(f[:g], f[g:].transpose(1, 2))
            sim = sim.masked_fill_(~(mask0[:, :, None] & mask1[:, None, :]), _MASKED)
            scores = sim.new_zeros((g, w + 1, w + 1))
            inner = scores[:, :w, :w]
            inner.copy_(F.log_softmax(sim, 2))
            cols = sim.transpose(1, 2).contiguous()  # a softmax along rows is the fast one
            del sim
            inner.add_(F.log_softmax(cols, 2).transpose(1, 2))
            del cols
            ls, lsn = F.logsigmoid(z), F.logsigmoid(-z[..., 0])
            inner.add_(ls[:g]).add_(ls[g:].transpose(1, 2))
            scores[:, :w, w] = lsn[:g]
            scores[:, w, :w] = lsn[g:]
            max0, max1 = inner.max(2), inner.max(1)
            m0, m1 = max0.indices, max1.indices
            mutual0 = torch.arange(w, device=x.device)[None] == m1.gather(1, m0)
            mutual1 = torch.arange(w, device=x.device)[None] == m0.gather(1, m1)
            ms0 = torch.where(mutual0, max0.values.exp(), 0.0)
            both = mask0.any(1, keepdim=True) & mask1.any(1, keepdim=True)
            valid0 = mutual0 & (ms0 > self.filter_threshold) & mask0 & both
            valid1 = mutual1 & valid0.gather(1, m1) & mask1
            partner = torch.cat([ind[g:].gather(1, m0), ind[:g].gather(1, m1)])
            match = torch.where(torch.cat([valid0, valid1]), partner, -1)
            slots = torch.where(mask, ind, n)
            rows = torch.full((2 * g, n + 1), -1, dtype=torch.long, device=x.device)
            score_rows = torch.zeros((g, n + 1), device=x.device)
            return (scores, rows.scatter_(1, slots, match),
                    score_rows.scatter_(1, slots[:g], torch.where(mask0, ms0, 0.0)),
                    mask0.sum(1), mask1.sum(1))

    def forward(self, kpts0, kpts1, desc0, desc1, mask0, mask1, size0, size1) -> dict:
        """kpts* [B, N*, 2] (x, y) pixels; desc* [B, N*, C]; mask* [B, N*]
        valid slots; size* (w, h). Returns matches0 [B, N0] and matches1
        [B, N1] (int64 slot indices, -1 unmatched or pruned),
        matching_scores0 [B, N0], and what each pair ran: "layers" (a list,
        0 for a pair with an empty image), "stopped_at" (the layer after
        which it stopped, -1 if it ran every layer), "pruned_at0" /
        "pruned_at1" [B, N*] (the layer after which each slot was dropped,
        -1 if it was kept or never valid) and "assignments": for each group
        of pairs that left together, {"rows", "scores", "ind0", "ind1",
        "len0", "len1"} (chunk rows, the [g, L + 1, L + 1] log assignment
        over the kept points, their slots, their counts)."""
        with span("lightglue.forward"):
            return self._forward(kpts0, kpts1, desc0, desc1, mask0, mask1, size0, size1)

    def _forward(self, kpts0, kpts1, desc0, desc1, mask0, mask1, size0, size1) -> dict:
        dev = desc0.device
        b_all, n0 = mask0.shape
        n1 = mask1.shape[1]
        n = max(n0, n1)
        # The chunk's pairs run as GROUPS interleaved groups: while the card
        # computes one group's layer, the host waits for the other's
        # lengths and stop flags, so the card does not idle at the syncs.
        size = -(-b_all // min(GROUPS, b_all))
        bounds = [(lo, min(lo + size, b_all)) for lo in range(0, b_all, size)]

        def prologue(kpts0, kpts1, desc0, desc1, mask0, mask1):
            """(each pair's valid keypoints, m + n; then each group's state:
            x, cos, sin, ind, mask)."""
            def stacked(t0, t1):  # both images on the batch axis, slots padded to n
                t0, t1 = (F.pad(t, [0, 0] * (t.dim() - 2) + [0, n - t.shape[1]])
                          if t.shape[1] < n else t for t in (t0, t1))
                return torch.cat([t0, t1])

            enc = self.posenc(stacked(normalize_keypoints(kpts0.float(), size0),
                                      normalize_keypoints(kpts1.float(), size1)))
            full = (stacked(desc0.float(), desc1.float()), *rotary_tables(enc),
                    torch.arange(n, device=dev).expand(2 * b_all, n), stacked(mask0, mask1))
            out = [(mask0.sum(1) + mask1.sum(1)).float()]
            for lo, hi in bounds:
                pairs = torch.arange(lo, hi, device=dev)
                rows = torch.cat([pairs, pairs + b_all])
                out += [t.index_select(0, rows) for t in full]
            return tuple(out)

        key = ("prologue", b_all, n0, n1, tuple(size0), tuple(size1), size)
        out = self._graphed(key, prologue, (kpts0, kpts1, desc0, desc1, mask0, mask1))
        run = _Run(self, dev, b_all, n, out[0])
        gens = [run.group(g, list(range(lo, hi)), _State(*out[1 + 5 * g:6 + 5 * g]))
                for g, (lo, hi) in enumerate(bounds)]
        while gens:
            for gen in list(gens):
                if next(gen, StopIteration) is StopIteration:
                    gens.remove(gen)
        self.stats = run.stats()
        return run.outputs(n0, n1)


class _Run:
    """One forward's outputs and counters, and each group's loop."""

    def __init__(self, lg: LightGlue, dev, b_all: int, n: int, total: torch.Tensor):
        self.lg, self.dev, self.b_all, self.n, self.total = lg, dev, b_all, n, total
        self.flash = softmax_attention_kernel(lg.attention_kernel, dev)
        # Outputs and the pruning record, a row a side and chunk pair, a
        # last column that takes the writes of padding rows.
        self.pruned = torch.full((2 * b_all, n + 1), -1, dtype=torch.long, device=dev)
        self.matches = torch.full((2 * b_all, n + 1), -1, dtype=torch.long, device=dev)
        self.score0 = torch.zeros((b_all, n + 1), device=dev)
        self.valid = [None] * b_all
        self.layers, self.stopped_at, self.groups = [0] * b_all, [-1] * b_all, []
        self.points, self.syncs, self.left_early = [], 0, 0

    def finish(self, gid: int, layer: int, rows: list, rows_dev, st: _State) -> None:
        """Outputs of the pairs `rows` (chunk rows, `rows_dev` on the card)
        of group `gid` that leave after `layer` with their state `st`."""
        g, n, b_all = len(rows), self.n, self.b_all
        if st.x.shape[1] == 0:
            return
        key = ("assign", gid, layer, g, st.x.shape[1], n, self.lg.filter_threshold)
        scores, match_rows, score_rows, len0, len1 = self.lg._graphed(
            key, lambda *t: self.lg._assign(layer, *t, n), (st.x, st.ind, st.mask),
            "lightglue.assign", ("group", gid))
        self.matches.index_copy_(0, torch.cat([rows_dev, rows_dev + b_all]), match_rows)
        self.score0.index_copy_(0, rows_dev, score_rows)
        # Copies: a graph's buffers are written again by its next replay.
        self.groups.append({"rows": list(rows), "scores": scores.clone(),
                            "ind0": st.ind[:g].clone(), "ind1": st.ind[g:].clone(),
                            "len0": len0.clone(), "len1": len1.clone()})

    def _fetch(self, t: torch.Tensor):
        """Start t's copy to the host; returns a function that waits for it
        (a host sync) and gives it as lists."""
        if self.dev.type != "cuda":
            return t.tolist
        host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
        host.copy_(t, non_blocking=True)
        done = torch.cuda.Event()
        done.record()

        def wait():
            done.synchronize()
            return host.tolist()

        return wait

    def group(self, gid: int, rows: list, st: _State):
        """A generator: the layers of the chunk's pairs `rows` (consecutive)
        from their state `st`, each pair until it leaves; it yields once a
        layer, when the layer's lengths and stop flags are on their way to
        the host."""
        lg, n_layers, n, b_all = self.lg, self.lg.n_layers, self.n, self.b_all
        rows_dev = torch.arange(rows[0], rows[-1] + 1, device=self.dev)
        total = self.total[rows[0]:rows[-1] + 1]
        lengths = None  # host: each live pair's kept points a side, once known
        last = 0
        for i in range(n_layers):
            last = i
            b = len(rows)
            out = lg.step(i, st, total, b, self.flash, gid)
            if lengths is not None:
                self.points += [(i, rows[p], *lengths[p]) for p in range(b)]
                for r in rows:
                    self.layers[r] = i + 1
            if i == n_layers - 1:
                st.x, st.ind = out  # ind: the previous step's, which this replay may overwrite
                break
            x, cos, sin, ind, mask, dropped, info, order = out
            both = torch.cat([rows_dev, rows_dev + b_all])
            slots = torch.where(dropped >= 0, dropped, n)
            self.pruned.index_put_((both[:, None].expand_as(slots), slots),
                                   torch.full_like(slots, i))
            st = _State(x, cos, sin, ind, mask)
            kept = torch.cat([info[2], info[3]])
            wait = self._fetch(info)
            yield
            leave_h, stop_h, k0, k1, l0, l1 = wait()
            self.syncs += 1
            if lengths is None:  # layer 0's counts are each pair's valid keypoints
                self.points += [(i, r, l0[p], l1[p]) for p, r in enumerate(rows)
                                if min(l0[p], l1[p]) > 0]
                for p, r in enumerate(rows):
                    self.valid[r] = (l0[p], l1[p])
                    self.layers[r] = 0 if min(l0[p], l1[p]) == 0 else 1
            stay = [p for p in range(b) if not leave_h[p]]
            go = [p for p in range(b) if leave_h[p]]
            if not go:
                st = st.select(None, kept, max(max(k0[p], k1[p]) for p in stay))
                lengths = [(k0[p], k1[p]) for p in stay]
                continue
            # Both selections are taken before the leaving pairs' assignment
            # replays in the group's pool, which may overwrite this step's
            # outputs (`_Graphs`).
            go_dev, stay_dev = order[len(stay):], order[:len(stay)]
            go_rows = [rows[p] for p in go]
            leaving = (rows_dev.index_select(0, go_dev),
                       st.select(go_dev, kept, max(max(k0[p], k1[p]) for p in go)))
            for p in go:
                if stop_h[p] and self.layers[rows[p]] > 0:
                    self.stopped_at[rows[p]] = i
            if stay:
                self.left_early += sum(1 for r in go_rows if self.layers[r] > 0)
                st = st.select(stay_dev, kept, max(max(k0[p], k1[p]) for p in stay))
                total = total.index_select(0, stay_dev)
                rows_dev = rows_dev.index_select(0, stay_dev)
                rows = [rows[p] for p in stay]
                lengths = [(k0[p], k1[p]) for p in stay]
            self.finish(gid, i, go_rows, *leaving)
            if not stay:
                return
        self.finish(gid, last, rows, rows_dev, st)

    def stats(self) -> dict:
        graphs = self.lg.graphs
        return {"attention_points": list(self.points), "syncs": self.syncs,
                "layers": list(self.layers), "valid": list(self.valid),
                "stopped_early": sum(1 for s in self.stopped_at if s >= 0),
                "left_early": self.left_early, "graphs": len(graphs),
                "graph_captures": graphs.captures}

    def outputs(self, n0: int, n1: int) -> dict:
        b = self.b_all
        return {"matches0": self.matches[:b, :n0], "matches1": self.matches[b:, :n1],
                "matching_scores0": self.score0[:, :n0], "layers": list(self.layers),
                "stopped_at": list(self.stopped_at), "pruned_at0": self.pruned[:b, :n0],
                "pruned_at1": self.pruned[b:, :n1], "assignments": self.groups}
