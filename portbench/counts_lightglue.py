"""Operations of LightGlue's work that a chunk actually ran, counted from
the keypoints each pair held in attention at each layer it ran (the
program's counters, `LightGlue.stats`): the yardstick of the LightGlue
cell's roofline and share of peak. Full-width work that exit or pruning
cut is never counted.

As in `counts.py`: a linear layer 2 * cin * cout a point; an attention of
lq queries over lk keys, c = H * D channels, 4 * lq * lk * c (q k^T and
the weighted sum) and one exp a logit (H * lq * lk); the assignment's two
log-softmaxes one exp an entry each way. LayerNorm, GELU, the rotary
products, sigmoids and the compaction are left out, so a share can only
read low.

K8 (`csrc/flash_attention.cu`) computes every product in 3xTF32 (three
TF32 products for each fp32 one, PERF.md §6), so its least time is 3 x
its matrix operations at the tensor cores' 495 TFLOP/s TF32 rate.
"""

from __future__ import annotations

from portbench.counts import Work

TF32_FLOPS = 495e12  # H100 SXM, dense TF32 on the tensor cores


def attention(lq: float, lk: float, c: int, heads: int) -> Work:
    """One softmax attention of lq queries over lk keys."""
    return Work(4.0 * lq * lk * c, heads * lq * lk, 0.0)


def _linear(points: float, cin: int, cout: int) -> float:
    return 2.0 * points * cin * cout


def _ffn(points: float, c: int) -> float:
    return _linear(points, 2 * c, 2 * c) + _linear(points, 2 * c, c)


def layer(l0: float, l1: float, c: int, heads: int) -> Work:
    """A layer on one pair: the self block on each image, the cross block
    both ways."""
    mm = 0.0
    for n in (l0, l1):
        mm += _linear(n, c, 3 * c) + _linear(n, c, c) + _ffn(n, c)
        mm += _linear(n, c, c) * 3 + _ffn(n, c)  # cross: to_qk, to_v, to_out; its FFN
    w = Work(mm, 0.0, 0.0)
    for lq, lk in ((l0, l0), (l1, l1), (l0, l1), (l1, l0)):
        w = w + attention(lq, lk, c, heads)
    return w


def heads_after(l0: float, l1: float, c: int) -> Work:
    """The token confidence and the matchability after a layer."""
    return Work(2 * _linear(l0 + l1, c, 1), 0.0, 0.0)


def assignment(l0: float, l1: float, c: int) -> Work:
    """Final projection, S = f0 f1^T, matchability, both log-softmaxes."""
    return Work(_linear(l0 + l1, c, c) + 2.0 * l0 * l1 * c + _linear(l0 + l1, c, 1),
                2.0 * l0 * l1, 0.0)


def chunk(stats: dict, c: int, heads: int, n_layers: int) -> Work:
    """The work one chunk ran: every layer each pair ran at the points it
    held then (`stats["attention_points"]`: (layer, pair, l0, l1)), the
    heads after each layer but the last, and each pair's assignment at the
    points it ended with."""
    w, last = Work(0.0, 0.0, 0.0), {}
    for layer_i, row, l0, l1 in stats["attention_points"]:
        w = w + layer(l0, l1, c, heads)
        if layer_i < n_layers - 1:
            w = w + heads_after(l0, l1, c)
        if layer_i >= last.get(row, (-1,))[0]:
            last[row] = (layer_i, l0, l1)
    for _, l0, l1 in last.values():
        w = w + assignment(l0, l1, c)
    return w


def flash_seconds(stats: dict, c: int) -> float:
    """K8's least time for a chunk's attentions, at the kept points: 3 x
    the matrix operations at 495 TFLOP/s."""
    mm = sum(4.0 * c * (l0 * l0 + l1 * l1 + 2.0 * l0 * l1)
             for _, _, l0, l1 in stats["attention_points"])
    return 3.0 * mm / TF32_FLOPS


def layers_per_pair(stats: dict) -> float:
    """Mean layers a pair ran."""
    return sum(stats["layers"]) / max(len(stats["layers"]), 1)


def left_early_share(chunks: list) -> float:
    """Share of the pairs that ran a layer which left their group while
    others of it went on, over the chunks' counters."""
    ran = sum(sum(1 for n in st["layers"] if n > 0) for st in chunks)
    return sum(st["left_early"] for st in chunks) / max(ran, 1)


def layer_counts(chunks: list) -> dict:
    """{layers run: pairs} over the chunks' counters."""
    out = {}
    for st in chunks:
        for n in st["layers"]:
            out[n] = out.get(n, 0) + 1
    return dict(sorted(out.items()))


def kept_points(stats: dict) -> tuple:
    """(keypoints in attention, valid keypoints), summed over the layers
    each pair ran."""
    valid = stats["valid"]
    points = stats["attention_points"]
    return (sum(l0 + l1 for _, _, l0, l1 in points),
            sum(sum(valid[row]) for _, row, _, _ in points))
