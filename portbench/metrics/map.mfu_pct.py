"""The mapping chunk's share of the card's bf16 peak: SuperGlue's GNN and
Sinkhorn operations a chunk (`counts.superglue_gnn`, `counts.sinkhorn`)
times the chunks of the traced window after the profiled ones, over that
window's host seconds, against 989 TFLOP/s."""

PEAK = 989e12


def read(t):
    if t.calls <= 0 or "call" not in t.work:
        return None
    w = t.work["call"]
    return 100.0 * (w.mm + w.elem) * t.calls / t.wall_s / PEAK
