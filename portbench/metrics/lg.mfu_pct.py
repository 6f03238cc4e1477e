"""The LightGlue chunk's share of the card's bf16 peak: the operations of
what each chunk ran (`counts_lightglue.chunk`: the layers each pair ran
at the points it held, the heads, the assignments; never the full-width
work that exit and pruning cut), a chunk on average over the traced
window's chunks after the profiled ones, times those chunks, over that
window's host seconds, against 989 TFLOP/s."""

PEAK = 989e12


def read(t):
    if t.calls <= 0 or "call" not in t.work:
        return None
    w = t.work["call"]
    return 100.0 * (w.mm + w.elem) * t.calls / t.wall_s / PEAK
