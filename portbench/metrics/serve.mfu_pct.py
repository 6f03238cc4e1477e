"""The serving call's share of the card's bf16 peak: the call's
operations counted from shapes (`counts.pose_pipeline`) times the calls
of the traced window after the profiled ones, over that window's host
seconds, against 989 TFLOP/s."""

PEAK = 989e12


def read(t):
    if t.calls <= 0 or "call" not in t.work:
        return None
    return 100.0 * t.work["call"].mm * t.calls / t.wall_s / PEAK
