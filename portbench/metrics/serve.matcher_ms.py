"""Device ms a serving call spends in the GATsSPG matcher (its forward,
CUDA events): the median over the traced calls."""

import statistics


def read(t):
    v = t.spans.get("matcher")
    return statistics.median(v) if v else None
