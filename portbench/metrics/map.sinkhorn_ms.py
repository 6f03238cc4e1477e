"""Device ms a chunk of pairs spends in `log_sinkhorn` (CUDA events): the
median over the traced chunks."""

import statistics


def read(t):
    v = t.spans.get("sinkhorn")
    return statistics.median(v) if v else None
