"""Device ms a serving call spends in SuperPoint and keypoint extraction:
the median over the traced calls of the two CUDA-event spans summed."""

import statistics


def read(t):
    sp, ex = t.spans.get("superpoint"), t.spans.get("extract")
    if not sp or not ex or len(sp) != len(ex):
        return None
    return statistics.median(a + b for a, b in zip(sp, ex))
