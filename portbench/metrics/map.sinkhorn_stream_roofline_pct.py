"""K7's share of its roofline: the least time of a chunk's Sinkhorn
iterations at the valid keypoints (`counts.sinkhorn`: elementwise
operations at the fp32 peak) over the device time of
`csrc/sinkhorn_stream.cu`'s kernels in the profiled chunks."""

import re

KERNEL = re.compile(r"^(void\s+)?(\(anonymous namespace\)::)?sinkhorn_stream(_cluster|_wide)?\b")


def read(t):
    s = t.kernel_seconds(KERNEL)
    if s is None or "sinkhorn_stream" not in t.work:
        return None
    return 100.0 * t.work["sinkhorn_stream"].seconds() * t.profiled_calls / s
