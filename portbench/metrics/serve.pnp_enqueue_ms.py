"""Host ms a serving call spends enqueueing RANSAC-PnP: the host ms of the
port's `pose.pnp` spans less the sync records inside them
(`portbench.spans.SYNCS`), over the profiled calls. What is left is the
launch work that a CUDA graph or a fused PnP would cut."""

from portbench import spans


def read(t):
    ranges = spans.host_ranges(t, "pose.pnp")
    if not ranges:
        return None
    host = sum(e - s for s, e in ranges) / 1e3 / t.profiled_calls
    return host - spans.ms_per_call(t, "pose.pnp", spans.SYNCS)
