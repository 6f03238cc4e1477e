"""Host syncs a LightGlue chunk: the calls that make the host wait for the
card (`portbench.spans.SYNCS`) that the host profile records inside the
port's `lightglue.forward` spans, over the profiled chunks: one a layer
that ends with the stop test, in each of the chunk's interleaved groups
(the runner's copy of matches0 comes after the span)."""

from portbench import spans


def read(t):
    return spans.count_per_call(t, "lightglue.forward", spans.SYNCS)
