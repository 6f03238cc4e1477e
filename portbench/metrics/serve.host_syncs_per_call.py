"""Host syncs a serving call: the calls that make the host wait for the
card (`portbench.spans.SYNCS`: cudaStreamSynchronize,
cudaDeviceSynchronize, cudaEventSynchronize, cudaMemcpy) that the host
profile records inside the port's `pose.call` spans, over the profiled
calls. The benchmark's own copies of the outputs come after the span."""

from portbench import spans


def read(t):
    return spans.count_per_call(t, "pose.call", spans.SYNCS)
