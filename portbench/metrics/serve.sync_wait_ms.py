"""Host ms a serving call waits on the card: the summed duration of the
sync records (`portbench.spans.SYNCS`: cudaStreamSynchronize,
cudaDeviceSynchronize, cudaEventSynchronize, cudaMemcpy) inside the
port's `pose.call` spans, over the profiled calls."""

from portbench import spans


def read(t):
    return spans.ms_per_call(t, "pose.call", spans.SYNCS)
