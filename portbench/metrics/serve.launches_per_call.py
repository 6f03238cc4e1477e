"""CUDA launches a serving call: the kernel launches, memsets and graph
launches (`portbench.spans.LAUNCHES`: cudaLaunchKernel,
cudaLaunchKernelExC, cudaLaunchCooperativeKernel, cuLaunchKernel,
cuLaunchKernelEx, cudaMemsetAsync, cudaMemset, cudaGraphLaunch) that the
host profile records inside the port's `pose.call` spans, over the
profiled calls."""

from portbench import spans


def read(t):
    return spans.count_per_call(t, "pose.call", spans.LAUNCHES)
