"""CUDA launches a serving call in RANSAC-PnP: the kernel launches,
memsets and graph launches (`portbench.spans.LAUNCHES`: cudaLaunchKernel,
cudaLaunchKernelExC, cudaLaunchCooperativeKernel, cuLaunchKernel,
cuLaunchKernelEx, cudaMemsetAsync, cudaMemset, cudaGraphLaunch) that the
host profile records inside the port's `pose.pnp` spans, over the
profiled calls."""

from portbench import spans


def read(t):
    return spans.count_per_call(t, "pose.pnp", spans.LAUNCHES)
