"""K5's share of its roofline: the least time of the VGG stages' work a
call (`counts.vgg_stages`) over the device time of `csrc/vgg_stage.cu`'s
kernel in the profiled calls."""

import re

KERNEL = re.compile(r"^(void\s+)?(\(anonymous namespace\)::)?vgg_stage_kernel\b")


def read(t):
    s = t.kernel_seconds(KERNEL)
    if s is None or "vgg_stage" not in t.work:
        return None
    return 100.0 * t.work["vgg_stage"].seconds() * t.profiled_calls / s
