"""Device ms a LightGlue chunk spends in softmax attention: the time of
K8's forward kernels (`csrc/flash_attention.cu`: two launches a layer,
self on both images and cross both ways) in the chunks profiled on the
card alone, a chunk. The port replays each layer as a CUDA graph, so the
`attention.softmax` spans inside a layer have no range on the card."""

import re

KERNEL = re.compile(r"^(void\s+)?(\(anonymous namespace\)::)?flash_fwd(_ws|_wide)?\b")


def read(t):
    s = t.kernel_seconds(KERNEL)
    return None if s is None else 1e3 * s / t.profiled_calls
