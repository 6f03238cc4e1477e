"""K8's share of its roofline in the LightGlue cell: the least time of the
attention the chunks ran, at the keypoints each pair held at each layer
(`counts_lightglue.flash_seconds`: 3xTF32, 3 x the matrix operations at
495 TFLOP/s), over the device time of `csrc/flash_attention.cu`'s forward
kernels in the chunks profiled on the card alone."""

import re

KERNEL = re.compile(r"^(void\s+)?(\(anonymous namespace\)::)?flash_fwd(_ws|_wide)?\b")


def read(t):
    s = t.kernel_seconds(KERNEL)
    if s is None or "flash" not in t.work:
        return None
    return 100.0 * t.work["flash"] * t.profiled_calls / s
