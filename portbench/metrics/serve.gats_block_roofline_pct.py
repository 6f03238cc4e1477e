"""K4's share of its roofline: the least time of the fused blocks' work a
call at the valid points and leaves (`counts.gats_blocks`) over the
device time of `csrc/gats_block.cu`'s kernels in the profiled calls."""

import re

KERNEL = re.compile(r"^(void\s+)?(\(anonymous namespace\)::)?(gemm_fp32_kernel|gemm_wgmma_kernel|kv_partial_kernel|"
                    r"kv_reduce_kernel|apply_kernel|colpart_kernel|colcombine_kernel|"
                    r"gats_kernel)\b")


def read(t):
    s = t.kernel_seconds(KERNEL)
    if s is None or "gats_block" not in t.work:
        return None
    return 100.0 * t.work["gats_block"].seconds() * t.profiled_calls / s
