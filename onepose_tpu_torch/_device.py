"""Device and dtype resolution for the port's entry points.

The port runs on the card unless the caller names the CPU. A request for
CUDA on a machine without it raises; nothing falls back silently.
"""

from __future__ import annotations

import torch


def resolve_device(device: str | torch.device = "cuda") -> torch.device:
    """torch.device for `device`; raises if CUDA is asked for and absent."""
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                f"device {str(device)!r} requested but CUDA is not available "
                "(pass device='cpu' to run the plain PyTorch path)"
            )
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {str(device)!r}: use cuda or cpu")
    return dev


COMPUTE_DTYPES = (torch.float32, torch.bfloat16)


def check_compute_dtype(dtype: torch.dtype) -> torch.dtype:
    """The port computes in float32 or bfloat16 (the JAX package's serving
    default); anything else, float16 included, raises."""
    if dtype not in COMPUTE_DTYPES:
        raise ValueError(
            f"compute dtype {dtype} is not supported: use torch.float32 or "
            "torch.bfloat16"
        )
    return dtype
