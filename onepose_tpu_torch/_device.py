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


def check_compute_dtype(dtype: torch.dtype) -> torch.dtype:
    """The port computes in float32 only; bfloat16 serving is queued."""
    if dtype != torch.float32:
        raise ValueError(
            f"compute dtype {dtype} is not supported: the port computes in "
            "torch.float32 only (bf16 / mixed attention are queued in "
            "ROADMAP.md)"
        )
    return dtype
