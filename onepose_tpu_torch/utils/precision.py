"""Full fp32 matmuls for the geometry solvers.

Port of onepose_tpu/utils/precision.py::fp32_matmuls. On the card, a float32
convolution goes through cuDNN in TF32 by default and a float32 matmul may
too (`allow_tf32`). TF32 keeps about three decimal digits, which the metric
geometry path cannot afford (the JAX package measured a 35x pose-accuracy
loss from reduced-precision matmuls in RANSAC-PnP). `fp32_matmuls` is a
context manager, and a decorator, that turns both TF32 switches off and
restores them on exit.
"""

from __future__ import annotations

import contextlib

import torch


@contextlib.contextmanager
def fp32_matmuls():
    matmul, cudnn = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = matmul
        torch.backends.cudnn.allow_tf32 = cudnn
