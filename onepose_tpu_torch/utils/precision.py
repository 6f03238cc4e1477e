"""Matmul precision helpers.

`fp32_matmuls` ports onepose_tpu/utils/precision.py::fp32_matmuls. On the
card, a float32 convolution goes through cuDNN in TF32 by default and a
float32 matmul may too (`allow_tf32`). TF32 keeps about three decimal
digits, which the metric geometry path cannot afford (the JAX package
measured a 35x pose-accuracy loss from reduced-precision matmuls in
RANSAC-PnP). `fp32_matmuls` is a context manager, and a decorator, that
turns both TF32 switches off and restores them on exit.

`mixed_einsum` is the counterpart of a JAX contraction with `dtype`
operands and `preferred_element_type=jnp.float32`: both operands are
rounded to `dtype`, the sum runs in fp32. `torch.matmul` of two bf16
tensors would return bf16 and so round the accumulator; here the rounded
operands are multiplied as fp32 with TF32 off, which is exact per product.
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


def rounded(x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """x rounded through `dtype` and held as fp32 (`dtype` fp32: x as fp32)."""
    return x.to(dtype).float()


def mixed_einsum(eq: str, *operands: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """einsum of `dtype`-rounded operands, summed in full fp32."""
    with fp32_matmuls():
        return torch.einsum(eq, *(rounded(x, dtype) for x in operands))
