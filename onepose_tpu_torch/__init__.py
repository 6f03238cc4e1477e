"""OnePose in PyTorch for one NVIDIA H100: the serving path of `onepose_tpu`.

A port of the JAX package, module for module (the names mirror
`onepose_tpu/`), held against it by the parity tests in
`tests/test_torch_*.py`. Plain tensor code is PyTorch; every Pallas TPU
kernel on the ported path is a CUDA C++ kernel written for Hopper
(`csrc/`, built with nvcc at first use and bound with ctypes, see
`ops/kernels/_build.py`).

Ported so far: the fused serving program, SuperPoint -> keypoint
extraction -> GATsSPG -> batched RANSAC-PnP (`runtime.pipeline.PosePipeline`,
bf16 or fp32), and the pair matcher of `map`, SuperGlue over chunks of
frame pairs with the resident and streamed Sinkhorn kernels
(`parallel.sfm_parallel`).

Conventions: NHWC / [B, N, C] layouts at the public functions, as in JAX;
an explicit `device` argument that defaults to CUDA and raises without it
(there is no CPU fallback: pass device="cpu" to run the plain PyTorch
versions); an explicit `torch.Generator` or injected uniform draws where
JAX takes a PRNG key; float32 or bfloat16 compute.

Importing this package loads neither JAX nor Triton, and builds nothing.
"""

__version__ = "0.1.0"
