"""Hand-written Hopper kernels of the port, one module per Pallas kernel.

Each module holds the wrapper that launches its CUDA kernel (sources in
`onepose_tpu_torch/csrc/`), the plain PyTorch version of the same function
(which the wrapper uses only for CPU tensors), and a plain-integer
`launches` counter that the wrapper bumps once per kernel launch.

| module        | replaces (onepose_tpu/ops/pallas/...)     | source             |
| score_path    | score_path.py::simple_nms_pallas          | csrc/score_path.cu |
| gats          | gats.py::_gats_pallas_raw                 | csrc/gats.cu       |
| dual_softmax  | dual_softmax.py::dual_softmax_match       | csrc/dual_softmax.cu |
"""

from __future__ import annotations

from onepose_tpu_torch.ops.kernels import dual_softmax, gats, score_path

_MODULES = {"nms": score_path, "gats": gats, "dual_softmax": dual_softmax}


def launch_counts() -> dict[str, int]:
    """Kernel launches per kernel since the last `reset_launches()`."""
    return {name: mod.launches for name, mod in _MODULES.items()}


def reset_launches() -> None:
    for mod in _MODULES.values():
        mod.launches = 0
