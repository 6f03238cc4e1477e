"""Hand-written Hopper kernels of the port, one module per Pallas kernel.

Each module holds the wrapper that launches its CUDA kernel (sources in
`onepose_tpu_torch/csrc/`), the plain PyTorch version of the same function
(which the wrapper uses only for CPU tensors), and a plain-integer
`launches` counter that the wrapper bumps once per kernel launch.

| module        | replaces (onepose_tpu/ops/pallas/...)     | source             |
| score_path    | score_path.py::simple_nms_pallas          | csrc/score_path.cu |
| gats          | gats.py::_gats_pallas_raw                 | csrc/gats.cu       |
| dual_softmax  | dual_softmax.py::dual_softmax_match       | csrc/dual_softmax.cu |
| vgg_stage     | vgg_stage.py::_vgg_stage_pallas           | csrc/vgg_stage.cu  |
| gats_block    | gats_block.py::fused_gats_block           | csrc/gats_block.cu |
| sinkhorn      | sinkhorn.py::sinkhorn_potentials          | csrc/sinkhorn.cu   |
| sinkhorn_stream | sinkhorn_stream.py::sinkhorn_potentials_streamed | csrc/sinkhorn_stream.cu |

`gats_block` counts one launch per call of its wrapper, which runs the
block as a sequence of 33 CUDA kernels. `sinkhorn` and `sinkhorn_stream`
each run all their iterations in one cooperative launch.
"""

from __future__ import annotations

from onepose_tpu_torch.ops.kernels import (
    dual_softmax,
    gats,
    gats_block,
    score_path,
    sinkhorn,
    sinkhorn_stream,
    vgg_stage,
)

_MODULES = {
    "nms": score_path,
    "vgg_stage": vgg_stage,
    "gats": gats,
    "gats_block": gats_block,
    "dual_softmax": dual_softmax,
    "sinkhorn": sinkhorn,
    "sinkhorn_stream": sinkhorn_stream,
}


def launch_counts() -> dict[str, int]:
    """Kernel launches per kernel since the last `reset_launches()`."""
    return {name: mod.launches for name, mod in _MODULES.items()}


def reset_launches() -> None:
    for mod in _MODULES.values():
        mod.launches = 0
