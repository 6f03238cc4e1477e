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
| flash_attention | JAX's library flash attention, reached by models/common.py::_flash_softmax_attention (not under ops/pallas/) | csrc/flash_attention.cu |
| ransac_pnp    | none: geometry/ransac.py::ransac_pnp, which XLA compiles whole (K9) | csrc/ransac_pnp.cu |

Three kernels carry a gradient, as the JAX package's custom VJPs do, each
an autograd.Function whose forward is the kernel (one launch, counted) and
whose backward recomputes a plain version (no kernel launch), as JAX's
`_bwd`s recompute through XLA: `GatsLeafAttention` (K2, in `gats`), `Nms`
(K1, in `score_path`: `simple_nms`'s VJP, bit for bit) and `VggStage` (K5,
in `vgg_stage`: the VJP of the unrounded fp32 stage, which raises for a
bf16 input as JAX's does). The wrappers take them whenever autograd
records. K8's `FlashAttention` (in `flash_attention`) differentiates
through kernels both ways, as the library's custom VJP does through two
Pallas backward kernels: its backward launches the dK / dV and the dQ
kernels, counted as `flash_attention_bwd`.

`gats_block` counts one launch per call of its wrapper, which runs the
block as a sequence of 33 CUDA kernels. `sinkhorn` and `sinkhorn_stream`
each run all their iterations in one cooperative launch; the streamed
kernel's two wide entries (rows wider than 14848 columns: the cluster
entry up to 118784, the two-sweep entry above) count their launches
together, as `sinkhorn_stream_wide`. `dual_softmax`
counts one per call: a cooperative launch after a memset of its scratch.
`score_path` counts one per call: one CUDA kernel up to radius 9, five
above. `ransac_pnp` counts each of its launches: two a call
(`geometry.ransac.ransac_pnp` on CUDA tensors), three with epnp_refit.
"""

from __future__ import annotations

from onepose_tpu_torch.ops.kernels import (
    dual_softmax,
    flash_attention,
    gats,
    gats_block,
    ransac_pnp,
    score_path,
    sinkhorn,
    sinkhorn_stream,
    vgg_stage,
)
from onepose_tpu_torch.ops.kernels.flash_attention import FlashAttention
from onepose_tpu_torch.ops.kernels.gats import GatsLeafAttention
from onepose_tpu_torch.ops.kernels.score_path import Nms
from onepose_tpu_torch.ops.kernels.vgg_stage import VggStage

__all__ = ["FlashAttention", "GatsLeafAttention", "Nms", "VggStage", "launch_counts", "reset_launches"]

# kernel name -> (module, its counter)
_COUNTERS = {
    "nms": (score_path, "launches"),
    "vgg_stage": (vgg_stage, "launches"),
    "gats": (gats, "launches"),
    "gats_block": (gats_block, "launches"),
    "dual_softmax": (dual_softmax, "launches"),
    "sinkhorn": (sinkhorn, "launches"),
    "sinkhorn_stream": (sinkhorn_stream, "launches"),
    "sinkhorn_stream_wide": (sinkhorn_stream, "wide_launches"),
    "flash_attention": (flash_attention, "launches"),
    "flash_attention_bwd": (flash_attention, "bwd_launches"),
    "ransac_pnp": (ransac_pnp, "launches"),
}


def launch_counts() -> dict[str, int]:
    """Kernel launches per kernel since the last `reset_launches()`."""
    return {name: getattr(mod, attr) for name, (mod, attr) in _COUNTERS.items()}


def reset_launches() -> None:
    for mod, attr in _COUNTERS.values():
        setattr(mod, attr, 0)
