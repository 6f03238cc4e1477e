"""Megatron-style tensor parallelism for the GATsSPG matcher.

Port of onepose_tpu/parallel/tensor_parallel.py. The JAX package gives the
parameters a PartitionSpec tree and lets its compiler derive the
communication. Here each rank of the "model" axis holds a matcher with its
slices of the parameters (`shard_params`), and the two all-reduces per
attention layer are explicit:

- the q/k/v projections are column-parallel: channels are head-major
  (c = h * D + d), so a column block is a block of heads, and each rank
  attends with its own heads without communication;
- the merge is row-parallel: each rank multiplies its heads' channels,
  the partial outputs are all-reduced over the model group, then the bias
  is added once (added on every rank it would count n_model times);
- the MLP's dense_0 is column-parallel, its dense_1 row-parallel (one more
  all-reduce and a bias added once); the instance norm between them is
  per channel over the points, so it needs no communication;
- everything else (GATs W / a, final_proj) is replicated.

`n_model` must divide the head count (4). The batch and the points stay
whole on every rank of a model group.
"""

from __future__ import annotations

import copy
import datetime

import torch
import torch.nn.functional as F
from torch import nn

from onepose_tpu_torch.models.common import Dense, MultiHeadAttention
from onepose_tpu_torch.parallel.mesh import Mesh, _rank_device
from onepose_tpu_torch.utils import comm

MODEL_AXIS = "model"


def make_tp_mesh(n_model: int, device: str | torch.device = "cuda",
                 timeout: datetime.timedelta = comm.TIMEOUT) -> Mesh:
    """A ("data", "model") mesh over every rank: n_model ranks split each
    matcher, world // n_model such matchers take the batch."""
    n_data = comm.get_world_size() // n_model
    return Mesh((n_data, n_model), ("data", MODEL_AXIS), _rank_device(device), timeout)


def _spec_for(name: str) -> tuple:
    """The spec of one parameter of the state_dict (torch layout: a
    Linear's weight is [out, in])."""
    parts = name.split(".")
    leaf, parent = parts[-1], parts[-2] if len(parts) >= 2 else ""
    mlp = "mlp" in parts
    if parent in ("proj_q", "proj_k", "proj_v") or (mlp and parent == "dense_0"):
        return (MODEL_AXIS, None) if leaf == "weight" else (MODEL_AXIS,)
    if parent == "merge" or (mlp and parent == "dense_1"):
        return (None, MODEL_AXIS) if leaf == "weight" else (None,)
    return (None,) * (2 if leaf in ("weight", "W", "a") else 1)


def gats_spg_tp_specs(state_dict: dict) -> dict:
    """{name: spec} for a GATsSPG state_dict: per dimension None (whole)
    or MODEL_AXIS (this rank's block), the Megatron split above."""
    return {k: _spec_for(k) for k in state_dict}


class RowParallelDense(Dense):
    """A Dense holding this rank's input columns: the partial products are
    all-reduced over the model group, then the bias is added once."""

    def __init__(self, in_features: int, out_features: int, dtype, group):
        super().__init__(in_features, out_features, dtype)
        self.group = group

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        d = self.dtype
        y = comm.all_reduce(F.linear(x.to(d), self.weight.to(d)), self.group)
        return y + self.bias.to(d)


def _block(w: torch.Tensor, dim: int, rank: int, n: int) -> nn.Parameter:
    step = w.shape[dim] // n
    return nn.Parameter(w.narrow(dim, rank * step, step).clone())


def shard_params(model: nn.Module, mesh: Mesh) -> nn.Module:
    """A copy of the GATsSPG `model` that holds this rank's heads and
    column / row slices, as `gats_spg_tp_specs` splits them, and
    all-reduces over the mesh's model group; `model` is left as it is."""
    n = mesh.axis_size(MODEL_AXIS)
    if model.num_heads % n:
        raise ValueError(f"n_model={n} must divide the {model.num_heads} heads")
    if model.block_fused:
        raise ValueError("the fused block kernel holds whole weights: build the matcher "
                         "with block_fused=False for tensor parallelism")
    rank, group = mesh.coords[MODEL_AXIS], mesh.group(MODEL_AXIS)
    specs = gats_spg_tp_specs(model.state_dict())
    tp = copy.deepcopy(model)
    for name, dense in list(tp.named_modules()):
        spec = specs.get(f"{name}.weight")
        if not isinstance(dense, Dense) or MODEL_AXIS not in spec:
            continue
        w, b = dense.weight.data, dense.bias.data
        if spec[0] == MODEL_AXIS:  # column-parallel: its output channels
            out = Dense(w.shape[1], w.shape[0] // n, dense.dtype)
            out.weight, out.bias = _block(w, 0, rank, n), _block(b, 0, rank, n)
        else:  # row-parallel: its input channels, the bias added once
            out = RowParallelDense(w.shape[1] // n, w.shape[0], dense.dtype, group)
            out.weight, out.bias = _block(w, 1, rank, n), nn.Parameter(b.clone())
        parent, _, leaf = name.rpartition(".")
        setattr(tp.get_submodule(parent), leaf, out.to(w.device))
    for layer in tp.modules():
        if isinstance(layer, MultiHeadAttention):  # its heads: a block of them
            layer.num_heads //= n
            layer.d_model //= n
    return tp
