"""A two-axis mesh over the ranks of the default process group.

Port of onepose_tpu/parallel/mesh.py. The JAX package lays a `Mesh` over
the devices of one SPMD program and lets its compiler insert the
communication. Here one process drives one device (one card, or the CPU),
and the mesh lays the ranks of the `torch.distributed` world out row-major
over two named axes: rank = row * cols + col. Each axis has a process group
per line of the mesh (`Mesh.group(axis)` is this rank's), and every
communication is an explicit call of `utils.comm` over one of them.

A tensor is sharded by a spec, one entry per dimension: None (the whole
dimension) or an axis name (this rank's block of the dimension, by its
coordinate on that axis). `shard` takes the block, `gather` puts the blocks
back together. Without a process group (one process) the mesh is 1 x 1 and
every collective is the identity.
"""

from __future__ import annotations

import datetime
from typing import Optional

import torch
import torch.distributed as dist

from onepose_tpu_torch._device import resolve_device
from onepose_tpu_torch.utils import comm

DATA_AXIS = "data"
POINTS_AXIS = "points"


class Mesh:
    """Ranks laid out as an `shape[0]` x `shape[1]` grid named `axis_names`.

    `device` is this rank's device (cuda:LOCAL_RANK on the card, or the
    CPU). Creating a mesh creates its groups, a collective call: every rank
    of the world creates the same meshes in the same order."""

    def __init__(self, shape: tuple, axis_names: tuple, device: torch.device,
                 timeout: datetime.timedelta = comm.TIMEOUT):
        rows, cols = shape
        world = comm.get_world_size()
        if rows * cols != world:
            raise ValueError(f"a {rows} x {cols} mesh needs {rows * cols} ranks; the world has "
                             f"{world}: every rank must be in the mesh")
        self.shape = (rows, cols)
        self.axis_names = tuple(axis_names)
        self.device = device
        self.rank = comm.get_rank()
        self.coords = {axis_names[0]: self.rank // cols, axis_names[1]: self.rank % cols}
        self._groups = {}
        if not dist.is_initialized():
            return
        lines = {
            axis_names[0]: [[r * cols + c for r in range(rows)] for c in range(cols)],
            axis_names[1]: [[r * cols + c for c in range(cols)] for r in range(rows)],
        }
        for axis, groups in lines.items():
            for ranks in groups:
                g = dist.new_group(ranks, timeout=timeout)
                if self.rank in ranks:
                    self._groups[axis] = g

    @property
    def size(self) -> int:
        return self.shape[0] * self.shape[1]

    def axis_size(self, axis: str) -> int:
        return self.shape[self.axis_names.index(axis)]

    def group(self, axis: str):
        """This rank's process group along `axis` (None in one process)."""
        return self._groups.get(axis)


def _rank_device(device) -> torch.device:
    return comm.rank_device(resolve_device(device))


def make_mesh(n_data: Optional[int] = None, n_points: int = 1,
              device: str | torch.device = "cuda",
              timeout: datetime.timedelta = comm.TIMEOUT) -> Mesh:
    """A ("data", "points") mesh over every rank: n_data defaults to
    world // n_points. The points axis shards the matcher's 3D points; it
    should divide the padded point count."""
    world = comm.get_world_size()
    if n_data is None:
        n_data = world // n_points
    return Mesh((n_data, n_points), (DATA_AXIS, POINTS_AXIS), _rank_device(device), timeout)


def replicated(mesh: Mesh, ndim: int = 0) -> tuple:
    """The spec of a tensor every rank holds whole."""
    return (None,) * ndim


def batch_sharding(mesh: Mesh, ndim: int = 1) -> tuple:
    """Axis 0 over the data axis, the rest whole."""
    return (DATA_AXIS,) + (None,) * (ndim - 1)


def points_sharding(mesh: Mesh, points_axis: int, ndim: int) -> tuple:
    """Axis 0 over the data axis and `points_axis` over the points axis."""
    spec = [None] * ndim
    spec[0] = DATA_AXIS
    spec[points_axis] = POINTS_AXIS
    return tuple(spec)


def shard(mesh: Mesh, x: torch.Tensor, spec: tuple) -> torch.Tensor:
    """This rank's block of x under `spec` (each sharded dimension must
    divide its axis)."""
    for dim, axis in enumerate(spec):
        if axis is None:
            continue
        n = mesh.axis_size(axis)
        if x.shape[dim] % n:
            raise ValueError(f"dimension {dim} of {tuple(x.shape)} does not divide the "
                             f"{axis} axis ({n})")
        step = x.shape[dim] // n
        x = x.narrow(dim, mesh.coords[axis] * step, step)
    return x


def gather(mesh: Mesh, x: torch.Tensor, spec: tuple) -> torch.Tensor:
    """The whole tensor from this rank's block under `spec`, on every rank."""
    for dim, axis in enumerate(spec):
        if axis is not None:
            x = comm.all_gather(x, mesh.group(axis), dim=dim)
    return x


def shard_batch(mesh: Mesh, batch):
    """A tree of tensors or numpy arrays (identical on every rank) as this
    rank's slice of axis 0 on the mesh's device."""
    def one(x):
        x = torch.as_tensor(x)
        return shard(mesh, x, batch_sharding(mesh, x.dim())).to(mesh.device)

    return comm.tree_map(one, batch)


def replicate_pytree(mesh: Mesh, tree):
    """A tree of tensors or numpy arrays as rank 0 holds it, on every rank
    (on the mesh's device)."""
    group = dist.group.WORLD if dist.is_initialized() else None

    def one(x):
        return comm.broadcast(torch.as_tensor(x).to(mesh.device), group)

    return comm.tree_map(one, tree)
