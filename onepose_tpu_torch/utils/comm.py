"""Cross-process communication over `torch.distributed`.

Port of onepose_tpu/utils/comm.py. The JAX package joins processes with
jax.distributed and gathers host values with its multihost utilities; here
the processes are `torch.distributed` ranks, one card each, launched by
torchrun (`python -m torch.distributed.run --nproc-per-node N ...`), and
every collective runs on trees of tensors (or numpy arrays), never on
pickles. With no process group (one process) every collective is the
identity, as in the JAX package.

Backends: NCCL for ranks on the card, gloo for ranks on the CPU
(`init_distributed(device=...)`); `backend=` names one explicitly, for the
one case that needs it: several ranks sharing one card, which NCCL refuses,
run gloo over CUDA tensors. gloo runs some collectives on CUDA tensors and
not others (found with two gloo ranks on one H100 under torch 2.11:
all_reduce (sum and max; fp32, bf16, int64, uint8), broadcast, all_gather
and barrier run; send and recv of a CUDA tensor abort the process). So
`ring_shift` passes blocks by send and receive where the backend takes
them for the tensor's device and builds the ring from all_gather where it
does not: a step chosen by the group's backend and the tensor's device
(`_gloo_on_cuda`), never by catching an error.

Every group is created with a timeout (`TIMEOUT`, or the caller's), so a
collective that waits for a rank that is gone raises instead of hanging.

`record_collectives()` counts the collectives of this module inside a
`with` block (kind, calls, bytes): the port's collectives are explicit,
so they are counted where they run, where the JAX package's audit
(scripts/audit_collectives.py) sums them from the compiled HLO. Outside
such a block each collective tests one module global and records nothing.
"""

from __future__ import annotations

import contextlib
import datetime
import os
from typing import Any, Callable, Optional

import numpy as np
import torch
import torch.distributed as dist

TIMEOUT = datetime.timedelta(seconds=300)

_TORCHRUN_ENV = ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR")


def init_distributed(
    device: str | torch.device = "cuda",
    backend: Optional[str] = None,
    timeout: datetime.timedelta = TIMEOUT,
) -> bool:
    """Join the process group that torchrun describes in the environment
    (RANK, WORLD_SIZE, LOCAL_RANK, MASTER_ADDR, MASTER_PORT); a no-op
    returning False when none of those is set (one process), True once
    joined (also when already joined). The backend is NCCL when `device`
    is the card, gloo for the CPU, or `backend`. On the card the rank binds
    cuda:LOCAL_RANK."""
    if dist.is_initialized():
        return True
    if not any(k in os.environ for k in _TORCHRUN_ENV):
        return False
    dev = torch.device(device)
    backend = backend or ("nccl" if dev.type == "cuda" else "gloo")
    kwargs = {}
    if dev.type == "cuda":
        local = torch.device("cuda", get_local_rank())
        torch.cuda.set_device(local)
        if backend == "nccl":
            kwargs["device_id"] = local
    dist.init_process_group(backend, init_method="env://", timeout=timeout, **kwargs)
    return True


def get_world_size() -> int:
    return dist.get_world_size() if dist.is_available() and dist.is_initialized() else 1


def get_rank() -> int:
    return dist.get_rank() if dist.is_available() and dist.is_initialized() else 0


def get_local_rank() -> int:
    return int(os.environ.get("LOCAL_RANK", "0"))


def is_main_process() -> bool:
    return get_rank() == 0


def rank_device(device: str | torch.device = "cuda") -> torch.device:
    """This rank's device: cuda:LOCAL_RANK for the card, else the CPU."""
    dev = torch.device(device)
    return torch.device("cuda", get_local_rank()) if dev.type == "cuda" else dev


def synchronize(group=None) -> None:
    """Barrier over `group` (the world by default); no-op in one process."""
    if get_world_size() == 1 and group is None:
        return
    dist.barrier(group=group)


# --- a count of the collectives ---------------------------------------------

class CollectiveLog:
    """The collectives run while recording, per kind ("all_reduce",
    "all_gather", "broadcast", "ring_shift"): calls and bytes. The bytes
    of a call are those of its result on this rank, at the width they
    travel at (bool as uint8): an all-reduce's or a broadcast's tensor,
    an all-gather's gathered tensor, a ring shift's received blocks (also
    where gloo builds the shift from an all-gather). They are what XLA's
    HLO shapes give for the same collectives."""

    def __init__(self):
        self.ops: dict[str, list] = {}

    def add(self, kind: str, n_bytes: int) -> None:
        entry = self.ops.setdefault(kind, [0, 0])
        entry[0] += 1
        entry[1] += n_bytes

    def totals(self) -> dict:
        """{kind: {"calls", "bytes"}}, by kind."""
        return {k: {"calls": c, "bytes": b} for k, (c, b) in sorted(self.ops.items())}


_LOG: Optional[CollectiveLog] = None


@contextlib.contextmanager
def record_collectives():
    """`with record_collectives() as log:` counts in `log` the collectives
    that the block runs on a group of two ranks or more (group=None, or a
    group of one rank, moves nothing and is not counted); an outer
    recording resumes after the block."""
    global _LOG
    outer, _LOG = _LOG, CollectiveLog()
    try:
        yield _LOG
    finally:
        _LOG = outer


def _record(kind: str, t: torch.Tensor, group, copies: int = 1) -> None:
    if _LOG is not None and dist.get_world_size(group) > 1:
        _LOG.add(kind, copies * t.numel() * t.element_size())


# --- tensors over a group --------------------------------------------------

def _gloo_on_cuda(t: torch.Tensor, group) -> bool:
    """A CUDA tensor in a gloo group: no send or recv there."""
    return t.is_cuda and dist.get_backend(group) == "gloo"


def _wire(t: torch.Tensor) -> torch.Tensor:
    """Bool tensors travel as uint8 (not every backend reduces bool)."""
    return t.to(torch.uint8) if t.dtype == torch.bool else t


def all_reduce(t: torch.Tensor, group, op: str = "sum") -> torch.Tensor:
    """The reduction ("sum" or "max") of t over `group`, as a new tensor;
    t itself when group is None."""
    if group is None:
        return t
    red = {"sum": dist.ReduceOp.SUM, "max": dist.ReduceOp.MAX}[op]
    buf = _wire(t).contiguous().clone()
    _record("all_reduce", buf, group)
    dist.all_reduce(buf, op=red, group=group)
    return buf.to(t.dtype)


def all_gather(t: torch.Tensor, group, dim: int = 0) -> torch.Tensor:
    """The ranks' tensors of `group` (equal shapes) concatenated along
    `dim` in rank order; t itself when group is None."""
    if group is None:
        return t
    buf = _wire(t).contiguous()
    _record("all_gather", buf, group, dist.get_world_size(group))
    return torch.cat(_gather(buf, group), dim=dim).to(t.dtype)


def _gather(buf: torch.Tensor, group) -> list:
    """Every rank's buf of `group`, in rank order (not recorded)."""
    parts = [torch.empty_like(buf) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, buf, group=group)
    return parts


def broadcast(t: torch.Tensor, group, src: int = 0) -> torch.Tensor:
    """`group`'s rank `src` (index within the group)'s t, on every rank."""
    if group is None:
        return t
    buf = _wire(t).contiguous().clone()
    _record("broadcast", buf, group)
    dist.broadcast(buf, src=dist.get_global_rank(group, src), group=group)
    return buf.to(t.dtype)


def ring_shift(tensors: list, group) -> list:
    """Each rank's tensors sent to the next rank of `group` (in a ring);
    returns those of the previous rank. Send and receive where the backend
    takes them for the tensors' device (`dist.batch_isend_irecv`); where it
    does not (gloo on CUDA tensors), an all-gather that each rank reads its
    predecessor's block from."""
    n = dist.get_world_size(group)
    me = dist.get_rank(group)
    nxt = dist.get_global_rank(group, (me + 1) % n)
    prv = dist.get_global_rank(group, (me - 1) % n)
    out = []
    for t in tensors:
        buf = _wire(t).contiguous()
        _record("ring_shift", buf, group)
        if _gloo_on_cuda(buf, group):
            out.append(_gather(buf, group)[(me - 1) % n].to(t.dtype))
            continue
        recv = torch.empty_like(buf)
        ops = [dist.P2POp(dist.isend, buf, nxt, group=group),
               dist.P2POp(dist.irecv, recv, prv, group=group)]
        for w in dist.batch_isend_irecv(ops):
            w.wait()
        out.append(recv.to(t.dtype))
    return out


# --- trees ----------------------------------------------------------------

def tree_map(fn: Callable, tree: Any) -> Any:
    """fn over the leaves of nested dicts, lists and tuples."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, v) for v in tree)
    return fn(tree)


def _comm_device(group) -> torch.device:
    """Where a host value travels: the rank's card for NCCL, else the CPU."""
    if dist.get_backend(group) == "nccl":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def all_gather_pytree(tree: Any, group=None) -> list:
    """A numeric tree (numpy arrays, numbers or tensors, the same shapes on
    every rank) from every rank of `group` (the world by default): a list
    of per-rank trees, on every rank. One process: [tree]."""
    if get_world_size() == 1:
        return [tree]
    group = group or dist.group.WORLD
    n = dist.get_world_size(group)
    dev = _comm_device(group)

    def gather(x):
        if isinstance(x, torch.Tensor):
            return all_gather(x[None].to(dev), group).to(x.device)
        a = np.asarray(x)
        g = all_gather(torch.from_numpy(a.copy())[None].to(dev), group)
        return g.cpu().numpy().astype(a.dtype)

    stacked = tree_map(gather, tree)
    return [tree_map(lambda g, i=i: g[i], stacked) for i in range(n)]


def reduce_dict(d: dict, average: bool = True, group=None) -> dict:
    """The mean (or sum) of scalar dicts over the ranks, as floats."""
    n = get_world_size()
    if n == 1:
        return {k: float(v) for k, v in d.items()}
    gathered = all_gather_pytree({k: np.float64(v) for k, v in d.items()}, group)
    out = {}
    for k in d:
        total = sum(float(g[k]) for g in gathered)
        out[k] = total / len(gathered) if average else total
    return out
