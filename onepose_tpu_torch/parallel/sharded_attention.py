"""Sequence-parallel attention over a sharded point axis.

Port of onepose_tpu/parallel/sharded_attention.py. The matcher's 3D point
axis is split over the mesh's points axis: each rank holds a block of the
keys and values (and, for the 3D stream, of the queries), and the 2D<->3D
attention and the dual-softmax confidence reduce over the points group:

- linear attention is a sum over source positions, so the blocks' [B, H,
  D, D] KV moments and [B, H, D] key sums are all-reduced (bytes
  independent of the point count);
- softmax attention passes K/V blocks around the ring of the points group
  while each rank merges streaming-softmax statistics (running max,
  weighted sum);
- the dual softmax's N3 softmax all-reduces its max and its exp-sum.

Every function takes this rank's blocks (the batch as the caller holds it:
when the mesh has a data axis, each data row runs its own points-axis
collectives) and returns this rank's block of the output.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from onepose_tpu_torch.models.common import NEG_INF
from onepose_tpu_torch.parallel.mesh import POINTS_AXIS, Mesh
from onepose_tpu_torch.utils import comm


def _phi(x: torch.Tensor) -> torch.Tensor:
    return F.elu(x) + 1.0


def sharded_linear_attention(
    mesh: Mesh,
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    kv_mask: torch.Tensor,
    v_length: int,
    eps: float = 1e-6,
) -> torch.Tensor:
    """Linear attention with keys and values sharded over the points axis.

    q [B, N, H, D]: whole, or this rank's block when the queries are the
    same sharded point set; k, v [B, M_local, H, D], kv_mask [B, M_local]:
    this rank's blocks; v_length: the GLOBAL M (the value conditioning).
    Returns [B, N, H, D], laid out as q."""
    group = mesh.group(POINTS_AXIS)
    phi_k = _phi(k) * kv_mask.to(k.dtype)[:, :, None, None]
    kv = comm.all_reduce(torch.einsum("bmhd,bmhe->bhde", phi_k, v / v_length), group)
    ksum = comm.all_reduce(phi_k.sum(dim=1), group)
    phi_q = _phi(q)
    z = 1.0 / (torch.einsum("bnhd,bhd->bnh", phi_q, ksum) + eps)
    return torch.einsum("bnhd,bhde,bnh->bnhe", phi_q, kv, z) * v_length


def ring_softmax_attention(
    mesh: Mesh,
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    kv_mask: torch.Tensor,
) -> torch.Tensor:
    """Softmax attention with keys and values sharded on the points axis:
    the K/V blocks go once around the ring of the points group and each
    rank merges every block into streaming-softmax statistics.

    q [B, N, H, D] (whole or this rank's block); k, v [B, M_local, H, D];
    kv_mask [B, M_local]. A block whose keys are all masked gives logits of
    NEG_INF, whose weights the merge then scales by exp(NEG_INF - max) = 0,
    so the output stays finite."""
    group = mesh.group(POINTS_AXIS)
    n_shards = mesh.axis_size(POINTS_AXIS)
    scale = 1.0 / float(q.shape[-1]) ** 0.5

    def block_stats(k_blk, v_blk, m_blk):
        logits = torch.einsum("bnhd,bmhd->bhnm", q, k_blk) * scale
        logits = torch.where(m_blk[:, None, None, :], logits, NEG_INF)
        m_local = logits.amax(dim=-1)  # [B, H, N]
        p = torch.exp(logits - m_local[..., None])
        return m_local, p.sum(dim=-1), torch.einsum("bhnm,bmhd->bnhd", p, v_blk)

    def merge(acc, blk):
        m_a, s_a, o_a = acc
        m_b, s_b, o_b = blk
        m_new = torch.maximum(m_a, m_b)
        ca, cb = torch.exp(m_a - m_new), torch.exp(m_b - m_new)
        o_new = o_a * ca.transpose(1, 2)[..., None] + o_b * cb.transpose(1, 2)[..., None]
        return m_new, s_a * ca + s_b * cb, o_new

    acc = block_stats(k, v, kv_mask)
    kvm = [k, v, kv_mask]
    for _ in range(n_shards - 1):
        kvm = comm.ring_shift(kvm, group)
        acc = merge(acc, block_stats(*kvm))
    _, s_f, o_f = acc
    return o_f / s_f.transpose(1, 2)[..., None].clamp(min=1e-20)


def sharded_dual_softmax(
    mesh: Mesh,
    scores: torch.Tensor,
    mask2d: torch.Tensor,
    mask3d: torch.Tensor,
) -> torch.Tensor:
    """Dual-softmax confidence with the 3D axis sharded: scores [B, N2,
    N3_local], mask2d [B, N2], mask3d [B, N3_local]. The N2 softmax is
    local; the N3 softmax all-reduces its max and its exp-sum over the
    points group. Returns this rank's block of conf [B, N2, N3_local]."""
    group = mesh.group(POINTS_AXIS)
    s = torch.where(mask2d[:, :, None], scores, NEG_INF)
    s = torch.where(mask3d[:, None, :], s, NEG_INF)
    sm1 = torch.softmax(s, dim=1)
    mx = comm.all_reduce(s.amax(dim=2, keepdim=True), group, op="max")
    e = torch.exp(s - mx)
    denom = comm.all_reduce(e.sum(dim=2, keepdim=True), group)
    return sm1 * (e / denom.clamp(min=1e-20))
