"""Weight layouts of the Hopper kernels, and a cache of packed weights.

`swizzle128` lays a [..., N, K] matrix out as the TMA bulk copies of
`csrc/vgg_stage.cu` and `csrc/gats_block.cu` load it: K cut into chunks of
64 (zero-padded), each chunk [N][64] bf16 with row n's 16-byte groups
permuted, group j stored at position j ^ (n % 8). Copied to a 1024-byte
aligned shared address, a chunk is the canonical SWIZZLE_128B K-major
operand of wgmma (see `csrc/hopper.cuh`).

`PackCache` keeps a module's packed weights and packs again only when one
of the parameters they come from changes: its `data_ptr()` (a new tensor,
`load_state_dict` into a moved module) or its `_version` (an in-place
update under `torch.no_grad()`, `copy_`, an optimizer step). Writes
through `.data` bypass the version counter and are not seen.
"""

from __future__ import annotations

import torch


def _group_index(shape, n: int, device) -> torch.Tensor:
    """Gather index over the 16-byte groups of rows [..., N, 8, 8]: position
    p of row n <-> group p ^ (n % 8) (the permutation is its own inverse)."""
    pos = torch.arange(8, device=device)[None, :] ^ (torch.arange(n, device=device) % 8)[:, None]
    return pos.reshape(*([1] * (len(shape) - 3)), n, 8, 1).expand(shape)


def swizzle128(w: torch.Tensor) -> torch.Tensor:
    """[..., N, K] -> [..., ceil(K / 64), N, 64] bf16, swizzled as above."""
    *lead, n, k = w.shape
    kp = -(-k // 64) * 64
    w = torch.nn.functional.pad(w.to(torch.bfloat16), (0, kp - k))
    w = w.reshape(*lead, n, kp // 64, 8, 8).movedim(-3, -4)  # [..., K/64, N, group, 8]
    w = torch.gather(w, -2, _group_index(w.shape, n, w.device))
    return w.reshape(*lead, kp // 64, n, 64).contiguous()


def unswizzle128(p: torch.Tensor, k: int) -> torch.Tensor:
    """The inverse of `swizzle128`: [..., K/64, N, 64] -> [..., N, k]."""
    *lead, kc, n, _ = p.shape
    g = p.reshape(*lead, kc, n, 8, 8)
    g = torch.gather(g, -2, _group_index(g.shape, n, p.device))
    return g.movedim(-4, -3).reshape(*lead, n, kc * 64)[..., :k]


class PackCache:
    """Packed weights per key, repacked when a source parameter changes."""

    def __init__(self):
        self._entries: dict = {}
        self.packs = 0  # how many times a pack function ran

    def get(self, key, params, pack):
        stamp = tuple((p.data_ptr(), p._version, p.device, p.dtype, tuple(p.shape))
                      for p in params)
        hit = self._entries.get(key)
        if hit is not None and hit[0] == stamp:
            return hit[1]
        out = pack()
        self.packs += 1
        self._entries[key] = (stamp, out)
        return out
