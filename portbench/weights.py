"""Seeded weights, made on the device in one draw.

Every parameter of a network's `(name, shape, bound)` list
(`reference.nets.*_specs`) is a slice of one uniform draw from a
`torch.Generator` on the device, scaled to U(-bound, bound); a bound of
None is the constant 1 and 0.0 the constant 0. The same seed gives the
same tensors, so the program's modules and the reference are handed the
same weights, each its own copy.
"""

from __future__ import annotations

import math

import torch

from portbench.reference import nets


def make(specs: list, seed: int, device) -> dict:
    """{name: fp32 tensor} for `specs`, drawn from `seed` on `device`."""
    sizes = [math.prod(shape) for _, shape, _ in specs]
    g = torch.Generator(device=device).manual_seed(seed)
    flat = torch.rand(sum(sizes), generator=g, device=device) * 2.0 - 1.0
    out, at = {}, 0
    for (name, shape, bound), n in zip(specs, sizes):
        part = flat[at:at + n].reshape(shape)
        at += n
        if bound is None:
            out[name] = torch.ones(shape, device=device)
        else:
            out[name] = part * bound
    return out


# SuperPoint's assumed init, the same in every configuration: He's uniform
# bound (sqrt(6) times PyTorch's default), no biases, each filter less its
# mean (`nets.zero_mean_filters`).
SUPERPOINT_GAIN = math.sqrt(6.0)
SUPERPOINT_BIAS_SCALE = 0.0


def superpoint(cfg: dict, seed: int, device) -> dict:
    """SuperPoint's weights at the configuration's descriptor width."""
    sp = make(nets.superpoint_specs(cfg["descriptor_dim"], SUPERPOINT_BIAS_SCALE,
                                    SUPERPOINT_GAIN), seed, device)
    return nets.zero_mean_filters(sp)
