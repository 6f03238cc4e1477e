"""Weight bridge: JAX (linen) parameter trees -> the port's state_dicts.

Input is a nested mapping of numpy arrays, e.g.
`jax.tree.map(np.asarray, params)` of the JAX SuperPoint, GATsSPG or
SuperGlue, with or without the top-level "params" collection. Module paths map one to one,
because the port's modules carry the JAX module names (`conv1a`,
`gats_0`, `self_0.attn.proj_q`, `final_proj`, ...):
- a conv `kernel` [kh, kw, in, out] (HWIO) becomes `weight` [out, in, kh, kw]
  (OIHW);
- a dense `kernel` [in, out] becomes a Linear `weight` [out, in];
- `bias`, the raw GATs parameters `W` [C, C] and `a` [2C, 1], the folded
  batch-norm `bn_scale_*` / `bn_bias_*` and SuperGlue's scalar
  `bin_score` are copied as they are.
Attention channels keep the head-major order c = h * D + d of the JAX
package; no permutation is applied.
"""

from __future__ import annotations

from collections.abc import Mapping

import numpy as np
import torch


def jax_to_state_dict(tree: Mapping) -> dict[str, torch.Tensor]:
    """Flatten a JAX parameter tree into a PyTorch state_dict."""
    if "params" in tree and isinstance(tree["params"], Mapping):
        tree = tree["params"]
    out: dict[str, torch.Tensor] = {}

    def walk(node: Mapping, prefix: str) -> None:
        for key, value in node.items():
            if isinstance(value, Mapping):
                walk(value, f"{prefix}{key}.")
                continue
            arr = np.asarray(value, dtype=np.float32)
            name = f"{prefix}{key}"
            if key == "kernel":
                name = f"{prefix}weight"
                if arr.ndim == 4:
                    arr = arr.transpose(3, 2, 0, 1)
                elif arr.ndim == 2:
                    arr = arr.T
                else:
                    raise ValueError(f"{prefix}kernel: unexpected rank {arr.ndim}")
            out[name] = torch.tensor(arr)  # a contiguous, writable copy

    walk(tree, "")
    return out


def superpoint_state_dict(params: Mapping) -> dict[str, torch.Tensor]:
    """State dict for `models.superpoint.SuperPoint` from JAX SuperPoint params."""
    sd = jax_to_state_dict(params)
    for name, t in sd.items():
        if name.endswith(".weight") and t.dim() != 4:
            raise ValueError(f"{name}: SuperPoint holds only conv weights")
    return sd


def gats_spg_state_dict(params: Mapping) -> dict[str, torch.Tensor]:
    """State dict for `models.gats_spg.GATsSPG` from JAX GATsSPG params."""
    sd = jax_to_state_dict(params)
    prefixes = ("gats_", "self_", "cross_", "final_proj.")
    bad = [n for n in sd if not n.startswith(prefixes)]
    if bad:
        raise ValueError(f"not GATsSPG parameters: {bad[:5]}")
    return sd


def superglue_state_dict(params: Mapping) -> dict[str, torch.Tensor]:
    """State dict for `models.superglue.SuperGlue` from JAX SuperGlue params."""
    sd = jax_to_state_dict(params)
    prefixes = ("kenc.", "self_", "cross_", "final_proj.")
    bad = [n for n in sd if not (n.startswith(prefixes) or n == "bin_score")]
    if bad:
        raise ValueError(f"not SuperGlue parameters: {bad[:5]}")
    return sd
