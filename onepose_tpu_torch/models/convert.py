"""Reference PyTorch checkpoints -> parameter trees in the JAX package's layout.

Port of onepose_tpu/models/convert.py. It reads the released OnePose-family
state_dicts (SuperPoint superpoint_v1.pth, SuperGlue indoor / outdoor
weights, a GATsSPG Lightning .ckpt) and returns the same numpy trees as
the JAX package, `{"params": {...}}`, which `utils.checkpoint` writes as
the JAX package's msgpack checkpoints and `models.bridge` turns into this
package's state_dicts. Numpy only: a tensor leaf is read with
`.detach().cpu().numpy()`.

Layout contracts:
- a Conv2d weight [out, in, kh, kw] becomes a conv kernel [kh, kw, in, out];
- a Conv1d(k=1) weight [out, in, 1] becomes a dense kernel [in, out];
- BatchNorm1d running statistics are FOLDED into the point MLP's
  per-channel affine (bn_scale, bn_bias): inference-mode parity, eps 1e-5;
- InstanceNorm1d has no parameters (affine=False), nothing to convert;
- attention channels are permuted from the reference's order c = d * H + h
  to the head-major c' = h * D + d (`_head_perm`).
The state-dict names follow the reference module trees
(src/models/matchers/SuperGlue/superglue.py, GATs_SuperGlue.py,
extractors/SuperPoint/superpoint.py).
"""

from __future__ import annotations

import numpy as np

BN_EPS = 1e-5


def _to_np(t) -> np.ndarray:
    try:
        return t.detach().cpu().numpy()
    except AttributeError:
        return np.asarray(t)


def _conv2d(sd: dict, name: str) -> dict:
    w = _to_np(sd[f"{name}.weight"])  # [out, in, kh, kw]
    b = _to_np(sd[f"{name}.bias"])
    return {"kernel": w.transpose(2, 3, 1, 0), "bias": b}


def _conv1d_as_dense(sd: dict, name: str) -> dict:
    w = _to_np(sd[f"{name}.weight"])  # [out, in, 1]
    b = _to_np(sd[f"{name}.bias"])
    return {"kernel": w[..., 0].T, "bias": b}


def _fold_bn(sd: dict, name: str) -> tuple[np.ndarray, np.ndarray]:
    gamma = _to_np(sd[f"{name}.weight"])
    beta = _to_np(sd[f"{name}.bias"])
    mean = _to_np(sd[f"{name}.running_mean"])
    var = _to_np(sd[f"{name}.running_var"])
    scale = gamma / np.sqrt(var + BN_EPS)
    bias = beta - mean * scale
    return scale, bias


def _mlp_params(sd: dict, prefix: str, n_dense: int, norm: str) -> dict:
    """A reference MLP (Conv1d [+ Norm] + ReLU stack) as the point MLP's
    tree. Sequential indices: layer i is conv 3*i (conv, norm, relu
    triplets; the last conv alone); the InstanceNorm variants have the
    same indices and no norm parameters."""
    out = {}
    for i in range(n_dense):
        conv_idx = 3 * i
        out[f"dense_{i}"] = _conv1d_as_dense(sd, f"{prefix}.{conv_idx}")
        if i < n_dense - 1 and norm == "batch":
            scale, bias = _fold_bn(sd, f"{prefix}.{conv_idx + 1}")
            out[f"bn_scale_{i}"] = scale
            out[f"bn_bias_{i}"] = bias
    return out


def _head_perm(d_model: int, num_heads: int) -> np.ndarray:
    """Channel permutation from the reference's head order to head-major:
    torch's view(B, D, H, N) means channel c = d*H + h; the models here
    reshape to [B, N, H, D], channel c' = h*D + d. perm[c'] = c."""
    D = d_model // num_heads
    return np.array([d * num_heads + h for h in range(num_heads) for d in range(D)])


def _attn_propagation(sd: dict, prefix: str, norm: str, num_heads: int = 4) -> dict:
    q = _conv1d_as_dense(sd, f"{prefix}.attn.proj.0")
    k = _conv1d_as_dense(sd, f"{prefix}.attn.proj.1")
    v = _conv1d_as_dense(sd, f"{prefix}.attn.proj.2")
    merge = _conv1d_as_dense(sd, f"{prefix}.attn.merge")
    perm = _head_perm(q["kernel"].shape[1], num_heads)
    for p in (q, k, v):
        p["kernel"] = p["kernel"][:, perm]
        p["bias"] = p["bias"][perm]
    merge["kernel"] = merge["kernel"][perm, :]
    return {
        "attn": {"proj_q": q, "proj_k": k, "proj_v": v, "merge": merge},
        "mlp": _mlp_params(sd, f"{prefix}.mlp", 2, norm),
    }


def superpoint_from_torch(state_dict: dict) -> dict:
    """SuperPoint state dict -> the SuperPoint parameter tree."""
    names = [
        "conv1a", "conv1b", "conv2a", "conv2b",
        "conv3a", "conv3b", "conv4a", "conv4b",
        "convPa", "convPb", "convDa", "convDb",
    ]
    return {"params": {n: _conv2d(state_dict, n) for n in names}}


def superglue_from_torch(state_dict: dict, num_layers: int = 9) -> dict:
    """SuperGlue state dict -> the SuperGlue parameter tree. The reference
    layer list is a flat ModuleList of 2*num_layers entries alternating
    self / cross (superglue.py:158-165 and the default config)."""
    sd = state_dict
    params = {
        "kenc": _mlp_params(sd, "kenc.encoder", 5, "batch"),
        "final_proj": _conv1d_as_dense(sd, "final_proj"),
        "bin_score": _to_np(sd["bin_score"]),
    }
    for i in range(num_layers):
        params[f"self_{i}"] = _attn_propagation(sd, f"gnn.layers.{2 * i}", "batch")
        params[f"cross_{i}"] = _attn_propagation(sd, f"gnn.layers.{2 * i + 1}", "batch")
    return {"params": params}


def gats_spg_from_torch(state_dict: dict, num_blocks: int = 4) -> dict:
    """GATsSPG state dict -> the GATsSPG parameter tree. The reference
    layer list is ['GATs', 'self', 'cross'] * num_blocks at
    gnn.layers.{3k, 3k+1, 3k+2} (GATs_SuperGlue.py:52-64,184); the unused
    keypoint encoders (kenc_2d / kenc_3d) and bin_score are ignored.
    Raw module names or Lightning 'matcher.' / 'model.' / 'module.'
    prefixed ones."""
    sd = {}
    for k, v in state_dict.items():
        for pre in ("matcher.", "model.", "module."):
            if k.startswith(pre):
                k = k[len(pre):]
        sd[k] = v
    params = {"final_proj": _conv1d_as_dense(sd, "final_proj")}
    for blk in range(num_blocks):
        base = 3 * blk
        params[f"gats_{blk}"] = {
            "W": _to_np(sd[f"gnn.layers.{base}.W"]),
            "a": _to_np(sd[f"gnn.layers.{base}.a"]),
        }
        params[f"self_{blk}"] = _attn_propagation(sd, f"gnn.layers.{base + 1}", "instance")
        params[f"cross_{blk}"] = _attn_propagation(sd, f"gnn.layers.{base + 2}", "instance")
    return {"params": params}


CONVERTERS = {
    "superpoint": superpoint_from_torch,
    "superglue": superglue_from_torch,
    "gats_spg": gats_spg_from_torch,
}


def load_torch_state_dict(path: str) -> dict:
    """The state_dict of a PyTorch weight file (.pth / .tar / .pt / .ckpt):
    the file itself, or its "state_dict" entry (a Lightning checkpoint).
    weights_only=False, as the JAX package's `convert` reads them:
    Lightning checkpoints hold objects that are not tensors. Load only
    files you trust."""
    import torch

    sd = torch.load(path, map_location="cpu", weights_only=False)
    return sd.get("state_dict", sd)
