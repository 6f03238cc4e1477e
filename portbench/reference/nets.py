"""Plain reference of the three networks the benchmark times: SuperPoint
(with keypoint extraction's pieces), the GATsSPG 2D-3D matcher and the
SuperGlue 2D-2D matcher with log-space Sinkhorn.

Written from the published descriptions as the port implements them, over
a flat dict of weights keyed by the port's parameter names (`*_specs` list
them), in fp32 with no kernel, cache or fusion. It imports nothing of the
port. The caller turns TF32 off (`run.fp32_context`) unless it wants the
TF32 control.

`q` rounds each operand of a product (convolution, linear layer, attention
contraction) before it is taken in fp32, and the matcher's activations
where a block hands them on: the identity for the reference, `fp8_round`
for the control of a bf16 configuration (per-tensor scaled float8 e4m3,
as fp8 inference feeds its GEMMs), `tf32_round` for that of an fp32 one
(TF32's 10-bit mantissa, as the tensor cores take fp32 operands).
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

NEG_INF = -1e9


def ident(x: torch.Tensor) -> torch.Tensor:
    return x


def fp8_round(x: torch.Tensor) -> torch.Tensor:
    """x through float8 e4m3 with one scale for the tensor (its absolute
    maximum maps to 448, the format's largest), held as fp32."""
    x = x.float()
    scale = x.abs().amax().clamp(min=1e-30) / 448.0
    return (x / scale).to(torch.float8_e4m3fn).float() * scale


def tf32_round(x: torch.Tensor) -> torch.Tensor:
    """x rounded to TF32 (10 mantissa bits, to nearest, ties to even), held
    as fp32."""
    i = x.float().contiguous().view(torch.int32)
    i = (i + 0x0FFF + ((i >> 13) & 1)) & -0x2000
    return i.view(torch.float32)


# ----------------------------------------------------------------- weights

def _fan_bound(fan_in: int) -> float:
    """PyTorch's default Conv / Linear init draws U(-b, b), b = 1 / sqrt(fan_in)."""
    return 1.0 / math.sqrt(fan_in)


def _dense_specs(name: str, cin: int, cout: int, bias_scale: float = 1.0) -> list:
    b = _fan_bound(cin)
    return [(f"{name}.weight", (cout, cin), b), (f"{name}.bias", (cout,), b * bias_scale)]


def superpoint_specs(descriptor_dim: int = 256, bias_scale: float = 1.0, gain: float = 1.0) -> list:
    """[(name, shape, bound)] of SuperPoint's parameters; each is drawn
    U(-bound, bound): the weights at `gain` times PyTorch's default bound
    (sqrt(6) is He's uniform init, which keeps a ReLU stack's scale), the
    biases at `bias_scale` times the default."""
    out = []
    for name, cin, cout, k in (("conv1a", 1, 64, 3), ("conv1b", 64, 64, 3),
                               ("conv2a", 64, 64, 3), ("conv2b", 64, 64, 3),
                               ("conv3a", 64, 128, 3), ("conv3b", 128, 128, 3),
                               ("conv4a", 128, 128, 3), ("conv4b", 128, 128, 3),
                               ("convPa", 128, 256, 3), ("convPb", 256, 65, 1),
                               ("convDa", 128, 256, 3), ("convDb", 256, descriptor_dim, 1)):
        b = _fan_bound(cin * k * k)
        out += [(f"{name}.weight", (cout, cin, k, k), b * gain),
                (f"{name}.bias", (cout,), b * bias_scale)]
    return out


def zero_mean_filters(params: dict) -> dict:
    """Each convolution filter less its mean over its taps, so that a
    uniform patch gives no response: with filters drawn at random, the
    descriptors of different places are then as distinct as a trained
    detector's, where raw draws make every descriptor nearly the same."""
    return {k: v - v.mean(dim=(1, 2, 3), keepdim=True) if v.dim() == 4 else v
            for k, v in params.items()}


def _propagation_specs(name: str, c: int, batch_norm: bool, out_scale: float = 1.0,
                       bias_scale: float = 1.0) -> list:
    out = []
    for p in ("proj_q", "proj_k", "proj_v", "merge"):
        out += _dense_specs(f"{name}.attn.{p}", c, c, bias_scale)
    if batch_norm:
        out += [(f"{name}.mlp.bn_scale_0", (2 * c,), None), (f"{name}.mlp.bn_bias_0", (2 * c,), 0.0)]
    last = [(n, shape, b * out_scale)
            for n, shape, b in _dense_specs(f"{name}.mlp.dense_1", 2 * c, c, bias_scale)]
    return out + _dense_specs(f"{name}.mlp.dense_0", 2 * c, 2 * c, bias_scale) + last


def gats_spg_specs(c: int = 256, blocks: int = 4, mlp_out_scale: float = 1.0,
                   bias_scale: float = 1.0) -> list:
    """GATsSPG's parameters. The GATs W and a take Xavier-normal's
    standard deviation as a uniform's (bound = std * sqrt(3)); each
    propagation MLP's output layer is drawn at `mlp_out_scale` times the
    default bound, so that the residual stream can keep a descriptor's
    identity through the blocks, as a trained matcher's does; the Dense
    layers' biases at `bias_scale` times theirs (a random bias is a
    direction common to every point, which masks their differences)."""
    out = []
    for blk in range(blocks):
        out += [(f"gats_{blk}.W", (c, c), math.sqrt(2.0 / (2 * c)) * math.sqrt(3.0)),
                (f"gats_{blk}.a", (2 * c, 1), math.sqrt(2.0 / (2 * c + 1)) * math.sqrt(3.0))]
        out += _propagation_specs(f"self_{blk}", c, False, mlp_out_scale, bias_scale)
        out += _propagation_specs(f"cross_{blk}", c, False, mlp_out_scale, bias_scale)
    return out + _dense_specs("final_proj", c, c, bias_scale)


def superglue_specs(c: int = 256, layers: int = 9, encoder=(32, 64, 128, 256),
                    final_proj_scale: float = 1.0) -> list:
    """SuperGlue's parameters; a bound of None is the constant 1 (the
    folded batch norms' scales and the dustbin score), 0.0 the constant 0.
    The final projection is drawn at `final_proj_scale` times the default
    bound: at the default, 18 random layers leave scores within about 0.2
    of each other, so that Sinkhorn settles in a few iterations and no pair
    is matched, where a trained matcher's scores spread by tens."""
    out = [("bin_score", (), None)]
    widths = [3, *encoder, c]
    for i in range(len(widths) - 1):
        if i < len(widths) - 2:
            out += [(f"kenc.bn_scale_{i}", (widths[i + 1],), None),
                    (f"kenc.bn_bias_{i}", (widths[i + 1],), 0.0)]
        out += _dense_specs(f"kenc.dense_{i}", widths[i], widths[i + 1])
    for i in range(layers):
        out += _propagation_specs(f"self_{i}", c, True)
        out += _propagation_specs(f"cross_{i}", c, True)
    return out + [(n, shape, b * final_proj_scale)
                  for n, shape, b in _dense_specs("final_proj", c, c)]


# ------------------------------------------------------------------ layers

def dense(p: dict, name: str, x: torch.Tensor, q=ident) -> torch.Tensor:
    return F.linear(q(x), q(p[f"{name}.weight"])) + p[f"{name}.bias"]


def instance_norm(x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """Over the point axis of [B, N, C], every point (padded ones too)."""
    mean = x.mean(dim=1, keepdim=True)
    var = x.var(dim=1, keepdim=True, unbiased=False)
    return (x - mean) * torch.rsqrt(var + eps)


def mlp(p: dict, name: str, x: torch.Tensor, n_layers: int, batch_norm: bool, q=ident):
    for i in range(n_layers):
        x = dense(p, f"{name}.dense_{i}", x, q)
        if i < n_layers - 1:
            x = (x * p[f"{name}.bn_scale_{i}"] + p[f"{name}.bn_bias_{i}"] if batch_norm
                 else instance_norm(x))
            x = F.relu(x)
    return x


def linear_attention(qh, kh, vh, kv_mask, q=ident, eps: float = 1e-6):
    """elu + 1 feature map; values over M and multiplied back."""
    m = vh.shape[1]
    phi_q, phi_k = F.elu(qh) + 1.0, F.elu(kh) + 1.0
    if kv_mask is not None:
        phi_k = phi_k * kv_mask.float()[:, :, None, None]
    kv = torch.einsum("bmhd,bmhe->bhde", q(phi_k), q(vh / m))
    z = 1.0 / (torch.einsum("bnhd,bhd->bnh", phi_q, phi_k.sum(dim=1)) + eps)
    return torch.einsum("bnhd,bhde->bnhe", q(phi_q), q(kv)) * (z[..., None] * m)


def softmax_attention(qh, kh, vh, kv_mask, q=ident):
    logits = torch.einsum("bnhd,bmhd->bhnm", q(qh), q(kh)) / math.sqrt(qh.shape[-1])
    if kv_mask is not None:
        logits = logits.masked_fill(~kv_mask[:, None, None, :], NEG_INF)
    return torch.einsum("bhnm,bmhd->bnhd", q(torch.softmax(logits, dim=-1)), q(vh))


def propagate(p, name, x, source, source_mask, heads, kind, batch_norm, q=ident):
    """One attentional propagation: the message over `source`, then the
    MLP on [x, message]; the caller adds the residual."""
    b, n, c = x.shape
    m = source.shape[1]
    hd = c // heads
    qh = dense(p, f"{name}.attn.proj_q", x, q).reshape(b, n, heads, hd)
    kh = dense(p, f"{name}.attn.proj_k", source, q).reshape(b, m, heads, hd)
    vh = dense(p, f"{name}.attn.proj_v", source, q).reshape(b, m, heads, hd)
    attend = softmax_attention if kind == "softmax" else linear_attention
    msg = dense(p, f"{name}.attn.merge", attend(qh, kh, vh, source_mask, q).reshape(b, n, c), q)
    return mlp(p, f"{name}.mlp", torch.cat([x, msg], dim=-1), 2, batch_norm, q)


def l2_normalize(x: torch.Tensor, dim: int = -1) -> torch.Tensor:
    return x / torch.linalg.vector_norm(x, dim=dim, keepdim=True).clamp(min=1e-12)


# -------------------------------------------------------------- SuperPoint

def max_pool(x: torch.Tensor, r: int) -> torch.Tensor:
    return F.max_pool2d(x[:, None], 2 * r + 1, stride=1, padding=r)[:, 0]


def simple_nms(scores: torch.Tensor, r: int) -> torch.Tensor:
    """Max-pool NMS with two refinement rounds, on [B, H, W]."""
    zeros = torch.zeros_like(scores)
    max_mask = scores == max_pool(scores, r)
    for _ in range(2):
        supp_mask = max_pool(max_mask.float(), r) > 0
        supp_scores = torch.where(supp_mask, zeros, scores)
        new_max = supp_scores == max_pool(supp_scores, r)
        max_mask = max_mask | (new_max & ~supp_mask)
    return torch.where(max_mask, scores, zeros)


def _conv(p, name, x, q):
    w = p[f"{name}.weight"]
    return F.conv2d(q(x), q(w), padding=w.shape[-1] // 2) + p[f"{name}.bias"][:, None, None]


def superpoint(p: dict, images: torch.Tensor, nms_radius: int = 4, q=ident) -> dict:
    """images [B, H, W, 1] -> prob [B, H, W] (the detector's softmax,
    dustbin dropped, depth-to-space, before NMS), score [B, H, W] (after
    NMS) and desc [B, H/8, W/8, C] (L2-normalised per cell)."""
    x = images.float().permute(0, 3, 1, 2)
    for s, (a, b) in enumerate((("conv1a", "conv1b"), ("conv2a", "conv2b"),
                                ("conv3a", "conv3b"), ("conv4a", "conv4b"))):
        x = F.relu(_conv(p, b, F.relu(_conv(p, a, x, q)), q))
        if s < 3:
            x = F.max_pool2d(x, 2, 2)
    logits = _conv(p, "convPb", F.relu(_conv(p, "convPa", x, q)), q)
    probs = torch.softmax(logits, dim=1)[:, :-1]
    bsz, _, h, w = probs.shape
    prob = probs.reshape(bsz, 8, 8, h, w).permute(0, 3, 1, 4, 2).reshape(bsz, h * 8, w * 8)
    desc = l2_normalize(_conv(p, "convDb", F.relu(_conv(p, "convDa", x, q)), q), dim=1)
    return {"prob": prob, "score": simple_nms(prob, nms_radius), "desc": desc.permute(0, 2, 3, 1)}


def gated_scores(score: torch.Tensor, threshold: float, border: int) -> torch.Tensor:
    """The NMS'd map with the border and the threshold applied (0 elsewhere)."""
    _, H, W = score.shape
    ys = torch.arange(H, device=score.device)[None, :, None]
    xs = torch.arange(W, device=score.device)[None, None, :]
    inside = (ys >= border) & (ys < H - border) & (xs >= border) & (xs < W - border)
    return torch.where(inside & (score > threshold), score, 0.0)


def select_keypoints(score: torch.Tensor, k: int, threshold: float, border: int) -> dict:
    """The top k of the gated map: keypoints [B, k, 2] (x, y), scores, mask."""
    _, H, W = score.shape
    vals, idx = torch.topk(gated_scores(score, threshold, border).flatten(1), k, dim=1)
    kp = torch.stack([(idx % W).float(), (idx // W).float()], dim=-1)
    mask = vals > threshold
    return {"keypoints": kp * mask[..., None], "scores": vals * mask, "mask": mask}


def sample_descriptors(keypoints: torch.Tensor, desc_map: torch.Tensor, stride: int = 8):
    """Bilinear sampling of [B, h, w, C] at full-resolution (x, y) pixels
    (grid_sample with align_corners=True through the published
    normalisation; outside corners read 0), then L2-normalised."""
    b, hf, wf, c = desc_map.shape
    s = float(stride)
    kp = keypoints.float() - s / 2 + 0.5
    fx = kp[..., 0] / (wf * s - s / 2 - 0.5) * (wf - 1)
    fy = kp[..., 1] / (hf * s - s / 2 - 0.5) * (hf - 1)
    x0, y0 = torch.floor(fx), torch.floor(fy)
    wx, wy = (fx - x0)[..., None], (fy - y0)[..., None]
    x0, y0 = x0.long(), y0.long()
    flat = desc_map.reshape(b, hf * wf, c)

    def at(yi, xi):
        ok = ((xi >= 0) & (xi < wf) & (yi >= 0) & (yi < hf)).float()[..., None]
        idx = (yi.clamp(0, hf - 1) * wf + xi.clamp(0, wf - 1))[..., None].expand(-1, -1, c)
        return torch.gather(flat, 1, idx) * ok

    d = (at(y0, x0) * (1 - wx) * (1 - wy) + at(y0, x0 + 1) * wx * (1 - wy)
         + at(y0 + 1, x0) * (1 - wx) * wy + at(y0 + 1, x0 + 1) * wx * wy)
    return l2_normalize(d)


# ------------------------------------------------------------------ GATsSPG

def gats(p, blk, leaves, x3, leaf_mask, q=ident, alpha: float = 0.2):
    """GATs leaf aggregation (self column included, no linear transform,
    ELU): softmax over [self, leaves] of LeakyReLU(a_l . W h + a_r . W h3)."""
    c = x3.shape[-1]
    W, a = p[f"gats_{blk}.W"], p[f"gats_{blk}.a"][:, 0]
    e_leaf = q(leaves) @ q(W @ a[:c])
    e_3d = q(x3) @ q(W @ a[c:])
    logits = F.leaky_relu(torch.cat([e_3d[..., None], e_leaf], dim=-1) + e_3d[..., None], alpha)
    if leaf_mask is not None:
        full = torch.cat([torch.ones_like(leaf_mask[..., :1]), leaf_mask], dim=-1)
        logits = logits.masked_fill(~full, NEG_INF)
    attn = torch.softmax(logits, dim=-1)
    values = torch.cat([x3[..., None, :], leaves], dim=-2)
    return F.elu(torch.einsum("bnl,bnlc->bnc", q(attn), q(values)))


def gats_spg_gnn(p, desc2d, desc3d, leaf_desc, mask2d, mask3d, leaf_mask, blocks: int = 4,
                 heads: int = 4, q=ident) -> tuple:
    """The matcher's `blocks` [GATs, self, cross] blocks: (x2, x3). Each
    block's outputs go through q, as a program in a lower precision keeps
    them between blocks."""
    x2, x3, leaves = desc2d.float(), desc3d.float(), leaf_desc.float()
    for blk in range(blocks):
        x3 = gats(p, blk, leaves, x3, leaf_mask, q)
        x2 = x2 + propagate(p, f"self_{blk}", x2, x2, mask2d, heads, "linear", False, q)
        x3 = x3 + propagate(p, f"self_{blk}", x3, x3, mask3d, heads, "linear", False, q)
        d2 = propagate(p, f"cross_{blk}", x2, x3, mask3d, heads, "linear", False, q)
        d3 = propagate(p, f"cross_{blk}", x3, x2, mask2d, heads, "linear", False, q)
        x2, x3 = q(x2 + d2), q(x3 + d3)
    return x2, x3


def gats_spg_conf(p, x2, x3, mask2d, mask3d, scale_factor: float = 0.07, q=ident):
    """The matcher's head: the dual-softmax confidence [B, N2, N3] (masked
    rows and columns at NEG_INF before both softmaxes)."""
    m2 = l2_normalize(dense(p, "final_proj", x2, q))
    m3 = l2_normalize(dense(p, "final_proj", x3, q))
    scores = torch.einsum("bnc,bmc->bnm", q(m2), q(m3)) / scale_factor
    scores = scores.masked_fill(~mask2d[:, :, None], NEG_INF).masked_fill(
        ~mask3d[:, None, :], NEG_INF)
    return torch.softmax(scores, dim=1) * torch.softmax(scores, dim=2)


def mutual_matches(conf: torch.Tensor, threshold: float, mask0=None) -> dict:
    """Mutual max and threshold over [B, N0, N1] (first index on ties):
    matches0 (-1 unmatched) and matching_scores0."""
    n0 = conf.shape[1]
    idx0, idx1 = conf.argmax(dim=2), conf.argmax(dim=1)
    max0 = conf.amax(dim=2)
    mutual = torch.arange(n0, device=conf.device)[None] == torch.gather(idx1, 1, idx0)
    scores0 = torch.where(mutual, max0, 0.0)
    valid = mutual & (scores0 > threshold)
    if mask0 is not None:
        valid = valid & mask0
    return {"matches0": torch.where(valid, idx0, -1), "matching_scores0": scores0}


# ---------------------------------------------------------------- SuperGlue

def normalize_keypoints(kpts: torch.Tensor, hw: tuple) -> torch.Tensor:
    h, w = hw
    size = torch.tensor([w, h], dtype=torch.float32, device=kpts.device)
    return (kpts.float() - size / 2.0) / (max(h, w) * 0.7)


def superglue_scores(p, kpts0, kpts1, desc0, desc1, scores0, scores1, hw, mask0, mask1,
                     layers: int = 9, heads: int = 4, encoder_layers: int = 5, q=ident):
    """SuperGlue's GNN: keypoint encoder, `layers` (self, cross) pairs of
    softmax attention, final projection; scores <m0, m1> / sqrt(C)."""
    x0, x1 = desc0.float(), desc1.float()
    enc = lambda k, s: mlp(p, "kenc", torch.cat([normalize_keypoints(k, hw), s.float()[..., None]],
                                                dim=-1), encoder_layers, True, q)  # noqa: E731
    x0, x1 = x0 + enc(kpts0, scores0), x1 + enc(kpts1, scores1)
    for i in range(layers):
        x0 = x0 + propagate(p, f"self_{i}", x0, x0, mask0, heads, "softmax", True, q)
        x1 = x1 + propagate(p, f"self_{i}", x1, x1, mask1, heads, "softmax", True, q)
        d0 = propagate(p, f"cross_{i}", x0, x1, mask1, heads, "softmax", True, q)
        d1 = propagate(p, f"cross_{i}", x1, x0, mask0, heads, "softmax", True, q)
        x0, x1 = x0 + d0, x1 + d1
    m0, m1 = dense(p, "final_proj", x0, q), dense(p, "final_proj", x1, q)
    return torch.einsum("bnc,bmc->bnm", q(m0), q(m1)) / math.sqrt(x0.shape[-1])


def log_sinkhorn(scores, bin_score, mask0, mask1, iters: int) -> torch.Tensor:
    """Masked log-space Sinkhorn with a dustbin row and column: the
    [B, M+1, N+1] log-assignment scaled by (m + n)."""
    b, m, n = scores.shape
    dev = scores.device
    ms, ns = mask0.sum(-1).float(), mask1.sum(-1).float()
    neg = torch.full((), NEG_INF, device=dev)
    bin_score = bin_score.float()
    inner = torch.where(mask0[:, :, None] & mask1[:, None, :], scores.float(), neg)
    bins0 = torch.where(mask0, bin_score, neg)[:, :, None]
    bins1 = torch.where(mask1, bin_score, neg)[:, None, :]
    c = torch.cat([torch.cat([inner, bins0], 2),
                   torch.cat([bins1, bin_score.expand(b, 1, 1)], 2)], 1)
    norm = -torch.log(torch.clamp(ms + ns, min=1.0))
    log_mu = torch.cat([torch.where(mask0, norm[:, None], neg),
                        (torch.log(ns.clamp(min=1e-9)) + norm)[:, None]], 1)
    log_nu = torch.cat([torch.where(mask1, norm[:, None], neg),
                        (torch.log(ms.clamp(min=1e-9)) + norm)[:, None]], 1)
    u, v = torch.zeros_like(log_mu), torch.zeros_like(log_nu)
    for _ in range(iters):
        u = log_mu - torch.logsumexp(c + v[:, None, :], dim=2)
        v = log_nu - torch.logsumexp(c + u[:, :, None], dim=1)
    return c + u[:, :, None] + v[:, None, :] - norm[:, None, None]
