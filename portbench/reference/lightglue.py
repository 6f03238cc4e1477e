"""Plain reference of LightGlue, one pair at a time.

LightGlue (Lindenberger, Sarlin, Pollefeys, ICCV 2023, arXiv 2306.13643;
cvg/LightGlue `lightglue/lightglue.py`, `LightGlue.default_conf` with the
SuperPoint features), written from its equations in plain `torch`, fp32,
with no kernel, no batching and no chunking: b = 1, every keypoint given
is valid. The weights are a flat dict keyed by upstream's state-dict
names and in upstream's layout (`specs` lists them): `Wqkv`'s output
channel 3 * (D * h + j) + s is head h, channel j of q (s = 0), k (1) or
v (2). The caller turns TF32 off unless it wants it.

Per pair, d = 256, H = 4 heads of D = 64, L = 9 layers:
- keypoints k in pixels, image size (w, h): k' = (k - size / 2) / (max(w, h) / 2);
  the input projection is the identity (256 -> 256);
- rotary encoding p = k' Wr^T ([32, 2], no bias), cos p and sin p each
  repeated twice along the channels to D, one for every head;
- a layer: a self block on each image (shared weights), then the cross
  block. Self: q, k, v from `Wqkv`, q and k rotated
  (t cos + rotate_half(t) sin), softmax(q k^T / sqrt(D)) v per head,
  `out_proj`, x + FFN([x | message]). Cross: qk and v of each image from
  `to_qk` and `to_v`; one S = qk0 qk1^T / sqrt(D) per head, softmaxed
  along its rows for image 0's message and along its columns for image
  1's; `to_out`, x + FFN. FFN: Linear(2d, 2d), LayerNorm (eps 1e-5,
  affine), GELU (erf), Linear(2d, d);
- after layer l < L - 1: token confidence c = sigmoid(token_l(x)); the
  pair stops when 1 - #{c < tau_l} / (m + n) > depth_confidence, m and n
  the pair's keypoints at the start (pruned points count as confident),
  tau_l = clip(0.8 + 0.1 exp(-4 l / L), 0, 1); else each image with more
  than `pruning_min_keypoints` points keeps those with
  sigmoid(matchability_l(x)) > 1 - width_confidence or c <= tau_l;
- the assignment of the last layer run: f = final_proj(x) / d^(1/4),
  S = f0 f1^T, z = matchability(x), P[i, j] = log_softmax_j(S) +
  log_softmax_i(S) + log sigmoid(z0_i) + log sigmoid(z1_j), the dustbins
  log sigmoid(-z); mutual argmax of P with exp(P) > filter_threshold.

`q` rounds each operand of a product (a linear layer, an attention or
assignment contraction) before it is taken in fp32: the identity for the
reference, TF32 rounding for the control of an fp32 configuration.

`program`, when given, is what a program under test decided for this
pair, in the pair's own keypoint order: {"stopped_at": the layer after
which it stopped, or -1; "pruned_at0" / "pruned_at1": [m] / [n], the
layer after which each keypoint was dropped, or -1}. A decision whose
margin, in the logit of the sigmoid it thresholds, is under `eps` is
then taken from the program (taught); one that differs outside it is
counted (`stop_faults`, `kept_faults`) and the reference keeps its own.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

CONF = {"descriptor_dim": 256, "num_heads": 4, "n_layers": 9, "depth_confidence": 0.95,
        "width_confidence": 0.99, "filter_threshold": 0.1, "pruning_min_keypoints": 1536}


def ident(x: torch.Tensor) -> torch.Tensor:
    return x


def specs(c: int = 256, heads: int = 4, layers: int = 9) -> list:
    """[(name, shape, bound)] of LightGlue's parameters under upstream's
    names: PyTorch's default U(-1/sqrt(fan_in), 1/sqrt(fan_in)) for the
    linear layers, sqrt(3) for `posenc.Wr` (unit variance, as upstream's
    normal init), LayerNorm's weight 1 (None) and bias 0 (0.0)."""
    head = c // heads

    def dense(name, cin, cout, bias=True):
        b = 1.0 / math.sqrt(cin)
        return [(f"{name}.weight", (cout, cin), b)] + ([(f"{name}.bias", (cout,), b)]
                                                       if bias else [])

    def ffn(name):
        return (dense(f"{name}.0", 2 * c, 2 * c)
                + [(f"{name}.1.weight", (2 * c,), None), (f"{name}.1.bias", (2 * c,), 0.0)]
                + dense(f"{name}.3", 2 * c, c))

    out = [("posenc.Wr.weight", (head // 2, 2), math.sqrt(3.0))]
    for i in range(layers):
        s, x = f"transformers.{i}.self_attn", f"transformers.{i}.cross_attn"
        out += dense(f"{s}.Wqkv", c, 3 * c) + dense(f"{s}.out_proj", c, c) + ffn(f"{s}.ffn")
        out += (dense(f"{x}.to_qk", c, c) + dense(f"{x}.to_v", c, c) + dense(f"{x}.to_out", c, c)
                + ffn(f"{x}.ffn"))
    for i in range(layers):
        out += (dense(f"log_assignment.{i}.matchability", c, 1)
                + dense(f"log_assignment.{i}.final_proj", c, c))
    for i in range(layers - 1):
        out += dense(f"token_confidence.{i}.token.0", c, 1)
    return out


def confidence_threshold(layer: int, n_layers: int) -> float:
    return min(max(0.8 + 0.1 * math.exp(-4.0 * layer / n_layers), 0.0), 1.0)


def logit(p: float) -> float:
    return math.log(p) - math.log1p(-p)


def normalize_keypoints(kpts: torch.Tensor, size) -> torch.Tensor:
    """kpts [n, 2] (x, y) pixels; size (w, h)."""
    size = torch.tensor(size, dtype=kpts.dtype, device=kpts.device)
    return (kpts - size / 2) / (size.max() / 2)


def linear(w: dict, name: str, x: torch.Tensor, q=ident) -> torch.Tensor:
    y = q(x) @ q(w[f"{name}.weight"]).T
    b = w.get(f"{name}.bias")
    return y if b is None else y + b


def rotate_half(t: torch.Tensor) -> torch.Tensor:
    t1, t2 = t.unflatten(-1, (-1, 2)).unbind(-1)
    return torch.stack((-t2, t1), dim=-1).flatten(start_dim=-2)


def rotary(enc: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    return t * enc[0] + rotate_half(t) * enc[1]


def posenc(w: dict, kn: torch.Tensor, q=ident) -> torch.Tensor:
    """[2, n, D]: cos and sin of the projected keypoints, each channel twice."""
    p = linear(w, "posenc.Wr", kn, q)
    return torch.stack([p.cos(), p.sin()]).repeat_interleave(2, dim=-1)


def softmax_attention(qh, kh, vh, q=ident) -> torch.Tensor:
    """[H, n, D] x [H, m, D] -> [H, n, D]."""
    s = q(qh) @ q(kh).transpose(-1, -2) / math.sqrt(qh.shape[-1])
    return q(torch.softmax(s, dim=-1)) @ q(vh)


def ffn(w: dict, name: str, x: torch.Tensor, q=ident) -> torch.Tensor:
    h = linear(w, f"{name}.0", x, q)
    h = F.layer_norm(h, (h.shape[-1],), w[f"{name}.1.weight"], w[f"{name}.1.bias"], 1e-5)
    return linear(w, f"{name}.3", F.gelu(h), q)


def self_block(w: dict, name: str, x, enc, heads: int, q=ident) -> torch.Tensor:
    qkv = linear(w, f"{name}.Wqkv", x, q).unflatten(-1, (heads, -1, 3)).transpose(0, 1)
    qh, kh, vh = qkv[..., 0], qkv[..., 1], qkv[..., 2]
    ctx = softmax_attention(rotary(enc, qh), rotary(enc, kh), vh, q)
    msg = linear(w, f"{name}.out_proj", ctx.transpose(0, 1).flatten(start_dim=-2), q)
    return x + ffn(w, f"{name}.ffn", torch.cat([x, msg], -1), q)


def cross_block(w: dict, name: str, x0, x1, heads: int, q=ident) -> tuple:
    def split(t):
        return t.unflatten(-1, (heads, -1)).transpose(0, 1)

    qk0, qk1 = split(linear(w, f"{name}.to_qk", x0, q)), split(linear(w, f"{name}.to_qk", x1, q))
    v0, v1 = split(linear(w, f"{name}.to_v", x0, q)), split(linear(w, f"{name}.to_v", x1, q))
    s = q(qk0) @ q(qk1).transpose(-1, -2) / math.sqrt(qk0.shape[-1])
    m0 = q(torch.softmax(s, dim=-1)) @ q(v1)
    m1 = q(torch.softmax(s.transpose(-1, -2), dim=-1)) @ q(v0)
    m0, m1 = (linear(w, f"{name}.to_out", t.transpose(0, 1).flatten(start_dim=-2), q)
              for t in (m0, m1))
    return (x0 + ffn(w, f"{name}.ffn", torch.cat([x0, m0], -1), q),
            x1 + ffn(w, f"{name}.ffn", torch.cat([x1, m1], -1), q))


def assignment(w: dict, layer: int, x0, x1, q=ident) -> torch.Tensor:
    """[m + 1, n + 1]: the log assignment with its dustbins."""
    name = f"log_assignment.{layer}"
    d = x0.shape[-1]
    f0 = linear(w, f"{name}.final_proj", x0, q) / d ** 0.25
    f1 = linear(w, f"{name}.final_proj", x1, q) / d ** 0.25
    s = q(f0) @ q(f1).T
    z0, z1 = linear(w, f"{name}.matchability", x0, q), linear(w, f"{name}.matchability", x1, q)
    m, n = s.shape
    p = s.new_zeros((m + 1, n + 1))
    p[:m, :n] = (F.log_softmax(s, 1) + F.log_softmax(s, 0) + F.logsigmoid(z0)
                 + F.logsigmoid(z1).T)
    p[:m, n] = F.logsigmoid(-z0[:, 0])
    p[m, :n] = F.logsigmoid(-z1[:, 0])
    return p


def filter_matches(p: torch.Tensor, threshold: float) -> tuple:
    """(matches0 [m], matches1 [n], scores0 [m]) of the log assignment:
    mutual argmax over the inner block with exp(P) over the threshold."""
    inner = p[:-1, :-1]
    max0, max1 = inner.max(1), inner.max(0)
    m0, m1 = max0.indices, max1.indices
    mutual0 = torch.arange(m0.shape[0], device=p.device) == m1[m0]
    mutual1 = torch.arange(m1.shape[0], device=p.device) == m0[m1]
    zero = p.new_tensor(0.0)
    ms0 = torch.where(mutual0, max0.values.exp(), zero)
    valid0 = mutual0 & (ms0 > threshold)
    valid1 = mutual1 & valid0[m1]
    return torch.where(valid0, m0, -1), torch.where(valid1, m1, -1), ms0


def _taught(ref: torch.Tensor, prog, near: torch.Tensor, tally: dict, fault: str) -> torch.Tensor:
    """The decision the reference goes on with: the program's where the
    margin is under eps, its own elsewhere; tallies both kinds of gap."""
    if prog is None:
        return ref
    differ = prog != ref
    tally["taught"] += int((differ & near).sum())
    tally[fault] += int((differ & ~near).sum())
    return torch.where(near, prog, ref)


def match_pair(w: dict, kpts0, kpts1, desc0, desc1, size0, size1, conf: dict = CONF, q=ident,
               program: dict = None, eps: float = 0.0) -> dict:
    """LightGlue on one pair: kpts [m, 2] and [n, 2] pixels, desc [m, d]
    and [n, d], sizes (w, h). Returns {"layers": layers run, "stopped_at",
    "pruned_at0" / "pruned_at1" (as `program`), "scores": P over the kept
    points, "ind0" / "ind1": their indices, "matches0" [m] / "matches1"
    [n] (-1 unmatched), "taught", "stop_faults", "kept_faults"}."""
    heads, n_layers = conf["num_heads"], conf["n_layers"]
    dc, wc = conf["depth_confidence"], conf["width_confidence"]
    m, n = kpts0.shape[0], kpts1.shape[0]
    dev = kpts0.device
    x = [desc0.float(), desc1.float()]
    enc = [posenc(w, normalize_keypoints(kpts0.float(), size0), q),
           posenc(w, normalize_keypoints(kpts1.float(), size1), q)]
    ind = [torch.arange(m, device=dev), torch.arange(n, device=dev)]
    pruned = [torch.full((m,), -1, dtype=torch.long, device=dev),
              torch.full((n,), -1, dtype=torch.long, device=dev)]
    tally = {"taught": 0, "stop_faults": 0, "kept_faults": 0}
    layers, stopped_at, last = 0, -1, 0
    for i in range(n_layers):
        if x[0].shape[0] == 0 or x[1].shape[0] == 0:
            break
        blk = f"transformers.{i}"
        x = [self_block(w, f"{blk}.self_attn", x[a], enc[a], heads, q) for a in (0, 1)]
        x = list(cross_block(w, f"{blk}.cross_attn", x[0], x[1], heads, q))
        layers, last = i + 1, i
        if i == n_layers - 1:
            break
        tau = confidence_threshold(i, n_layers)
        t = c = None
        if dc > 0:
            t = [linear(w, f"token_confidence.{i}.token.0", xa, q)[:, 0] for xa in x]
            c = [torch.sigmoid(ta) for ta in t]
            unconf = sum((ca < tau).float().sum() for ca in c)
            stop = bool(1.0 - unconf / (m + n) > dc)
            if program is not None:
                lo = sum(int((ta < logit(tau) - eps).sum()) for ta in t)
                hi = sum(int((ta < logit(tau) + eps).sum()) for ta in t)
                near = (1.0 - hi / (m + n) > dc) != (1.0 - lo / (m + n) > dc)
                stop = bool(_taught(torch.tensor(stop), torch.tensor(program["stopped_at"] == i),
                                    torch.tensor(near), tally, "stop_faults"))
            if stop:
                stopped_at = i
                break
        for a in (0, 1):
            keep = torch.ones(x[a].shape[0], dtype=torch.bool, device=dev)
            near = torch.zeros_like(keep)
            if wc > 0 and x[a].shape[0] > conf["pruning_min_keypoints"]:
                z = linear(w, f"log_assignment.{i}.matchability", x[a], q)[:, 0]
                keep = torch.sigmoid(z) > 1 - wc
                if c is not None:
                    keep = keep | (c[a] <= tau)
                if program is not None:
                    gz = z - logit(1 - wc)
                    sure_keep, sure_drop = gz > eps, gz < -eps
                    if t is not None:
                        gt = logit(tau) - t[a]
                        sure_keep, sure_drop = sure_keep | (gt > eps), sure_drop & (gt < -eps)
                    near = ~(sure_keep | sure_drop)
            if program is not None:
                pa = program[f"pruned_at{a}"][ind[a]]
                keep = _taught(keep, (pa < 0) | (pa > i), near, tally, "kept_faults")
            pruned[a][ind[a][~keep]] = i
            ind[a], x[a], enc[a] = ind[a][keep], x[a][keep], enc[a][:, keep]
    out = {"layers": layers, "stopped_at": stopped_at, "pruned_at0": pruned[0],
           "pruned_at1": pruned[1], "ind0": ind[0], "ind1": ind[1], **tally}
    if x[0].shape[0] == 0 or x[1].shape[0] == 0:
        out.update(scores=None, matches0=torch.full((m,), -1, dtype=torch.long, device=dev),
                   matches1=torch.full((n,), -1, dtype=torch.long, device=dev))
        return out
    p = assignment(w, last, x[0], x[1], q)
    mm0, mm1, _ = filter_matches(p, conf["filter_threshold"])
    matches0 = torch.full((m,), -1, dtype=torch.long, device=dev)
    matches1 = torch.full((n,), -1, dtype=torch.long, device=dev)
    matches0[ind[0]] = torch.where(mm0 >= 0, ind[1][mm0.clamp(min=0)], -1)
    matches1[ind[1]] = torch.where(mm1 >= 0, ind[0][mm1.clamp(min=0)], -1)
    out.update(scores=p, matches0=matches0, matches1=matches1)
    return out
