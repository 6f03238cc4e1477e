"""Operations and bytes of the timed layers, counted from shapes: the
benchmark's yardstick for rooflines and for the share of the chip's peak.

The serving stages (`superpoint_dense`, `extract_keypoints`,
`gats_spg_matcher`, `ransac_pnp`, `pose_pipeline`) are a frozen copy of
the port's `utils/costs.py`, whose counts the port's tests hold against
XLA's within a few percent. Added here: the split of a count into matrix
operations, elementwise operations and bytes (`Work`), the VGG stages
that K5 runs, the fused GATsSPG blocks that K4 runs, SuperGlue's GNN and
the log-space Sinkhorn iterations that K7 runs.

What is counted, as in the copy:
- a convolution or a Dense layer: 2 * k^2 * cin * cout per output pixel or
  point (a multiply and an add per weight); biases, ReLUs and pools are
  left out;
- an einsum: 2 per multiply-add;
- the match head's softmaxes: `DUAL_SOFTMAX_OPS` per element of the
  [B, N2, N3] scores; RANSAC-PnP's geometry: loosely, per hypothesis and
  per point (see `ransac_pnp`).
A sort, a top-k, a gather, a threshold or a mask counts as bytes only.
The new counts take the fewest elementwise operations the mathematics
needs (an exp, an add and a sum term per coupling entry and half-step of
Sinkhorn; one exp per attention logit), so a roofline share can only be
read low, never above 100%.

Bytes follow the roofline rule: each input read once and each output
written once, at its dtype's width, whatever the kernels read again;
what stays inside a stage is not counted. Weights count at the compute
dtype's width, as the kernels read them.

The bound of a `Work` is the largest of its matrix operations at the bf16
peak (whatever the precision, so a change of precision cannot read above
100%), its elementwise operations at the fp32 peak, and its bytes at the
memory rate (H100 SXM, NVIDIA's data sheet, dense, at 700 W).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

# H100 SXM, NVIDIA's data sheet: dense rates without sparsity, at 700 W.
PEAK_BF16_FLOPS = 989e12
PEAK_FP32_FLOPS = 67e12
PEAK_BYTES_PER_S = 3.35e12

DUAL_SOFTMAX_OPS = 10  # an element: scale, two maxima, two exps, two sums, two divides, product
P3P_OPS = 600  # a hypothesis: the quartic and its four poses
REPROJ_OPS = 30  # a pose and a point: rotate, translate, project, squared error
GN_OPS = 200  # a point in one Gauss-Newton iteration: residual, 2 x 6 Jacobian, normal equations

_F32 = 4


def bound(flops: float, n_bytes: float) -> tuple[float, str]:
    """(least seconds, "operations" or "bytes"): the larger of the flops at
    the bf16 peak and the bytes at the memory rate."""
    t_ops, t_bytes = flops / PEAK_BF16_FLOPS, n_bytes / PEAK_BYTES_PER_S
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def _conv(pixels: int, k: int, cin: int, cout: int) -> tuple[int, int]:
    """(flops, parameters) of a k x k convolution over `pixels` outputs."""
    return 2 * k * k * cin * cout * pixels, k * k * cin * cout + cout


def superpoint_dense(batch: int, h: int, w: int, dtype: torch.dtype = torch.bfloat16,
                     descriptor_dim: int = 256) -> tuple[int, int]:
    """SuperPoint's dense forward on [batch, h, w, 1]: the eight encoder
    convs (the four VGG stages, each at its own resolution) and the two
    convs of each head at 1/8. Bytes: the fp32 image, the weights, the
    fp32 score map and descriptor map."""
    flops = params = 0
    for s, (cin, cout) in enumerate(((1, 64), (64, 64), (64, 128), (128, 128))):
        px = batch * (h >> s) * (w >> s)
        for a, b in ((cin, cout), (cout, cout)):
            f, p = _conv(px, 3, a, b)
            flops, params = flops + f, params + p
    px = batch * (h // 8) * (w // 8)
    for k, cin, cout in ((3, 128, 256), (1, 256, 65), (3, 128, 256), (1, 256, descriptor_dim)):
        f, p = _conv(px, k, cin, cout)
        flops, params = flops + f, params + p
    n_bytes = (batch * h * w * _F32 + params * dtype.itemsize + px * 64 * _F32
               + px * descriptor_dim * _F32)
    return flops, n_bytes


def extract_keypoints(batch: int, h: int, w: int, n_kpts: int, c: int = 256) -> tuple[int, int]:
    """Threshold, border gate, top-k and bilinear descriptor sampling: 0
    operations by convention (a selection and a gather). Bytes: the score
    map and the descriptor map in; keypoints, scores, descriptors and the
    slot mask out."""
    maps = batch * h * w * _F32 + batch * (h // 8) * (w // 8) * c * _F32
    out = batch * n_kpts * (2 * _F32 + _F32 + c * _F32 + 1)
    return 0, maps + out


def _attention(n_x: int, n_s: int, c: int, d: int) -> int:
    """One AttentionalPropagation of n_x points over n_s source points, per
    frame: q, k, v and the merge; the linear attention's kv moments, key
    sums, normaliser and output; the MLP on [x, message] (2c -> 2c -> c)."""
    projections = 2 * (2 * n_x + 2 * n_s) * c * c
    linear = 2 * n_s * c * d + n_s * c + 2 * n_x * c + 2 * n_x * c * d
    mlp = 2 * n_x * (2 * c) * (2 * c) + 2 * n_x * (2 * c) * c
    return projections + linear + mlp


def gats_spg_matcher(batch: int, n2: int, n3: int, leaves: int, c: int = 256, heads: int = 4,
                     blocks: int = 4, dtype: torch.dtype = torch.bfloat16) -> tuple[int, int]:
    """GATsSPG: per block the GATs leaf attention (logits through W a, the
    softmax-weighted sum of self + leaves), the self-attention of each
    stream and the cross-attention each way (`_attention`); then the final
    projection of both streams, their L2 norms, the [N2, N3] similarity
    and the dual softmax. Bytes: the fp32 descriptors and leaves, the
    masks, the weights, and the [B, N2] matches and scores out."""
    d = c // heads
    gats = 2 * n3 * leaves * c + 2 * n3 * c + 2 * n3 * (leaves + 1) * c
    block = gats + (_attention(n2, n2, c, d) + _attention(n3, n3, c, d)
                    + _attention(n2, n3, c, d) + _attention(n3, n2, c, d))
    head = (2 * (n2 + n3) * c * c + 3 * (n2 + n3) * c + 2 * n2 * n3 * c
            + DUAL_SOFTMAX_OPS * n2 * n3)
    flops = batch * (blocks * block + head) + blocks * 2 * 2 * c * c  # W a, once a block
    layer = 4 * (c * c + c) + (2 * c * 2 * c + 2 * c) + (2 * c * c + c)
    params = blocks * (c * c + 2 * c + 2 * layer) + c * c + c
    inputs = batch * (n2 + n3 + n3 * leaves) * c * _F32 + batch * (n2 + n3 + n3 * leaves)
    n_bytes = inputs + params * dtype.itemsize + batch * n2 * 2 * _F32
    return flops, n_bytes


def ransac_pnp(batch: int, n_kpts: int, n_hyp: int, refine_iters: int = 5) -> tuple[int, int]:
    """RANSAC-PnP as `geometry.ransac.ransac_pnp` runs it, counted loosely:
    P3P per hypothesis, the first scoring of its four poses on 128 points,
    the second of 64 survivors on every point, the Gauss-Newton refine and
    the final error. It is a rounding error of the whole call. Bytes: the
    keypoints, points, K, mask and draws in; pose, R, t, inliers, their
    count and ok out."""
    n_sub, n_keep = min(128, n_kpts), min(64, 4 * n_hyp)
    flops = batch * (n_hyp * P3P_OPS + 4 * n_hyp * n_sub * REPROJ_OPS
                     + n_keep * n_kpts * REPROJ_OPS + refine_iters * n_kpts * GN_OPS
                     + n_kpts * REPROJ_OPS)
    inputs = batch * (n_kpts * (5 * _F32 + 1) + 9 * _F32 + n_hyp * 3 * _F32)
    outputs = batch * ((16 + 9 + 3) * _F32 + n_kpts + 8 + 1)
    return flops, inputs + outputs


def pose_pipeline(batch: int, h: int, w: int, n_kpts: int, n3: int, leaves: int, c: int = 256,
                  heads: int = 4, blocks: int = 4, n_hyp: int = 512,
                  dtype: torch.dtype = torch.bfloat16) -> tuple[int, int]:
    """The whole serving call: the sum of its four stages."""
    parts = (superpoint_dense(batch, h, w, dtype, c), extract_keypoints(batch, h, w, n_kpts, c),
             gats_spg_matcher(batch, n_kpts, n3, leaves, c, heads, blocks, dtype),
             ransac_pnp(batch, n_kpts, n_hyp))
    return sum(f for f, _ in parts), sum(b for _, b in parts)


class Work(NamedTuple):
    """What a kernel or a call must do: matrix operations, elementwise
    operations and bytes."""

    mm: float
    elem: float
    bytes: float

    def __add__(self, other):
        return Work(self.mm + other.mm, self.elem + other.elem, self.bytes + other.bytes)

    def scaled(self, k: float) -> "Work":
        return Work(self.mm * k, self.elem * k, self.bytes * k)

    def seconds(self) -> float:
        """The least time: the largest of the three at the card's peaks."""
        return max(self.mm / PEAK_BF16_FLOPS, self.elem / PEAK_FP32_FLOPS,
                   self.bytes / PEAK_BYTES_PER_S)


def vgg_stages(batch: int, h: int, w: int) -> Work:
    """K5: SuperPoint's four encoder stages (two 3 x 3 convs each, the
    first three pooled) on [batch, h, w, 1], one launch a stage. Bytes: a
    stage's input (the fp32 image, fp32 after stage 1, bf16 after the
    others), its bf16 weights and its output."""
    mm = n_bytes = 0
    chans = ((1, 64), (64, 64), (64, 128), (128, 128))
    for s, (cin, cout) in enumerate(chans):
        px = batch * (h >> s) * (w >> s)
        for a, b in ((cin, cout), (cout, cout)):
            f, p = _conv(px, 3, a, b)
            mm, n_bytes = mm + f, n_bytes + p * 2
        out_px = px // 4 if s < 3 else px
        n_bytes += px * cin * (_F32 if s < 2 else 2) + out_px * cout * (_F32 if s == 0 else 2)
    return Work(mm, 0, n_bytes)


def gats_blocks(batch: int, n2: float, n3: float, leaves: float, c: int = 256, heads: int = 4,
                blocks: int = 4) -> Work:
    """K4: the fused [GATs, self, cross] blocks, each launch one block, at
    n2 keypoints, n3 points and `leaves` leaves a point (valid counts).
    Matrix operations as `gats_spg_matcher` counts a block; bytes a block:
    x2, x3 in and out in fp32, the bf16 leaves, the bf16 weights."""
    d = c // heads
    gats = 2 * n3 * leaves * c + 2 * n3 * c + 2 * n3 * (leaves + 1) * c
    block = gats + (_attention(n2, n2, c, d) + _attention(n3, n3, c, d)
                    + _attention(n2, n3, c, d) + _attention(n3, n2, c, d))
    layer = 4 * (c * c + c) + (2 * c * 2 * c + 2 * c) + (2 * c * c + c)
    params = c * c + 2 * c + 2 * layer
    io = batch * (2 * (n2 + n3) * c * _F32 + n3 * leaves * c * 2) + params * 2
    return Work(blocks * (batch * block + 2 * 2 * c * c), 0, blocks * io)


def _softmax_attention(n_x: float, n_s: float, c: int, heads: int) -> Work:
    """One SuperGlue propagation of n_x points over n_s sources: the q, k,
    v projections and the merge, logits and the weighted sum, the MLP on
    [x, message] (2c -> 2c -> c); one exp per logit."""
    mm = (2 * (2 * n_x + 2 * n_s) * c * c + 2 * 2 * n_x * n_s * c
          + 2 * n_x * (2 * c) * (2 * c) + 2 * n_x * (2 * c) * c)
    return Work(mm, heads * n_x * n_s, 0)


def superglue_gnn(pairs: int, n0: float, n1: float, c: int = 256, heads: int = 4,
                  layers: int = 9, encoder=(32, 64, 128, 256)) -> Work:
    """SuperGlue's GNN over `pairs` pairs of n0 and n1 keypoints: the
    keypoint encoder, `layers` (self, cross) pairs both ways, the final
    projection and the [n0, n1] scores. Bytes: the fp32 keypoints, scores
    and descriptors in, the fp32 weights once, the scores out."""
    widths = [3, *encoder, c]
    enc = sum(2 * a * b for a, b in zip(widths, widths[1:]))
    w = Work((n0 + n1) * enc, 0, 0)
    for _ in range(layers):
        w = (w + _softmax_attention(n0, n0, c, heads) + _softmax_attention(n1, n1, c, heads)
             + _softmax_attention(n0, n1, c, heads) + _softmax_attention(n1, n0, c, heads))
    w = w + Work(2 * (n0 + n1) * c * c + 2 * n0 * n1 * c, 0, 0)
    params = (sum(a * b + b for a, b in zip(widths, widths[1:]))
              + 2 * layers * (4 * (c * c + c) + 4 * c * c + 2 * c + 2 * c * c + c + 4 * c)
              + c * c + c)
    io = (n0 + n1) * (2 + 1 + c) * _F32 + n0 * n1 * _F32
    return Work(w.mm * pairs, w.elem * pairs, io * pairs + params * _F32)


def sinkhorn(pairs: int, m: float, n: float, iters: int = 100) -> Work:
    """K7: `iters` log-space Sinkhorn iterations on [pairs, m + 1, n + 1]
    couplings (m, n valid keypoints, plus the dustbins): per entry and
    half-iteration an add of the potential, an exp and a sum term. Bytes:
    the fp32 coupling and marginals in, the potentials out."""
    entries = pairs * (m + 1) * (n + 1)
    return Work(0, iters * 2 * 3 * entries,
                entries * _F32 + 2 * pairs * (m + n + 2) * _F32 * 2)
