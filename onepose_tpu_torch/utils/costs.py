"""Operations and bytes of the serving path's stages, counted from shapes.

The port's stand-in for XLA's `compiled.cost_analysis()`, which PyTorch
has no counterpart of. The roofline audit (`scripts/roofline_audit.py`)
divides these counts by the card's peaks. Each function is pure, takes
shapes only and returns (flops, bytes).

What is counted as operations:
- a convolution or a Dense layer: 2 * k^2 * cin * cout per output pixel or
  point (a multiply and an add per weight); biases, ReLUs and pools are
  left out;
- an einsum: 2 per multiply-add;
- the match head's softmaxes: `DUAL_SOFTMAX_OPS` per element of the
  [B, N2, N3] scores; RANSAC-PnP's geometry: loosely, per hypothesis and
  per point (see `ransac_pnp`).
A sort, a top-k, a gather, a threshold or a mask counts as bytes only.

Bytes follow the roofline rule: each input read once and each output
written once, at its dtype's width, whatever the kernels read again;
what stays inside a stage is not counted. Weights count at the compute
dtype's width, as the kernels read them.

XLA's count of the JAX package's models agrees with these within a few
percent (`tests/test_torch_bench.py`): XLA leaves out SAME padding's
out-of-bounds taps (about 5% of SuperPoint's at 64 x 64) and adds the
elementwise operations left out here.
"""

from __future__ import annotations

import torch

# H100 SXM, NVIDIA's data sheet: dense rates without sparsity, at 700 W.
PEAK_BF16_FLOPS = 989e12
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


def ransac_pnp(batch: int, n_kpts: int, n_hyp: int, refine_iters: int = 5,
               n_valid: float | None = None) -> tuple[int, int]:
    """RANSAC-PnP as `geometry.ransac.ransac_pnp` runs it, counted loosely:
    P3P per hypothesis, the first scoring of its four poses on 128 points,
    the second of 64 survivors on every point, the Gauss-Newton refine and
    the final error. It is a rounding error of the whole call. With
    `n_valid` (valid matches a frame, a mean), the scorings, the refine and
    the final error count the valid matches alone, the work K9 does; the
    refine still counts every valid match where it works on the inliers, so
    it is an upper count either way. Bytes: the keypoints, points, K, mask
    and draws in; pose, R, t, inliers, their count and ok out."""
    n_pts = n_kpts if n_valid is None else n_valid
    n_sub, n_keep = min(128, n_pts), min(64, 4 * n_hyp)
    flops = batch * (n_hyp * P3P_OPS + 4 * n_hyp * n_sub * REPROJ_OPS
                     + n_keep * n_pts * REPROJ_OPS + refine_iters * n_pts * GN_OPS
                     + n_pts * REPROJ_OPS)
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
