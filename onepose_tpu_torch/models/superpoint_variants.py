"""Semantics-preserving forms of SuperPoint's front end.

The JAX package chose its SuperPoint's front end by timing several forms
of the same computation on its chip (scripts/bench_sp_front.py,
bench_sp_score.py, bench_sp_variants.py). These are the port's forms of
the same computations, one function per part, each taking the form by
name; the benchmarks `onepose_tpu_torch.scripts.bench_sp_front`,
`bench_sp_score` and `bench_sp_variants` time them on the card. None is
SuperPoint's default unless it says so: `SuperPoint.forward` is
`dense_forward` with the forms its flags select (bit for bit, tested).

Parts and forms (the default first):
- `conv1a` (the 1 -> 64 input conv, bias and ReLU; NCHW in `sp.dtype`):
  "cudnn" (`F.conv2d`), "pad8" (the input and the weight padded to 8
  channels with zeros, then `F.conv2d`), "im2col" (the 9 shifted views of
  the image stacked, one matmul with the [9, 64] weight);
- `stage1` (conv1a, conv1b, ReLU, 2 x 2 pool; NCHW in `sp.dtype`): any
  conv1a form then SuperPoint's conv1b and pool, or "k5": the whole stage
  in the VGG-stage kernel (K5, `csrc/vgg_stage.cu`, which takes the
  single-channel input as it stands). K5 computes bf16 taps, so "k5" is a
  form of the bf16 SuperPoint only, as in serving;
- `encoder` (the four stages): a conv1a form then SuperPoint's plain
  stages, or "k5": all four stages in K5 (SuperPoint(vgg_kernel=True));
- `softmax` (65 logits -> 64 probabilities, fp32): "dim1" (`torch.softmax`
  over the channels of NCHW logits), "channels_last" (over the last axis
  of the NHWC view), "manual" (max, exp, sum, divide), "pad128" (the
  channels padded to 128 with -1e30);
- `depth_to_space`: "permute" (reshape, permute, reshape), "pixel_shuffle"
  (`F.pixel_shuffle`, whose channel order is SuperPoint's), "conv_transpose"
  (a stride-8 transposed conv with a one-hot kernel, TF32 off);
- `nms`: "separable" (`simple_nms`: two 1-D max-pools a window), "window2d"
  (one (2r+1)^2 max-pool a window), "k1" (the NMS kernel, K1);
- `sync`: the stream synchronized between depth-to-space and NMS. The JAX
  package puts an optimization barrier there so that XLA materialises the
  depth-to-space before NMS; eager PyTorch always materialises it, so the
  nearest counterpart is a wait of the host for the card at that point.

On a CUDA tensor, "k1" and "k5" launch their kernel or raise; on a CPU
tensor they run the kernels' plain versions, as every wrapper does.

Tolerances of a form against the default of its part:
- exact (0): depth_to_space "pixel_shuffle", nms "window2d" and "k1",
  `sync` (the same operations or a bit-exact kernel);
- SOFTMAX_ABS (1e-6 absolute) for the softmax forms and "conv_transpose"
  (fp32 sums in another order, probabilities at most 1);
- FP32_ABS (1e-5 absolute) for fp32 encoder forms: activations, the raw
  score map (NMS radius 0) and the descriptors (conv sums in another
  order, the tolerance of the port's SuperPoint against JAX's);
- BF16_REL (2^-6 of the largest |default|) for bf16 conv1a and stage1
  forms: each conv rounds to bf16, at other points in K5 (fp32 sums and
  bias, one rounding) than in the plain conv (product, then bias);
- BF16_SCORE_REL (2e-3 of the largest raw score) and BF16_DESC_ABS (5e-3)
  for bf16 dense forwards, the bounds chip_smoke holds bf16 maps to.
A dense forward whose encoder or softmax differs from the default is
compared at NMS radius 0: NMS and top-k then pick among near-ties, which
a rounding difference flips.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from onepose_tpu_torch.models.superpoint import SuperPoint, depth_to_space as d2s_permute
from onepose_tpu_torch.models.superpoint import score_probs
from onepose_tpu_torch.ops.kernels.score_path import nms as nms_kernel, simple_nms
from onepose_tpu_torch.utils.precision import fp32_matmuls

CONV1A_FORMS = ("cudnn", "pad8", "im2col")
STAGE1_FORMS = CONV1A_FORMS + ("k5",)
SOFTMAX_FORMS = ("dim1", "channels_last", "manual", "pad128")
D2S_FORMS = ("permute", "pixel_shuffle", "conv_transpose")
NMS_FORMS = ("separable", "window2d", "k1")

SOFTMAX_ABS = 1e-6
FP32_ABS = 1e-5
BF16_REL = 2.0**-6
BF16_SCORE_REL, BF16_DESC_ABS = 2e-3, 5e-3


def _check(form: str, forms: tuple) -> None:
    if form not in forms:
        raise ValueError(f"unknown form {form!r}: one of {forms}")


def conv1a(sp: SuperPoint, image: torch.Tensor, form: str = "cudnn") -> torch.Tensor:
    """relu(conv1a(image)) for [B, H, W, 1] images: [B, 64, H, W] in sp.dtype.
    Each form rounds the product to sp.dtype, then adds the bias in
    sp.dtype, as SuperPoint's convs do."""
    _check(form, CONV1A_FORMS)
    d, conv = sp.dtype, sp.conv1a
    x = image.to(d)
    if form == "cudnn":
        return F.relu(sp._conv(conv, x.permute(0, 3, 1, 2)))
    w = conv.weight.to(d)  # [64, 1, 3, 3]
    if form == "pad8":
        y = F.conv2d(F.pad(x, (0, 7)).permute(0, 3, 1, 2), F.pad(w, (0, 0, 0, 0, 0, 7)),
                     padding=1)
    else:
        h, wd = x.shape[1:3]
        xp = F.pad(x[..., 0], (1, 1, 1, 1))
        taps = [xp[:, dy:dy + h, dx:dx + wd] for dy in range(3) for dx in range(3)]
        y = (torch.stack(taps, dim=-1) @ w.reshape(-1, 9).t()).permute(0, 3, 1, 2)
    return F.relu(y + conv.bias.to(d)[:, None, None])


def _k5_stages(sp: SuperPoint, image: torch.Tensor, n: int) -> torch.Tensor:
    if sp.dtype != torch.bfloat16:
        raise ValueError("the K5 forms compute bf16 taps: they are forms of a bf16 SuperPoint")
    x = sp._kernel_stages(image.to(sp.dtype).float().contiguous(), n)
    return x.permute(0, 3, 1, 2).to(sp.dtype)


def stage1(sp: SuperPoint, image: torch.Tensor, form: str = "cudnn") -> torch.Tensor:
    """The first encoder stage of [B, H, W, 1] images: [B, 64, H/2, W/2] in sp.dtype."""
    _check(form, STAGE1_FORMS)
    if form == "k5":
        return _k5_stages(sp, image, 1)
    x = F.relu(sp._conv(sp.conv1b, conv1a(sp, image, form)))
    return F.max_pool2d(x, 2, 2)


def encoder(sp: SuperPoint, image: torch.Tensor, form: str = "cudnn") -> torch.Tensor:
    """The encoder of [B, H, W, 1] images: [B, 128, H/8, W/8] in sp.dtype."""
    _check(form, STAGE1_FORMS)
    if form == "k5":
        return _k5_stages(sp, image, 4)
    x = stage1(sp, image, form)
    for a, b, pool in sp._stages()[1:]:
        x = sp._stage(a, b, pool, x)
    return x


def softmax(logits: torch.Tensor, form: str = "dim1") -> torch.Tensor:
    """[B, 65, h, w] logits -> [B, 64, h, w] fp32 probabilities, the dustbin dropped."""
    _check(form, SOFTMAX_FORMS)
    if form == "dim1":
        return score_probs(logits)
    x = logits.float()
    if form == "channels_last":
        return torch.softmax(x.permute(0, 2, 3, 1), dim=-1)[..., :-1].permute(0, 3, 1, 2)
    if form == "manual":
        e = torch.exp(x - x.amax(dim=1, keepdim=True))
        return (e / e.sum(dim=1, keepdim=True))[:, :-1]
    return torch.softmax(F.pad(x, (0, 0, 0, 0, 0, 63), value=-1e30), dim=1)[:, :64]


def depth_to_space(probs: torch.Tensor, form: str = "permute") -> torch.Tensor:
    """[B, 64, h, w] -> [B, 8h, 8w]: channel 8 dy + dx to pixel (8y + dy, 8x + dx)."""
    _check(form, D2S_FORMS)
    if form == "permute":
        return d2s_permute(probs)
    if form == "pixel_shuffle":
        return F.pixel_shuffle(probs, 8)[:, 0]
    onehot = torch.eye(64, dtype=probs.dtype, device=probs.device).reshape(64, 1, 8, 8)
    with fp32_matmuls():
        return F.conv_transpose2d(probs, onehot, stride=8)[:, 0]


def _max_pool_2d(x: torch.Tensor, r: int) -> torch.Tensor:
    return F.max_pool2d(x[:, None], 2 * r + 1, stride=1, padding=r)[:, 0]


def nms(scores: torch.Tensor, radius: int, form: str = "separable") -> torch.Tensor:
    """simple_nms of [B, H, W] fp32 scores."""
    _check(form, NMS_FORMS)
    if form == "separable":
        return simple_nms(scores, radius)
    if form == "k1":
        return nms_kernel(scores.contiguous(), radius)
    zeros = torch.zeros_like(scores)
    max_mask = scores == _max_pool_2d(scores, radius)
    for _ in range(2):
        supp_mask = _max_pool_2d(max_mask.to(scores.dtype), radius) > 0
        supp_scores = torch.where(supp_mask, zeros, scores)
        max_mask |= (supp_scores == _max_pool_2d(supp_scores, radius)) & ~supp_mask
    return torch.where(max_mask, scores, zeros)


def _sync(x: torch.Tensor) -> None:
    if x.device.type == "cuda":
        torch.cuda.current_stream(x.device).synchronize()


def score_path(logits: torch.Tensor, radius: int = 4, softmax_form: str = "dim1",
               d2s: str = "permute", nms_form: str = "separable",
               sync: bool = False) -> torch.Tensor:
    """[B, 65, h, w] detector logits -> the NMS'd score map [B, 8h, 8w]."""
    scores = depth_to_space(softmax(logits, softmax_form), d2s)
    if sync:
        _sync(scores)
    return nms(scores, radius, nms_form)


def dense_forward(sp: SuperPoint, image: torch.Tensor, encoder_form: str = "cudnn",
                  nms_form: str = "separable", sync: bool = False,
                  radius: int | None = None, softmax_form: str = "dim1") -> dict:
    """SuperPoint's dense forward with these forms and sp's weights and
    dtype ({"score_map", "descriptor_map"} as SuperPoint returns them);
    radius: the NMS radius, sp.nms_radius if None."""
    x = encoder(sp, image, encoder_form)
    r = sp.nms_radius if radius is None else radius
    scores = score_path(sp._logits(x), r, softmax_form, nms_form=nms_form, sync=sync)
    return {"score_map": scores, "descriptor_map": sp._descriptors(x)}


def rel_to_max(out: torch.Tensor, ref: torch.Tensor) -> float:
    """max |out - ref| / max |ref|, in fp32."""
    ref = ref.float()
    return float((out.float() - ref).abs().max() / ref.abs().max().clamp(min=1e-30))


def max_abs(out: torch.Tensor, ref: torch.Tensor) -> float:
    return float((out.float() - ref.float()).abs().max())


def encoder_tolerance(dtype: torch.dtype) -> tuple:
    """(tolerance, relative to the largest |default|) of a conv1a, stage1 or
    encoder form's activations against the default form's."""
    return (BF16_REL, True) if dtype == torch.bfloat16 else (FP32_ABS, False)


def d2s_tolerance(form: str) -> tuple:
    return (SOFTMAX_ABS, False) if form == "conv_transpose" else (0.0, False)


def dense_tolerances(dtype: torch.dtype) -> dict:
    """{output: (tolerance, relative)} of a dense forward whose encoder or
    softmax form is not the default's, at NMS radius 0 ("raw_score_map")."""
    if dtype == torch.bfloat16:
        return {"raw_score_map": (BF16_SCORE_REL, True), "descriptor_map": (BF16_DESC_ABS, False)}
    return {"raw_score_map": (FP32_ABS, False), "descriptor_map": (FP32_ABS, False)}
