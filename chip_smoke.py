#!/usr/bin/env python3
"""Smoke run of the PyTorch port (onepose_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py            # all phases, one card

Phases, each printing its lines before the last:
  1. build the CUDA kernels from onepose_tpu_torch/csrc (one nvcc per
     source, all at once) and print the card's name and power limit;
  2. hold each kernel against its plain PyTorch version on the card, at the
     main path's production shapes and at ragged, masked shapes, and time
     both (CUDA events, L2 flushed before each launch, median), beside the
     bound at the card's peak rate for the kernel's operand type and, where
     one PyTorch call computes the same thing, that call's time; with the
     breakdowns of the VGG stage (each encoder stage beside cuDNN's conv
     pair) and of the fused block (launched from Python and replayed as a
     CUDA graph; device ms per CUDA kernel from torch.profiler), and the
     Sinkhorn kernels at 1 and 100 iterations (fixed cost and us per
     iteration; K7's sweep rate, in fp32 and with bf16 storage);
  3. the RANSAC-PnP oracle: synthetic matches with a known pose, 0.5 px
     noise and 30% outliers, recovered within 1 cm and 1 degree;
  4. the serving paths: PosePipeline at batch 8, 512 x 512, 1000 keypoints,
     2000 x 8 points, 512 hypotheses, 4 blocks, d_model 256, 4 heads,
     random weights from a seed, in bf16 (the serving default: NMS, VGG
     stage, fused block and dual-softmax kernels) and in fp32 (NMS, GATs
     and dual-softmax kernels); shapes, finiteness, kernel launch counts
     per path, agreement with the CPU plain path on a small input and
     between the paths; per-stage times and launches, device busy share
     and frames/s of bf16 kernels on / off and fp32 kernels on / off;
  5. the pair matcher of `map` (make_superglue_pair_matcher, SuperGlue at
     full width, random weights from a seed): 24 frames x 1024 keypoints in
     chunks of 16 (the resident Sinkhorn kernel) and 12 frames x 4096
     keypoints in chunks of 7 (the streamed one, also with its coupling
     stored in bf16); launches per chunk, kernels on against off, stage
     times, device time and Sinkhorn's share, ms per chunk, pairs/s and
     peak memory, kernels on and off;
  6. one JSON line {"kernels": [...]}, then the last line
     {"ok": true, "device": {...}}.

Any failure raises: the script exits non-zero and prints no result line. It
also exits non-zero, printing nothing on stdout, without CUDA or without the
onepose_tpu_torch package beside it. TF32 is off (cudnn and matmul) for
the parity phases; the main path runs with PyTorch's defaults.
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
PHASES = ("build", "kernels", "ransac", "main", "pairs")
HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory
FP32_OPS_PER_S = 67e12  # H100 SXM fp32 outside the tensor cores
BF16_OPS_PER_S = 989e12  # H100 SXM dense bf16 on the tensor cores
NEG_INF = -1e9
DEV = "cuda"

# Shapes. The first entry of each kernel's list is the main path's
# production shape (bench.py's serving configuration), the rest ragged.
NMS_SHAPES = ((8, 512, 512), (3, 136, 200))  # [B, H, W]
GATS_SHAPES = ((8, 2000, 8, 256, True), (3, 37, 5, 96, True), (2, 300, 8, 256, False))
DUAL_SHAPES = ((8, 1000, 2000), (3, 45, 203))  # [B, M, N]
# [B, H, W, Cin, C1, C2, pool]: the four stages of one encoder pass, then ragged ones
# (the last with input channels padded to 128 and C1 != C2).
VGG_SHAPES = (
    ((8, 512, 512, 1, 64, 64, True), (8, 256, 256, 64, 64, 64, True),
     (8, 128, 128, 64, 128, 128, True), (8, 64, 64, 128, 128, 128, False)),
    ((3, 136, 200, 1, 64, 64, True), (3, 68, 100, 64, 128, 128, True),
     (3, 68, 100, 128, 128, 128, False), (2, 36, 70, 96, 64, 128, True)),
)
BLOCK_SHAPES = ((8, 1000, 2000, 8, 256, True), (3, 37, 45, 5, 256, True),
                (2, 300, 200, 8, 256, False))  # [B, N2, N3, L, C, masked]
GEMM_SHAPE = (16000, 512, 512)  # [M, K, N]: the block's largest GEMM (MLP dense_0 on x3, x2)
BLOCK_BF16_REL = 2e-2  # K4 in bf16: max |kernel - plain| / max |plain|
# bf16 against fp32 at the production shape, on the dense maps. bf16 keeps
# 8 significant bits: rounding the encoder's activations moves a softmax
# score by a few 1e-4 relative and a unit descriptor's entries by about 1e-3.
BF16_SCORE_REL, BF16_DESC_ABS = 2e-3, 5e-3
RANSAC = dict(batch=8, matches=1000, hypotheses=512)
MAIN = dict(batch=8, size=512, keypoints=1000, points=2000, leaves=8, hypotheses=512, blocks=4)
TIMED_CALLS = 10
# With random weights no pair clears the shipped threshold of 0.2 (conf
# stays near 1e-3), so every mutual nearest neighbour counts as a match:
# the comparisons then see real matches and RANSAC real correspondences.
# The work is the same at any threshold (static shapes).
MATCH_THRESHOLD = 0.0
# K6 [B, M, N] couplings (keypoints + dustbin): map's default (1024
# keypoints, chunks of 16; three waves of pairs), then a ragged one. K7:
# the SfM budget (4096 keypoints, chunks of 7), then a ragged one whose
# blocks stream several row blocks each. The shapes after those reach the
# other instantiations (warps a group x chunks a thread): K6 8 x 1 and
# 16 x 1; K7 16 x 2, and one row a step at 16 x 5 and 16 x 7.
SINKHORN_SHAPES = ((16, 1025, 1025), (3, 301, 257), (2, 1201, 1201), (2, 301, 2401))
STREAM_SHAPES = ((7, 4097, 4097), (5, 3000, 2049), (2, 700, 4401), (1, 1000, 9001),
                 (1, 1500, 13001))
SINKHORN_ITERS = 100
SINKHORN_ABS = 1e-3
# exp on the special-function units: 16 per clock per SM, 132 SMs, 1.98 GHz.
EXP_PER_S = 16 * 132 * 1.98e9
# The pair matcher of `map` at full width (SuperGlue: d_model 256, 4 heads,
# 9 layers, 100 Sinkhorn iterations) with random weights: (a) map's default
# of 1024 keypoints in chunks of 16 (K6), (b) the SfM budget of 4096
# keypoints, where the HBM guard caps the chunk at 7 (K7).
PAIRS = (dict(label="a", frames=24, keypoints=1024, pairs=32, pair_chunk=16, chunk=16,
              kernel="sinkhorn"),
         dict(label="b", frames=12, keypoints=4096, pairs=14, pair_chunk=16, chunk=7,
              kernel="sinkhorn_stream"))
PAIR_HW = (480, 640)
PAIR_RUNS = 2  # timed match_pairs calls per setting, in turns (on, off, off, on)


def log(msg: str) -> None:
    print(msg, flush=True)


def fail(msg: str) -> None:
    raise SystemExit(f"chip_smoke: FAILED: {msg}")


def bound(n_bytes: float, n_ops: float, ops_per_s: float = FP32_OPS_PER_S) -> tuple[float, str]:
    """(least ms, "bytes" or "operations") for the work at the card's peaks;
    ops_per_s is the peak rate of the operation's type (fp32 SIMT, bf16 MMA,
    exp on the special-function units)."""
    t_bytes, t_ops = n_bytes / HBM_BYTES_PER_S, n_ops / ops_per_s
    return (max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else "operations")


class Timer:
    """Median device time of a call, each run after an L2 flush."""

    def __init__(self, torch):
        self.torch = torch
        self.flush = torch.empty(64 * 2**20, dtype=torch.int32, device=DEV)  # 256 MB

    def __call__(self, fn, reps: int = 20, warmup: int = 3) -> float:
        torch = self.torch
        for _ in range(warmup):
            fn()
        times = []
        for _ in range(reps):
            self.flush.zero_()
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            fn()
            end.record()
            torch.cuda.synchronize()
            times.append(start.elapsed_time(end))
        return statistics.median(times)


def phase_build():
    from onepose_tpu_torch.ops.kernels import _build

    t0 = time.perf_counter()
    logs = _build.build()
    for name in _build.KERNELS:
        _build.load(name)
    log(f"[build] {len(logs)} of {len(_build.KERNELS)} kernel libraries compiled with "
        f"{' '.join(_build.NVCC_FLAGS)} in {time.perf_counter() - t0:.1f} s")
    for name, text in logs.items():
        fn = ""
        for line in text.splitlines():
            if "Function properties for" in line:
                fn = line.split()[-1]  # the mangled name: template arguments as Li<n>E
            elif "spill" in line:
                log(f"[build] {name} {fn}: {line.strip()}")
            elif "Used" in line:
                log(f"[build] {name}: {line.strip()}")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]
    log(smi)  # the card's name and power limit, as nvidia-smi prints them
    return smi


def _nms_input(torch, g, b, h, w):
    s = torch.rand((b, h, w), generator=g, device=DEV) ** 4
    s[:, 5:8, 5:8] = 0.7
    s[:, 0, 0] = 2.0
    s[:, h - 1, w // 2] = 2.0
    s[:, h // 2, w - 1] = 2.0
    s[:, :, 10:12] = 0.0
    return s.contiguous()


def _dual_input(torch, g, b, m, n, c=256):
    def unit(x):
        return x / torch.linalg.vector_norm(x, dim=-1, keepdim=True)

    d3 = unit(torch.randn((b, n, c), generator=g, device=DEV))
    pick = torch.randperm(n, generator=g, device=DEV)[:m]
    noise = torch.randn((b, m, c), generator=g, device=DEV) * (0.3 / c**0.5)
    d2 = unit(d3[:, pick] + noise)  # each row's true column stands out
    s = torch.einsum("bmc,bnc->bmn", d2, d3) / 0.07
    m2 = torch.rand((b, m), generator=g, device=DEV) < 0.9
    m3 = torch.rand((b, n), generator=g, device=DEV) < 0.9
    s = s.masked_fill(~m2[:, :, None], NEG_INF).masked_fill(~m3[:, None, :], NEG_INF)
    return s.contiguous()


def phase_kernels(torch, timer):
    from onepose_tpu_torch.ops.kernels import dual_softmax, gats, score_path

    g = torch.Generator(device=DEV).manual_seed(0)
    rows = {}

    # K1 NMS: bit-exact; the ragged shape at every radius class as well
    # (the kernel is compiled once per radius).
    for i, shape in enumerate(NMS_SHAPES):
        prod = i == 0
        s = _nms_input(torch, g, *shape)
        for radius in (4,) if prod else (0, 1, 4, 9):
            out, ref = score_path.nms(s, radius), score_path.simple_nms(s, radius)
            torch.cuda.synchronize()
            n_bad = int((out != ref).sum())
            n_max = int((out > 0).sum())
            log(f"[kernels] nms {shape} radius {radius}: {n_bad} differing pixels (bit-exact "
                f"required), {n_max} maxima kept")
            if n_bad or n_max == 0:
                fail("nms kernel differs from simple_nms")
        if prod:
            err = float((out - ref).abs().max())
            ms = timer(lambda: score_path.nms(s, 4))
            plain = timer(lambda: score_path.simple_nms(s, 4), reps=5)
            rows["nms"] = dict(
                name="nms", route="cuda", source="onepose_tpu_torch/csrc/score_path.cu",
                replaces="onepose_tpu/ops/pallas/score_path.py:94", max_abs_err=err,
                ms=ms, plain_ms=plain, library_ms=None,
            )
            rows["nms"]["bound_ms"], rows["nms"]["bound_by"] = bound(
                2 * s.numel() * 4, 5 * 2 * 9 * s.numel())

    # K2 GATs leaf attention: max abs error <= 1e-5.
    for i, (b, n3, L, c, masked) in enumerate(GATS_SHAPES):
        prod = i == 0
        leaves = torch.randn((b, n3, L, c), generator=g, device=DEV)
        leaves = leaves / torch.linalg.vector_norm(leaves, dim=-1, keepdim=True)
        d3 = torch.randn((b, n3, c), generator=g, device=DEV)
        d3 = d3 / torch.linalg.vector_norm(d3, dim=-1, keepdim=True)
        W = torch.randn((c, c), generator=g, device=DEV) * (2.0 / (2 * c)) ** 0.5
        a2 = torch.randn((2, c), generator=g, device=DEV) * (2.0 / (2 * c + 1)) ** 0.5
        mask = torch.rand((b, n3, L), generator=g, device=DEV) < 0.8 if masked else None
        wa = gats.leaf_logit_vectors(W, a2)
        add = gats.additive_mask(mask)
        out = gats.gats_kernel(leaves, d3, add, wa, 0.2)
        ref = gats.gats_leaf_attention_plain(leaves, d3, add, wa, 0.2)
        torch.cuda.synchronize()
        err = float((out - ref).abs().max())
        log(f"[kernels] gats {(b, n3, L, c)} masked={masked}: max abs err {err:.3e} (<= 1e-5)")
        if not err <= 1e-5:
            fail("gats kernel differs from its plain version")
        if prod:
            ms = timer(lambda: gats.gats_kernel(leaves, d3, add, wa, 0.2))
            plain = timer(lambda: gats.gats_leaf_attention_plain(leaves, d3, add, wa, 0.2), reps=5)
            n_bytes = (leaves.numel() + 2 * d3.numel() + add.numel() + wa.numel()) * 4
            rows["gats"] = dict(
                name="gats_leaf_attention", route="cuda", source="onepose_tpu_torch/csrc/gats.cu",
                replaces="onepose_tpu/ops/pallas/gats.py:82", max_abs_err=err,
                ms=ms, plain_ms=plain, library_ms=None,
            )
            rows["gats"]["bound_ms"], rows["gats"]["bound_by"] = bound(
                n_bytes, 4 * b * n3 * (L + 1) * c)

    # K3 dual-softmax: identical matches, scores <= 1e-6 relative.
    for i, shape in enumerate(DUAL_SHAPES):
        prod = i == 0
        s = _dual_input(torch, g, *shape)
        out = dual_softmax.dual_softmax_match(s, 0.2)
        ref = dual_softmax.dual_softmax_match_plain(s, 0.2)
        torch.cuda.synchronize()
        bad = int((out["matches0"] != ref["matches0"]).sum()
                  + (out["matches1"] != ref["matches1"]).sum())
        rel = max(
            float(((out[k] - ref[k]).abs() / ref[k].abs().clamp(min=1e-30)).max())
            for k in ("matching_scores0", "matching_scores1")
        )
        err = max(float((out[k] - ref[k]).abs().max())
                  for k in ("matching_scores0", "matching_scores1"))
        n_hits = int((out["matches0"] >= 0).sum())
        log(f"[kernels] dual_softmax {shape}: {bad} match mismatches (0 required), {n_hits} "
            f"matches, scores max rel err {rel:.3e} (<= 1e-6)")
        if bad or not rel <= 1e-6 or n_hits == 0:
            fail("dual_softmax kernel differs from its plain version")
        if prod:
            b, m, n = shape
            ms = timer(lambda: dual_softmax.dual_softmax_match(s, 0.2))
            plain = timer(lambda: dual_softmax.dual_softmax_match_plain(s, 0.2), reps=5)
            rows["dual_softmax"] = dict(
                name="dual_softmax_match", route="cuda",
                source="onepose_tpu_torch/csrc/dual_softmax.cu",
                replaces="onepose_tpu/ops/pallas/dual_softmax.py:78", max_abs_err=err,
                ms=ms, plain_ms=plain, library_ms=None,
            )
            rows["dual_softmax"]["bound_ms"], rows["dual_softmax"]["bound_by"] = bound(
                s.numel() * 4 + b * (m + n) * 8, 10 * s.numel())
    rows["vgg_stage"] = _kernels_vgg(torch, timer, g)
    rows["gats_block"] = _kernels_block(torch, timer, g)
    rows.update(_kernels_sinkhorn(torch, timer, g))
    for r in rows.values():
        lib = "n/a" if r["library_ms"] is None else f"{r['library_ms']:.4f} ms"
        log(f"[kernels] {r['name']}: kernel {r['ms']:.4f} ms, plain {r['plain_ms']:.4f} ms, "
            f"library {lib}, bound {r['bound_ms']:.4f} ms ({r['bound_by']})")
    return rows


def _bf16_ulp(torch, x):
    """The spacing of bf16 numbers at |x| (8 significant bits)."""
    mag = x.abs().clamp(min=2.0**-126)
    return torch.exp2(torch.floor(torch.log2(mag)) - 7)


def _kernels_vgg(torch, timer, g):
    """K5: at least 99% of the elements bit-identical to the plain version
    (the same rounding points; the fp32 sums run in another order), the
    rest within 2^-6 of the largest output: where a conv1 sum lands on the
    other side of a bf16 rounding boundary, that one-ulp flip of conv1's
    output moves conv2's sums by a few ulps of their own. The tile height
    the kernel picks must equal `vgg_stage.tile_rows`' (which the CPU
    replay of the schedule uses). Timed as one encoder pass (the four
    production stages) with the weights packed once, as SuperPoint's
    PackCache keeps them, then stage by stage."""
    import torch.nn.functional as F

    from onepose_tpu_torch.ops.kernels import vgg_stage

    def stage_args(b, h, w, cin, c1, c2, pool):
        if cin == 1:
            x = torch.rand((b, h, w, 1), generator=g, device=DEV)
        else:
            x = torch.relu(torch.randn((b, h, w, cin), generator=g, device=DEV)).bfloat16()
        w1 = torch.randn((3, 3, cin, c1), generator=g, device=DEV) * (2.0 / (9 * cin)) ** 0.5
        w2 = torch.randn((3, 3, c1, c2), generator=g, device=DEV) * (2.0 / (9 * c1)) ** 0.5
        b1 = torch.randn((c1,), generator=g, device=DEV) * 0.1
        b2 = torch.randn((c2,), generator=g, device=DEV) * 0.1
        return x, w1, b1, w2, b2, pool

    from onepose_tpu_torch.ops.kernels import _build

    prod, err = [], 0.0
    klib = _build.load("vgg_stage")
    for i, shapes in enumerate(VGG_SHAPES):
        for shape in shapes:
            cin, c1, c2 = shape[3:6]
            th = klib.vgg_stage_tile_rows(cin, c1, c2)
            if th != vgg_stage.tile_rows(cin, c1, c2):
                fail(f"vgg_stage tile height {th} differs from the Python mirror's")
            args = stage_args(*shape)
            out = vgg_stage.vgg_stage_kernel(*args).float()
            ref = vgg_stage.vgg_stage_plain(*args).float()
            torch.cuda.synchronize()
            same = float((out == ref).float().mean())
            err, top = float((out - ref).abs().max()), float(ref.abs().max())
            ulp = (out - ref).abs() / _bf16_ulp(torch, torch.maximum(out.abs(), ref.abs()))
            nz = float((ref != 0).float().mean())
            log(f"[kernels] vgg_stage {shape}, tiles of {th} x 32: {same:.6f} of elements "
                f"bit-identical (>= 0.99), "
                f"max abs err {err:.3e} (<= 2^-6 x max |plain| = {top / 64:.3e}); "
                f"{int((ulp > 1).sum())} of {ref.numel()} elements over one bf16 ulp of their "
                f"own value (max {float(ulp.max()):.1f}); {nz:.3f} non-zero")
            if not (same >= 0.99 and err <= top / 64 and nz > 0.05):
                fail("vgg_stage kernel differs from its plain version")
            if i == 0:
                prod.append(args)
                err = max(err, float((out - ref).abs().max()))
    n_bytes = n_ops = 0
    for x, w1, b1, w2, b2, pool in prod:
        b, h, w, cin = x.shape
        c1, c2 = w1.shape[-1], w2.shape[-1]
        out_bytes = b * (h // 2 if pool else h) * (w // 2 if pool else w) * c2 * (4 if cin == 1
                                                                                  else 2)
        n_bytes += x.numel() * x.element_size() + 2 * (w1.numel() + w2.numel()) + out_bytes
        n_ops += 2 * b * h * w * 9 * (cin * c1 + c1 * c2)
    # The library yardstick: cuDNN's bf16 conv pair + ReLU [+ pool], channels_last.
    lib_args = []
    for x, w1, b1, w2, b2, pool in prod:
        xl = x.bfloat16().permute(0, 3, 1, 2).contiguous(memory_format=torch.channels_last)
        lib_args.append((xl, *(t.bfloat16().permute(3, 2, 0, 1).contiguous(
            memory_format=torch.channels_last) for t in (w1, w2)), b1.bfloat16(), b2.bfloat16(),
            pool))

    def library():
        for xl, w1l, w2l, b1l, b2l, pool in lib_args:
            z = F.relu(F.conv2d(F.relu(F.conv2d(xl, w1l, b1l, padding=1)), w2l, b2l, padding=1))
            if pool:
                F.max_pool2d(z, 2, 2)

    # The weights packed once, as SuperPoint's PackCache keeps them on the main path.
    packs = [vgg_stage.pack_stage_weights(*a[1:5]) for a in prod]
    ms = timer(lambda: [vgg_stage.vgg_stage_kernel(*a, packed=p) for a, p in zip(prod, packs)])
    plain = timer(lambda: [vgg_stage.vgg_stage_plain(*a) for a in prod], reps=5)
    lib = timer(library)
    # The breakdown: each stage's launch alone, beside cuDNN's pair and its bound.
    for a, p, la, shape in zip(prod, packs, lib_args, VGG_SHAPES[0]):
        b, h, w, cin, c1, c2, pool = shape
        k_ms = timer(lambda a=a, p=p: vgg_stage.vgg_stage_kernel(*a, packed=p))
        l_ms = timer(lambda la=la: (lambda xl, w1l, w2l, b1l, b2l, pool: F.relu(F.conv2d(
            F.relu(F.conv2d(xl, w1l, b1l, padding=1)), w2l, b2l, padding=1)))(*la))
        ops = 2 * b * h * w * 9 * (cin * c1 + c1 * c2)
        log(f"[kernels] vgg_stage breakdown {shape}: kernel {k_ms:.4f} ms ({ops / k_ms / 1e9:.1f} "
            f"TFLOP/s), cuDNN conv pair + ReLU {l_ms:.4f} ms, bound {ops / BF16_OPS_PER_S * 1e3:.4f}"
            f" ms ({ops / 1e9:.1f} GFLOP)")
    row = dict(name="vgg_stage", route="cuda", source="onepose_tpu_torch/csrc/vgg_stage.cu",
               replaces="onepose_tpu/ops/pallas/vgg_stage.py:160", max_abs_err=err, ms=ms,
               plain_ms=plain, library_ms=lib)
    row["bound_ms"], row["bound_by"] = bound(n_bytes, n_ops, BF16_OPS_PER_S)
    log(f"[kernels] vgg_stage: times are of one encoder pass (4 launches: {n_ops / 1e9:.1f} "
        f"GFLOP, {n_bytes / 1e6:.1f} MB)")
    return row


def _block_inputs(torch, g, b, n2, n3, L, c, masked):
    def rn(*shape, scale=1.0):
        return torch.randn(shape, generator=g, device=DEV) * scale

    x = (rn(b, n2, c), rn(b, n3, c), rn(b, n3, L, c))
    masks = ((torch.rand((b, n2), generator=g, device=DEV) < 0.8,
              torch.rand((b, n3), generator=g, device=DEV) < 0.8,
              torch.rand((b, n3, L), generator=g, device=DEV) < 0.7) if masked
             else (None, None, None))
    params = {"wa": rn(2, c, scale=c**-0.5)}
    for s in ("self", "cross"):
        params.update({f"{s}_w4": rn(4, c, c, scale=c**-0.5), f"{s}_b4": rn(4, c, scale=0.1),
                       f"{s}_w0": rn(2 * c, 2 * c, scale=(2 * c) ** -0.5),
                       f"{s}_b0": rn(2 * c, scale=0.1),
                       f"{s}_w1": rn(2 * c, c, scale=(2 * c) ** -0.5), f"{s}_b1": rn(c, scale=0.1)})
    return (*x, *masks, params)


def _block_ops(b, n2, n3, L, c, h=4):
    """Products of one block: GATs, the q/k/v, merge and MLP GEMMs, and the
    per-head kv and numerator of each of the four attentions."""
    d, rows = c // h, b * (n2 + n3)
    gemm = 2 * rows * c * 3 * c * 2 + 2 * rows * (c * c + 4 * c * c + 2 * c * c) * 2
    attn = sum(4 * b * n * h * d * d + 2 * b * n * c for n in (n2, n3, n2, n3))
    return 4 * b * n3 * (L + 1) * c + gemm + attn


def _kernel_breakdown(torch, fn, calls=3) -> dict:
    """{CUDA kernel name: (launches, device ms)} per call of fn, from
    torch.profiler over `calls` calls after a warm-up."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    out = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            n, ms = out.get(e.name, (0, 0.0))
            out[e.name] = (n + 1, ms + e.time_range.elapsed_us() / 1e3)
    return {k: (n // calls, ms / calls) for k, (n, ms) in out.items()}


def _graph_ms(torch, timer, fn) -> float:
    """Median time of fn's kernels captured once in a CUDA graph and
    replayed (no host work in the window)."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()  # warm-up outside the capture (kernel build, allocator)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        fn()
    return timer(graph.replay)


def _kernels_block(torch, timer, g):
    """K4: fp32 within 1e-4 absolute of the plain version; bf16 within
    BLOCK_BF16_REL of the largest output (the same rounding points; a sum
    that lands on the other side of a bf16 rounding boundary moves one
    operand by 2^-8, and four attention layers with instance norms carry
    that on). bf16 runs with bf16 leaves, as the main path holds them.
    Timed in bf16 at the production shape, one launch (37 CUDA kernels)
    with the weights packed once, as GATsSPG's PackCache keeps them; the
    block's GEMM alone beside bf16 torch.matmul."""
    from onepose_tpu_torch.ops.kernels import gats_block

    row = None
    for i, shape in enumerate(BLOCK_SHAPES):
        args = _block_inputs(torch, g, *shape)
        for dtype in (torch.float32, torch.bfloat16):
            a = args if dtype == torch.float32 else (*args[:2], args[2].bfloat16(), *args[3:])
            out = gats_block.gats_block_kernel(*a, dtype=dtype)
            ref = gats_block.fused_gats_block_plain(*a, dtype=dtype)
            torch.cuda.synchronize()
            err = max(float((o - r).abs().max()) for o, r in zip(out, ref))
            rel = max(float((o - r).abs().max() / r.abs().max()) for o, r in zip(out, ref))
            finite = all(bool(torch.isfinite(o).all()) for o in out)
            ok = err <= 1e-4 if dtype == torch.float32 else rel <= BLOCK_BF16_REL
            log(f"[kernels] gats_block {shape} {str(dtype)[6:]}: max abs err {err:.3e}, max rel "
                f"err {rel:.3e} (fp32: abs <= 1e-4; bf16: rel <= {BLOCK_BF16_REL})")
            if not (ok and finite):
                fail("gats_block kernels differ from their plain version")
        if i == 0:
            b, n2, n3, L, c, _ = shape
            a = (*args[:2], args[2].bfloat16(), *args[3:])
            kw = gats_block.kernel_weights(args[6], torch.bfloat16)
            ms = timer(lambda: gats_block.gats_block_kernel(*a, packed=kw))
            plain = timer(lambda: gats_block.fused_gats_block_plain(*a), reps=5)
            n_bytes = sum(t.numel() * t.element_size() for t in a[:6] if t is not None)
            n_bytes += sum(t.numel() * 2 for t in args[6].values()) + 4 * b * (n2 + n3) * c
            row = dict(name="gats_block", route="cuda",
                       source="onepose_tpu_torch/csrc/gats_block.cu",
                       replaces="onepose_tpu/ops/pallas/gats_block.py:173", max_abs_err=err,
                       ms=ms, plain_ms=plain, library_ms=None)
            row["bound_ms"], row["bound_by"] = bound(n_bytes, _block_ops(b, n2, n3, L, c),
                                                     BF16_OPS_PER_S)
            graph_ms = _graph_ms(torch, timer, lambda: gats_block.gats_block_kernel(*a, packed=kw))
            log(f"[kernels] gats_block {shape} bf16, one block: {ms:.4f} ms launched from Python "
                f"(the wrapper and 37 launches on the host), {graph_ms:.4f} ms replayed as one "
                "CUDA graph (the device's time alone)")
            by_name = _kernel_breakdown(torch, lambda: gats_block.gats_block_kernel(*a, packed=kw))
            n_launch = sum(n for n, _ in by_name.values())
            log(f"[kernels] gats_block breakdown, one bf16 block {shape}: {n_launch} CUDA kernels, "
                f"{sum(ms for _, ms in by_name.values()):.4f} ms of device time (torch.profiler)")
            for name, (n, k_ms) in sorted(by_name.items(), key=lambda kv: -kv[1][1]):
                log(f"[kernels] gats_block breakdown: {k_ms:.4f} ms in {n} launch(es)  {name[:90]}")
    m, k, n = GEMM_SHAPE
    a = torch.randn((m, k), generator=g, device=DEV)
    w = torch.randn((k, n), generator=g, device=DEV) * k**-0.5
    bias = torch.randn((n,), generator=g, device=DEV) * 0.1
    wp = gats_block.pack_gemm_weight(w, torch.bfloat16)
    out, ref = gats_block.gemm(a, w, bias, packed=wp), gats_block.gemm_plain(a, w, bias)
    err = float((out - ref).abs().max())
    ms = timer(lambda: gats_block.gemm(a, w, bias, packed=wp))
    plain = timer(lambda: gats_block.gemm_plain(a, w, bias), reps=5)
    ab, wb = a.bfloat16(), w.bfloat16()
    lib = timer(lambda: torch.matmul(ab, wb))
    gb, gby = bound(4 * m * k + 2 * k * n + 4 * m * n, 2 * m * k * n, BF16_OPS_PER_S)
    log(f"[kernels] gats_block GEMM [{m}, {k}] x [{k}, {n}] bf16: max abs err {err:.3e} vs plain; "
        f"kernel {ms:.4f} ms, plain {plain:.4f} ms, library (bf16 torch.matmul, bf16 in and out) "
        f"{lib:.4f} ms, bound {gb:.4f} ms ({gby})")
    if not err <= 1e-3 * float(ref.abs().max()):
        fail("the gats_block GEMM differs from its plain version")
    return row


def _sinkhorn_input(torch, g, b, m, n):
    """The transport problem of log_sinkhorn for a planted assignment (after
    the JAX test's, test_pallas_kernels.py:506-513): scores of unit
    descriptors and copies of them with noise of norm 0.2, at scale 8, 10%
    of the keypoints masked, a dustbin score of 1. Returns (couplings
    [b, m, n], log_mu, log_nu, norm, mask0, mask1)."""
    from onepose_tpu_torch.models.superglue import sinkhorn_problem

    def unit(x):
        return x / torch.linalg.vector_norm(x, dim=-1, keepdim=True)

    k0, k1 = m - 1, n - 1
    d1 = unit(torch.randn((b, k1, 64), generator=g, device=DEV))
    pick = torch.randint(0, k1, (k0,), generator=g, device=DEV)
    d0 = unit(d1[:, pick] + 0.2 / 8 * torch.randn((b, k0, 64), generator=g, device=DEV))
    scores = torch.einsum("bmc,bnc->bmn", d0, d1) * 8.0
    m0 = torch.rand((b, k0), generator=g, device=DEV) >= 0.1
    m1 = torch.rand((b, k1), generator=g, device=DEV) >= 0.1
    c, mu, nu, norm = sinkhorn_problem(scores, torch.tensor(1.0, device=DEV), m0, m1)
    return c, mu, nu, norm, m0, m1


def _kernels_sinkhorn(torch, timer, g):
    """K6 and K7 against the plain scan, 100 iterations: u and v within
    SINKHORN_ABS on the slots that carry mass (masked slots hold NEG_INF
    sentinels whose value depends on summation order: an fp32 ulp at 1e9 is
    64), and the matches extracted from the log-assignment identical. The
    kernels sum the exponentials in another order than torch.logsumexp;
    100 contracting iterations keep the difference near the fp32 rounding
    of potentials of size 10 to 20. Matches at MATCH_THRESHOLD: at 4096
    keypoints a planted pair's assignment stays below 0.2 (thousands of
    competitors at scale 8). K7 also with bf16 storage (the plain
    version rounds the coupling the same way). Bounds count the
    exponentials at EXP_PER_S (2 per coupling entry per iteration) and
    each input byte once."""
    from onepose_tpu_torch.models.superglue import extract_matches
    from onepose_tpu_torch.ops.kernels import sinkhorn, sinkhorn_stream

    plain = sinkhorn.sinkhorn_potentials_plain
    runs = [("sinkhorn", shape, None) for shape in SINKHORN_SHAPES]
    runs += [("sinkhorn_stream", shape, dt) for shape in STREAM_SHAPES
             for dt in (None, torch.bfloat16)]
    rows = {}
    for i, (name, shape, cdt) in enumerate(runs):
        c, mu, nu, norm, m0, m1 = _sinkhorn_input(torch, g, *shape)

        def call(iters, name=name, c=c, mu=mu, nu=nu, cdt=cdt):
            if name == "sinkhorn":
                return sinkhorn.sinkhorn_kernel(c, mu, nu, iters)
            return sinkhorn_stream.sinkhorn_stream_kernel(c, mu, nu, iters, coupling_dtype=cdt)

        kern = lambda: call(SINKHORN_ITERS)  # noqa: E731
        ref = lambda: plain(c, mu, nu, SINKHORN_ITERS, coupling_dtype=cdt)  # noqa: E731
        (u, v), (ur, vr) = kern(), ref()
        torch.cuda.synchronize()
        ones = torch.ones((shape[0], 1), dtype=torch.bool, device=DEV)
        vm0, vm1 = torch.cat([m0, ones], 1), torch.cat([m1, ones], 1)
        err = max(float((u - ur).abs()[vm0].max()), float((v - vr).abs()[vm1].max()))
        zs = [c + a[:, :, None] + b[:, None, :] - norm[:, None, None]
              for a, b in ((u, v), (ur, vr))]
        mk, mp = (extract_matches(z, MATCH_THRESHOLD, m0, m1)["matches0"] for z in zs)
        bad, hits = int((mk != mp).sum()), int((mp >= 0).sum())
        finite = bool(torch.isfinite(u).all() and torch.isfinite(v).all())
        store = "bf16" if cdt is not None else "fp32"
        log(f"[kernels] {name} {shape} {store} x {SINKHORN_ITERS}: max abs err on valid slots "
            f"{err:.3e} (<= {SINKHORN_ABS}), {bad} match mismatches (0 required), {hits} matches")
        if not (err <= SINKHORN_ABS and bad == 0 and hits > 0 and finite):
            fail(f"the {name} kernel differs from its plain version")
        prod = shape == (SINKHORN_SHAPES if name == "sinkhorn" else STREAM_SHAPES)[0]
        if not prod:
            log(f"[kernels] {name} {shape} {store}: kernel {timer(kern, reps=3):.4f} ms at "
                f"iters={SINKHORN_ITERS}")
            continue
        b, m, n = shape
        one = timer(lambda: call(1), reps=10)
        ms = timer(kern, reps=10)
        plain_ms = timer(ref, reps=3, warmup=1)
        per_iter = (ms - one) / (SINKHORN_ITERS - 1)
        key = name if cdt is None else "sinkhorn_stream_bf16"
        k = "K6" if name == "sinkhorn" else "K7"
        line = (f"[kernels] {key} ({k}) {shape} {store}: kernel {ms:.4f} ms at iters="
                f"{SINKHORN_ITERS}, {one:.4f} ms at iters=1: {per_iter * 1e3:.2f} us per "
                f"iteration, {one - per_iter:.4f} ms fixed; plain {plain_ms:.4f} ms")
        if name == "sinkhorn_stream":
            sweep = b * m * sinkhorn_stream.row_pitch(n) * (2 if cdt is not None else 4)
            line += (f"; sweeps of {sweep / 1e6:.1f} MB at {sweep / per_iter / 1e9:.3f} TB/s per "
                     f"iteration, {sweep * SINKHORN_ITERS / ms / 1e9:.3f} TB/s over the call; one "
                     f"sweep per iteration at {HBM_BYTES_PER_S / 1e12:.2f} TB/s would take "
                     f"{sweep * SINKHORN_ITERS / HBM_BYTES_PER_S * 1e3:.3f} ms")
        log(line)
        n_bytes = 4 * (b * m * n + 2 * b * (m + n))
        bms, by = bound(n_bytes, 2 * b * m * n * SINKHORN_ITERS, EXP_PER_S)
        rows[key] = dict(
            name=key, route="cuda", source=f"onepose_tpu_torch/csrc/{name}.cu",
            replaces=("onepose_tpu/ops/pallas/sinkhorn.py:78" if name == "sinkhorn" else
                      "onepose_tpu/ops/pallas/sinkhorn_stream.py:105"),
            max_abs_err=err, ms=ms, plain_ms=plain_ms, library_ms=None, bound_ms=bms,
            bound_by=by)
    return rows


def _synthetic_matches(torch, g, b, n, outlier_frac=0.3, noise=0.5):
    from onepose_tpu_torch.geometry.rotations import qvec_to_rotmat

    q = torch.randn((b, 4), generator=g, device=DEV)
    R = qvec_to_rotmat(q / torch.linalg.vector_norm(q, dim=-1, keepdim=True))
    t = torch.tensor([0.01, -0.02, 0.7], device=DEV).repeat(b, 1)
    t[:, 0] += 0.01 * torch.arange(b, device=DEV)
    K = torch.tensor([[600.0, 0, 256], [0, 600.0, 256], [0, 0, 1]], device=DEV).repeat(b, 1, 1)
    pts3d = (torch.rand((b, n, 3), generator=g, device=DEV) - 0.5) * 0.2
    pc = pts3d @ R.transpose(1, 2) + t[:, None]
    uv = pc @ K.transpose(1, 2)
    pts2d = uv[..., :2] / uv[..., 2:3] + noise * torch.randn((b, n, 2), generator=g, device=DEV)
    out = torch.rand((b, n), generator=g, device=DEV) < outlier_frac
    pts2d = torch.where(out[..., None], torch.rand((b, n, 2), generator=g, device=DEV) * 512,
                        pts2d)
    pose = torch.eye(4, device=DEV).repeat(b, 1, 1)
    pose[:, :3, :3], pose[:, :3, 3] = R, t
    return pts2d, pts3d, K, pose


def phase_ransac(torch):
    from onepose_tpu_torch.geometry import aggregate_metrics, query_pose_error, ransac_pnp

    g = torch.Generator(device=DEV).manual_seed(1)
    b, n = RANSAC["batch"], RANSAC["matches"]
    pts2d, pts3d, K, pose_gt = _synthetic_matches(torch, g, b, n)
    mask = torch.ones((b, n), dtype=torch.bool, device=DEV)
    mask[:, n - 100:] = False  # padded slots
    out = ransac_pnp(pts2d, pts3d, K, mask, n_hyp=RANSAC["hypotheses"], generator=g)
    rot, trans = query_pose_error(out["pose"], pose_gt)
    log(f"[ransac] {b} frames x {n} matches, 30% outliers, 0.5 px noise: rot err max "
        f"{float(rot.max()):.4f} deg, trans err max {float(trans.max()):.4f} cm, inliers "
        f"{out['num_inliers'].tolist()}, recall {aggregate_metrics(rot, trans)}")
    if not (bool(out["ok"].all()) and float(rot.max()) < 1.0 and float(trans.max()) < 1.0):
        fail("RANSAC-PnP oracle outside 1 cm / 1 degree")


def _annotation(torch, g, n3, L, c, device):
    from onepose_tpu_torch.runtime.pipeline import ObjectAnnotation

    def unit(x):
        return x / torch.linalg.vector_norm(x, dim=-1, keepdim=True)

    mask3d = torch.ones(n3, dtype=torch.bool, device=device)
    mask3d[n3 - n3 // 20:] = False  # padded points
    return ObjectAnnotation(
        points3d=(torch.rand((n3, 3), generator=g, device=device) - 0.5) * 0.2,
        desc3d=unit(torch.randn((n3, c), generator=g, device=device)),
        leaf_desc=unit(torch.randn((n3, L, c), generator=g, device=device)),
        mask3d=mask3d,
        leaf_mask=torch.rand((n3, L), generator=g, device=device) < 0.8,
    )


def _images(torch, g, b, size, device):
    """Smooth random images (noise blurred at a few scales) in [0, 1]."""
    import torch.nn.functional as F

    img = torch.zeros((b, 1, size, size), device=device)
    for cells in (8, 32, 128):
        noise = torch.rand((b, 1, cells, cells), generator=g, device=device)
        img += F.interpolate(noise, size=(size, size), mode="bilinear", align_corners=False)
    img = (img - img.amin()) / (img.amax() - img.amin())
    return img.permute(0, 2, 3, 1).contiguous()


def _pipelines(torch, n_blocks, configs, **kw):
    """One PosePipeline per (dtype, kernels on, device) in `configs`, all with
    the same random weights (seeded). Kernels on: NMS, VGG stage, fused
    block and dual softmax in bf16; NMS, GATs and dual softmax in fp32."""
    from onepose_tpu_torch.models.gats_spg import GATsSPG
    from onepose_tpu_torch.models.superpoint import SuperPoint
    from onepose_tpu_torch.runtime.pipeline import PosePipeline

    torch.manual_seed(0)
    sp_sd = SuperPoint().state_dict()
    m_sd = GATsSPG(num_blocks=n_blocks).state_dict()
    out = []
    for dtype, on, device in configs:
        bf16 = dtype == torch.bfloat16
        sp = SuperPoint(dtype=dtype, nms_kernel=on, vgg_kernel=on and bf16)
        sp.load_state_dict(sp_sd)
        m = GATsSPG(num_blocks=n_blocks, dtype=dtype, gats_kernel=on and not bf16,
                    block_fused=on and bf16, fused_match=on, match_threshold=MATCH_THRESHOLD)
        m.load_state_dict(m_sd)
        out.append(PosePipeline(superpoint=sp, matcher=m, device=device, compute_dtype=dtype,
                                **kw))
    return out


def _raw_maps(torch, pipe, imgs) -> dict:
    """The pipeline's SuperPoint dense maps with NMS radius 0: the raw score
    map, before NMS and top-k pick among near-ties."""
    sp = pipe.superpoint
    radius, sp.nms_radius = sp.nms_radius, 0
    try:
        with torch.inference_mode():
            return sp(imgs)
    finally:
        sp.nms_radius = radius


def _keypoint_overlap(a, b) -> float:
    """The JAX package's keypoint criterion (tests/test_pipeline.py:254): the
    share of b's valid keypoints that a also holds, averaged over frames."""
    agree = 0.0
    for i in range(a["keypoints"].shape[0]):
        sa = {tuple(k) for k in a["keypoints"][i][a["kpt_mask"][i]].tolist()}
        sb = {tuple(k) for k in b["keypoints"][i][b["kpt_mask"][i]].tolist()}
        agree += len(sa & sb) / max(len(sb), 1) / a["keypoints"].shape[0]
    return agree


def _small_input(torch, g, device):
    imgs = _images(torch, g, 2, 64, device)
    anno = _annotation(torch, g, 32, 4, 256, device)
    K = torch.tensor([[60.0, 0, 32], [0, 60.0, 32], [0, 0, 1]], device=device).repeat(2, 1, 1)
    draws = torch.rand((2, 32, 3), generator=g, device=device)
    return imgs, K, anno, draws


def _small_fp32(torch):
    """fp32: the card (kernels) against the CPU plain path on a small input,
    with the same weights, images and RANSAC draws."""
    gpu, cpu = _pipelines(torch, 2, [(torch.float32, True, DEV), (torch.float32, True, "cpu")],
                          max_keypoints=64, ransac_hypotheses=32)
    imgs, K, anno, draws = _small_input(torch, torch.Generator(device=DEV).manual_seed(2), DEV)
    a = gpu(imgs, K, anno, draws=draws)
    c = cpu(imgs.cpu(), K.cpu(), anno.to("cpu"), draws=draws.cpu())
    kp_agree = float((a["keypoints"].cpu() == c["keypoints"]).all(-1).float().mean())
    m_agree = float((a["matches0"].cpu() == c["matches0"]).float().mean())
    same = (a["keypoints"].cpu() == c["keypoints"]).all(-1)
    desc_err = float((a["descriptors"].cpu() - c["descriptors"])[same].abs().max())
    n_matches = c["num_matches"].tolist()
    log(f"[main] fp32 small input, card vs CPU plain path: keypoint slots agreeing {kp_agree:.4f}, "
        f"matches0 agreeing {m_agree:.4f} (CPU matches/frame {n_matches}, match_threshold "
        f"{MATCH_THRESHOLD}), descriptor max abs err {desc_err:.2e} (fp32 convolutions sum "
        "in another order on each side)")
    if not (kp_agree >= 0.95 and m_agree >= 0.95 and desc_err < 1e-4 and sum(n_matches)):
        fail("the card's fp32 path disagrees with the CPU plain path on a small input")


def _small_bf16(torch):
    """bf16: the card (NMS, VGG-stage, fused-block, dual-softmax kernels)
    against the CPU plain path on a small input. Keypoint slots are
    reported, not held: with random weights the score map is nearly flat,
    and NMS and top-k turn 1-ulp bf16 differences into other picks (the JAX
    package's own two bf16 SuperPoint paths do not agree on every slot
    either). Held: the kept keypoint scores, sorted, within
    1e-4 + 1e-2 relative; then, from the same features, matches0 agreeing
    on at least 90% of the slots and poses within 1e-3 on the frames whose
    matches agree."""
    gpu, cpu = _pipelines(torch, 2, [(torch.bfloat16, True, DEV), (torch.bfloat16, True, "cpu")],
                          max_keypoints=64, ransac_hypotheses=32)
    imgs, K, anno, draws = _small_input(torch, torch.Generator(device=DEV).manual_seed(4), DEV)
    a = {k: v.cpu() for k, v in gpu(imgs, K, anno, draws=draws).items()}
    c = cpu(imgs.cpu(), K.cpu(), anno.to("cpu"), draws=draws.cpu())
    kp_agree = float((a["keypoints"] == c["keypoints"]).all(-1).float().mean())
    counts = [a["kpt_mask"].sum(1).tolist(), c["kpt_mask"].sum(1).tolist()]
    score_ok = True
    for i in range(a["keypoints"].shape[0]):
        n = min(int(a["kpt_mask"][i].sum()), int(c["kpt_mask"][i].sum()))
        sa = torch.sort(a["kpt_scores"][i], descending=True).values[:n]
        sc = torch.sort(c["kpt_scores"][i], descending=True).values[:n]
        score_ok &= bool(torch.allclose(sa, sc, atol=1e-4, rtol=1e-2))
    feats = {"keypoints": c["keypoints"], "descriptors": c["descriptors"],
             "scores": c["kpt_scores"], "mask": c["kpt_mask"]}
    fa = gpu.from_features({k: v.to(DEV) for k, v in feats.items()}, K, anno, draws=draws)
    fc = cpu.from_features(feats, K.cpu(), anno.to("cpu"), draws=draws.cpu())
    m_agree = float((fa["matches0"].cpu() == fc["matches0"]).float().mean())
    same = ((fa["matches0"].cpu() == fc["matches0"]).all(-1) & fa["pnp_ok"].cpu() & fc["pnp_ok"])
    pose_err = float((fa["pose"].cpu() - fc["pose"])[same].abs().max()) if bool(same.any()) else 0.0
    log(f"[main] bf16 small input, card vs CPU plain path: keypoint slots agreeing {kp_agree:.4f} "
        f"(reported), valid keypoints/frame {counts}, kept scores within 1e-4 + 1e-2 rel "
        f"{score_ok}; from the same features: matches0 agreeing {m_agree:.4f} (CPU matches/frame "
        f"{fc['num_matches'].tolist()}), pose max abs err {pose_err:.2e} on "
        f"{int(same.sum())} frame(s) with identical matches")
    if not (score_ok and m_agree >= 0.9 and pose_err <= 1e-3 and int(fc["num_matches"].sum())
            and abs(counts[0][0] - counts[1][0]) <= 3 and abs(counts[0][1] - counts[1][1]) <= 3):
        fail("the card's bf16 path disagrees with the CPU plain path on a small input")


def phase_main(torch, rows):
    from onepose_tpu_torch.ops.kernels import launch_counts, reset_launches

    _small_fp32(torch)
    _small_bf16(torch)

    # Production shapes.
    torch.backends.cudnn.allow_tf32 = True  # PyTorch's defaults for the main path
    torch.backends.cuda.matmul.allow_tf32 = False
    log("[main] TF32: cudnn on, matmul off (PyTorch defaults)")
    B, S, KP, HYP = MAIN["batch"], MAIN["size"], MAIN["keypoints"], MAIN["hypotheses"]
    labels = ("bf16 on", "bf16 off", "fp32 on", "fp32 off")
    bf16, fp32 = torch.bfloat16, torch.float32
    pipes = dict(zip(labels, _pipelines(
        torch, MAIN["blocks"], [(bf16, True, DEV), (bf16, False, DEV), (fp32, True, DEV),
                                (fp32, False, DEV)], max_keypoints=KP, ransac_hypotheses=HYP)))
    g = torch.Generator(device=DEV).manual_seed(3)
    imgs = _images(torch, g, B, S, DEV)
    anno = _annotation(torch, g, MAIN["points"], MAIN["leaves"], 256, DEV)
    K = torch.tensor([[500.0, 0, S / 2], [0, 500.0, S / 2], [0, 0, 1]], device=DEV).repeat(B, 1, 1)
    draws = torch.rand((B, HYP, 3), generator=g, device=DEV)

    nb = MAIN["blocks"]
    none = dict.fromkeys(launch_counts(), 0)
    want = {"bf16 on": {**none, "nms": 1, "vgg_stage": 4, "gats_block": nb, "dual_softmax": 1},
            "fp32 on": {**none, "nms": 1, "gats": nb, "dual_softmax": 1}}
    res = {}
    for label, pipe in pipes.items():
        pipe(imgs, K, anno, draws=draws)  # warm-up (cuDNN autotune, first launches)
        torch.cuda.synchronize()
        reset_launches()  # each path's counts: 0 just before it, read just after
        res[label] = pipe(imgs, K, anno, draws=draws)
        torch.cuda.synchronize()
        counts = launch_counts()
        expect = want.get(label, dict.fromkeys(counts, 0))
        log(f"[main] launches in one {label} PosePipeline call: {counts} (want {expect})")
        if counts != expect:
            fail(f"the {label} path did not launch each kernel as expected")
        keys = {"bf16 on": ("vgg_stage", "gats_block"), "fp32 on": ("nms", "gats", "dual_softmax")}
        for key in keys.get(label, ()):
            if key in rows:
                rows[key]["launches"] = counts[key]

    shapes = {"pose": (B, 4, 4), "keypoints": (B, KP, 2), "descriptors": (B, KP, 256),
              "matches0": (B, KP), "inliers": (B, KP), "num_inliers": (B,)}
    for label, r in res.items():
        for k, shape in shapes.items():
            if tuple(r[k].shape) != shape:
                fail(f"{label}: {k} has shape {tuple(r[k].shape)}, want {shape}")
        for k in ("pose", "descriptors", "matching_scores0", "kpt_scores"):
            if not bool(torch.isfinite(r[k]).all()):
                fail(f"{label}: {k} is not finite")
        if not bool((r["num_matches"] > 0).all()):
            fail(f"{label}: a frame has no match")
    on, off = res["fp32 on"], res["fp32 off"]
    same_kp = bool(torch.equal(on["keypoints"], off["keypoints"]))
    agree = float((on["matches0"] == off["matches0"]).float().mean())
    log(f"[main] fp32 kernels on vs off: keypoints identical {same_kp}, matches0 agreement "
        f"{agree:.4f}; keypoints/frame {on['kpt_mask'].sum(1).tolist()}, matches/frame "
        f"{on['num_matches'].tolist()}, pnp_ok {on['pnp_ok'].tolist()}")
    if not same_kp or agree < 0.95:
        fail("the fp32 kernels-on main path disagrees with the kernels-off path")
    b16 = res["bf16 on"]
    overlap = _keypoint_overlap(b16, on)
    overlap_off = _keypoint_overlap(b16, res["bf16 off"])
    raw = {label: _raw_maps(torch, pipes[label], imgs) for label in ("bf16 on", "fp32 on")}
    s16, s32 = (raw[k]["score_map"] for k in ("bf16 on", "fp32 on"))
    score_rel = float(((s16 - s32).abs() / s32.abs().clamp(min=1e-12)).max())
    desc_err = float((raw["bf16 on"]["descriptor_map"] - raw["fp32 on"]["descriptor_map"]).abs()
                     .max())
    log(f"[main] bf16 (kernels on) vs fp32 (kernels on): raw score maps (NMS radius 0) max rel "
        f"diff {score_rel:.3e} (<= {BF16_SCORE_REL}; scores span {float(s32.min()):.4f} .. "
        f"{float(s32.max()):.4f} with random weights), descriptor maps max abs diff {desc_err:.3e} "
        f"(<= {BF16_DESC_ABS}); keypoint overlap {overlap:.4f} (reported: {KP} slots among many "
        f"near-tied NMS survivors); bf16 kernels on vs off: keypoint overlap {overlap_off:.4f}; "
        f"keypoints/frame {b16['kpt_mask'].sum(1).tolist()}, matches/frame "
        f"{b16['num_matches'].tolist()}, pnp_ok {b16['pnp_ok'].tolist()}")
    if not (score_rel <= BF16_SCORE_REL and desc_err <= BF16_DESC_ABS):
        fail("the bf16 main path's dense maps disagree with the fp32 path's")

    for label, pipe in pipes.items():
        stages = _stage_times(torch, pipe, imgs, K, anno, draws)
        log(f"[main] stages, {label} (ms, median of 5, device synchronized between stages): "
            + ", ".join(f"{k} {v:.2f}" for k, v in stages.items()))
    for label, pipe in pipes.items():
        counts = _stage_launches(torch, pipe, imgs, K, anno, draws)
        log(f"[main] profiler, {label}, per stage of one call (kernel launches, device ms): "
            + ", ".join(f"{k} {n} {ms:.2f}" for k, (n, ms) in counts.items()))
    for label in ("bf16 on", "fp32 on"):
        _device_busy(torch, label, pipes[label], imgs, K, anno, draws)

    def run(pipe, n=TIMED_CALLS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(n):
            pipe(imgs, K, anno, draws=draws)
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) / n * 1e3

    for pipe in pipes.values():  # warm-up
        run(pipe, 3)
    results = {label: [] for label in labels}
    for label in (labels + labels[::-1]) * 2:  # in turns: the host's load drifts
        torch.cuda.reset_peak_memory_stats()
        ms = run(pipes[label])
        peak = torch.cuda.max_memory_allocated() / 2**30
        results[label].append(ms)
        log(f"[main] {label}: {ms:.2f} ms per call of {B} frames, {B / ms * 1e3:.1f} frames/s, "
            f"peak memory {peak:.2f} GiB")
    for label, runs in results.items():
        q1, ms, q3 = statistics.quantiles(runs, n=4)
        log(f"[main] {label} (median of {len(runs)} runs of {TIMED_CALLS} calls): {ms:.2f} ms per "
            f"call (quartiles {q1:.2f} .. {q3:.2f}), {B / ms * 1e3:.1f} frames/s")


def _stages(torch, pipe, imgs, K, anno, draws):
    """The steps of PosePipeline._forward as (name, call) pairs; each call
    reads what the one before it left in a shared dict. Run them in order,
    under torch.inference_mode()."""
    from onepose_tpu_torch.geometry.ransac import ransac_pnp
    from onepose_tpu_torch.models.superpoint import extract_keypoints

    b = imgs.shape[0]
    per_frame = {k: getattr(anno, k)[None].expand((b,) + getattr(anno, k).shape).contiguous()
                 for k in ("desc3d", "leaf_desc", "mask3d", "leaf_mask", "points3d")}
    st = {}

    def superpoint():
        st["dense"] = pipe.superpoint(imgs)

    def keypoints():
        st["feats"] = extract_keypoints(st["dense"]["score_map"], st["dense"]["descriptor_map"],
                                        max_keypoints=pipe.max_keypoints,
                                        keypoint_threshold=pipe.keypoint_threshold,
                                        border=pipe.border)

    def matcher():
        f = st["feats"]
        st["match"] = pipe.matcher(f["descriptors"], per_frame["desc3d"], per_frame["leaf_desc"],
                                   f["mask"], per_frame["mask3d"], per_frame["leaf_mask"])

    def ransac():
        m0 = st["match"]["matches0"]
        idx = m0.clamp(min=0).long()[..., None].expand(-1, -1, 3)
        ransac_pnp(st["feats"]["keypoints"], torch.gather(per_frame["points3d"], 1, idx), K,
                   m0 >= 0, draws=draws, n_hyp=pipe.ransac_hypotheses,
                   reproj_threshold=pipe.reproj_threshold)

    return (("superpoint", superpoint), ("extract_keypoints", keypoints), ("matcher", matcher),
            ("ransac_pnp", ransac))


def _stage_times(torch, pipe, imgs, K, anno, draws, reps=5) -> dict:
    """Host-clock time of each stage of a PosePipeline call, with the device
    synchronized between stages: median of `reps`."""
    times = {}
    with torch.inference_mode():
        stages = _stages(torch, pipe, imgs, K, anno, draws)
        for _ in range(reps):
            for name, call in stages:
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                call()
                torch.cuda.synchronize()
                times.setdefault(name, []).append((time.perf_counter() - t0) * 1e3)
    return {n: statistics.median(v) for n, v in times.items()}


def _stage_launches(torch, pipe, imgs, K, anno, draws) -> dict:
    """(kernel launches, device ms) of each stage of one PosePipeline call,
    each stage under its own torch.profiler (CUDA activity)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    out = {}
    with torch.inference_mode():
        for name, call in _stages(torch, pipe, imgs, K, anno, draws):
            torch.cuda.synchronize()
            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                call()
                torch.cuda.synchronize()
            kernels = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
            out[name] = (len(kernels), sum(e.time_range.elapsed_us() for e in kernels) / 1e3)
    return out


def _device_busy(torch, label, pipe, imgs, K, anno, draws, calls=3) -> None:
    """Kernel time, kernel count and device busy share of PosePipeline calls
    under torch.profiler (CUDA activity), and the kernels taking most time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(calls):
            pipe(imgs, K, anno, draws=draws)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3 / calls
    kernels = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    busy = sum(e.time_range.elapsed_us() for e in kernels) / 1e3 / calls
    by_name = {}
    for e in kernels:
        by_name[e.name] = by_name.get(e.name, 0.0) + e.time_range.elapsed_us() / 1e3 / calls
    log(f"[main] profiler, {label}, per call: {len(kernels) // calls} kernel launches, "
        f"{busy:.2f} ms of device time in {wall:.2f} ms wall under the profiler: device busy "
        f"{100 * busy / wall:.1f}%, idle {100 - 100 * busy / wall:.1f}%")
    for name, ms in sorted(by_name.items(), key=lambda kv: -kv[1])[:8]:
        log(f"[main] profiler top kernel, {label}: {ms:.3f} ms/call  {name[:100]}")


def _pair_feats(np, cfg, seed):
    """Random sequence features: unit descriptors, each frame sharing half
    of its keypoints (noisy copies) with the frame before, 10% of the
    keypoints masked."""
    rng = np.random.default_rng(seed)
    f, n = cfg["frames"], cfg["keypoints"]

    def unit(x):
        return (x / np.linalg.norm(x, axis=-1, keepdims=True)).astype(np.float32)

    desc = unit(rng.standard_normal((f, n, 256), dtype=np.float32))
    for i in range(1, f):
        src = desc[i - 1, rng.permutation(n)[: n // 2]]
        desc[i, : n // 2] = unit(src + 0.1 / 16 * rng.standard_normal(src.shape, dtype=np.float32))
    h, w = PAIR_HW
    kpts = rng.uniform((0, 0), (w, h), size=(f, n, 2)).astype(np.float32)
    return {"keypoints": kpts, "descriptors": desc,
            "scores": rng.random((f, n), dtype=np.float32), "mask": rng.random((f, n)) >= 0.1,
            "image_hw": PAIR_HW}


def _pair_stages(torch, model, feats, pairs):
    """The stages of one chunk through SuperGlue as (name, call) pairs: the
    GNN up to the scores, log_sinkhorn, extract_matches."""
    from onepose_tpu_torch.models.superglue import extract_matches, log_sinkhorn

    idx = torch.as_tensor(pairs, device=DEV)
    ii, jj = idx[:, 0], idx[:, 1]
    k, d, s, m = (torch.from_numpy(feats[x]).to(DEV) for x in
                  ("keypoints", "descriptors", "scores", "mask"))
    st = {}

    def gnn():
        st["sim"] = model.similarity(k[ii], k[jj], d[ii], d[jj], s[ii], s[jj], PAIR_HW, PAIR_HW,
                                     m[ii], m[jj])

    def sink():
        st["z"] = log_sinkhorn(st["sim"], model.bin_score, m[ii], m[jj],
                               model.sinkhorn_iterations, kernel=model.sinkhorn_kernel)

    def extract():
        st["out"] = extract_matches(st["z"], model.match_threshold, m[ii], m[jj])

    return (("gnn", gnn), ("sinkhorn", sink), ("extract_matches", extract)), st


def _profile_stages(torch, stages) -> dict:
    """(kernel launches, device ms) of each stage, each under its own
    torch.profiler (CUDA activity)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    out = {}
    for name, call in stages:
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            call()
            torch.cuda.synchronize()
        kernels = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
        out[name] = (len(kernels), sum(e.time_range.elapsed_us() for e in kernels) / 1e3)
    return out


def _pairs_bf16_storage(torch, sd, feats, pairs, cfg, chunk, n_chunks, res_off, rows, tag):
    """(b) once more with K7's coupling stored in bf16 (SuperGlue's
    sinkhorn_stream_bf16): launches of one match_pairs call (the
    sinkhorn_stream_bf16 row's count), agreement with the plain path, ms per
    chunk of one timed call."""
    from onepose_tpu_torch.models.superglue import SuperGlue
    from onepose_tpu_torch.ops.kernels import launch_counts, reset_launches
    from onepose_tpu_torch.parallel.sfm_parallel import make_superglue_pair_matcher

    model = SuperGlue(match_threshold=MATCH_THRESHOLD, sinkhorn_stream_bf16=True)
    model.load_state_dict(sd)
    match = make_superglue_pair_matcher(model, feats, pair_chunk=cfg["pair_chunk"], device=DEV)
    match(pairs[:chunk])  # warm-up
    torch.cuda.synchronize()
    reset_launches()
    t0 = time.perf_counter()
    res = match(pairs)
    torch.cuda.synchronize()
    sec = time.perf_counter() - t0
    counts = launch_counts()
    want = dict.fromkeys(counts, 0)
    want["sinkhorn_stream"] = n_chunks
    agree = float((res == res_off).mean())
    log(f"[pairs] {tag}, kernels on, K7 bf16 storage: launches {counts} (want {want}); matches "
        f"agreeing with kernels off {agree:.6f}, {int((res >= 0).sum())} matches; "
        f"{sec * 1e3 / n_chunks:.2f} ms per chunk of {chunk} (one call)")
    if counts != want or int((res >= 0).sum()) == 0:
        fail(f"{tag}: the bf16-storage pair matcher did not launch K7 as expected")
    if "sinkhorn_stream_bf16" in rows:
        rows["sinkhorn_stream_bf16"]["launches"] = counts["sinkhorn_stream"]


def phase_pairs(torch, rows):
    """make_superglue_pair_matcher at full width on shapes (a) and (b):
    launch counts per chunk, kernels on against off, stage times, device
    time and Sinkhorn's share of it, ms per chunk, pairs/s, peak memory."""
    import numpy as np

    from onepose_tpu_torch.models.superglue import SuperGlue
    from onepose_tpu_torch.ops.kernels import launch_counts, reset_launches
    from onepose_tpu_torch.parallel.sfm_parallel import make_superglue_pair_matcher

    log(f"[pairs] TF32: cudnn {torch.backends.cudnn.allow_tf32}, matmul "
        f"{torch.backends.cuda.matmul.allow_tf32} (the main path's setting)")
    torch.manual_seed(0)
    sd = SuperGlue().state_dict()
    for seed, cfg in enumerate(PAIRS):
        tag = f"({cfg['label']}) {cfg['frames']} frames x {cfg['keypoints']} keypoints"
        feats = _pair_feats(np, cfg, seed)
        rng = np.random.default_rng(seed)
        pairs = np.stack([np.arange(cfg["pairs"]) % cfg["frames"],
                          (np.arange(cfg["pairs"]) + 1 + rng.integers(0, 2, cfg["pairs"]))
                          % cfg["frames"]], 1)
        models, matchers = {}, {}
        for label, kern in (("on", None), ("off", False)):
            models[label] = SuperGlue(match_threshold=MATCH_THRESHOLD, sinkhorn_kernel=kern)
            models[label].load_state_dict(sd)
            matchers[label] = make_superglue_pair_matcher(models[label], feats,
                                                          pair_chunk=cfg["pair_chunk"], device=DEV)
        chunk = matchers["on"].chunk
        n_chunks = -(-len(pairs) // chunk)
        if chunk != cfg["chunk"]:
            fail(f"{tag}: chunk {chunk}, want {cfg['chunk']}")
        res = {}
        for label, match in matchers.items():
            match(pairs[:chunk])  # warm-up
            torch.cuda.synchronize()
            reset_launches()  # this path's counts: 0 just before it, read just after
            res[label] = match(pairs)
            torch.cuda.synchronize()
            counts = launch_counts()
            want = dict.fromkeys(counts, 0)
            if label == "on":
                want[cfg["kernel"]] = n_chunks
            log(f"[pairs] {tag}, kernels {label}: launches in one match_pairs call of "
                f"{len(pairs)} pairs ({n_chunks} chunks of {chunk}): {counts} (want {want})")
            if counts != want:
                fail(f"{tag}: the kernels-{label} pair matcher did not launch as expected")
            if label == "on" and cfg["kernel"] in rows:
                rows[cfg["kernel"]]["launches"] = counts[cfg["kernel"]]
        if cfg["kernel"] == "sinkhorn_stream":
            _pairs_bf16_storage(torch, sd, feats, pairs, cfg, chunk, n_chunks, res["off"], rows,
                                tag)
        agree = float((res["on"] == res["off"]).mean())
        hits = int((res["on"] >= 0).sum())
        log(f"[pairs] {tag}: kernels on vs off, matches agreeing {agree:.6f} (>= 0.99), "
            f"{hits} matches in {len(pairs)} pairs")
        if agree < 0.99 or hits == 0:
            fail(f"{tag}: the kernels-on pair matcher disagrees with the kernels-off one")

        device_ms = {}
        with torch.inference_mode():
            for label, model in models.items():
                stages, st = _pair_stages(torch, model, feats, pairs[:chunk])
                times = {}
                for _ in range(3):
                    for name, call in stages:
                        torch.cuda.synchronize()
                        t0 = time.perf_counter()
                        call()
                        torch.cuda.synchronize()
                        times.setdefault(name, []).append((time.perf_counter() - t0) * 1e3)
                z, out = st["z"], st["out"]
                if not (bool(torch.isfinite(z).all()) and bool(torch.isfinite(
                        out["matching_scores0"]).all())):
                    fail(f"{tag}: the log-assignment is not finite (kernels {label})")
                prof = _profile_stages(torch, stages)
                total = sum(ms for _, ms in prof.values())
                device_ms[label] = total
                log(f"[pairs] {tag}, kernels {label}, one chunk of {chunk}: stages host ms "
                    "(median of 3, synchronized) " + ", ".join(
                        f"{k} {statistics.median(v):.2f}" for k, v in times.items())
                    + "; launches and device ms " + ", ".join(
                        f"{k} {n} {ms:.2f}" for k, (n, ms) in prof.items())
                    + f"; device {total:.2f} ms, Sinkhorn {100 * prof['sinkhorn'][1] / total:.1f}%")
        runs = {"on": [], "off": []}
        for label in ("on", "off", "off", "on") * PAIR_RUNS:
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            matchers[label](pairs)
            torch.cuda.synchronize()
            sec = time.perf_counter() - t0
            peak = torch.cuda.max_memory_allocated() / 2**30
            runs[label].append(sec * 1e3 / n_chunks)
            log(f"[pairs] {tag}, kernels {label}: {sec * 1e3 / n_chunks:.2f} ms per chunk of "
                f"{chunk}, {len(pairs) / sec:.1f} pairs/s, peak memory {peak:.2f} GiB")
        for label, v in runs.items():
            ms = statistics.median(v)
            log(f"[pairs] {tag}, kernels {label} (median of {len(v)} calls): {ms:.2f} ms per "
                f"chunk, {len(pairs) / (ms * n_chunks) * 1e3:.1f} pairs/s; device "
                f"{device_ms[label]:.2f} ms per chunk")


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--phases", default=",".join(PHASES),
                        help="comma-separated subset of " + ",".join(PHASES))
    args = parser.parse_args(argv)
    phases = args.phases.split(",")
    t_start = time.perf_counter()

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; this script runs on the card", file=sys.stderr)
        return 1
    if not (ROOT / "onepose_tpu_torch" / "csrc").is_dir():
        print("chip_smoke: onepose_tpu_torch is not beside this script", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    log(f"[env] python {sys.version.split()[0]}, torch {torch.__version__}, CUDA "
        f"{torch.version.cuda}, {torch.cuda.device_count()} device(s): "
        f"{torch.cuda.get_device_name(0)}")

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    log("[env] TF32 off (cudnn and matmul) for the parity phases")
    phase_build()  # every other phase needs the kernels
    rows = {}
    if "kernels" in phases:
        rows = phase_kernels(torch, Timer(torch))
    if "ransac" in phases:
        phase_ransac(torch)
    if "main" in phases:
        phase_main(torch, rows)
    if "pairs" in phases:
        phase_pairs(torch, rows)
    log(f"[total] {time.perf_counter() - t_start:.1f} s of command time, the build included")
    if set(phases) != set(PHASES):
        log(f"[partial] ran {phases} of {list(PHASES)}: no result line")
        return 0
    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err", "ms", "plain_ms",
            "bound_ms", "bound_by", "library_ms")
    print(json.dumps({"kernels": [{k: r[k] for k in keys} for r in rows.values()]}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
