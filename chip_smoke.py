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
     iteration; K7's sweep rate, in fp32 and with bf16 storage); NMS also
     on plateau inputs and at radii 10 and 12 (its large-radius entry),
     the dual-softmax head also with planted ties, through its masked
     entry and at two shapes too wide for shared memory; K7's wide entry
     (rows wider than 14848 columns) at 16385 and 20481 columns; then the
     gradients of NMS and the VGG stage (the autograd.Functions Nms and
     VggStage: the kernel forward, the plain VJP recomputed) at the
     production shapes, against autograd through their plain versions on
     the card and against the CPU, a bf16 stage input raising in the
     backward, and SuperPoint at batch 8, 512 x 512 differentiated with
     its NMS kernel on (fp32 and bf16, against the kernel off) and with
     its VGG kernel on (the forward runs, the backward raises, as in the
     JAX package); each backward's time beside its plain version's,
     cuDNN's conv backward and its bound;
  3. the RANSAC-PnP oracle: synthetic matches with a known pose, 0.5 px
     noise and 30% outliers, recovered within 1 cm and 1 degree; and a
     batch whose Gauss-Newton system is singular for some frame (ROADMAP
     C20): no raise, ok and inliers equal to the CPU's;
  4. the serving paths: PosePipeline at batch 8, 512 x 512, 1000 keypoints,
     2000 x 8 points, 512 hypotheses, 4 blocks, d_model 256, 4 heads,
     random weights from a seed, in bf16 (the serving default: NMS, VGG
     stage, fused block and dual-softmax kernels) and in fp32 (NMS, GATs
     and dual-softmax kernels); shapes, finiteness, kernel launch counts
     per path, no masked_fill over the match logits with the kernels on,
     agreement with the CPU plain path on a small input and
     between the paths; per-stage times and launches, device busy share
     and frames/s of bf16 kernels on / off and fp32 kernels on / off;
  5. the pair matcher of `map` (make_superglue_pair_matcher, SuperGlue at
     full width, random weights from a seed): 24 frames x 1024 keypoints in
     chunks of 16 (the resident Sinkhorn kernel) and 12 frames x 4096
     keypoints in chunks of 7 (the streamed one, also with its coupling
     stored in bf16); launches per chunk, kernels on against off, stage
     times, device time and Sinkhorn's share, ms per chunk, pairs/s and
     peak memory, kernels on and off; then SuperGlue's log_sinkhorn at
     16384 keypoints asked for a kernel (K7's wide entry, once in fp32
     and once with bf16 storage) against the plain scan;
  6. map's SfM core (sfm.mapping.run_mapping) at the full width of
     configs/map.yaml on a planted scene of 160 frames x 4096 slots with
     the NN pair matcher on the card: global BA off, on with the cameras
     fixed, on refining them; each against the scene's oracle, with host
     ms per stage, the device stages' launches and device ms, peak memory
     and seconds; the full-width triangulation and a reduced scene's
     run_mapping on the card against the CPU;
  7. the `map` command (python -m onepose_tpu_torch map, through its main()
     in the process) on a rendered 160-frame orbit sequence written as PNG
     files, at configs/map.yaml's width with random weights from a seed
     written as msgpack checkpoints: (a) matcher=nn on every frame (every
     artifact on disk and consistent, K1 once per batch of 8 frames and no
     other kernel), (b) matcher=superglue on the first 48 frames (K7 once
     per chunk of 7 pairs), stage_s and peak memory of each; then the
     card against the CPU on 12 frames (the extracted keypoints by overlap,
     the map's counts), and the decoder that load_gray used; then the host
     commands: convert of seeded reference-layout weights, infer reading
     those files against infer reading their conversion, parse-scan,
     video2img and merge-anno;
  8. the `train` command (python -m onepose_tpu_torch train, in the
     process) on map (a)'s 160 frames at configs/train_gats_spg.yaml's
     width (batch 8, accumulate 2, 1000 keypoint slots, 2000 x 8 points,
     the shipped matcher), random init from a seed: (a) the GATs kernel
     with its gradient (autograd.Function: kernel forward, plain
     recompute) against the plain version at [8, 2000, 8, 256], 20% of the
     leaves masked, and the backward's time beside the forward's; (b) 2
     epochs (ms per micro-step, peak memory, K2 4 launches a micro-step
     and no other kernel, every loss finite), a third epoch resumed from
     ckpt_1, each checkpoint's train-state layout, the run's artifacts,
     and infer serving a batch with the trained checkpoint; (c) 3
     micro-steps on the card and the CPU from one checkpoint, the losses
     within 1e-4 relative;
  9. detect and infer as commands (phases detect, infer);
 10. the BA tracker (phase tracker) at demo's width (1000 keypoint slots,
     window 10, capacity 4096, 128 hypotheses) on a planted 24-frame orbit
     at 512 x 512: every pose within 5 cm / 5 degrees of the ground truth,
     most within 1 degree, the blank-frame motion fallback, ms a tracked
     frame, host syncs (and their source lines), CUDA kernels and busy
     share of a frame, peak
     memory, and the card against the CPU on the same frames and draws;
 11. the demo command (phase demo) on phase detect's full frames against
     phase cli's map: without tracking and with it (K1 / K2 / K3 launches
     a matcher frame and a tracked frame, stage times, peak memory, the
     video), and the route of the first frames on the card against the CPU;
 12. the multi-device work over torch.distributed (phase multi): (a) a
     one-rank NCCL group on the card runs every meshed path at the main
     path's width (PosePipeline.sharded in bf16 and fp32 with its kernels,
     the points-sharded and the tensor-parallel matcher, StagePipeline,
     distributed BA at run_mapping's width, SuperGlue pair matching over
     the data axis with K6 and K7), each against the same call without a
     mesh; (b) two ranks on the same card joined by gloo over CUDA tensors
     (NCCL refuses two ranks on one device), each serving 4 of the 8 frames
     and holding 1000 of the 2000 points, held against (a); each path's
     launches of K1 to K7 and its ms (two ranks share one card: no scaling
     claim); then A17, `onepose_tpu_torch.scripts.audit_collectives` on the
     same two ranks: the collective bytes of the points-sharded matcher and
     the data-parallel train step, a block's equal at N3 2000 and 4000 and
     each kind at its closed form; `--multi-cards N` runs (b) and A17 as
     one NCCL rank on each of N cards instead;
 13. the repository's measurement entry points (phase bench), each run as
     a subprocess under its own time limit and its last line checked:
     `python -m onepose_tpu_torch.bench` (bench.py's four keys, a finite
     positive frames/s, the kernel launches of one call), the stage
     roofline `onepose_tpu_torch.scripts.roofline_audit --sweep` (five
     rows, each measured at or above its bound; batches 8 to 64),
     `onepose_tpu_torch.scripts.bench_train_step` (finite losses), and the
     ports of the last measurement scripts, each with its launches:
     `profile_pnp` (RANSAC-PnP's sub-stages: ms, CUDA kernels, host syncs;
     none in the refine), `bench_pair_batching` (batched matches equal to
     serial), `bench_matcher_parts`, `bench_mixed_attention`,
     `profile_sp_layers`, `profile_superpoint_parts` and `demo_pipeline`
     (parse-scan, map and demo with tracking on a rendered ARKit capture);
 14. SuperPoint's front end in its semantics-preserving forms (phase
     sp_variants), in the process at the scripts' shapes (B 8, 512 x 512):
     `onepose_tpu_torch.scripts.bench_sp_front` (the input conv: cuDNN,
     padded to 8 channels, im2col-9, folded into K5's first stage; the
     score path and its parts), `bench_sp_score` (softmax forms, the path
     plain and with K1, each with a stream sync before NMS; NMS
     separable, as one 2-D window, K1) and `bench_sp_variants` (the whole
     dense forward with each encoder, NMS and sync form, fp32 and bf16,
     kernel flags off and on): each form held against its default within
     the tolerance that models/superpoint_variants.py states, its
     kernels launched, and a line of times a form (the median of
     SP_VARIANT_WINDOWS windows of each module's calls, and the spread);
 15. one JSON line {"kernels": [...]}, then the last line
     {"ok": true, "device": {...}}.

Any failure raises: the script exits non-zero and prints no result line. It
also exits non-zero, printing nothing on stdout, without CUDA or without the
onepose_tpu_torch package beside it. TF32 is off (cudnn and matmul) for
the parity phases; the main path runs with PyTorch's defaults.
"""

from __future__ import annotations

import argparse
import collections
import json
import math
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
PHASES = ("build", "kernels", "ransac", "main", "pairs", "map", "cli", "train", "detect",
          "infer", "tracker", "demo", "multi", "bench", "sp_variants")
HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory
FP32_OPS_PER_S = 67e12  # H100 SXM fp32 outside the tensor cores
BF16_OPS_PER_S = 989e12  # H100 SXM dense bf16 on the tensor cores
NEG_INF = -1e9
DEV = "cuda"

# Shapes. The first entry of each kernel's list is the main path's
# production shape (bench.py's serving configuration), the rest ragged.
NMS_SHAPES = ((8, 512, 512), (3, 136, 200))  # [B, H, W]
GATS_SHAPES = ((8, 2000, 8, 256, True), (3, 37, 5, 96, True), (2, 300, 8, 256, False))
# [B, M, N]; the last two rows are too wide for a band in shared memory
# (every sweep reads device memory), with N % 4 == 0 and not.
DUAL_SHAPES = ((8, 1000, 2000), (3, 45, 203), (1, 160, 24000), (1, 200, 20001))
# [B, H, W, Cin, C1, C2, pool]: the four stages of one encoder pass, then ragged ones
# (the last with input channels padded to 128 and C1 != C2).
VGG_SHAPES = (
    ((8, 512, 512, 1, 64, 64, True), (8, 256, 256, 64, 64, 64, True),
     (8, 128, 128, 64, 128, 128, True), (8, 64, 64, 128, 128, 128, False)),
    ((3, 136, 200, 1, 64, 64, True), (3, 68, 100, 64, 128, 128, True),
     (3, 68, 100, 128, 128, 128, False), (2, 36, 70, 96, 64, 128, True)),
)
# Gradients (Nms, VggStage): NMS radii (the fused entry, the large-radius one);
# K5's gradient against autograd through vgg_stage_reference on the card (max
# abs err over max abs: the same recompute, deterministic cuDNN), and against
# the CPU's (relative L2: the fp32 convs sum in another order, and a ReLU input
# or a pool value within that rounding of its rival routes the gradient the
# other way; those positions are counted); SuperPoint(nms_kernel=True) against
# nms_kernel=False (the NMS VJP is bit-exact and cuDNN deterministic: 0 expected).
GRAD_NMS_RADII = (4, 12)
GRAD_VGG_REL, GRAD_VGG_CPU_REL, GRAD_SP_REL = 1e-5, 1e-2, 1e-6
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
# K7's wide entry (rows wider than its widest instantiation, 14848
# columns), taken on an explicit kernel request: 16384 and 20480 keypoints.
WIDE_SHAPES = ((1, 16385, 16385), (1, 20481, 20481))
SINKHORN_ITERS = 100
STREAM_DRAWS = 6  # more draws of K7's production inputs, checked but not timed
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
# Phase map: run_mapping at the full width of configs/map.yaml (4096
# keypoint slots, 256-d descriptors, num_covis 10, max_points3d 2500,
# num_leaf 8) on a planted scene of 160 frames (one scan of about 800
# frames at the reference's down_ratio 5) on two camera rings, with the
# NN pair matcher on the card; and a reduced scene for the card against
# the CPU.
MAP = dict(frames=160, slots=4096, desc=256, points=12000, planted=3072, noise=0.5, img=512,
           pair_chunk=16)
MAP_SMALL = dict(frames=24, slots=1024, desc=256, points=3000, planted=768, noise=0.5, img=512)
MAP_CONFIG = dict(num_covis=10, max_points3d=2500, num_leaf=8)
# 0.5 px of noise at 500 px focal length and about 1 m is 1 mm a view,
# averaged over the track's views: the median point lands well inside
# 1 mm of its planted point and no point beyond 5 mm (the JAX test's
# bound, tests/test_sfm.py:245).
MAP_ORACLE = dict(median_m=1e-3, max_m=5e-3, min_points=2000)
# Card against CPU: fp32 eigenvectors, solves and sums in another order;
# the map's coordinates are tenths of a metre.
MAP_CARD_CPU_ABS = 1e-4
PAIR_RUNS = 2  # timed match_pairs calls per setting, in turns (on, off, off, on)
# Phase cli: `python -m onepose_tpu_torch map` in the process (its main()),
# on a rendered orbit sequence written as PNG files, with configs/map.yaml's
# values but its weight files (the repo holds none): random weights from a
# seed, written as msgpack checkpoints. (a) matcher=nn on every frame; (b)
# matcher=superglue on the first CLI_SG_FRAMES frames (a depth cut: a chunk
# of 7 pairs takes about 0.41 s at 4096 keypoints, PERF.md section 5);
# per-image annotations as npz (the json writer costs about a second a
# frame at 4096 x 256; the card-against-CPU runs write json).
CLI_SCENE = dict(frames=160, img=512, points=2000, blob=11, focal=1800.0, cube=0.2,
                 win=(10.0, 30.0), noise=(0.1, 0.05))
CLI_MAP = dict(max_keypoints=4096, keypoint_threshold=0.005, num_covis=10, max_points3d=2500,
               num_leaf=8, det_type="GT_box")
CLI_SG_FRAMES = 48
# Random weights: no SuperGlue score clears 0.7, so every mutual maximum
# counts (as phase pairs does); epipolar verification keeps the consistent ones.
CLI_SG_THRESHOLD = 0.0
# A random SuperPoint is not shift-equivariant: its keypoints do not follow
# the planted points, so the map's points are not the planted ones. The
# bounds are the JAX package's own for random weights on a rendered
# sequence (tests/test_cli.py:201-202), with every point inside the planted
# box (the map's box filter).
CLI_ORACLE = dict(min_points=10, max_reproj_px=4.0)
CLI_SMALL = dict(frames=12, keypoints=1024)
# Card against CPU, TF32 off on both: fp32 convolutions sum in another
# order (about 1e-6); a keypoint moves only where NMS or the top-k cut
# meets two scores that close.
CLI_KPT_OVERLAP = 0.99
# C15: cuSOLVER's batched eigh rejected one batch of 39441 4x4 systems.
CLI_DLT_TRACKS = 40000
CLI_DESC_ABS = 1e-4
CLI_COUNT_REL = 0.1
# The serving paths' new kernel shapes, held in phase kernels with a
# generator of their own (the earlier inputs keep their draws): K1 on one
# full phone frame (detect's SuperPoint, batch 1), K6 on detect's SuperGlue
# (15 reference views against one frame, 1000 keypoints each side).
NMS_FULL_FRAME = (1, 1440, 1920)
SINKHORN_DETECT = (15, 1001, 1001)
# Phase detect: `python -m onepose_tpu_torch detect` in the process, the DB
# from phase cli's 160-frame orbit (512 x 512 crops), the queries full
# 1440 x 1920 frames of the same object from viewpoints a quarter step
# round from the DB's; (a) detector_matcher=nn on DETECT_FRAMES frames,
# (b) superglue on DETECT_SG_FRAMES (a depth cut: SuperGlue's GNN takes
# about 0.1 s a frame), then the card against the CPU on DETECT_SMALL
# (an 8-frame DB, a depth cut: the CPU extracts it). The query frames are
# written at zlib level 1 (level 6 took 6 s for 24 frames).
DETECT_FRAMES = 24
DETECT_SG_FRAMES = 8
DETECT = dict(n_ref_views=15, max_keypoints=1000, crop_size=512)
DETECT_HW = (1440, 1920)
QUERY_SUBS = ("color_full", "poses_ba")  # what a query sequence holds besides intrinsics.txt
DETECT_SMALL = dict(db_frames=8, frames=2)
DETECT_BOX_PX = 1.0  # card against CPU
# The box K_crop implies against the detected box: the crop's first stage
# truncates the box to whole pixels and centres it there, which moves each
# side of the implied box by up to about a pixel.
DETECT_IMPLIED_PX = 1.5
# Phase infer: `python -m onepose_tpu_torch infer` in the process at the
# shipped width (batch 8, 1000 keypoints, shape3d 2000, 8 leaves, 4 blocks
# at d_model 256) on phase cli's 160 frames and map and on phase detect's
# crops; the card against the CPU on INFER_SMALL frames; the planted
# oracle (tests/test_cli.py:663) at production width through the feature
# route: INFER_ORACLE frames of 512 x 512, 1000 points with a unit
# descriptor each on a jittered 10^3 grid (spacing 1.8 cm, far above map's
# 1 mm merge), mapped by run_mapping on the card.
INFER_SMALL = 8
INFER_POSE_ABS = 1e-3
INFER_ORACLE = dict(frames=48, grid=10, cube=0.16, jitter=0.003, focal=500.0, img=512,
                    radius=0.6)
# Phase train: `python -m onepose_tpu_torch train` in the process at the
# values of configs/train_gats_spg.yaml (batch 8, accumulate 2, shape2d
# 1000, shape3d 2000, 8 leaves; the shipped matcher: 4 blocks at d_model
# 256) on phase cli's map (a), 160 frames: 2 epochs (a depth cut from 10),
# then a third resumed from ckpt_1; infer takes the trained checkpoint.
# (a) K2's gradient at its training shape, 20% of the leaves masked; (c)
# TRAIN_SMALL micro-steps on the card and the CPU from one checkpoint at
# full width, at a batch the CPU takes in seconds.
TRAIN = dict(batch_size=8, accumulate=2, shape2d=1000, shape3d=2000, num_leaf=8, epochs=2)
TRAIN_GATS = (8, 2000, 8, 256)
# The backward recomputes the plain version, so the gradients are autograd's
# through it on the same inputs; cuBLAS may split a sum differently between
# calls, so the check allows fp32 rounding of the largest entry.
TRAIN_GRAD_REL = 1e-5
TRAIN_SMALL = dict(batch=2, steps=3, accumulate=2)
TRAIN_LOSS_REL = 1e-4  # card against CPU: ROADMAP A11's criterion for the loss history
# Before the first optimizer update both devices hold the same parameters, so
# each micro-step's loss and raw grad_norm differ by fp32 rounding only. The
# first micro-step's whole gradient differs by rounding too, amplified through
# four blocks of backward: 1.051e-4 norm-relative on an H100 (NVIDIA H100
# 80GB HBM3, 700.00 W). A backward with a wrong sign or a missing term differs
# by order 1, so the bound sits a decade above the rounding.
TRAIN_STEP_REL = 1e-5
TRAIN_STEP_GRAD_REL = 1e-3
# Phase tracker: BATracker with TrackerConfig's defaults at demo's width
# (n_kpts 1000: window 10, capacity 4096, 128 hypotheses, 5 BA iterations,
# a keyframe every 5 frames) on tests/test_tracker.py's planted orbit at
# 512 x 512 with 1000 points (256-d descriptors), 24 frames; the ground
# truth's bounds are that test's. The card against the CPU on the same
# frames and draws: flow_ok and used_motion identical; the counts of
# tracked and new points identical up to the first keyframe commit. A new
# point at the triangulation's 20 px or 0.5 m gate is decided by fp32
# rounding (BA's block sums add in atomic order on the card), a committed
# keyframe carries the difference on, and the counts part by up to 2% (7
# of 615 tracked points, 7 of 385 new ones in a chip run; ROADMAP C watch
# item 11); poses within TRACKER_CARD_CPU_ABS (rotation entries and
# metres: 5 mm, about 0.3 degree, against the ground truth's 5 cm).
TRACKER = dict(img=512, points=1000, frames=24, desc=256, focal=960.0, cube=0.25, radius=0.6)
TRACKER_ORACLE = dict(max_cm=5.0, max_deg=5.0, fine_deg=1.0)
TRACKER_CARD_CPU_ABS = 5e-3
TRACKER_COUNT_REL = 0.03
# Phase demo: `python -m onepose_tpu_torch demo` in the process at the
# shipped width (1000 keypoints, 512 crops, shape3d 2000, 8 leaves, the
# gats matcher with K1 / K2 / K3), the DB phase cli's 160 crops and map
# (a), the frames phase detect's 24 full 1440 x 1920 ones (a depth cut).
# (a) without tracking; (b) with tracking, a keyframe every 5 frames and
# redetect_inliers 0: random weights give the matcher no inlier (no score
# clears 0.2), so at the shipped 8 every frame would re-detect and none be
# tracked; at 0 the route is the keyframe cadence. Then the route and
# confidence of DEMO_SMALL's first frames on the card against the CPU (an
# 8-crop DB, a depth cut: the CPU extracts it).
DEMO = dict(max_keypoints=1000, crop_size=512, shape3d=2000, num_leaf=8)
DEMO_RUNS = (("a", ()), ("b", ("use_tracking=true", "kf_interval=5", "redetect_inliers=0")))
DEMO_SMALL = dict(db_frames=8, frames=6)


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


def _reset_peak(torch, phase: str, what: str) -> float:
    """torch.cuda.reset_peak_memory_stats() after a synchronize, logging what
    was allocated at the reset (GiB, returned): a peak read after it is
    that resident memory plus the phase's own."""
    torch.cuda.synchronize()
    resident = torch.cuda.memory_allocated() / 2**30
    torch.cuda.reset_peak_memory_stats()
    log(f"[{phase}] {what}: {resident:.3f} GiB allocated at the peak-memory reset")
    return resident


def phase_build():
    from onepose_tpu_torch.ops.kernels import _build
    from onepose_tpu_torch.utils.profiling import card_line

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
    smi = card_line()
    log(smi)  # the card's name and power limit, as nvidia-smi prints them
    return smi


def _nms_input(torch, g, b, h, w, plateau=False):
    s = torch.rand((b, h, w), generator=g, device=DEV) ** 4
    if plateau:  # quantised scores: many exact ties
        s = torch.floor(s * 8) / 8
    s[:, 5:8, 5:8] = 0.7
    s[:, 0, 0] = 2.0
    s[:, h - 1, w // 2] = 2.0
    s[:, h // 2, w - 1] = 2.0
    s[:, :, 10:12] = 0.0
    return s.contiguous()


def _dual_descriptors(torch, g, b, m, n, c=256):
    def unit(x):
        return x / torch.linalg.vector_norm(x, dim=-1, keepdim=True)

    d3 = unit(torch.randn((b, n, c), generator=g, device=DEV))
    pick = torch.randperm(n, generator=g, device=DEV)[:m]
    noise = torch.randn((b, m, c), generator=g, device=DEV) * (0.3 / c**0.5)
    d2 = unit(d3[:, pick] + noise)  # each row's true column stands out
    m2 = torch.rand((b, m), generator=g, device=DEV) < 0.9
    m3 = torch.rand((b, n), generator=g, device=DEV) < 0.9
    return d2, d3, m2, m3


def _dual_input(torch, g, b, m, n, ties=False):
    """Masked logits; with ties, duplicated columns and rows planted so that
    rows and columns have exact ties at their max."""
    d2, d3, m2, m3 = _dual_descriptors(torch, g, b, m, n)
    s = torch.einsum("bmc,bnc->bmn", d2, d3) / 0.07
    if ties:
        s[:, :, n - 1] = s[:, :, 3]  # duplicated columns: every row ties there
        s[:, :, n // 2] = s[:, :, 3]
        s[:, m - 1] = s[:, 5]  # a duplicated row: its columns tie
        s[:, 7, [3, n // 2, n - 1]] = 40.0
        m2[:, [5, 7, m - 1]] = True
        m3[:, [3, n // 2, n - 1]] = True
    s = s.masked_fill(~m2[:, :, None], NEG_INF).masked_fill(~m3[:, None, :], NEG_INF)
    return s.contiguous()


def _sms(torch) -> int:
    return torch.cuda.get_device_properties(0).multi_processor_count


def phase_kernels(torch, timer):
    from onepose_tpu_torch.ops.kernels import dual_softmax, gats, score_path

    g = torch.Generator(device=DEV).manual_seed(0)
    rows = {}

    # K1 NMS: bit-exact, on smooth and plateau (quantised) inputs; the fused
    # entry at radii 0 .. 9 (compiled once per radius), the large-radius
    # entry at 10 and 12.
    for i, shape in enumerate(NMS_SHAPES):
        prod = i == 0
        smooth = _nms_input(torch, g, *shape)
        for s, plateau in ((smooth, False), (_nms_input(torch, g, *shape, plateau=True), True)):
            for radius in (4, 10, 12) if prod else (0, 1, 4, 9, 10, 12):
                out, ref = score_path.nms(s, radius), score_path.simple_nms(s, radius)
                torch.cuda.synchronize()
                n_bad = int((out != ref).sum())
                n_max = int((out > 0).sum())
                entry = "fused" if radius <= score_path.FUSED_MAX_RADIUS else "large-radius"
                log(f"[kernels] nms {shape} radius {radius} ({entry} entry, "
                    f"{'plateau' if plateau else 'smooth'} input): {n_bad} differing pixels "
                    f"(bit-exact required), {n_max} maxima kept")
                if n_bad or n_max == 0:
                    fail("nms kernel differs from simple_nms")
        if prod:
            s = smooth
            err = float((score_path.nms(s, 4) - score_path.simple_nms(s, 4)).abs().max())
            ms = timer(lambda: score_path.nms(s, 4))
            plain = timer(lambda: score_path.simple_nms(s, 4), reps=5)
            large = timer(lambda: score_path.nms(s, 12), reps=5)
            log(f"[kernels] nms {shape}: radius 12 (large-radius entry, 5 CUDA launches) "
                f"{large:.4f} ms")
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

    # K3 dual-softmax: identical matches, scores <= 1e-6 relative; at the
    # production and ragged shapes, with planted exact ties, and through the
    # masked entry (the kernel reads the masks) at the production shape.
    def dual_check(label, out, ref):
        bad = int((out["matches0"] != ref["matches0"]).sum()
                  + (out["matches1"] != ref["matches1"]).sum())
        rel = max(
            float(((out[k] - ref[k]).abs() / ref[k].abs().clamp(min=1e-30)).max())
            for k in ("matching_scores0", "matching_scores1")
        )
        err = max(float((out[k] - ref[k]).abs().max())
                  for k in ("matching_scores0", "matching_scores1"))
        n_hits = int((out["matches0"] >= 0).sum())
        log(f"[kernels] dual_softmax {label}: {bad} match mismatches (0 required), {n_hits} "
            f"matches, scores max rel err {rel:.3e} (<= 1e-6)")
        if bad or not rel <= 1e-6 or n_hits == 0:
            fail("dual_softmax kernel differs from its plain version")
        return err

    for i, shape in enumerate(DUAL_SHAPES):
        s = _dual_input(torch, g, *shape)
        out = dual_softmax.dual_softmax_match(s, 0.2)
        ref = dual_softmax.dual_softmax_match_plain(s, 0.2)
        torch.cuda.synchronize()
        err = dual_check(f"{shape} plan {tuple(dual_softmax.plan(*shape, _sms(torch)))}", out, ref)
        ref_s = ref
        st = _dual_input(torch, g, *shape, ties=True)
        for thr in (0.2, 0.0):
            out = dual_softmax.dual_softmax_match(st, thr)
            ref = dual_softmax.dual_softmax_match_plain(st, thr)
            torch.cuda.synchronize()
            dual_check(f"{shape} planted ties, threshold {thr}", out, ref)
        if i == 0:
            b, m, n = shape
            d2, d3, m2, m3 = _dual_descriptors(torch, g, b, m, n)
            raw = (torch.einsum("bmc,bnc->bmn", d2, d3) / 0.07).contiguous()
            out = dual_softmax.dual_softmax_match(raw, 0.2, m2, m3)
            ref = dual_softmax.dual_softmax_match_plain(raw, 0.2, m2, m3)
            torch.cuda.synchronize()
            dual_check(f"{shape} masked entry", out, ref)
            ms = timer(lambda: dual_softmax.dual_softmax_match(s, 0.2))
            plain = timer(lambda: dual_softmax.dual_softmax_match_plain(s, 0.2), reps=5)
            # Every resident plan of the shape, each held to the plain
            # version and timed in both orders, beside the planner's cost.
            plans = dual_softmax.resident_plans(b, m, n, _sms(torch))
            times = {q: [] for q in plans}
            for q in plans + plans[::-1]:
                times[q].append(timer(lambda q=q: dual_softmax.dual_softmax_kernel(s, 0.2, p=q)))
            for q in plans:
                dual_check(f"{shape} plan {tuple(q)}",
                           dual_softmax.dual_softmax_kernel(s, 0.2, p=q), ref_s)
            log(f"[kernels] dual_softmax {shape} plans (rows, bands, groups): " + "; ".join(
                f"{q[:3]} cost {dual_softmax.plan_cost(q, b)} {t[0]:.4f} / {t[1]:.4f} ms"
                for q, t in times.items()) + f"; chosen {dual_softmax.plan(b, m, n, _sms(torch))[:3]}")
            masked_ms = timer(lambda: dual_softmax.dual_softmax_match(raw, 0.2, m2, m3))
            fill_ms = timer(lambda: dual_softmax.apply_masks(raw, m2, m3))
            per_call = _kernel_breakdown(torch, lambda: dual_softmax.dual_softmax_match(
                raw, 0.2, m2, m3))
            log(f"[kernels] dual_softmax {shape}: masked entry {masked_ms:.4f} ms against "
                f"{fill_ms:.4f} ms for the two masked_fill passes it replaces; CUDA launches "
                f"per call {sum(n for n, _ in per_call.values())}: " + ", ".join(
                    f"{k[:60]} x{n} {t:.4f} ms" for k, (n, t) in per_call.items()))
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
    rows.update(_kernels_serving(torch, timer))
    rows.update(_kernels_grad(torch, timer))
    for r in rows.values():
        lib = "n/a" if r["library_ms"] is None else f"{r['library_ms']:.4f} ms"
        log(f"[kernels] {r['name']}: kernel {r['ms']:.4f} ms, plain {r['plain_ms']:.4f} ms, "
            f"library {lib}, bound {r['bound_ms']:.4f} ms ({r['bound_by']})")
    return rows


def _bf16_ulp(torch, x):
    """The spacing of bf16 numbers at |x| (8 significant bits)."""
    mag = x.abs().clamp(min=2.0**-126)
    return torch.exp2(torch.floor(torch.log2(mag)) - 7)


def _vgg_stage_args(torch, g, shape, fp32_x=False):
    """A stage's (x, w1, b1, w2, b2, pool) at shape [B, H, W, Cin, C1, C2,
    pool]: x in [0, 1) for the image stage, else a ReLU'd activation in
    bf16 (as the previous stage writes it) or, with fp32_x, in fp32."""
    b, h, w, cin, c1, c2, pool = shape
    if cin == 1:
        x = torch.rand((b, h, w, 1), generator=g, device=DEV)
    else:
        x = torch.relu(torch.randn((b, h, w, cin), generator=g, device=DEV))
        x = x if fp32_x else x.bfloat16()
    w1 = torch.randn((3, 3, cin, c1), generator=g, device=DEV) * (2.0 / (9 * cin)) ** 0.5
    w2 = torch.randn((3, 3, c1, c2), generator=g, device=DEV) * (2.0 / (9 * c1)) ** 0.5
    b1 = torch.randn((c1,), generator=g, device=DEV) * 0.1
    b2 = torch.randn((c2,), generator=g, device=DEV) * 0.1
    return x, w1, b1, w2, b2, pool


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

    from onepose_tpu_torch.ops.kernels import _build, vgg_stage

    prod, err = [], 0.0
    klib = _build.load("vgg_stage")
    for i, shapes in enumerate(VGG_SHAPES):
        for shape in shapes:
            cin, c1, c2 = shape[3:6]
            th = klib.vgg_stage_tile_rows(cin, c1, c2)
            if th != vgg_stage.tile_rows(cin, c1, c2):
                fail(f"vgg_stage tile height {th} differs from the Python mirror's")
            args = _vgg_stage_args(torch, g, shape)
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


def _planted_scores(torch, g, b, k0, k1):
    """Scores [b, k0, k1] of a planted assignment (after the JAX test's,
    test_pallas_kernels.py:506-513): unit descriptors and copies of them
    with noise of norm 0.2, at scale 8; masks with 10% of the keypoints
    out."""

    def unit(x):
        return x / torch.linalg.vector_norm(x, dim=-1, keepdim=True)

    d1 = unit(torch.randn((b, k1, 64), generator=g, device=DEV))
    pick = torch.randint(0, k1, (k0,), generator=g, device=DEV)
    d0 = unit(d1[:, pick] + 0.2 / 8 * torch.randn((b, k0, 64), generator=g, device=DEV))
    scores = torch.einsum("bmc,bnc->bmn", d0, d1) * 8.0
    m0 = torch.rand((b, k0), generator=g, device=DEV) >= 0.1
    m1 = torch.rand((b, k1), generator=g, device=DEV) >= 0.1
    return scores, m0, m1


def _sinkhorn_input(torch, g, b, m, n):
    """The transport problem of log_sinkhorn for `_planted_scores` with a
    dustbin score of 1. Returns (couplings [b, m, n], log_mu, log_nu, norm,
    mask0, mask1)."""
    from onepose_tpu_torch.models.superglue import sinkhorn_problem

    scores, m0, m1 = _planted_scores(torch, g, b, m - 1, n - 1)
    c, mu, nu, norm = sinkhorn_problem(scores, torch.tensor(1.0, device=DEV), m0, m1)
    return c, mu, nu, norm, m0, m1


def _near_tie_mismatches(torch, zk, zp, m0, m1, err):
    """The rows whose matches differ between the kernel's (zk) and the plain
    (zp) log-assignment, with their plain leads and the largest lead an
    error of err in the potentials can overturn. A row's lead is the least
    of: its best minus its runner-up, and the same in the columns of both
    argmaxes (mutuality turns on those). A comparison inside a row moves by
    two errors of v, inside a column by two of u, and each value compared
    carries one fp32 rounding: tolerance 2 err + 2 ulps of the largest |z|.
    Returns (number of rows, their leads, tolerance)."""
    from onepose_tpu_torch.models.superglue import extract_matches

    mk, mp = (extract_matches(z, MATCH_THRESHOLD, m0, m1)["matches0"] for z in (zk, zp))
    bad = (mk != mp).nonzero().tolist()
    if not bad:
        return 0, [], 0.0
    inner_p, inner_k = zp[:, :-1, :-1], zk[:, :-1, :-1]
    top_r = inner_p.topk(2, dim=2).values
    top_c = inner_p.topk(2, dim=1).values
    lead_r, lead_c = top_r[..., 0] - top_r[..., 1], top_c[:, 0] - top_c[:, 1]
    idx_p, idx_k = inner_p.argmax(dim=2), inner_k.argmax(dim=2)
    leads = [min(float(lead_r[b, i]), float(lead_c[b, idx_p[b, i]]),
                 float(lead_c[b, idx_k[b, i]])) for b, i in bad]
    valid = m0[:, :, None] & m1[:, None, :]
    ulp = torch.finfo(torch.float32).eps * float(inner_p[valid].abs().max())
    return len(bad), leads, 2 * err + 2 * ulp


def _kernels_sinkhorn(torch, timer, g):
    """K6 and K7 against the plain scan, 100 iterations: u and v within
    SINKHORN_ABS on the slots that carry mass (masked slots hold NEG_INF
    sentinels whose value depends on summation order: an fp32 ulp at 1e9 is
    64), and the matches extracted from the log-assignment identical but on
    near ties (`_near_tie_mismatches`: a row may differ only where the plain
    lead is within what the measured error can overturn; the leads are
    printed). The kernels sum the exponentials in another order than
    torch.logsumexp; 100 contracting iterations keep the difference near
    the fp32 rounding of potentials of size 10 to 20. Matches at
    MATCH_THRESHOLD: at 4096 keypoints a planted pair's assignment stays
    below 0.2 (thousands of competitors at scale 8). K7 also with bf16
    storage (the plain version rounds the coupling the same way), and in
    fp32 at its production shape on STREAM_DRAWS more draws (a generator
    each), where near ties turn up. Bounds count the exponentials at EXP_PER_S (2 per coupling entry
    per iteration) and each input byte once."""
    from onepose_tpu_torch.models.superglue import extract_matches
    from onepose_tpu_torch.ops.kernels import launch_counts, sinkhorn, sinkhorn_stream

    plain = sinkhorn.sinkhorn_potentials_plain
    runs = [("sinkhorn", shape, None, g, "") for shape in SINKHORN_SHAPES]
    runs += [("sinkhorn_stream", shape, dt, g, "") for shape in STREAM_SHAPES
             for dt in (None, torch.bfloat16)]
    runs += [("sinkhorn_stream_wide", shape, dt, g, "") for shape in WIDE_SHAPES
             for dt in (None, torch.bfloat16)]
    for k in range(STREAM_DRAWS, 0, -1):
        gen = torch.Generator(device=DEV).manual_seed(6 + k)
        runs.insert(len(SINKHORN_SHAPES) + 1,
                    ("sinkhorn_stream", STREAM_SHAPES[0], None, gen, f" (draw {k + 1})"))
    rows = {}
    for name, shape, cdt, gen, draw in runs:
        c, mu, nu, norm, m0, m1 = _sinkhorn_input(torch, gen, *shape)

        def call(iters, name=name, c=c, mu=mu, nu=nu, cdt=cdt):
            if name == "sinkhorn":
                return sinkhorn.sinkhorn_kernel(c, mu, nu, iters)
            return sinkhorn_stream.sinkhorn_stream_kernel(c, mu, nu, iters, coupling_dtype=cdt)

        kern = lambda: call(SINKHORN_ITERS)  # noqa: E731
        ref = lambda: plain(c, mu, nu, SINKHORN_ITERS, coupling_dtype=cdt)  # noqa: E731
        before = launch_counts()
        (u, v), (ur, vr) = kern(), ref()
        torch.cuda.synchronize()
        moved = [k for k, x in launch_counts().items() if x != before[k]]
        if moved != [name]:
            fail(f"{name} {shape}: the call launched {moved}, not {name}")
        ones = torch.ones((shape[0], 1), dtype=torch.bool, device=DEV)
        vm0, vm1 = torch.cat([m0, ones], 1), torch.cat([m1, ones], 1)
        err = max(float((u - ur).abs()[vm0].max()), float((v - vr).abs()[vm1].max()))
        zk, zp = (c + a[:, :, None] + b[:, None, :] - norm[:, None, None]
                  for a, b in ((u, v), (ur, vr)))
        hits = int((extract_matches(zp, MATCH_THRESHOLD, m0, m1)["matches0"] >= 0).sum())
        bad, leads, tol = _near_tie_mismatches(torch, zk, zp, m0, m1, err)
        ties = all(lead <= tol for lead in leads)
        finite = bool(torch.isfinite(u).all() and torch.isfinite(v).all())
        store = "bf16" if cdt is not None else "fp32"
        line = (f"[kernels] {name} {shape} {store}{draw} x {SINKHORN_ITERS}: max abs err on "
                f"valid slots {err:.3e} (<= {SINKHORN_ABS}), {bad} match mismatches (only on "
                f"near ties), {hits} matches")
        if bad:
            line += (f"; plain leads of the mismatched rows "
                     f"{', '.join(f'{x:.3e}' for x in leads)} against {tol:.3e} "
                     f"(2 x err + 2 ulps): {'all near ties' if ties else 'NOT all near ties'}")
        log(line)
        if not (err <= SINKHORN_ABS and ties and hits > 0 and finite):
            fail(f"the {name} kernel differs from its plain version")
        if draw:
            continue
        prod = shape == {"sinkhorn": SINKHORN_SHAPES, "sinkhorn_stream": STREAM_SHAPES,
                         "sinkhorn_stream_wide": WIDE_SHAPES}[name][0]
        if not prod:
            log(f"[kernels] {name} {shape} {store}: kernel {timer(kern, reps=3):.4f} ms at "
                f"iters={SINKHORN_ITERS}")
            continue
        b, m, n = shape
        one = timer(lambda: call(1), reps=10)
        ms = timer(kern, reps=10)
        plain_ms = timer(ref, reps=3, warmup=1)
        per_iter = (ms - one) / (SINKHORN_ITERS - 1)
        key = name if cdt is None else f"{name}_bf16"
        k = {"sinkhorn": "K6", "sinkhorn_stream": "K7"}.get(name, "K7 wide entry")
        line = (f"[kernels] {key} ({k}) {shape} {store}: kernel {ms:.4f} ms at iters="
                f"{SINKHORN_ITERS}, {one:.4f} ms at iters=1: {per_iter * 1e3:.2f} us per "
                f"iteration, {one - per_iter:.4f} ms fixed; plain {plain_ms:.4f} ms")
        if name != "sinkhorn":
            # The design's floor: one sweep of the stored coupling per
            # iteration (two for the wide entry, whose second pass may
            # miss L2).
            sweeps = 2 if name == "sinkhorn_stream_wide" else 1
            sweep = b * m * sinkhorn_stream.row_pitch(n) * (2 if cdt is not None else 4)
            line += (f"; sweeps of {sweep / 1e6:.1f} MB at {sweep / per_iter / 1e9:.3f} TB/s per "
                     f"iteration, {sweep * SINKHORN_ITERS / ms / 1e9:.3f} TB/s over the call; "
                     f"{sweeps} sweep(s) per iteration at {HBM_BYTES_PER_S / 1e12:.2f} TB/s would "
                     f"take {sweeps * sweep * SINKHORN_ITERS / HBM_BYTES_PER_S * 1e3:.3f} ms")
        log(line)
        n_bytes = 4 * (b * m * n + 2 * b * (m + n))
        bms, by = bound(n_bytes, 2 * b * m * n * SINKHORN_ITERS, EXP_PER_S)
        rows[key] = dict(
            name=key, route="cuda",
            replaces=("onepose_tpu/ops/pallas/sinkhorn.py:78" if name == "sinkhorn" else
                      "onepose_tpu/ops/pallas/sinkhorn_stream.py:105"),
            source=f"onepose_tpu_torch/csrc/{name.replace('_wide', '')}.cu",
            max_abs_err=err, ms=ms, plain_ms=plain_ms, library_ms=None, bound_ms=bms,
            bound_by=by)
    return rows


def _kernels_serving(torch, timer):
    """K1 at NMS_FULL_FRAME (detect's full frame; bit-exact, smooth and
    plateau inputs) and K6 at SINKHORN_DETECT (detect's SuperGlue: valid
    slots within SINKHORN_ABS, matches identical but on near ties), each
    beside its plain version and bound, timed as the rows above."""
    from onepose_tpu_torch.ops.kernels import _build, score_path, sinkhorn

    g = torch.Generator(device=DEV).manual_seed(41)
    rows = {}
    b, h, w = NMS_FULL_FRAME
    smooth = _nms_input(torch, g, b, h, w)
    for x, kind in ((smooth, "smooth"), (_nms_input(torch, g, b, h, w, plateau=True), "plateau")):
        out, ref = score_path.nms(x, 4), score_path.simple_nms(x, 4)
        torch.cuda.synchronize()
        n_bad, n_max = int((out != ref).sum()), int((out > 0).sum())
        log(f"[kernels] nms {NMS_FULL_FRAME} radius 4 ({kind} input, a full frame): {n_bad} "
            f"differing pixels (bit-exact required), {n_max} maxima kept")
        if n_bad or n_max == 0:
            fail("nms kernel differs from simple_nms on a full frame")
    row = dict(name="nms_full_frame", route="cuda", source="onepose_tpu_torch/csrc/score_path.cu",
               replaces="onepose_tpu/ops/pallas/score_path.py:94", max_abs_err=0.0,
               ms=timer(lambda: score_path.nms(smooth, 4)),
               plain_ms=timer(lambda: score_path.simple_nms(smooth, 4), reps=5), library_ms=None)
    row["bound_ms"], row["bound_by"] = bound(2 * smooth.numel() * 4, 5 * 2 * 9 * smooth.numel())
    rows["nms_full_frame"] = row

    b, m, n = SINKHORN_DETECT
    c, mu, nu, norm, m0, m1 = _sinkhorn_input(torch, g, b, m, n)
    sms = _build.device_sms(c.device)
    p = sinkhorn.plan(m, n, sms=sms)
    lib = _build.load("sinkhorn")
    max_blocks = _build.resident_blocks(lib, "sinkhorn_max_blocks", p.warps_per_group, p.chunks,
                                        p.smem)
    ppw = sinkhorn.pairs_per_wave(b, p.blocks_per_pair, max_blocks)
    kern = lambda: sinkhorn.sinkhorn_kernel(c, mu, nu, SINKHORN_ITERS)  # noqa: E731
    ref = lambda: sinkhorn.sinkhorn_potentials_plain(c, mu, nu, SINKHORN_ITERS)  # noqa: E731
    (u, v), (ur, vr) = kern(), ref()
    torch.cuda.synchronize()
    ones = torch.ones((b, 1), dtype=torch.bool, device=DEV)
    vm0, vm1 = torch.cat([m0, ones], 1), torch.cat([m1, ones], 1)
    err = max(float((u - ur).abs()[vm0].max()), float((v - vr).abs()[vm1].max()))
    zk, zp = (c + a[:, :, None] + bb[:, None, :] - norm[:, None, None]
              for a, bb in ((u, v), (ur, vr)))
    bad, leads, tol = _near_tie_mismatches(torch, zk, zp, m0, m1, err)
    ties = all(lead <= tol for lead in leads)
    log(f"[kernels] sinkhorn {SINKHORN_DETECT} (detect's SuperGlue) x {SINKHORN_ITERS}: plan "
        f"{p.blocks_per_pair} bands of {p.rows} rows a pair ({p.warps_per_group} warps a group, "
        f"{p.chunks} chunks a thread), {max_blocks} resident blocks, {ppw} pairs a wave, "
        f"{-(-b // ppw)} waves; max abs err on valid slots {err:.3e} (<= {SINKHORN_ABS}), {bad} "
        f"match mismatches (only on near ties{': leads ' + ', '.join(f'{x:.3e}' for x in leads) if bad else ''})")
    if not (err <= SINKHORN_ABS and ties and torch.isfinite(u).all() and torch.isfinite(v).all()):
        fail("the sinkhorn kernel differs from its plain version at detect's shape")
    bms, by = bound(4 * (b * m * n + 2 * b * (m + n)), 2 * b * m * n * SINKHORN_ITERS, EXP_PER_S)
    rows["sinkhorn_detect"] = dict(
        name="sinkhorn_detect", route="cuda", source="onepose_tpu_torch/csrc/sinkhorn.cu",
        replaces="onepose_tpu/ops/pallas/sinkhorn.py:78", max_abs_err=err,
        ms=timer(kern, reps=10), plain_ms=timer(ref, reps=3, warmup=1), library_ms=None,
        bound_ms=bms, bound_by=by)
    return rows


def _bits_differ(torch, a, b) -> int:
    """Elements of two fp32 tensors whose bits differ (0.0 and -0.0 too)."""
    return int((a.contiguous().view(torch.int32) != b.contiguous().view(torch.int32)).sum())


def _vgg_routing(torch, x, w1, b1, w2, b2, pool) -> list:
    """Where the fp32 stage (vgg_stage_reference, TF32 off) routes its
    gradient: the sign of each ReLU input (the tie at 0 halves it) and,
    with the pool, which values of each 2 x 2 window reach its max."""
    import torch.nn.functional as F

    with torch.no_grad():
        y = F.conv2d(x.permute(0, 3, 1, 2), w1.permute(3, 2, 0, 1), padding=1)
        y = y + b1[:, None, None]
        z = F.conv2d(y.clamp_min(0), w2.permute(3, 2, 0, 1), padding=1) + b2[:, None, None]
        out = [torch.sign(y).to(torch.int8), torch.sign(z).to(torch.int8)]
        if pool:
            b, c, h, w = z.shape
            zw = z.clamp_min(0).reshape(b, c, h // 2, 2, w // 2, 2)
            out.append(zw == zw.amax(dim=(3, 5), keepdim=True))
    return out


def _kernels_grad(torch, timer):
    """K1's and K5's gradients (`Nms`, `VggStage`: the kernel forward on
    detached inputs, the backward the plain VJP recomputed, as the JAX
    package's `_bwd`s recompute through XLA) at the production shapes, TF32
    off, cuDNN deterministic for the comparisons:
    (a) K1 at NMS_SHAPES[0], radii GRAD_NMS_RADII, smooth and plateau
        inputs: output and gradient bit-equal to autograd through
        simple_nms on the card and to the CPU's; one launch a forward;
    (b) K5 at the four stages of VGG_SHAPES[0], each alone with an fp32 x:
        every gradient within GRAD_VGG_REL of autograd through
        vgg_stage_reference on the card, within GRAD_VGG_CPU_REL (relative
        L2) of the CPU's, with the ReLU and pool positions that route the
        gradient differently on the two devices counted; a bf16 x raises
        TypeError in the backward on both, as the JAX package's VJP does;
    (c) SuperPoint(nms_kernel=True) at MAIN's batch and size, fp32 and
        bf16: the gradients of a fixed loss of score_map and descriptor_map
        with respect to the image and every parameter within GRAD_SP_REL
        of nms_kernel=False's, nms launched once; SuperPoint(vgg_kernel=True,
        nms_kernel=True) runs its forward under autograd (vgg_stage 4, nms 1)
        and its backward raises TypeError.
    Times: forward plus backward, the backward alone (CUDA events; device ms
    and CUDA kernels from torch.profiler), the plain version's, cuDNN's fp32
    conv backward for K5's eight convs, and the bounds."""
    import contextlib

    from onepose_tpu_torch.models.superpoint import SuperPoint
    from onepose_tpu_torch.ops.kernels import launch_counts, reset_launches, score_path, vgg_stage

    g = torch.Generator(device=DEV).manual_seed(43)
    rows = {}
    none = dict.fromkeys(launch_counts(), 0)
    dev_ms = lambda d: sum(ms for _, ms in d.values())  # noqa: E731
    dev_n = lambda d: sum(n for n, _ in d.values())  # noqa: E731
    max_abs = lambda t: float(t.abs().max())  # noqa: E731

    @contextlib.contextmanager
    def deterministic():
        old = torch.backends.cudnn.deterministic
        torch.backends.cudnn.deterministic = True
        try:
            yield
        finally:
            torch.backends.cudnn.deterministic = old

    def vjp(fn, ins, cot, *args):
        ins = [t.detach().requires_grad_() for t in ins]
        out = fn(*ins, *args)
        return out.detach(), torch.autograd.grad(out, ins, cot)

    # (a) K1: bit-equal, the forward one launch.
    shape = NMS_SHAPES[0]
    for plateau in (False, True):
        s = _nms_input(torch, g, *shape, plateau=plateau)
        cot = torch.randn(shape, generator=g, device=DEV)
        for radius in GRAD_NMS_RADII:
            torch.cuda.synchronize()
            reset_launches()
            out, (grad,) = vjp(score_path.nms, [s], cot, radius)
            torch.cuda.synchronize()
            n_launch = launch_counts()["nms"]
            ref_out, (ref,) = vjp(score_path.simple_nms, [s], cot, radius)
            cpu_out, (cpu,) = vjp(score_path.nms, [s.cpu()], cot.cpu(), radius)
            bad = _bits_differ(torch, out, ref_out) + _bits_differ(torch, grad, ref)
            bad_cpu = _bits_differ(torch, out.cpu(), cpu_out) + _bits_differ(torch, grad.cpu(), cpu)
            kept_zeros = int(((out == 0) & (grad != 0)).sum())
            log(f"[kernels] nms gradient {shape} radius {radius} "
                f"({'plateau' if plateau else 'smooth'} input): {n_launch} launch (1 required); "
                f"against autograd through simple_nms {bad} and against the CPU {bad_cpu} "
                f"differing output and gradient values (bit-equal required); "
                f"{int((grad != 0).sum())} non-zero, {kept_zeros} of them at kept zeros")
            if bad or bad_cpu or n_launch != 1 or not bool((grad != 0).any()):
                fail("the nms gradient differs from simple_nms's VJP")
    s = _nms_input(torch, g, *shape)
    cot = torch.randn(shape, generator=g, device=DEV)
    st = s.detach().requires_grad_()
    ms = timer(lambda: torch.autograd.grad(score_path.nms(st, 4), st, cot))
    plain = timer(lambda: torch.autograd.grad(score_path.simple_nms(st, 4), st, cot), reps=5)
    out, out_p = score_path.nms(st, 4), score_path.simple_nms(st, 4)
    bwd = lambda: torch.autograd.grad(out, st, cot, retain_graph=True)  # noqa: E731
    bwd_p = lambda: torch.autograd.grad(out_p, st, cot, retain_graph=True)  # noqa: E731
    bwd_ms, bwd_p_ms = timer(bwd), timer(bwd_p, reps=5)
    bwd_dev, bwd_p_dev = _kernel_breakdown(torch, bwd), _kernel_breakdown(torch, bwd_p)
    n = s.numel()
    # The least work: read the scores and the cotangent, write the output and
    # the gradient; the forward's window maxima and a select.
    bms, by = bound(4 * n * 4, 5 * 2 * 9 * n + n)
    bwd_bound, bwd_by = bound(3 * n * 4, 5 * 2 * 9 * n + n)
    log(f"[kernels] nms gradient {shape} radius 4: forward (kernel) plus backward {ms:.4f} ms "
        f"(plain {plain:.4f}), bound {bms:.4f} ms ({by}); backward alone (the mask recomputed) "
        f"{bwd_ms:.4f} ms, {dev_ms(bwd_dev):.4f} ms device time in {dev_n(bwd_dev)} CUDA "
        f"kernels, bound {bwd_bound:.4f} ms ({bwd_by}); autograd through simple_nms's backward "
        f"(a select with the mask its forward kept) {bwd_p_ms:.4f} ms "
        f"({dev_ms(bwd_p_dev):.4f} ms device time)")
    rows["nms_grad"] = dict(
        name="nms_grad", route="cuda", source="onepose_tpu_torch/csrc/score_path.cu",
        replaces="onepose_tpu/ops/pallas/score_path.py:133", max_abs_err=0.0, ms=ms,
        plain_ms=plain, library_ms=None, bound_ms=bms, bound_by=by,
        extra=dict(backward="onepose_tpu_torch/ops/kernels/score_path.py::Nms",
                   backward_ms=bwd_ms, backward_device_ms=dev_ms(bwd_dev),
                   backward_cuda_kernels=dev_n(bwd_dev), backward_bound_ms=bwd_bound,
                   plain_backward_ms=bwd_p_ms))

    # (b) K5, each production stage alone with an fp32 x.
    names = ("x", "w1", "b1", "w2", "b2")
    prod, err_all = [], 0.0
    for shape in VGG_SHAPES[0]:
        *ins, pool = _vgg_stage_args(torch, g, shape, fp32_x=True)
        b, h, w, cin, c1, c2, _ = shape
        out_shape = (b, h // 2, w // 2, c2) if pool else (b, h, w, c2)
        cot = torch.randn(out_shape, generator=g, device=DEV).to(vgg_stage._out_dtype(cin))
        prod.append((ins, pool, cot))
        with deterministic():
            torch.cuda.synchronize()
            reset_launches()
            _, got = vjp(vgg_stage.vgg_stage, ins, cot, pool)
            torch.cuda.synchronize()
            n_launch = launch_counts()["vgg_stage"]
            _, ref = vjp(vgg_stage.vgg_stage_reference, ins, cot.float(), pool)
        errs = [(max_abs(a - r), max_abs(r)) for a, r in zip(got, ref)]
        err_all = max(err_all, *(e for e, _ in errs))
        _, cpu = vjp(vgg_stage.vgg_stage, [t.cpu() for t in ins], cot.cpu(), pool)
        rel = [float(torch.linalg.vector_norm(a.cpu() - c) / torch.linalg.vector_norm(c))
               for a, c in zip(got, cpu)]
        flips = [int((a.cpu() != c).sum()) for a, c in zip(
            _vgg_routing(torch, *ins, pool), _vgg_routing(torch, *(t.cpu() for t in ins), pool))]
        log(f"[kernels] vgg_stage gradient {shape} (fp32 x): {n_launch} launch (1 required); "
            f"against autograd through vgg_stage_reference on the card, max abs err / max abs "
            f"of " + ", ".join(f"{k} {e:.3e} / {m:.3e}" for k, (e, m) in zip(names, errs))
            + f" (<= {GRAD_VGG_REL} x max); against the CPU, relative L2 "
            + ", ".join(f"{k} {r:.3e}" for k, r in zip(names, rel))
            + f" (<= {GRAD_VGG_CPU_REL}), positions routed differently (ReLU 1, ReLU 2"
            + (", pool" if pool else "") + f"): {flips}; gradient dtypes "
            + str(sorted({str(a.dtype) for a in got})))
        if (n_launch != 1 or any(not (e <= GRAD_VGG_REL * m and m > 0) for e, m in errs)
                or any(not r <= GRAD_VGG_CPU_REL for r in rel)
                or any(a.dtype != torch.float32 for a in got)):
            fail("the vgg_stage gradient differs from vgg_stage_reference's VJP")
    (x, *ws), pool, cot = prod[1]
    for dev in (DEV, "cpu"):
        wd = [t.detach().to(dev).requires_grad_() for t in ws]
        reset_launches()
        out = vgg_stage.vgg_stage(x.to(dev).bfloat16(), *wd, pool)
        n_launch = launch_counts()["vgg_stage"]
        try:
            torch.autograd.grad(out, wd, cot.to(dev))
        except TypeError as e:
            log(f"[kernels] vgg_stage gradient {tuple(x.shape)} with a bf16 x on {dev}: forward "
                f"ran ({n_launch} launch), backward raised TypeError as JAX's VJP does: "
                f"{str(e)[:100]}...")
        else:
            fail(f"a vgg_stage backward with a bf16 x did not raise on {dev}")
        if n_launch != (1 if dev == DEV else 0):
            fail("the vgg_stage forward with a bf16 x did not launch as expected")

    packs = [vgg_stage.pack_stage_weights(*ins[1:]) for ins, _, _ in prod]
    leaves = [[t.detach().requires_grad_() for t in ins] for ins, _, _ in prod]

    def fwd_bwd():
        for ins, (_, pool, cot), p in zip(leaves, prod, packs):
            torch.autograd.grad(vgg_stage.vgg_stage(*ins, pool, packed=p), ins, cot)

    def plain_fwd_bwd():
        for ins, (_, pool, cot) in zip(leaves, prod):
            torch.autograd.grad(vgg_stage.vgg_stage_reference(*ins, pool), ins, cot.float())

    outs = [vgg_stage.vgg_stage(*ins, pool, packed=p)
            for ins, (_, pool, _), p in zip(leaves, prod, packs)]

    def bwd():
        for o, ins, (_, _, cot) in zip(outs, leaves, prod):
            torch.autograd.grad(o, ins, cot, retain_graph=True)

    # cuDNN's fp32 conv backward alone for the eight convs (input, weight
    # and bias gradients), NCHW: the library yardstick of the backward.
    lib_args = []
    for (x, w1, _, w2, _), _, _ in prod:
        b, h, w, cin = x.shape
        for wt in (w1, w2):
            weight = wt.permute(3, 2, 0, 1).contiguous()
            lib_args.append((torch.randn((b, weight.shape[0], h, w), generator=g, device=DEV),
                             torch.randn((b, weight.shape[1], h, w), generator=g, device=DEV),
                             weight))

    def library():
        for gout, inp, weight in lib_args:
            torch.ops.aten.convolution_backward(gout, inp, weight, [weight.shape[0]], [1, 1],
                                                [1, 1], [1, 1], False, [0, 0], 1,
                                                [True, True, True])

    ms, plain = timer(fwd_bwd, reps=5), timer(plain_fwd_bwd, reps=5)
    bwd_ms, lib = timer(bwd, reps=5), timer(library, reps=5)
    bwd_dev = _kernel_breakdown(torch, bwd, calls=2)
    n_bytes = fwd_ops = 0
    for (x, w1, b1, w2, b2), pool, cot in prod:
        b, h, w, cin = x.shape
        c1, c2 = w1.shape[-1], w2.shape[-1]
        # read x, the weights and the cotangent, write the output and the
        # five gradients (fp32 but the bf16 output of a multi-channel stage)
        n_bytes += (2 * x.numel() + 2 * (w1.numel() + w2.numel() + c1 + c2)) * 4
        n_bytes += 2 * cot.numel() * cot.element_size()
        fwd_ops += 2 * b * h * w * 9 * (cin * c1 + c1 * c2)
    # The forward in bf16 on the tensor cores; the VJP of the fp32 stage
    # recomputes its fp32 forward (the ReLU and pool routing) and takes the
    # input and weight gradients: three times the forward's flops in fp32.
    t_ops = (fwd_ops / BF16_OPS_PER_S + 3 * fwd_ops / FP32_OPS_PER_S) * 1e3
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    bms, by = max(t_ops, t_bytes), "operations" if t_ops >= t_bytes else "bytes"
    bwd_bound = 3 * fwd_ops / FP32_OPS_PER_S * 1e3
    log(f"[kernels] vgg_stage gradient, one encoder pass (4 stages, fp32 x): forward (4 kernel "
        f"launches) plus backward {ms:.4f} ms; backward alone (vgg_stage_reference recomputed "
        f"under autograd) {bwd_ms:.4f} ms, {dev_ms(bwd_dev):.4f} ms device time in "
        f"{dev_n(bwd_dev)} CUDA kernels (the most device time: " + ", ".join(
            f"{k[:60]} x{n} {t:.4f} ms" for k, (n, t) in sorted(
                bwd_dev.items(), key=lambda kv: -kv[1][1])[:5])
        + f"), bound {bwd_bound:.4f} ms (operations: "
        f"{3 * fwd_ops / 1e9:.1f} GFLOP in fp32); the reference's forward plus backward "
        f"{plain:.4f} ms; cuDNN's fp32 conv backward alone (8 calls) {lib:.4f} ms; bound of "
        f"forward plus backward {bms:.4f} ms ({by}: {fwd_ops / 1e9:.1f} GFLOP in bf16, "
        f"{3 * fwd_ops / 1e9:.1f} in fp32)")
    rows["vgg_stage_grad"] = dict(
        name="vgg_stage_grad", route="cuda", source="onepose_tpu_torch/csrc/vgg_stage.cu",
        replaces="onepose_tpu/ops/pallas/vgg_stage.py:287", max_abs_err=err_all, ms=ms,
        plain_ms=plain, library_ms=lib, bound_ms=bms, bound_by=by,
        extra=dict(backward="onepose_tpu_torch/ops/kernels/vgg_stage.py::VggStage",
                   backward_ms=bwd_ms, backward_device_ms=dev_ms(bwd_dev),
                   backward_cuda_kernels=dev_n(bwd_dev), backward_bound_ms=bwd_bound))
    del outs, lib_args, leaves

    # (c) The path: SuperPoint under autograd with its kernels on.
    B, S = MAIN["batch"], MAIN["size"]
    torch.manual_seed(0)
    sd = SuperPoint().state_dict()
    img = torch.rand((B, S, S, 1), generator=g, device=DEV)
    cots = (torch.randn((B, S, S), generator=g, device=DEV),
            torch.randn((B, S // 8, S // 8, 256), generator=g, device=DEV))

    def model(**kw):
        m = SuperPoint(**kw).to(DEV)
        m.load_state_dict(sd)
        return m

    def sp_grads(m):
        im = img.detach().requires_grad_()
        out = m(im)
        return torch.autograd.grad([out["score_map"], out["descriptor_map"]],
                                   [im, *m.parameters()], cots)

    for dtype in (torch.float32, torch.bfloat16):
        kern, plain_m = model(nms_kernel=True, dtype=dtype), model(nms_kernel=False, dtype=dtype)
        labels = ["image", *(name for name, _ in kern.named_parameters())]
        sp_grads(kern)  # warm-up (cuDNN, the first launches)
        with deterministic():
            torch.cuda.synchronize()
            reset_launches()  # the path's counts: 0 just before it, read just after
            got = sp_grads(kern)
            torch.cuda.synchronize()
            counts = launch_counts()
            want = sp_grads(plain_m)
        errs = {k: (max_abs(a.float() - w.float()), max_abs(w.float()))
                for k, a, w in zip(labels, got, want)}
        same = sum(_bits_differ(torch, a.float(), w.float()) == 0 for a, w in zip(got, want))
        finite = all(bool(torch.isfinite(a).all()) for a in got)
        worst = max(errs, key=lambda k: errs[k][0] / max(errs[k][1], 1e-30))
        ms_k, ms_p = timer(lambda: sp_grads(kern), reps=5), timer(lambda: sp_grads(plain_m), reps=5)
        log(f"[kernels] SuperPoint(nms_kernel=True) {str(dtype)[6:]} at {(B, S, S, 1)} under "
            f"autograd: launches {counts} (want nms 1); gradients of the image and "
            f"{len(labels) - 1} parameters against nms_kernel=False (cuDNN deterministic): "
            f"{same} of {len(labels)} bit-identical, worst {worst} {errs[worst][0]:.3e} / "
            f"{errs[worst][1]:.3e} (<= {GRAD_SP_REL} x max), finite {finite}; forward plus "
            f"backward {ms_k:.4f} ms, nms_kernel=False {ms_p:.4f} ms")
        if (counts != {**none, "nms": 1} or not finite
                or any(not (e <= GRAD_SP_REL * m and m > 0) for e, m in errs.values())):
            fail(f"SuperPoint(nms_kernel=True) {dtype} gradients differ from the plain path's")
        if dtype == torch.float32:
            rows["nms_grad"]["launches"] = counts["nms"]
            rows["nms_grad"]["extra"]["superpoint_fwd_bwd_ms"] = ms_k
            rows["nms_grad"]["max_abs_err"] = max(e for e, _ in errs.values())
        del kern, plain_m, got, want

    m = model(vgg_kernel=True, nms_kernel=True)
    im = img.detach().requires_grad_()
    torch.cuda.synchronize()
    reset_launches()  # the path's counts: 0 just before it, read just after
    out = m(im)
    torch.cuda.synchronize()
    counts = launch_counts()
    want = {**none, "nms": 1, "vgg_stage": 4}
    if counts != want or not bool(torch.isfinite(out["score_map"]).all()):
        fail(f"SuperPoint(vgg_kernel=True) under autograd launched {counts}, want {want}")
    try:
        torch.autograd.grad([out["score_map"], out["descriptor_map"]], [im, *m.parameters()],
                            cots)
    except TypeError as e:
        log(f"[kernels] SuperPoint(vgg_kernel=True, nms_kernel=True) fp32 at {(B, S, S, 1)} "
            f"under autograd: forward launches {counts}; backward raised TypeError as jax.grad "
            f"through SuperPoint(use_pallas=True) does: {str(e)[:100]}...")
    else:
        fail("the backward of SuperPoint(vgg_kernel=True) did not raise")
    rows["vgg_stage_grad"]["launches"] = counts["vgg_stage"]
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
    _ransac_singular(torch)


def _ransac_singular(torch):
    """ROADMAP C20 on the card: 8 frames of 16 matches with 3D points on a
    0.1 grid, integer pixels and 1 to 3 valid matches a frame (as
    tests/test_torch_geometry.py::_gridded_batch makes them, seed 17) and
    draws from default_rng(1017): a batch whose refine has an exactly
    singular normal matrix in fp32, on which torch.linalg.solve raised on
    the CPU. The batch must not raise, and ok, num_inliers and inliers must
    equal the CPU's for the same draws."""
    import numpy as np

    from onepose_tpu_torch.geometry import ransac_pnp

    rng = np.random.default_rng(17)
    b, n = 8, 16
    pts3d = (rng.integers(-3, 4, size=(b, n, 3)) * 0.1).astype(np.float32)
    pts2d = rng.integers(0, 512, size=(b, n, 2)).astype(np.float32)
    mask = np.zeros((b, n), bool)
    for f in range(b):
        mask[f, rng.choice(n, rng.integers(1, 4), replace=False)] = True
    K = np.broadcast_to(np.array([[600.0, 0, 256], [0, 600.0, 256], [0, 0, 1]], np.float32),
                        (b, 3, 3)).copy()
    draws = np.random.default_rng(1017).random((b, 64, 3)).astype(np.float32)
    outs = [ransac_pnp(*(torch.from_numpy(x).to(dev) for x in (pts2d, pts3d, K, mask, draws)),
                       n_hyp=64) for dev in (DEV, "cpu")]
    card, cpu = ({k: v.cpu() for k, v in o.items()} for o in outs)
    same = all(torch.equal(card[k], cpu[k]) for k in ("ok", "num_inliers", "inliers"))
    log(f"[ransac] C20 (a singular refine in the batch): no raise; ok {card['ok'].tolist()}, "
        f"num_inliers {card['num_inliers'].tolist()}; ok, num_inliers and inliers equal to "
        f"the CPU's: {same}; poses finite {bool(torch.isfinite(card['pose']).all())}")
    if not (same and bool(torch.isfinite(card["pose"]).all())):
        fail("RANSAC-PnP on the C20 batch differs from the CPU's")


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

    # The fused head reads the masks itself: no masked_fill over the
    # [B, keypoints, points] logits in a kernels-on call (the off paths keep
    # the two).
    orig_fill, fills = torch.Tensor.masked_fill, []

    def counting_fill(x, *a, **k):
        if tuple(x.shape) == (B, KP, MAIN["points"]):
            fills.append(1)
        return orig_fill(x, *a, **k)

    for label in labels:
        fills.clear()
        torch.Tensor.masked_fill = counting_fill
        try:
            pipes[label](imgs, K, anno, draws=draws)
        finally:
            torch.Tensor.masked_fill = orig_fill
        want_fills = 0 if label.endswith(" on") else 2
        log(f"[main] {label}: {len(fills)} masked_fill passes over the match logits "
            f"(want {want_fills})")
        if len(fills) != want_fills:
            fail(f"the {label} matcher head ran {len(fills)} masked_fill passes")

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
        _reset_peak(torch, "main", label)
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


def _pairs_wide_request(torch, rows):
    """(c) An explicit Sinkhorn kernel request above K7's widest row:
    SuperGlue's log_sinkhorn at WIDE_SHAPES[0] (16384 keypoints a side, a
    planted assignment) with sinkhorn_kernel=True and with bf16 storage
    launches K7's wide entry once each; the default mode takes the plain
    scan and launches nothing, as before. The kernel route's matches equal
    the scan's but on near ties (`_near_tie_mismatches`, with the largest
    difference of the log-assignment on valid slots as the error); bf16
    storage is held to the scan of the bf16-rounded coupling through the
    wrappers' plain version."""
    from onepose_tpu_torch.models.superglue import extract_matches, log_sinkhorn
    from onepose_tpu_torch.ops.kernels import launch_counts, reset_launches

    g = torch.Generator(device=DEV).manual_seed(11)
    b, m, n = WIDE_SHAPES[0]
    scores, m0, m1 = _planted_scores(torch, g, b, m - 1, n - 1)
    bin_score = torch.tensor(1.0, device=DEV)
    ones = torch.ones((b, 1), dtype=torch.bool, device=DEV)
    valid = torch.cat([m0, ones], 1)[:, :, None] & torch.cat([m1, ones], 1)[:, None, :]
    z = {}
    for label, kw, key in (("default", {}, None),
                           ("sinkhorn_kernel=True", dict(kernel=True), "sinkhorn_stream_wide"),
                           ("stream_bf16=True", dict(stream_bf16=True),
                            "sinkhorn_stream_wide_bf16")):
        torch.cuda.synchronize()
        reset_launches()  # this path's counts: 0 just before it, read just after
        z[label] = log_sinkhorn(scores, bin_score, m0, m1, SINKHORN_ITERS, **kw)
        torch.cuda.synchronize()
        counts = launch_counts()
        want = dict.fromkeys(counts, 0)
        if key:
            want["sinkhorn_stream_wide"] = 1
        log(f"[pairs] (c) log_sinkhorn {(b, m - 1, n - 1)} scores, {label}: launches {counts} "
            f"(want {want})")
        if counts != want:
            fail(f"log_sinkhorn {label} above K7's widest row did not launch as expected")
        if key in rows:
            rows[key]["launches"] = counts["sinkhorn_stream_wide"]
    with torch.inference_mode():
        from onepose_tpu_torch.models.superglue import sinkhorn_problem
        from onepose_tpu_torch.ops.kernels.sinkhorn import sinkhorn_potentials_plain

        c, mu, nu, norm = sinkhorn_problem(scores, bin_score, m0, m1)
        u, v = sinkhorn_potentials_plain(c, mu, nu, SINKHORN_ITERS, torch.bfloat16)
        z["plain bf16"] = c + u[:, :, None] + v[:, None, :] - norm[:, None, None]
        del c, u, v
    for label, ref in (("sinkhorn_kernel=True", "default"), ("stream_bf16=True", "plain bf16")):
        zk, zp = z[label], z[ref]
        err = float((zk - zp).abs()[valid].max())
        bad, leads, tol = _near_tie_mismatches(torch, zk, zp, m0, m1, err)
        hits = int((extract_matches(zk, MATCH_THRESHOLD, m0, m1)["matches0"] >= 0).sum())
        ok = all(lead <= tol for lead in leads) and hits > 0 and bool(torch.isfinite(zk).all())
        log(f"[pairs] (c) {label} against the {ref} scan: log-assignment max abs err on valid "
            f"slots {err:.3e}, {bad} match mismatches (only on near ties; leads "
            f"{', '.join(f'{x:.3e}' for x in leads) or 'none'} against {tol:.3e}), {hits} "
            f"matches")
        if not ok or err > 10 * SINKHORN_ABS:
            fail(f"log_sinkhorn {label} above K7's widest row disagrees with the scan")


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
            _reset_peak(torch, "pairs", f"{tag}, kernels {label}")
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
    _pairs_wide_request(torch, rows)


def _look_at(np, center):
    """World->camera pose looking at the origin (tests/test_sfm.py:18)."""
    z = -center / np.linalg.norm(center)
    x = np.cross([0.0, 0.0, 1.0], z)
    x /= np.linalg.norm(x)
    R = np.stack([x, np.cross(z, x), z])
    pose = np.eye(4)
    pose[:3, :3], pose[:3, 3] = R, -R @ center
    return pose


def _map_scene(np, cfg, seed):
    """The planted object scene of tests/test_sfm.py::make_scene (:35) at
    map's width: `points` points in a 0.2 m cube, each with a unit
    descriptor of `desc` dimensions; `frames` cameras on two rings of radius
    1 m (heights 0.3 and 0.7 m, with make_scene's wobble), the two
    sequences of seq_ids 0 and 1. Each point is seen from an azimuth window
    of its own, a half-width of 3 + 32 u^2 degrees (u uniform), so that
    track lengths spread below max_track_length and the track-length
    threshold lands near max_points3d; each frame fills its `slots` with
    its visible points (at most `planted`, a random subset), projected with
    `noise` px of noise, and random distractors with random unit descriptors
    in the rest."""
    rng = np.random.default_rng(seed)
    n_pts, F, S, C = cfg["points"], cfg["frames"], cfg["slots"], cfg["desc"]
    pts = (rng.random((n_pts, 3)) - 0.5) * 0.2
    desc_gt = rng.standard_normal((n_pts, C), dtype=np.float32)
    desc_gt /= np.linalg.norm(desc_gt, axis=-1, keepdims=True)
    az_p = rng.random(n_pts) * 2 * np.pi
    half = np.radians(3.0 + 32.0 * rng.random(n_pts) ** 2)
    img = cfg["img"]
    K = np.array([[500.0, 0, img / 2], [0, 500.0, img / 2], [0, 0, 1]])
    per = F // 2
    seq = np.arange(F) // per
    poses = np.zeros((F, 4, 4))
    kpts = np.zeros((F, S, 2), np.float32)
    descs = np.zeros((F, S, C), np.float32)
    masks = np.ones((F, S), bool)
    gt_ids = np.full((F, S), -1, np.int64)
    for f in range(F):
        ang = 2 * np.pi * (f % per + 0.5 * seq[f]) / per
        center = np.array([np.cos(ang), np.sin(ang), 0.3 + 0.4 * seq[f] + 0.1 * np.sin(3 * ang)])
        poses[f] = _look_at(np, center)
        R, t = poses[f, :3, :3], poses[f, :3, 3]
        pc = pts @ R.T + t
        uv = pc @ K.T
        uv = uv[:, :2] / uv[:, 2:3]
        d_az = np.abs((az_p - ang + np.pi) % (2 * np.pi) - np.pi)
        vis = ((d_az <= half) & (pc[:, 2] > 0.1) & (uv > 8).all(1) & (uv < img - 8).all(1))
        ids = rng.permutation(np.nonzero(vis)[0])[:cfg["planted"]]
        n = len(ids)
        kpts[f, :n] = uv[ids] + rng.normal(size=(n, 2)) * cfg["noise"]
        descs[f, :n] = desc_gt[ids]
        gt_ids[f, :n] = ids
        kpts[f, n:] = rng.uniform(8, img - 8, size=(S - n, 2))
        noise = rng.standard_normal((S - n, C), dtype=np.float32)
        descs[f, n:] = noise / np.linalg.norm(noise, axis=-1, keepdims=True)
    return {"pts": pts, "K": np.broadcast_to(K, (F, 3, 3)).astype(np.float32),
            "poses": poses.astype(np.float32), "keypoints": kpts, "descriptors": descs,
            "scores": rng.random((F, S), dtype=np.float32), "mask": masks, "gt_ids": gt_ids,
            "seq_ids": seq}


class _StageClock:
    """Host ms of run_mapping's stages, each call synchronized on both
    sides, by wrapping the functions that `sfm.mapping` calls (and the
    pair matcher); with `profile`, the device stages also run under
    torch.profiler: (launches, device ms) each. `last` keeps each
    stage's latest output (the tracks, for the card against the CPU)."""

    STAGES = {
        "covis": ("covis_pairs_from_poses",),
        "verify": ("epipolar_verify_matches",),
        "tracks": ("build_tracks",),
        "triangulate": ("triangulate_and_filter_tracks",),
        "filter and merge": ("track_length_for_max_points", "filter_points_by_box",
                             "merge_close_points"),
        "BA": ("_global_ba",),
        "aggregate, leaves, assign": ("aggregate_point_features", "build_leaf_slots",
                                      "assign_matrix_for_frame"),
    }
    DEVICE = ("matching", "verify", "triangulate", "BA")

    def __init__(self, torch, device, profile=False):
        self.torch, self.cuda, self.profile = torch, device != "cpu", profile
        self.ms = {}
        self.dev = {}
        self.last = {}

    def wrap(self, name, fn):
        torch = self.torch

        def sync():
            if self.cuda:
                torch.cuda.synchronize()

        def timed(*a, **k):
            sync()
            t0 = time.perf_counter()
            if self.profile and self.cuda and name in self.DEVICE:
                from torch.autograd import DeviceType
                from torch.profiler import ProfilerActivity, profile

                with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                    out = fn(*a, **k)
                    sync()
                kern = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
                n, ms = self.dev.get(name, (0, 0.0))
                self.dev[name] = (n + len(kern),
                                  ms + sum(e.time_range.elapsed_us() for e in kern) / 1e3)
            else:
                out = fn(*a, **k)
                sync()
            self.ms[name] = self.ms.get(name, 0.0) + (time.perf_counter() - t0) * 1e3
            self.last[name] = out
            return out

        return timed

    def run(self, mapping, *args, match, **kw):
        """mapping.run_mapping(*args, match, **kw) with every stage timed;
        the module's functions are restored afterwards."""
        saved = {fn: getattr(mapping, fn) for fns in self.STAGES.values() for fn in fns}
        try:
            for stage, fns in self.STAGES.items():
                for fn in fns:
                    setattr(mapping, fn, self.wrap(stage, saved[fn]))
            return mapping.run_mapping(*args, self.wrap("matching", match), **kw)
        finally:
            for fn, orig in saved.items():
                setattr(mapping, fn, orig)


def _map_run(torch, np, scene, cfg, label, device, matcher, profile=False):
    """One run_mapping of `scene` on `device` (NN pairs from `matcher`),
    timed by stage; returns (result, clock, seconds, peak GiB)."""
    from onepose_tpu_torch.sfm import mapping

    config = mapping.MappingConfig(num_covis=MAP_CONFIG["num_covis"],
                                   max_points3d=MAP_CONFIG["max_points3d"],
                                   num_leaf=MAP_CONFIG["num_leaf"], **cfg)
    clock = _StageClock(torch, device, profile)
    if device != "cpu":
        _reset_peak(torch, "map", label)
    t0 = time.perf_counter()
    res = clock.run(mapping, scene["keypoints"], scene["descriptors"], scene["scores"],
                    scene["mask"], scene["K"], scene["poses"], match=matcher,
                    seq_ids=scene["seq_ids"], config=config, device=device)
    sec = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() / 2**30 if device != "cpu" else 0.0
    return res, clock, sec, peak


def _map_oracle(np, scene, res, label, tag):
    """The planted scene's oracle: map's point budget, each point near its
    planted point, reprojection under a pixel, BA that does not raise the
    RMSE, refined poses only when asked, the annotation's mask3d exactly
    the real slots, one-to-one assign matrices."""
    st = res.stats
    P = st["num_points3d"]
    d = np.sqrt(((res.points_xyz[:, None, :].astype(np.float64) - scene["pts"][None]) ** 2)
                .sum(-1)).min(1)
    med, worst = float(np.median(d)), float(d.max())
    mask3d = res.annotation.mask3d.cpu().numpy()
    one_to_one = all(len(np.unique(a[0])) == a.shape[1] == len(np.unique(a[1]))
                     and (a.shape[1] == 0 or a[1].max() < P) for a in res.frame_assign.values())
    ba = "global_ba_rmse_final_px" in st
    log(f"[map] {tag} ({label}): {st['num_pairs']} pairs, {st['num_tracks']} tracks, {P} "
        f"points (in ({MAP_ORACLE['min_points']}, {MAP_CONFIG['max_points3d']}]), track length "
        f"threshold {st['track_length_threshold']}, "
        f"{st['num_observations']} observations; distance to the planted point median "
        f"{med * 1e3:.4f} mm (< {MAP_ORACLE['median_m'] * 1e3} mm), max {worst * 1e3:.4f} mm "
        f"(< {MAP_ORACLE['max_m'] * 1e3} mm); mean reprojection error "
        f"{st['mean_reproj_error_px']:.4f} px (< 1)"
        + (f"; BA RMSE {st['global_ba_rmse_initial_px']:.6f} -> "
           f"{st['global_ba_rmse_final_px']:.6f} px" if ba else "")
        + f"; refined poses {'present' if res.refined_poses is not None else 'absent'}; "
        f"mask3d real slots {int(mask3d.sum())}; assign matrices one-to-one {one_to_one}")
    want_poses = label == "c"
    good = (MAP_ORACLE["min_points"] < P <= MAP_CONFIG["max_points3d"]
            and med < MAP_ORACLE["median_m"]
            and worst < MAP_ORACLE["max_m"] and st["mean_reproj_error_px"] < 1.0
            and (res.refined_poses is not None) == want_poses
            and (not ba or st["global_ba_rmse_final_px"] <= st["global_ba_rmse_initial_px"])
            and ba == (label != "a") and bool(mask3d[:P].all()) and not mask3d[P:].any()
            and one_to_one)
    if not good:
        fail(f"phase map ({label}) fails the planted scene's oracle")


def _map_card_vs_cpu(torch, np):
    """run_mapping on MAP_SMALL on the card against the port's own CPU run
    (the NN matcher on each device), global BA off and refining the
    cameras: the same tracks and integer stats, points within
    MAP_CARD_CPU_ABS."""
    from onepose_tpu_torch.parallel.sfm_parallel import make_nn_pair_matcher

    scene = _map_scene(np, MAP_SMALL, seed=1)
    out = {}
    for dev in (DEV, "cpu"):
        match = make_nn_pair_matcher(scene["descriptors"], scene["mask"], distance_thresh=0.2,
                                     device=dev)
        for label, cfg in (("a", {}), ("c", dict(global_ba=True,
                                                 global_ba_refine_cameras=True))):
            res, clock, sec, _ = _map_run(torch, np, scene, cfg, label, dev, match)
            out[dev, label] = (res, clock.last["tracks"], sec)
    ints = ("num_frames", "num_pairs", "num_tracks", "num_points3d", "track_length_threshold",
            "num_observations")
    for label in ("a", "c"):
        (rk, tk, sk), (rc, tc, sc) = out[DEV, label], out["cpu", label]
        same_tracks = all(np.array_equal(getattr(tk, k), getattr(tc, k))
                          for k in ("obs_frame", "obs_kpt", "obs_mask", "lengths"))
        same_ints = all(rk.stats[k] == rc.stats[k] for k in ints)
        same_shape = rk.points_xyz.shape == rc.points_xyz.shape
        err = float(np.abs(rk.points_xyz - rc.points_xyz).max()) if same_shape else float("inf")
        pose_err = (float(np.abs(rk.refined_poses - rc.refined_poses).max())
                    if label == "c" else 0.0)
        log(f"[map] card against CPU, {MAP_SMALL['frames']} frames x {MAP_SMALL['slots']} "
            f"slots ({label}): tracks identical {same_tracks}, integer stats identical "
            f"{same_ints} ({rk.stats['num_points3d']} points, {rk.stats['num_tracks']} tracks), "
            f"points max abs diff {err:.3e} m, refined poses {pose_err:.3e} (<= "
            f"{MAP_CARD_CPU_ABS}); {sk:.2f} s on the card, {sc:.2f} s on the CPU")
        if not (same_tracks and same_ints and err <= MAP_CARD_CPU_ABS
                and pose_err <= MAP_CARD_CPU_ABS):
            fail(f"run_mapping ({label}) on the card disagrees with the CPU run")


def _map_triangulation_card_vs_cpu(torch, np, scene, tracks):
    """The full-width scene's tracks (about 1e4, 32 slots) through
    triangulate_and_filter_tracks on the card and on the CPU: the batched
    4x4 eigh of the DLT and the GN solves agree; ok and obs_inlier
    identical, xyz within MAP_CARD_CPU_ABS where ok."""
    from onepose_tpu_torch.sfm.triangulate import triangulate_and_filter_tracks

    P = scene["poses"]
    args = [np.ascontiguousarray(a) for a in (
        tracks.obs_frame, tracks.obs_kpt, tracks.obs_mask, scene["keypoints"], scene["K"],
        P[:, :3, :3], P[:, :3, 3])]
    out = {}
    for dev in (DEV, "cpu"):
        t0 = time.perf_counter()
        res = triangulate_and_filter_tracks(*(torch.from_numpy(a).to(dev) for a in args))
        out[dev] = {k: v.cpu().numpy() for k, v in res.items()}
        out[dev]["s"] = time.perf_counter() - t0
    k, c = out[DEV], out["cpu"]
    same = (np.array_equal(k["ok"], c["ok"]) and np.array_equal(k["obs_inlier"], c["obs_inlier"]))
    ok = c["ok"]
    err = float(np.abs(k["xyz"][ok] - c["xyz"][ok]).max()) if ok.any() else 0.0
    log(f"[map] triangulation of the {len(ok)} full-width tracks ({tracks.max_len} slots), "
        f"card against CPU: ok and obs_inlier identical {same} ({int(ok.sum())} ok), xyz max "
        f"abs diff {err:.3e} m (<= {MAP_CARD_CPU_ABS}); {k['s']:.3f} s on the card, "
        f"{c['s']:.3f} s on the CPU")
    if not (same and err <= MAP_CARD_CPU_ABS):
        fail("triangulation on the card disagrees with the CPU at full width")


def phase_map(torch):
    """run_mapping at the full width of configs/map.yaml on the planted
    scene: (a) global_ba off (the shipped default), (b) on with the cameras
    fixed, (c) on refining the cameras; each against the scene's oracle,
    with host ms per stage, the device stages' launches and device ms
    (torch.profiler, a second run), peak memory and seconds; then the card
    against the CPU: the full-width triangulation, and run_mapping on a
    reduced scene."""
    import numpy as np

    from onepose_tpu_torch import native
    from onepose_tpu_torch.ops.kernels import launch_counts, reset_launches
    from onepose_tpu_torch.parallel.sfm_parallel import make_nn_pair_matcher

    t_phase = time.perf_counter()
    log(f"[map] union-find core: {native.backend()}; TF32: cudnn "
        f"{torch.backends.cudnn.allow_tf32}, matmul {torch.backends.cuda.matmul.allow_tf32} "
        "(the SfM device stages turn both off themselves)")
    t0 = time.perf_counter()
    scene = _map_scene(np, MAP, seed=0)
    match = make_nn_pair_matcher(scene["descriptors"], scene["mask"], distance_thresh=0.2,
                                 pair_chunk=MAP["pair_chunk"], device=DEV)
    log(f"[map] scene: {MAP['frames']} frames x {MAP['slots']} slots x {MAP['desc']}-d, "
        f"{MAP['points']} planted points, up to {MAP['planted']} a frame "
        f"({float((scene['gt_ids'] >= 0).mean()) * 100:.1f}% of the slots), made in "
        f"{time.perf_counter() - t0:.1f} s")
    runs = (("a", {}), ("b", dict(global_ba=True)),
            ("c", dict(global_ba=True, global_ba_refine_cameras=True)))
    for label, cfg in runs:
        tag = f"{MAP['frames']} frames x {MAP['slots']} slots"
        reset_launches()  # this path's counts: 0 just before it, read just after
        res, clock, sec, peak = _map_run(torch, np, scene, cfg, label, DEV, match)
        counts = launch_counts()
        _map_oracle(np, scene, res, label, tag)
        log(f"[map] {tag} ({label}): launches of the hand-written kernels {counts} (the NN "
            f"pair matcher and the SfM core run none); host ms by stage, synchronized: "
            + ", ".join(f"{k} {v:.1f}" for k, v in clock.ms.items())
            + f"; {sec:.2f} s in all, peak device memory {peak:.2f} GiB")
        if any(counts.values()):
            fail(f"phase map ({label}) launched a kernel it should not")
        if label == "a":
            _map_triangulation_card_vs_cpu(torch, np, scene, clock.last["tracks"])
        _, prof, sec_p, _ = _map_run(torch, np, scene, cfg, label, DEV, match, profile=True)
        log(f"[map] {tag} ({label}), a second run under torch.profiler: device stages' CUDA "
            f"launches and device ms " + ", ".join(
                f"{k} {n} {ms:.2f}" for k, (n, ms) in prof.dev.items())
            + f"; {sec_p:.2f} s with the profiler on")
    _map_card_vs_cpu(torch, np)
    log(f"[map] phase map took {time.perf_counter() - t_phase:.1f} s")


# --- phase cli: the `map` command ------------------------------------------


def _png_gray(path, img, level: int = 6) -> None:
    """An 8-bit grayscale PNG (filter 0 on every row) written with zlib (at
    compression `level`) and struct alone."""
    import zlib

    h, w = img.shape
    raw = bytearray()
    for row in img:
        raw += b"\x00" + row.tobytes()

    def chunk(tag, data):
        return (len(data).to_bytes(4, "big") + tag + data
                + zlib.crc32(tag + data).to_bytes(4, "big"))

    with open(path, "wb") as f:
        f.write(b"\x89PNG\r\n\x1a\n"
                + chunk(b"IHDR", w.to_bytes(4, "big") + h.to_bytes(4, "big") + bytes([8, 0, 0, 0, 0]))
                + chunk(b"IDAT", zlib.compress(bytes(raw), level)) + chunk(b"IEND", b""))


def _cli_object(np, cfg, seed):
    """The rendered object of `_cli_scene`: `points` points in a
    `cube`-metre cube, each a Gaussian blob of its own size and brightness
    in a `blob`-pixel window, seen from an azimuth window of its own
    (half-width win[0] + win[1] u^2 degrees). Returns the object and the
    generator, whose next draws are the frames' background noise."""
    rng = np.random.default_rng(seed)
    n, B = cfg["points"], cfg["blob"]
    pts = (rng.random((n, 3)) - 0.5) * cfg["cube"]
    az_p = rng.random(n) * 2 * np.pi
    half = np.radians(cfg["win"][0] + cfg["win"][1] * rng.random(n) ** 2)
    oy, ox = np.mgrid[:B, :B] - B // 2
    size = rng.uniform(2.0, 5.0, n)
    amp = 0.4 + 0.6 * np.sin(rng.random(n) * 2 * np.pi) ** 2
    blobs = (amp[:, None, None] * np.exp(-(ox ** 2 + oy ** 2)[None] / size[:, None, None]))
    return dict(pts=pts, az_p=az_p, half=half, oy=oy, ox=ox, blobs=blobs), rng


def _cli_frame(np, obj, rng, cfg, pose, ang, K, hw):
    """One 8-bit frame [h, w] of the object from `pose` (azimuth `ang`):
    each visible point's blob splatted on a background of fresh noise."""
    h, w = hw
    B = cfg["blob"]
    pc = obj["pts"] @ pose[:3, :3].T + pose[:3, 3]
    uv = pc @ K.T
    uv = uv[:, :2] / uv[:, 2:3]
    d_az = np.abs((obj["az_p"] - ang + np.pi) % (2 * np.pi) - np.pi)
    ids = np.nonzero((d_az <= obj["half"]) & (uv > B).all(1) & (uv[:, 0] < w - B)
                     & (uv[:, 1] < h - B))[0]
    u = np.rint(uv[ids]).astype(np.int64)
    flat = ((u[:, 1, None, None] + obj["oy"]) * w + u[:, 0, None, None] + obj["ox"]).reshape(-1)
    img = cfg["noise"][0] + cfg["noise"][1] * rng.random(h * w)
    np.add.at(img, flat, obj["blobs"][ids].reshape(-1))
    return (np.clip(img, 0, 1) * 255).round().astype(np.uint8).reshape(h, w)


def _ring_pose(np, f, per, offset=0.0):
    """Camera f of _map_scene's two rings at 1 m (`per` cameras a ring),
    `offset` of a step further round: (pose, azimuth)."""
    ring = f // per
    ang = 2 * np.pi * (f % per + 0.5 * ring + offset) / per
    return _look_at(np, np.array([np.cos(ang), np.sin(ang),
                                  0.3 + 0.4 * ring + 0.1 * np.sin(3 * ang)])), ang


def _cli_scene(np, root: Path, cfg, seed):
    """A rendered orbit sequence in the layout of data/paths.py under
    root/obj/seq (color/*.png, poses_ba/, intrin_ba/, intrinsics.txt) and
    root/obj/box3d_corners.txt: `_cli_object` (tests/test_cli.py::
    build_sequence's texture, cheap to render) on a background of fresh
    noise in every frame (no region is exactly constant: a cell of all-zero
    features has no descriptor, its normalisation divides 0 by 0 as in the
    JAX package), from `frames` cameras on _map_scene's two rings at 1 m
    with focal length `focal`. Returns the sequence directory and the
    planted points."""
    obj, rng = _cli_object(np, cfg, seed)
    F, S = cfg["frames"], cfg["img"]
    K = np.array([[cfg["focal"], 0, S / 2], [0, cfg["focal"], S / 2], [0, 0, 1]])
    seq = root / "obj" / "seq"
    for sub in ("color", "poses_ba", "intrin_ba"):
        (seq / sub).mkdir(parents=True)
    c = cfg["cube"] / 2 * 1.2  # the box: the cube and a margin
    np.savetxt(root / "obj" / "box3d_corners.txt",
               [[x, y, z] for z in (c, -c) for x, y in ((-c, -c), (-c, c), (c, c), (c, -c))])
    (seq / "intrinsics.txt").write_text(f"fx: {K[0, 0]}\nfy: {K[1, 1]}\ncx: {K[0, 2]}\ncy: {K[1, 2]}")
    for f in range(F):
        pose, ang = _ring_pose(np, f, F // 2)
        _png_gray(seq / "color" / f"{f}.png", _cli_frame(np, obj, rng, cfg, pose, ang, K, (S, S)))
        np.savetxt(seq / "poses_ba" / f"{f}.txt", pose)
        np.savetxt(seq / "intrin_ba" / f"{f}.txt", K)
    return seq, obj["pts"]


def _cli_subsequence(seq: Path, root: Path, frames: int,
                     subs=("color", "poses_ba", "intrin_ba")) -> Path:
    """The first `frames` frames of `seq` (its `subs` directories, its
    intrinsics.txt and the object's box when there is one) as a sequence of
    their own under root."""
    import shutil

    dst = root / "obj" / "seq"
    for sub in subs:
        (dst / sub).mkdir(parents=True)
        for f in range(frames):
            name = f"{f}.png" if sub.startswith("color") else f"{f}.txt"
            shutil.copy(seq / sub / name, dst / sub / name)
    shutil.copy(seq / "intrinsics.txt", dst)
    if (seq.parent / "box3d_corners.txt").exists():
        shutil.copy(seq.parent / "box3d_corners.txt", root / "obj")
    return dst


def _seeded_checkpoint(np, model, ckpt_dir: Path, seed: int) -> str:
    """Random weights for `model` from a seed, written as a msgpack
    checkpoint in the JAX package's layout (utils.checkpoint): kernels drawn
    as the JAX package's default init draws them (lecun normal: a normal
    truncated at 2 sigma, scaled to std 1 / sqrt(fan_in)), biases zero, the
    other parameters (batch-norm affines, the dustbin score) at their
    constructor values."""
    from onepose_tpu_torch.utils.checkpoint import save_checkpoint

    rng = np.random.default_rng(seed)
    tree: dict = {}
    for name, value in model.state_dict().items():
        *path, leaf = name.split(".")
        node = tree
        for p in path:
            node = node.setdefault(p, {})
        v = value.detach().cpu().float().numpy()
        if leaf == "weight":  # conv OIHW -> HWIO, dense [out, in] -> [in, out]
            shape = v.transpose(2, 3, 1, 0).shape if v.ndim == 4 else v.T.shape
            z = np.clip(rng.standard_normal(shape), -2.0, 2.0) / 0.87962566  # unit variance
            node["kernel"] = (z / np.sqrt(np.prod(shape[:-1]))).astype(np.float32)
        elif leaf == "bias":
            node["bias"] = np.zeros_like(v)
        else:
            node[leaf] = v
    return save_checkpoint(str(ckpt_dir), {"params": tree}, 0)


def _cli_map(torch, args, label):
    """One `python -m onepose_tpu_torch map` in the process: (stats, the
    kernels' launches in the run, peak device GiB, seconds)."""
    from onepose_tpu_torch.__main__ import main as cli_main
    from onepose_tpu_torch.ops.kernels import launch_counts, reset_launches

    out = Path(next(a.split("=", 1)[1] for a in args if a.startswith("out_dir=")))
    dev = next(a.split("=", 1)[1] for a in args if a.startswith("device="))
    if dev != "cpu":
        _reset_peak(torch, "cli", f"map ({label})")
    reset_launches()  # this path's counts: 0 just before it, read just after
    t0 = time.perf_counter()
    rc = cli_main(["map", *args])
    sec = time.perf_counter() - t0
    counts = launch_counts()
    peak = torch.cuda.max_memory_allocated() / 2**30 if dev != "cpu" else 0.0
    if rc != 0:
        fail(f"map ({label}) returned {rc}")
    stats = json.loads((out / "stats.json").read_text())
    return stats, counts, peak, sec


def _cli_artifacts(np, out: Path, stats, box_half, label):
    """Every artifact of `map` on disk and consistent with stats.json: the
    3D files, one 2D annotation per index entry (assign matrices inside the
    frame's keypoints and the map's points), points.ply, every point inside
    the planted box."""
    from onepose_tpu_torch.data.anno_io import load_anno2d, load_annotation_npz

    names = ["anno/anno_3d_average.npz", "anno/anno_3d_collect.npz", "anno/idxs.npy",
             "anno/anno_index.json", "points.ply", "stats.json"]
    missing = [a for a in names if not (out / a).exists()]
    anno = load_annotation_npz(str(out / "anno")) if not missing else None
    P = stats["num_points3d"]
    index = json.loads((out / "anno" / "anno_index.json").read_text()) if not missing else []
    bad_2d = 0
    for e in index:
        if not Path(e["anno_file"]).exists():
            missing.append(e["anno_file"])
            continue
        a = load_anno2d(e["anno_file"])
        am = a["assign_matrix"]
        bad_2d += int(am.size and (am[0].max() >= len(a["keypoints2d"]) or am[1].max() >= P))
    ply_rows = int((out / "points.ply").read_text().split("element vertex ")[1].split()[0]) \
        if not missing else -1
    ok = (not missing and anno["keypoints3d"].shape == (P, 3) and len(anno["idxs"]) == P
          and anno["desc_concat"].shape[0] == int(anno["idxs"].sum()) and ply_rows == P
          and bad_2d == 0 and len(index) > 0
          and bool((np.abs(anno["keypoints3d"]) <= box_half + 1e-6).all()))
    log(f"[cli] ({label}) artifacts: {len(names)} files and {len(index)} per-image 2D "
        f"annotations on disk (missing {missing[:3]}), {P} points in the 3D files, the PLY and "
        f"idxs.npy, assign matrices out of range in {bad_2d} file(s), all points inside the "
        f"planted box {ok}")
    if not ok:
        fail(f"map ({label}) wrote missing or inconsistent artifacts")


def _cli_args() -> list:
    return [f"{k}={v}" for k, v in CLI_MAP.items()]


def _cli_stage_line(stats) -> str:
    return ", ".join(f"{k} {v}" for k, v in stats["stage_s"].items())


def _cli_dlt_at_scale(torch, np):
    """C15: triangulate_tracks_dlt on CLI_DLT_TRACKS random tracks of 4
    views (90% observed; normalized image coordinates, 3e-4 of noise,
    camera centres within 1 m at 3 m) on the card, where the batched eigh
    runs in chunks, against the CPU: ok identical, and xyz within 1e-3 on
    the tracks of 3 or more views (fp32 holds those within 1e-4 of a
    float64 solve; a 2-view track's system is too flat to compare)."""
    from onepose_tpu_torch.geometry.triangulation import EIGH_BATCH, triangulate_tracks_dlt

    rng = np.random.default_rng(5)
    n, views = CLI_DLT_TRACKS, 4
    xyz = rng.uniform(-0.5, 0.5, (n, 3))
    P = np.zeros((n, views, 3, 4))
    P[..., :3, :3] = np.eye(3)
    P[..., :, 3] = rng.uniform(-1.0, 1.0, (n, views, 3)) + np.array([0.0, 0.0, 3.0])
    pix = np.einsum("nvij,nj->nvi", P, np.concatenate([xyz, np.ones((n, 1))], axis=1))
    uv = pix[..., :2] / pix[..., 2:] + rng.normal(0, 3e-4, (n, views, 2))
    mask = rng.random((n, views)) < 0.9
    args = [np.ascontiguousarray(uv, np.float32), np.ascontiguousarray(P, np.float32), mask]
    out = {}
    for dev in (DEV, "cpu"):
        t0 = time.perf_counter()
        x, ok = triangulate_tracks_dlt(*(torch.from_numpy(a).to(dev) for a in args))
        out[dev] = (x.cpu().numpy(), ok.cpu().numpy(), time.perf_counter() - t0)
    (xk, okk, sk), (xc, okc, sc) = out[DEV], out["cpu"]
    same = bool(np.array_equal(okk, okc))
    held = okc & (mask.sum(1) >= 3)
    err = float(np.abs(xk[held] - xc[held]).max())
    log(f"[cli] DLT of {n} tracks (eigh in chunks of {EIGH_BATCH}; C15), card against CPU: ok "
        f"identical {same} ({int(okc.sum())} ok), xyz max abs diff {err:.3e} on the "
        f"{int(held.sum())} tracks of 3 or 4 views (<= 1e-3); {sk:.3f} s on the card, "
        f"{sc:.3f} s on the CPU")
    if not (same and err <= 1e-3):
        fail("triangulation of a large track set on the card disagrees with the CPU")


def _cli_card_vs_cpu(torch, np, root, seq, sp_ckpt):
    """CLI_SMALL on the card and on the CPU: the features that `map`
    extracts (the same function, the same weights) by keypoint overlap and
    descriptor error; then `map` itself on each device, its counts."""
    from onepose_tpu_torch.cli.common import extract_sequence_features, load_superpoint_params
    from onepose_tpu_torch.models.superpoint import SuperPoint

    small = _cli_subsequence(seq, root / "small", CLI_SMALL["frames"])
    feats = {}
    for dev in (DEV, "cpu"):
        sp = SuperPoint(nms_kernel=dev != "cpu", vgg_kernel=False)
        feats[dev] = extract_sequence_features(str(small), load_superpoint_params(sp, sp_ckpt), sp,
                                               max_keypoints=CLI_SMALL["keypoints"], device=dev)
    a, c = feats[DEV], feats["cpu"]
    overlap = _keypoint_overlap({"keypoints": a["keypoints"], "kpt_mask": a["mask"]},
                                {"keypoints": c["keypoints"], "kpt_mask": c["mask"]})
    same = (a["keypoints"] == c["keypoints"]).all(-1) & a["mask"] & c["mask"]
    desc_err = float(np.abs(a["descriptors"] - c["descriptors"])[same].max())
    log(f"[cli] card against CPU, {CLI_SMALL['frames']} frames x {CLI_SMALL['keypoints']} "
        f"keypoints: valid keypoints {int(a['mask'].sum())} / {int(c['mask'].sum())}, overlap "
        f"{overlap:.4f} (>= {CLI_KPT_OVERLAP}), descriptor max abs diff on shared slots "
        f"{desc_err:.3e} (< {CLI_DESC_ABS})")
    if not (overlap >= CLI_KPT_OVERLAP and desc_err < CLI_DESC_ABS):
        fail("the card's features disagree with the CPU's")
    stats = {}
    for dev in (DEV, "cpu"):
        args = [f"data_dir={small}", f"out_dir={root / 'small' / dev}", *_cli_args(),
                f"max_keypoints={CLI_SMALL['keypoints']}", "matcher=nn",
                f"weights.superpoint={sp_ckpt}", f"cache={str(_has_h5py()).lower()}",
                f"device={dev}"]
        stats[dev], counts, _, sec = _cli_map(torch, args, f"card against CPU, {dev}")
        _cli_artifacts(np, root / "small" / dev, stats[dev], CLI_SCENE["cube"] / 2 * 1.2,
                       f"card against CPU, {dev}")
        log(f"[cli] card against CPU, map on {dev}: {sec:.2f} s, launches {counts}")
    k, c = stats[DEV], stats["cpu"]
    exact = ("num_frames", "num_pairs")
    close = ("num_tracks", "num_points3d", "num_observations")
    diffs = {x: (k[x], c[x]) for x in exact + close}
    ok = (all(k[x] == c[x] for x in exact)
          and all(abs(k[x] - c[x]) <= CLI_COUNT_REL * max(c[x], 1) for x in close))
    log(f"[cli] card against CPU, map counts (card, CPU): {diffs}; frames and pairs identical, "
        f"tracks, points and observations within {CLI_COUNT_REL:.0%} (a keypoint that moves "
        "between the devices changes the tracks through it; identical "
        f"{all(k[x] == c[x] for x in close)})")
    if not ok:
        fail("map on the card disagrees with map on the CPU beyond the stated margin")


def _has_h5py() -> bool:
    import importlib.util

    return importlib.util.find_spec("h5py") is not None


_WORLD: dict = {}  # phase cli's scene, weights and map, shared with phases detect and infer


def _cache_arg() -> str:
    return f"cache={str(_has_h5py()).lower()}"


def _world(np) -> dict:
    """Phase cli's rendered sequence (CLI_SCENE, seed 0) and the seeded
    msgpack checkpoints of SuperPoint (seed 1), SuperGlue (seed 2) and
    GATsSPG (seed 3), made at the first call under a temporary directory
    that main removes; "map_a" is map (a)'s output once it ran."""
    if "root" in _WORLD:
        return _WORLD
    import tempfile

    import torch

    from onepose_tpu_torch.models.gats_spg import GATsSPG
    from onepose_tpu_torch.models.superglue import SuperGlue
    from onepose_tpu_torch.models.superpoint import SuperPoint
    from onepose_tpu_torch.native import frame_loader

    root = _WORLD["root"] = Path(tempfile.mkdtemp(prefix="chip_smoke_"))
    t0 = time.perf_counter()
    _WORLD["seq"], _WORLD["pts"] = _cli_scene(np, root / "full", CLI_SCENE, seed=0)
    decoder = "native" if frame_loader.native_available() else "cv2"
    log(f"[cli] sequence: {CLI_SCENE['frames']} frames of {CLI_SCENE['img']}^2, "
        f"{CLI_SCENE['points']} planted points, written as PNG (zlib) in "
        f"{time.perf_counter() - t0:.1f} s; load_gray decodes with {decoder}; h5py "
        f"{'present: cache=true' if _has_h5py() else 'absent: cache=false'}")
    _WORLD["sp_ckpt"] = _seeded_checkpoint(np, SuperPoint(), root / "ckpt_superpoint", seed=1)
    _WORLD["sg_ckpt"] = _seeded_checkpoint(np, SuperGlue(), root / "ckpt_superglue", seed=2)
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(3)  # the GATs layers' W and a, drawn at construction
        gats = GATsSPG()
    _WORLD["gats_ckpt"] = _seeded_checkpoint(np, gats, root / "ckpt_gats", seed=3)
    return _WORLD


def _map_a_args(w) -> list:
    return [f"data_dir={w['seq']}", f"out_dir={w['root'] / 'out_a'}", *_cli_args(), "matcher=nn",
            f"weights.superpoint={w['sp_ckpt']}", _cache_arg(), "anno_format=npz",
            f"device={DEV}"]


def _world_map(torch, np) -> Path:
    """map (a)'s output directory: phase cli's, or the same command run here
    when phase cli did not run."""
    w = _world(np)
    if "map_a" not in w:
        stats, _, _, sec = _cli_map(torch, _map_a_args(w), "a")
        log(f"[world] map (a) for the later phases: {stats['num_points3d']} points in {sec:.2f} s")
        w["map_a"] = w["root"] / "out_a"
    return w["map_a"]


def phase_cli(torch):
    """`python -m onepose_tpu_torch map` on the card, in the process, on a
    rendered sequence: (a) matcher=nn at configs/map.yaml's width, (b)
    matcher=superglue on the first frames, then the card against the CPU."""
    import numpy as np

    from onepose_tpu_torch.parallel.sfm_parallel import superglue_chunk

    t_phase = time.perf_counter()
    log(f"[cli] TF32: cudnn {torch.backends.cudnn.allow_tf32}, matmul "
        f"{torch.backends.cuda.matmul.allow_tf32} (feature extraction turns both off itself)")
    w = _world(np)
    root, seq, sp_ckpt, sg_ckpt = w["root"], w["seq"], w["sp_ckpt"], w["sg_ckpt"]
    cache = _cache_arg()
    box_half = CLI_SCENE["cube"] / 2 * 1.2
    _cli_dlt_at_scale(torch, np)

    # (a) matcher=nn, every frame.
    out = w["map_a"] = root / "out_a"
    stats, counts, peak, sec = _cli_map(torch, _map_a_args(w), "a")
    _cli_artifacts(np, out, stats, box_half, "a")
    batches = -(-CLI_SCENE["frames"] // 8)
    want = {k: (batches if k == "nms" else 0) for k in counts}
    log(f"[cli] (a) matcher=nn, {CLI_SCENE['frames']} frames: {stats['num_pairs']} pairs, "
        f"{stats['num_tracks']} tracks, {stats['num_points3d']} points (> "
        f"{CLI_ORACLE['min_points']}), mean reprojection error "
        f"{stats['mean_reproj_error_px']:.4f} px (< {CLI_ORACLE['max_reproj_px']}); stage_s "
        f"{_cli_stage_line(stats)}; {sec:.2f} s in all, peak device memory {peak:.2f} GiB; "
        f"launches {counts} (want K1 once per batch of 8: {batches}, no other kernel)")
    if not (stats["num_points3d"] > CLI_ORACLE["min_points"]
            and stats["mean_reproj_error_px"] < CLI_ORACLE["max_reproj_px"]):
        fail("map (a) is outside the planted scene's bounds")
    if counts != want:
        fail(f"map (a) launched {counts}, want {want}")

    # (b) matcher=superglue on the first CLI_SG_FRAMES frames.
    sub = _cli_subsequence(seq, root / "sub", CLI_SG_FRAMES)
    out = root / "out_b"
    stats, counts, peak, sec = _cli_map(torch, [
        f"data_dir={sub}", f"out_dir={out}", *_cli_args(), "matcher=superglue",
        f"match_threshold={CLI_SG_THRESHOLD}", f"weights.superpoint={sp_ckpt}",
        f"weights.superglue={sg_ckpt}", cache, "anno_format=npz", f"device={DEV}"], "b")
    _cli_artifacts(np, out, stats, box_half, "b")
    chunk = superglue_chunk(CLI_MAP["max_keypoints"], 16)
    chunks = -(-stats["num_pairs"] // chunk)
    batches = -(-CLI_SG_FRAMES // 8)
    log(f"[cli] (b) matcher=superglue, match_threshold {CLI_SG_THRESHOLD}, {CLI_SG_FRAMES} "
        f"frames: {stats['num_pairs']} pairs in {chunks} chunks of {chunk}, "
        f"{stats['num_points3d']} points, mean reprojection error "
        f"{stats['mean_reproj_error_px']:.4f} px; stage_s {_cli_stage_line(stats)}; "
        f"{sec:.2f} s in all, peak device memory {peak:.2f} GiB; launches {counts} (want K7 "
        f"once per chunk: {chunks}, K1 once per batch: {batches})")
    if not (counts["sinkhorn_stream"] == chunks and counts["nms"] == batches
            and counts["sinkhorn"] == 0 and counts["vgg_stage"] == 0):
        fail(f"map (b) launched {counts}")

    _cli_card_vs_cpu(torch, np, root, seq, sp_ckpt)
    _cli_a15(torch, np, w)
    log(f"[cli] phase cli took {time.perf_counter() - t_phase:.1f} s")


# --- phase train: the `train` command ---------------------------------------


def _train_gats_grad(torch, timer, rows):
    """K2 with a gradient at TRAIN_GATS, 20% of the leaves masked: the
    Function's gradients (kernel forward, plain recompute) against autograd
    through the plain version, all four inputs; the times of the forward
    kernel, the backward and the plain forward plus backward as training
    runs them (the leaves are data: gradients of d3, W and a)."""
    from onepose_tpu_torch.ops.kernels import gats

    b, n3, L, c = TRAIN_GATS
    g = torch.Generator(device=DEV).manual_seed(5)
    unit = lambda x: x / torch.linalg.vector_norm(x, dim=-1, keepdim=True)
    leaves = unit(torch.randn((b, n3, L, c), generator=g, device=DEV))
    d3 = unit(torch.randn((b, n3, c), generator=g, device=DEV))
    W = torch.randn((c, c), generator=g, device=DEV) * (2.0 / (2 * c)) ** 0.5
    a2 = torch.randn((2, c), generator=g, device=DEV) * (2.0 / (2 * c + 1)) ** 0.5
    add = gats.additive_mask(torch.rand((b, n3, L), generator=g, device=DEV) < 0.8)
    cot = torch.randn((b, n3, c), generator=g, device=DEV)

    def grads(fn, want):
        ins = [t.detach().requires_grad_(w) for t, w in zip((leaves, d3, W, a2), want)]
        out = fn(ins[0], ins[1], add, gats.leaf_logit_vectors(ins[2], ins[3]))
        return out, ins, [x for x, w in zip(ins, want) if w]

    kern = lambda l, d, m, wa: gats.GatsLeafAttention.apply(l, d, m, wa, 0.2, gats.gats_kernel)
    plain = lambda l, d, m, wa: gats.gats_leaf_attention_plain(l, d, m, wa, 0.2)
    every = (True,) * 4
    out_k, _, xs_k = grads(kern, every)
    out_p, _, xs_p = grads(plain, every)
    got = torch.autograd.grad(out_k, xs_k, cot)
    ref = torch.autograd.grad(out_p, xs_p, cot)
    torch.cuda.synchronize()
    fwd_err = float((out_k - out_p).detach().abs().max())
    errs = {name: (float((a - r).abs().max()), float(r.abs().max()))
            for name, a, r in zip(("leaves", "desc3d", "W", "a"), got, ref)}
    log(f"[train] K2 with a gradient at {TRAIN_GATS}, 20% masked: forward max abs err "
        f"{fwd_err:.3e} (<= 1e-5); gradients against autograd through the plain version, max "
        f"abs err / max abs: " + ", ".join(f"{k} {e:.3e} / {m:.3e}" for k, (e, m) in errs.items())
        + f" (<= {TRAIN_GRAD_REL} x max)")
    if not fwd_err <= 1e-5 or any(not e <= TRAIN_GRAD_REL * m for e, m in errs.values()):
        fail("K2's gradients disagree with the plain version's")

    train = (False, True, True, True)  # what training asks for
    out_k, _, xs_k = grads(kern, train)
    wa = gats.leaf_logit_vectors(W, a2)
    fwd_ms = timer(lambda: gats.gats_kernel(leaves, d3, add, wa, 0.2))
    bwd_ms = timer(lambda: torch.autograd.grad(out_k, xs_k, cot, retain_graph=True))
    plain_ms = timer(lambda: (lambda o, _, xs: torch.autograd.grad(o, xs, cot))(
        *grads(plain, train)), reps=5)
    # The backward's least work: read the leaves, d3, the mask and the
    # cotangent once, write d d3 and d wa; about twice the forward's flops.
    n_bytes = (leaves.numel() + 3 * d3.numel() + add.numel() + 4 * c) * 4
    bwd_bound, bwd_by = bound(n_bytes, 8 * b * n3 * (L + 1) * c)
    # The backward is some 20 launches from the host: its device time (the
    # kernels' sum under torch.profiler) beside the events' span.
    dev_bwd = _kernel_breakdown(torch, lambda: torch.autograd.grad(out_k, xs_k, cot,
                                                                   retain_graph=True))
    dev_plain = _kernel_breakdown(torch, lambda: (lambda o, _, xs: torch.autograd.grad(
        o, xs, cot))(*grads(plain, train)))
    dev_ms = lambda d: sum(ms for _, ms in d.values())
    dev_n = lambda d: sum(n for n, _ in d.values())
    log(f"[train] K2 at {TRAIN_GATS}: forward kernel {fwd_ms:.4f} ms; backward (plain "
        f"recompute under autograd) {bwd_ms:.4f} ms, of which {dev_ms(dev_bwd):.4f} ms device "
        f"time in {dev_n(dev_bwd)} CUDA kernels, bound {bwd_bound:.4f} ms ({bwd_by}); plain "
        f"forward plus backward {plain_ms:.4f} ms ({dev_ms(dev_plain):.4f} ms device time in "
        f"{dev_n(dev_plain)} kernels)")
    if "gats" in rows:
        rows["gats"]["extra"] = dict(grad_max_abs_err=max(e for e, _ in errs.values()),
                                     backward_ms=bwd_ms, backward_device_ms=dev_ms(dev_bwd),
                                     backward_bound_ms=bwd_bound, plain_fwd_bwd_ms=plain_ms)


def _train_checkpoint(np, path: Path, micro: int, every_k: int):
    """A train checkpoint in the JAX package's layout: {step, params,
    opt_state {mini_step, gradient_step, inner_opt_state {"0": {}, "1":
    {"0": {count, mu, nu}, "1": {count}}}, acc_grads, skip_state}}, the
    moments and the accumulated gradients shaped as the parameters, the
    counts int32."""
    from onepose_tpu_torch.utils.checkpoint import load_checkpoint

    t = load_checkpoint(str(path))
    o = t["opt_state"]
    inner = o["inner_opt_state"]
    adam = inner["1"]["0"]
    shapes = lambda tree: [(k, v.shape) for k, v in _flat(tree)]
    updates = micro // every_k
    counts = {"step": t["step"], "mini_step": o["mini_step"], "gradient_step": o["gradient_step"],
              "count": adam["count"], "schedule": inner["1"]["1"]["count"]}
    ok = (set(t) == {"step", "params", "opt_state"}
          and set(o) == {"mini_step", "gradient_step", "inner_opt_state", "acc_grads", "skip_state"}
          and inner["0"] == {} and o["skip_state"] == {}
          and shapes(adam["mu"]) == shapes(adam["nu"]) == shapes(o["acc_grads"])
          == shapes(t["params"])
          and all(v.dtype == np.int32 for v in counts.values())
          and {k: int(v) for k, v in counts.items()} == {
              "step": micro, "mini_step": micro % every_k, "gradient_step": updates,
              "count": updates, "schedule": updates})
    log(f"[train] {path.name}: {len(shapes(t['params']))} parameter arrays, counts "
        f"{ {k: int(v) for k, v in counts.items()} } (want step {micro}, {updates} updates)")
    if not ok:
        fail(f"{path.name} is not the JAX package's train-state layout")


def _flat(tree, prefix=""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flat(v, f"{prefix}{k}.")
        else:
            yield f"{prefix}{k}", v


def _train(torch, args):
    """train in the process: (summary, launches, peak GiB, seconds, the
    clock of its micro-steps, the loss of each)."""
    from onepose_tpu_torch.train import loop

    clock, losses = _Clock(torch, DEV), []

    def timed_steps(make):
        def make_timed(*a, **k):
            step = clock.wrap("step")(make(*a, **k))

            def run(state, batch):
                state, metrics = step(state, batch)
                losses.append(float(metrics["loss"]))
                return state, metrics
            return run
        return make_timed

    summary, counts, peak, sec = _command(torch, ["train", *args], DEV,
                                          wraps=((loop, "make_train_step", timed_steps),))
    return summary, counts, peak, sec, clock, losses


def _train_card_vs_cpu(torch, np, index: str):
    """TRAIN_SMALL micro-steps at full width on the card and on the CPU, from
    one checkpoint (the card's seeded init written as a train state and
    read back on the CPU), on the same batches of the map's dataset. Before
    the first optimizer update the losses, the raw grad_norms and the first
    micro-step's gradients (MultiSteps' accumulator after it) are held to
    fp32 rounding; after it the loss to ROADMAP A11's 1e-4."""
    from onepose_tpu_torch.data.dataset import GATsSPGDataset, batch_iterator
    from onepose_tpu_torch.models.gats_spg import GATsSPG
    from onepose_tpu_torch.train import loop
    from onepose_tpu_torch.train import train_step as ts

    n = TRAIN_SMALL
    ds = GATsSPGDataset(index, num_leaf=TRAIN["num_leaf"], shape2d=TRAIN["shape2d"],
                        shape3d=TRAIN["shape3d"], seed=0)
    it = batch_iterator(ds, n["batch"], seed=0)
    batches = [loop.adapt_batch(next(it)) for _ in range(n["steps"])]
    cfg = ts.TrainConfig(accumulate=n["accumulate"], steps_per_epoch=len(ds) // n["batch"])
    histories, grads, t0 = {}, {}, time.perf_counter()
    tree = None
    for dev in (DEV, "cpu"):
        state = ts.create_train_state(0, GATsSPG(gats_kernel=True, fused_match=False), cfg, dev)
        if tree is None:
            tree = state.state_dict()
        else:
            state.load_state_dict(tree)
        step = ts.make_train_step(state.model, cfg)
        hist = []
        for i, b in enumerate(batches):
            state, m = step(state, {k: torch.from_numpy(v).to(dev) for k, v in b.items()})
            hist.append((float(m["loss"]), float(m["grad_norm"])))
            if i == 0:
                grads[dev] = [a.detach().cpu().clone() for a in state.tx.acc]
        histories[dev] = hist
    pre = n["accumulate"]  # micro-steps before the first update

    def rel(i, k):
        a, c = histories[DEV][i][k], histories["cpu"][i][k]
        return abs(a - c) / abs(c)

    pre_rel = max(rel(i, k) for i in range(pre) for k in (0, 1))
    post_rel = max(rel(i, 0) for i in range(pre, n["steps"]))
    diff = ts.global_norm([a - c for a, c in zip(grads[DEV], grads["cpu"])])
    grad_rel = float(diff / ts.global_norm(grads["cpu"]))
    per = [float((a - c).norm() / c.norm().clamp(min=1e-30))
           for a, c in zip(grads[DEV], grads["cpu"])]
    worst = max(range(len(per)), key=per.__getitem__)
    log(f"[train] card against CPU, {n['steps']} micro-steps of batch {n['batch']} at full "
        f"width, accumulate {n['accumulate']}, from one checkpoint: (loss, grad_norm) card "
        f"{histories[DEV]}, CPU {histories['cpu']}; before the first update: losses and "
        f"grad_norms max rel diff {pre_rel:.3e} (<= {TRAIN_STEP_REL}), micro-step 0's "
        f"gradients rel diff {grad_rel:.3e} (<= {TRAIN_STEP_GRAD_REL}; worst tensor "
        f"{state.tx.names[worst]} {per[worst]:.3e}); after it: losses max rel diff "
        f"{post_rel:.3e} (<= {TRAIN_LOSS_REL}); {time.perf_counter() - t0:.1f} s")
    if not (pre_rel <= TRAIN_STEP_REL and grad_rel <= TRAIN_STEP_GRAD_REL
            and post_rel <= TRAIN_LOSS_REL):
        fail("train on the card disagrees with the CPU")


def _train_step_breakdown(torch, index: str):
    """One micro-step of the shipped matcher at TRAIN's width on one batch of
    the map's dataset: synchronized host ms of its parts (forward and loss,
    backward, optimizer; median of 5 steps), then torch.profiler over 3
    steps: CUDA kernels, device ms, busy share and the top kernels."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from onepose_tpu_torch.data.dataset import GATsSPGDataset, batch_iterator
    from onepose_tpu_torch.models.gats_spg import GATsSPG
    from onepose_tpu_torch.train import loop
    from onepose_tpu_torch.train import train_step as ts
    from onepose_tpu_torch.utils.precision import fp32_matmuls

    ds = GATsSPGDataset(index, num_leaf=TRAIN["num_leaf"], shape2d=TRAIN["shape2d"],
                        shape3d=TRAIN["shape3d"], seed=0)
    b = loop.adapt_batch(next(batch_iterator(ds, TRAIN["batch_size"], seed=0)))
    batch = {k: torch.from_numpy(v).to(DEV) for k, v in b.items()}
    cfg = ts.TrainConfig(accumulate=TRAIN["accumulate"], steps_per_epoch=20)
    state = ts.create_train_state(0, GATsSPG(gats_kernel=True, fused_match=False), cfg, DEV)
    step = ts.make_train_step(state.model, cfg)
    parts = {"forward and loss": [], "backward": [], "optimizer": []}
    with fp32_matmuls():
        for _ in range(6):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            loss, _ = ts.loss_fn(state.model, batch, cfg)
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            grads = list(torch.autograd.grad(loss, state.tx.params))
            torch.cuda.synchronize()
            t2 = time.perf_counter()
            state.apply_gradients(grads)
            torch.cuda.synchronize()
            t3 = time.perf_counter()
            for k, dt in zip(parts, (t1 - t0, t2 - t1, t3 - t2)):
                parts[k].append(dt * 1e3)
    # After the first step (which accumulates), the optimizer's steps
    # alternate: an update, then an accumulation.
    opt = parts.pop("optimizer")
    host = {k: statistics.median(v[1:]) for k, v in parts.items()}
    host.update({"optimizer update": statistics.median(opt[1::2]),
                 "accumulation": statistics.median(opt[2::2])})
    calls = 4  # two optimizer updates under accumulate 2
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(calls):
            step(state, batch)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3 / calls
    kernels = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    busy = sum(e.time_range.elapsed_us() for e in kernels) / 1e3 / calls
    by_name = {}
    for e in kernels:
        by_name[e.name] = by_name.get(e.name, 0.0) + e.time_range.elapsed_us() / 1e3 / calls
    log(f"[train] one micro-step at batch {TRAIN['batch_size']}, host ms (synchronized, median "
        f"of 5): " + ", ".join(f"{k} {v:.2f}" for k, v in host.items())
        + f"; profiler over "
        f"{calls} micro-steps: {len(kernels) // calls} CUDA kernels, {busy:.2f} ms of device "
        f"time in {wall:.2f} ms wall a micro-step: device busy {100 * busy / wall:.1f}%")
    for name, ms in sorted(by_name.items(), key=lambda kv: -kv[1])[:6]:
        log(f"[train] profiler top kernel: {ms:.3f} ms a micro-step  {name[:100]}")


def phase_train(torch, rows):
    """`python -m onepose_tpu_torch train` on the card: K2's gradient (a),
    the command on phase cli's map at configs/train_gats_spg.yaml's width,
    its resume and its hand-off to infer (b), the card against the CPU
    (c)."""
    import numpy as np

    t_phase = time.perf_counter()
    _train_gats_grad(torch, Timer(torch), rows)

    w = _world(np)
    anno_dir = _world_map(torch, np) / "anno"
    index = str(anno_dir / "anno_index.json")
    frames = len(json.loads(Path(index).read_text()))
    run = w["root"] / "train"
    t = TRAIN
    args = [f"anno_index={index}", f"run_dir={run}", f"batch_size={t['batch_size']}",
            f"accumulate={t['accumulate']}", f"shape2d={t['shape2d']}",
            f"shape3d={t['shape3d']}", f"num_leaf={t['num_leaf']}", f"device={DEV}"]
    per_epoch = frames // t["batch_size"]
    for epochs, label in ((t["epochs"], "b"), (t["epochs"] + 1, "b, resumed")):
        summary, counts, peak, sec, clock, losses = _train(torch, [*args, f"max_epochs={epochs}"])
        micro = per_epoch * (1 if "resumed" in label else epochs)
        each = clock.each["step"]
        want = {k: 0 for k in counts}
        want["gats"] = 4 * micro
        log(f"[train] ({label}) {frames} annotated frames, batch {t['batch_size']}, accumulate "
            f"{t['accumulate']}, {epochs} epochs: {micro} micro-steps in {sec:.2f} s, "
            f"{clock.s['step'] / micro * 1e3:.1f} ms a micro-step (median "
            f"{statistics.median(each) * 1e3:.1f}, first {each[0] * 1e3:.1f}), peak device "
            f"memory {peak:.2f} GiB; launches {counts} (want K2 4 a micro-step: {want}); summary "
            f"{summary}; losses {[round(x, 5) for x in losses]}")
        if counts != want or len(losses) != micro or not all(np.isfinite(losses)):
            fail(f"train ({label}) launched {counts} for {len(losses)} steps, want {want}")
        if label == "b":
            per_micro = counts["gats"] / micro
        if summary["epoch"] != epochs - 1 or not np.isfinite(summary["train_loss"]):
            fail(f"train ({label}) printed {summary}")
    for e in range(t["epochs"] + 1):
        _train_checkpoint(np, run / "ckpt" / f"ckpt_{e}.msgpack", per_epoch * (e + 1),
                          t["accumulate"])
    records = [json.loads(x) for x in (run / "metrics.jsonl").read_text().splitlines()]
    epochs_run = [r["epoch"] for r in records if "train_loss" in r]
    missing = [p for p in ("metrics.jsonl", "best_metrics.json", "code_snapshot.zip",
                           "ckpt/best.msgpack", "ckpt/best.json") if not (run / p).is_file()]
    tb = sorted(p.name for p in (run / "tb").glob("events.*")) if (run / "tb").is_dir() else []
    log(f"[train] artifacts: epochs recorded {epochs_run} (the resumed run added epoch "
        f"{t['epochs']} only), missing {missing}; TensorBoard event files {len(tb)} "
        f"({'written' if tb else 'none: torch.utils.tensorboard cannot be imported here'})")
    if missing or epochs_run != list(range(t["epochs"] + 1)):
        fail("train's artifacts are incomplete")

    _train_step_breakdown(torch, index)

    # The hand-off: infer loads the trained checkpoint and serves a batch.
    sub = _cli_subsequence(w["seq"], w["root"] / "train_sub", 8)
    ckpt = run / "ckpt" / f"ckpt_{t['epochs']}.msgpack"
    metrics, counts, _, sec, _ = _infer(torch, [
        f"data_dir={sub}", "matcher=gats", f"anno_dir={anno_dir}",
        f"weights.superpoint={w['sp_ckpt']}", f"weights.matcher={ckpt}"], DEV, "trained")
    want = {**{k: 0 for k in counts}, "nms": 1, "gats": 4, "dual_softmax": 1}
    log(f"[train] infer matcher=gats with {ckpt.name} on 8 frames: {metrics}, {sec:.2f} s; "
        f"launches {counts} (want {want})")
    if counts != want or metrics["num_frames"] != 8:
        fail("infer did not serve with the trained checkpoint")
    if "gats" in rows:
        rows["gats"].setdefault("extra", {})["train_launches_per_micro_step"] = per_micro
    _train_card_vs_cpu(torch, np, index)
    log(f"[train] phase train took {time.perf_counter() - t_phase:.1f} s")


# --- phase detect: the `detect` command ------------------------------------


def _query_scene(np, root: Path, frames: int, seed=0):
    """Full DETECT_HW frames of phase cli's object (CLI_SCENE, seed 0) in
    root/obj/seq/color_full, with intrinsics.txt and poses_ba/: cameras on
    the DB's two rings a quarter step round from its views, at the DB's
    focal length, the object in the middle of a phone-sized frame."""
    obj, rng = _cli_object(np, CLI_SCENE, seed)
    h, w = DETECT_HW
    f_len = CLI_SCENE["focal"]
    K = np.array([[f_len, 0, w / 2], [0, f_len, h / 2], [0, 0, 1]])
    seq = root / "obj" / "seq"
    for sub in ("color_full", "poses_ba"):
        (seq / sub).mkdir(parents=True)
    (seq / "intrinsics.txt").write_text(f"fx: {K[0, 0]}\nfy: {K[1, 1]}\ncx: {K[0, 2]}\ncy: {K[1, 2]}")
    for f in range(frames):
        pose, ang = _ring_pose(np, f, max(frames // 2, 1), offset=0.25)
        _png_gray(seq / "color_full" / f"{f}.png",
                  _cli_frame(np, obj, rng, CLI_SCENE, pose, ang, K, (h, w)), level=1)
        np.savetxt(seq / "poses_ba" / f"{f}.txt", pose)
    return seq


def _command(torch, argv, device, wraps=()):
    """One `python -m onepose_tpu_torch ...` in the process, its stdout
    captured and echoed: (its JSON last line, the kernels' launches in the
    run, peak device GiB, seconds). `wraps` are (owner, attribute,
    wrapper) patches applied for the run and restored after."""
    import contextlib
    import io

    from onepose_tpu_torch.__main__ import main as cli_main
    from onepose_tpu_torch.ops.kernels import launch_counts, reset_launches

    saved = [(o, a, getattr(o, a)) for o, a, _ in wraps]
    for o, a, wrap in wraps:
        setattr(o, a, wrap(getattr(o, a)))
    buf = io.StringIO()
    try:
        if device != "cpu":
            _reset_peak(torch, argv[0], "the command")
        reset_launches()  # this path's counts: 0 just before it, read just after
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(buf):
            rc = cli_main(argv)
        if device != "cpu":
            torch.cuda.synchronize()
        sec = time.perf_counter() - t0
        counts = launch_counts()
        peak = torch.cuda.max_memory_allocated() / 2**30 if device != "cpu" else 0.0
    finally:
        for o, a, orig in saved:
            setattr(o, a, orig)
    out = buf.getvalue().strip().splitlines()
    if rc != 0 or not out:
        fail(f"{argv[0]} returned {rc} with output {out[-3:]}")
    return json.loads(out[-1]), counts, peak, sec


class _Clock:
    """Synchronized host seconds of wrapped calls, by name."""

    def __init__(self, torch, device):
        self.torch, self.cuda = torch, device != "cpu"
        self.s, self.each = {}, {}

    def wrap(self, name, keep=None):
        def outer(fn):
            def timed(*a, **k):
                if self.cuda:
                    self.torch.cuda.synchronize()
                t0 = time.perf_counter()
                out = fn(*a, **k)
                if self.cuda:
                    self.torch.cuda.synchronize()
                dt = time.perf_counter() - t0
                self.s[name] = self.s.get(name, 0.0) + dt
                self.each.setdefault(name, []).append(dt)
                if keep is not None:
                    keep.append((a, out))
                return out
            return timed
        return outer


def _detect(torch, np, db: Path, query: Path, device, kind, sg_ckpt, sp_ckpt):
    """detect in the process: (summary, launches, peak GiB, seconds, the
    boxes each frame was cropped to, the clock: DB extraction, detect_bbox
    and crop)."""
    from onepose_tpu_torch.cli import common
    from onepose_tpu_torch.detector import feature_detector as fd

    clock, crops = _Clock(torch, device), []
    args = ["detect", f"db_dir={db}", f"query_dir={query}", f"weights.superpoint={sp_ckpt}",
            f"weights.superglue={sg_ckpt}", f"detector_matcher={kind}", f"device={device}",
            *(f"{k}={v}" for k, v in DETECT.items())]
    summary, counts, peak, sec = _command(torch, args, device, wraps=(
        (common, "extract_sequence_features", clock.wrap("DB extraction")),
        (fd.FeatureObjectDetector, "detect_bbox", clock.wrap("detect_bbox")),
        (fd.FeatureObjectDetector, "crop", clock.wrap("crop", keep=crops))))
    boxes = [np.asarray(a[2], np.float64) for a, _ in crops]  # (self, image, bbox, K)
    return summary, counts, peak, sec, boxes, clock


def _detect_outputs(np, query: Path, boxes, label):
    """Every crop and K_crop on disk, finite; per frame, K_crop equals
    get_affine_transform's two stages composed, and the box it implies (the
    crop's centre mapped back, the crop's width over its scale) is the
    detected box within DETECT_BOX_PX (stage 1 truncates the box to whole
    pixels)."""
    import cv2

    from onepose_tpu_torch.cli.detect_cmd import read_full_intrinsics
    from onepose_tpu_torch.geometry.transforms import get_affine_transform

    K = read_full_intrinsics(str(query)).astype(np.float64)
    size = DETECT["crop_size"]
    worst_A, worst_box = 0.0, 0.0
    for f, box in enumerate(boxes):
        crop = cv2.imread(str(query / "color_det" / f"{f}.png"), cv2.IMREAD_GRAYSCALE)
        Kc = np.loadtxt(query / "intrin_det" / f"{f}.txt")
        if crop is None or crop.shape != (size, size) or not np.isfinite(Kc).all():
            fail(f"detect ({label}): frame {f}'s crop or K_crop is missing or not finite")
        bw, bh = box[2] - box[0], box[3] - box[1]
        A1 = get_affine_transform(((box[0] + box[2]) / 2, (box[1] + box[3]) / 2), (bw, bh), 0,
                                  (int(bw), int(bh)))
        A2 = get_affine_transform((bw / 2, bh / 2), (bw, bh), 0, (size, size))
        A = np.vstack([A2, [0, 0, 1]]) @ np.vstack([A1, [0, 0, 1]])
        S = Kc @ np.linalg.inv(K)
        worst_A = max(worst_A, float(np.abs(S[:2] - A[:2]).max() / np.abs(A[:2, :2]).max()))
        s = S[0, 0]
        cx, cy = np.linalg.solve(S[:2, :2], np.array([size / 2, size / 2]) - S[:2, 2])
        implied = np.array([cx - size / s / 2, cy - size * bh / bw / s / 2,
                            cx + size / s / 2, cy + size * bh / bw / s / 2])
        worst_box = max(worst_box, float(np.abs(implied - box).max()))
    log(f"[detect] ({label}) {len(boxes)} crops {size}^2 and K_crop files on disk, finite; "
        f"K_crop against get_affine_transform's composed stages: max rel diff {worst_A:.3e} "
        f"(<= 1e-4); the box K_crop implies against the detected one: max {worst_box:.3f} px "
        f"(<= {DETECT_IMPLIED_PX})")
    if not (worst_A <= 1e-4 and worst_box <= DETECT_IMPLIED_PX):
        fail(f"detect ({label}): K_crop disagrees with the box it was cropped to")


def _detect_line(label, summary, counts, peak, sec, clock, frames):
    db = clock.s.get("DB extraction", 0.0)
    per = (sec - db) / frames
    log(f"[detect] ({label}) {frames} frames of {DETECT_HW[1]}x{DETECT_HW[0]}: summary "
        f"{summary}; {sec:.2f} s in all, DB extraction {db:.2f} s, {per:.3f} s a frame after it "
        f"(detect_bbox {clock.s.get('detect_bbox', 0.0) / frames * 1e3:.1f} ms, crop "
        f"{clock.s.get('crop', 0.0) / frames * 1e3:.1f} ms a frame; the rest: decode, SuperPoint, "
        f"keypoints, PNG write), peak device memory {peak:.2f} GiB; launches {counts}")
    return per


def phase_detect(torch, rows):
    """`python -m onepose_tpu_torch detect` on the card: (a) nn, (b)
    superglue, then the card against the CPU."""
    import numpy as np

    t_phase = time.perf_counter()
    w = _world(np)
    root = w["root"]
    t0 = time.perf_counter()
    query = _query_scene(np, root / "query", DETECT_FRAMES)
    log(f"[detect] query sequence: {DETECT_FRAMES} full frames of {DETECT_HW[1]}x{DETECT_HW[0]} "
        f"written as PNG in {time.perf_counter() - t0:.1f} s; DB: phase cli's "
        f"{CLI_SCENE['frames']} frames of {CLI_SCENE['img']}^2, {DETECT['n_ref_views']} views")
    w["query"] = query
    db_batches = -(-CLI_SCENE["frames"] // 8)
    for label, kind, frames in (("a", "nn", DETECT_FRAMES), ("b", "superglue", DETECT_SG_FRAMES)):
        q = query if kind == "nn" else _cli_subsequence(query, root / "query_sg", frames,
                                                          QUERY_SUBS)
        summary, counts, peak, sec, boxes, clock = _detect(torch, np, w["seq"], q, DEV, kind,
                                                           w["sg_ckpt"], w["sp_ckpt"])
        per = _detect_line(f"{label}: detector_matcher={kind}", summary, counts, peak, sec, clock,
                           frames)
        want = {k: 0 for k in counts}
        want["nms"] = db_batches + frames
        if kind == "superglue":
            want["sinkhorn"] = frames
        log(f"[detect] ({label}) want K1 once per DB batch of 8 ({db_batches}) and once per "
            f"frame ({frames}){', K6 once per frame' if kind == 'superglue' else ''}, no other "
            f"kernel: {want}; {frames / (sec - clock.s.get('DB extraction', 0.0)):.2f} frames/s "
            f"after the DB ({1 / per:.2f})")
        if counts != want or summary["num_frames"] != frames:
            fail(f"detect ({label}) launched {counts}, want {want}")
        _detect_outputs(np, q, boxes, label)
        key = "nms_full_frame" if kind == "nn" else "sinkhorn_detect"
        if key in rows:
            rows[key]["launches"] = counts["nms" if kind == "nn" else "sinkhorn"]

    # The card against the CPU: a DETECT_SMALL DB and frames.
    db = _cli_subsequence(w["seq"], root / "det_small", DETECT_SMALL["db_frames"])
    boxes = {}
    for i, dev in enumerate((DEV, "cpu")):
        q = _cli_subsequence(query, root / f"det_small_{i}", DETECT_SMALL["frames"], QUERY_SUBS)
        summary, counts, _, sec, boxes[dev], _ = _detect(torch, np, db, q, dev, "nn",
                                                         w["sg_ckpt"], w["sp_ckpt"])
        log(f"[detect] card against CPU, detect on {dev} ({DETECT_SMALL['db_frames']}-frame DB, "
            f"{DETECT_SMALL['frames']} frames): {sec:.2f} s, boxes "
            f"{[b.round(2).tolist() for b in boxes[dev]]}, launches {counts}")
    diff = float(np.abs(np.stack(boxes[DEV]) - np.stack(boxes["cpu"])).max())
    log(f"[detect] card against CPU: boxes max abs diff {diff:.4f} px (<= {DETECT_BOX_PX})")
    if not diff <= DETECT_BOX_PX:
        fail("detect on the card disagrees with detect on the CPU")
    log(f"[detect] phase detect took {time.perf_counter() - t_phase:.1f} s")


# --- phase infer: the `infer` command ----------------------------------------


def _infer(torch, args, device, label):
    """infer in the process: (metrics, launches, peak GiB, seconds, the
    clock of its batches)."""
    from onepose_tpu_torch.cli import infer

    clock = _Clock(torch, device)
    metrics, counts, peak, sec = _command(torch, ["infer", *args, f"device={device}"], device,
                                          wraps=((infer, "_serve", clock.wrap("batch")),))
    keys = {"cmd1", "cmd3", "cmd5", "mean_rot_deg", "mean_trans_cm", "num_frames"}
    if not keys <= set(metrics):
        fail(f"infer ({label}) printed {metrics}, not the metrics line")
    return metrics, counts, peak, sec, clock


def _infer_card_vs_cpu(torch, np, w, anno_dir):
    """INFER_SMALL frames of phase cli's sequence through the command's
    pipeline (`infer.build_pipeline`, `infer._serve`) on the card and the
    CPU. SuperPoint: the keypoints by overlap (slots follow score order,
    which fp32 sums in another order may swap), descriptors on shared slots.
    Then both devices match the CPU's features: matches0 identical, pnp_ok
    identical, poses within INFER_POSE_ABS where solved; the gats matcher
    at match_threshold MATCH_THRESHOLD on both (random weights clear no
    0.2), nn as shipped."""
    from onepose_tpu_torch.cli import infer
    from onepose_tpu_torch.data import paths as path_utils
    from onepose_tpu_torch.data.anno_io import annotation_from_npz_dir

    paths = path_utils.list_color_images(str(w["seq"]))[:INFER_SMALL]
    imgs = np.stack([path_utils.load_gray(p) for p in paths])
    K = np.stack([np.loadtxt(path_utils.intrin_path_by_color(p)).astype(np.float32)
                  for p in paths])
    weights = {"superpoint": w["sp_ckpt"], "matcher": w["gats_ckpt"]}
    keys = ("keypoints", "kpt_mask", "descriptors", "kpt_scores", "matches0", "pose", "pnp_ok",
            "num_matches")

    def run(dev, matcher, feats=None):
        cfg = {**infer.DEFAULTS, "matcher": matcher, "weights": weights, "device": dev}
        pipe = infer.build_pipeline(cfg, torch.device(dev))
        if matcher == "gats":
            pipe.matcher.match_threshold = MATCH_THRESHOLD
        anno = annotation_from_npz_dir(str(anno_dir), num_leaf=8, shape3d=cfg["shape3d"],
                                       device=dev)
        if feats is None:
            out = infer._serve(pipe, 0, K, anno, images=imgs)
        else:
            out = infer._serve(pipe, 0, K, anno,
                               feats={k: torch.from_numpy(v) for k, v in feats.items()})
        return {k: out[k].cpu().numpy() for k in keys}

    a, c = run(DEV, "nn"), run("cpu", "nn")
    overlap = _keypoint_overlap(a, c)
    same = (a["keypoints"] == c["keypoints"]).all(-1) & a["kpt_mask"] & c["kpt_mask"]
    desc_err = float(np.abs(a["descriptors"] - c["descriptors"])[same].max())
    log(f"[infer] card against CPU, {INFER_SMALL} frames through SuperPoint: keypoint overlap "
        f"{overlap:.4f} (>= {CLI_KPT_OVERLAP}), descriptor max abs diff on shared slots "
        f"{desc_err:.3e} (< {CLI_DESC_ABS})")
    if not (overlap >= CLI_KPT_OVERLAP and desc_err < CLI_DESC_ABS):
        fail("infer's features on the card disagree with the CPU's")
    feats = {"keypoints": c["keypoints"], "descriptors": c["descriptors"],
             "scores": c["kpt_scores"], "mask": c["kpt_mask"]}
    for matcher in ("gats", "nn"):
        a, c = run(DEV, matcher, feats), run("cpu", matcher, feats)
        same_m = int((a["matches0"] == c["matches0"]).all(-1).sum())
        same_ok = bool((a["pnp_ok"] == c["pnp_ok"]).all())
        solved = a["pnp_ok"] & c["pnp_ok"]
        worst = float(np.abs(a["pose"] - c["pose"])[solved].max()) if solved.any() else 0.0
        log(f"[infer] card against CPU, matcher={matcher}, the CPU's features: matches0 "
            f"identical in {same_m} of {INFER_SMALL} frames ({int(a['num_matches'].sum())} "
            f"matches on the card, {int(c['num_matches'].sum())} on the CPU), pnp_ok identical "
            f"{same_ok} ({int(solved.sum())} solved), poses max abs diff {worst:.3e} (<= "
            f"{INFER_POSE_ABS})")
        if same_m != INFER_SMALL or not same_ok or not worst <= INFER_POSE_ABS:
            fail(f"infer matcher={matcher} on the card disagrees with the CPU")


def _oracle_world(np, root: Path):
    """The planted oracle at production width: INFER_ORACLE frames on a ring
    around a jittered grid of points, exact projections, one unit
    descriptor a point; a sequence directory (blank color/ images, poses_ba,
    intrin_ba) and the features [F, P, ...] in load_features_h5's layout."""
    cfg = INFER_ORACLE
    rng = np.random.default_rng(7)
    n = cfg["grid"]
    g = np.stack(np.meshgrid(*[np.linspace(-cfg["cube"] / 2, cfg["cube"] / 2, n)] * 3), -1)
    pts = g.reshape(-1, 3) + rng.uniform(-cfg["jitter"], cfg["jitter"], (n ** 3, 3))
    desc = rng.normal(size=(len(pts), 256)).astype(np.float32)
    desc /= np.linalg.norm(desc, axis=-1, keepdims=True)
    S, f_len = cfg["img"], cfg["focal"]
    K = np.array([[f_len, 0, S / 2], [0, f_len, S / 2], [0, 0, 1]])
    seq = root / "obj" / "seq"
    for sub in ("color", "poses_ba", "intrin_ba"):
        (seq / sub).mkdir(parents=True)
    blank = np.zeros((8, 8), np.uint8)
    kps, poses = [], []
    for f in range(cfg["frames"]):
        ang = 0.6 * f / cfg["frames"] * 2 * np.pi
        pose = _look_at(np, np.array([np.cos(ang) * cfg["radius"], np.sin(ang) * cfg["radius"],
                                      0.4]))
        uvw = (pts @ pose[:3, :3].T + pose[:3, 3]) @ K.T
        kps.append((uvw[:, :2] / uvw[:, 2:3]).astype(np.float32))
        poses.append(pose)
        _png_gray(seq / "color" / f"{f}.png", blank)
        np.savetxt(seq / "poses_ba" / f"{f}.txt", pose)
        np.savetxt(seq / "intrin_ba" / f"{f}.txt", K)
    F, P = cfg["frames"], len(pts)
    feats = {"keypoints": np.stack(kps), "descriptors": np.broadcast_to(desc, (F, P, 256)).copy(),
             "scores": np.ones((F, P), np.float32), "mask": np.ones((F, P), bool)}
    inside = bool(((feats["keypoints"] > 0) & (feats["keypoints"] < S)).all())
    return seq, feats, np.stack(poses), np.broadcast_to(K, (F, 3, 3)).copy(), inside


def _infer_oracle(torch, np, root: Path):
    """(c) The planted oracle through eval_sequence's feature route (the
    arrays load_features_h5 would give) and the NN matcher, the annotation
    from run_mapping on the card over the same features: cmd1 == 1.0, then
    again with the EPnP refit on (the same recalls; epnp_solve counted)."""
    import functools

    from onepose_tpu_torch.cli import infer
    from onepose_tpu_torch.data.anno_io import annotation_from_npz_dir, save_annotation_npz
    from onepose_tpu_torch.eval import Evaluator
    from onepose_tpu_torch.geometry import ransac
    from onepose_tpu_torch.parallel.sfm_parallel import make_nn_pair_matcher
    from onepose_tpu_torch.runtime import pipeline
    from onepose_tpu_torch.sfm.mapping import MappingConfig, run_mapping

    t0 = time.perf_counter()
    seq, feats, poses, K, inside = _oracle_world(np, root / "oracle")
    P = feats["keypoints"].shape[1]
    match = make_nn_pair_matcher(feats["descriptors"], feats["mask"], distance_thresh=0.7,
                                 device=DEV)
    res = run_mapping(feats["keypoints"], feats["descriptors"], feats["scores"], feats["mask"],
                      K.astype(np.float32), poses.astype(np.float32), match,
                      config=MappingConfig(num_covis=10, max_points3d=2000, num_leaf=8),
                      device=DEV)
    anno_dir = root / "oracle" / "anno"
    save_annotation_npz(res, str(anno_dir))
    st = res.stats
    log(f"[infer] (c) oracle: {INFER_ORACLE['frames']} frames x {P} planted points (all inside "
        f"the {INFER_ORACLE['img']}^2 frame: {inside}), run_mapping on the card: {st['num_points3d']} "
        f"points, mean reprojection error {st['mean_reproj_error_px']:.2e} px, in "
        f"{time.perf_counter() - t0:.2f} s")
    if st["num_points3d"] != P or not inside:
        fail("the oracle map is not the planted points")
    cfg = {**infer.DEFAULTS, "matcher": "nn", "max_keypoints": P, "device": DEV}
    pipe = infer.build_pipeline(cfg, torch.device(DEV))
    anno = annotation_from_npz_dir(str(anno_dir), num_leaf=8, shape3d=cfg["shape3d"], device=DEV)
    results = {}
    calls = []  # seconds of each epnp_solve call, synchronized
    for refit in (False, True):
        saved_pnp, saved_epnp = pipeline.ransac_pnp, ransac.epnp_solve
        if refit:
            pipeline.ransac_pnp = functools.partial(saved_pnp, epnp_refit=True)

            def counted(*a, **k):
                if DEV != "cpu":
                    torch.cuda.synchronize()
                t = time.perf_counter()
                out = saved_epnp(*a, **k)
                if DEV != "cpu":
                    torch.cuda.synchronize()
                calls.append(time.perf_counter() - t)
                return out

            ransac.epnp_solve = counted
        try:
            t1 = time.perf_counter()
            m = infer.eval_sequence(cfg, str(seq), anno, pipe, Evaluator(), features=feats)
            if DEV != "cpu":
                torch.cuda.synchronize()
            sec = time.perf_counter() - t1
        finally:
            pipeline.ransac_pnp, ransac.epnp_solve = saved_pnp, saved_epnp
        results[refit] = m
        log(f"[infer] (c) oracle, epnp_refit={refit}: {m} in {sec:.2f} s"
            + (f"; epnp_solve ran {len(calls)} times (once a batch of {cfg['batch']} frames x "
               f"{P} correspondences): first {calls[0] * 1e3:.1f} ms, median of the rest "
               f"{statistics.median(calls[1:] or calls) * 1e3:.2f} ms" if refit else ""))
    want_calls = -(-INFER_ORACLE["frames"] // cfg["batch"])
    if not (results[False]["cmd1"] == 1.0 and all(results[True][k] == results[False][k]
                                                  for k in ("cmd1", "cmd3", "cmd5"))
            and len(calls) == want_calls):
        fail("the infer oracle missed cmd1 == 1.0, or the EPnP refit changed its recalls")


def phase_infer(torch):
    """`python -m onepose_tpu_torch infer` on the card: (a) gats on phase
    cli's frames and on phase detect's crops, (b) nn; the card against the
    CPU; (c) the planted oracle, with the EPnP refit off and on."""
    import numpy as np

    t_phase = time.perf_counter()
    w = _world(np)
    anno_dir = _world_map(torch, np) / "anno"
    F, B = CLI_SCENE["frames"], 8
    batches = -(-F // B)
    base = [f"anno_dir={anno_dir}", f"weights.superpoint={w['sp_ckpt']}",
            f"weights.matcher={w['gats_ckpt']}"]
    runs = [("a", "gats", f"data_dir={w['seq']}", F)]
    if "query" in w and (w["query"] / "color_det").is_dir():
        runs.append(("a, detect's crops", "gats", f"data_dir={w['query']}", DETECT_FRAMES))
    runs.append(("b", "nn", f"data_dir={w['seq']}", F))
    for label, matcher, data, frames in runs:
        extra = ["det_type=feature_matching"] if "crops" in label else []
        metrics, counts, peak, sec, clock = _infer(torch, [data, f"matcher={matcher}", *base,
                                                           *extra], DEV, label)
        nb = -(-frames // B)
        per = clock.s["batch"] / nb
        each = clock.each["batch"]
        want = {k: 0 for k in counts}
        want["nms"] = nb
        if matcher == "gats":
            want.update(gats=4 * nb, dual_softmax=nb)
        side = DETECT["crop_size"] if "crops" in label else CLI_SCENE["img"]
        log(f"[infer] ({label}) matcher={matcher}, {frames} frames of {side}^2 in "
            f"{nb} batches of {B}: {metrics}; {sec:.2f} s in all, {per * 1e3:.1f} ms a batch "
            f"through the pipeline (median {statistics.median(each) * 1e3:.1f}, first "
            f"{each[0] * 1e3:.1f}; {frames / clock.s['batch']:.1f} frames/s; "
            f"{frames / sec:.1f} with decode, annotation and evaluation), peak device memory "
            f"{peak:.2f} GiB; launches {counts} (want per batch K1 1"
            f"{', K2 4, K3 1' if matcher == 'gats' else ''}, no other: {want})")
        if counts != want or metrics["num_frames"] != frames:
            fail(f"infer ({label}) launched {counts}, want {want}")
    _infer_card_vs_cpu(torch, np, w, anno_dir)
    _infer_oracle(torch, np, w["root"])
    log(f"[infer] phase infer took {time.perf_counter() - t_phase:.1f} s; random weights: the "
        f"recalls of (a) and (b) say nothing of accuracy, (c) does")


# --- phase tracker: the BA tracker -------------------------------------------


def _tracker_scene(np):
    """TRACKER's planted orbit (tests/test_tracker.py:49-120 at full width):
    points in a cube, each a Gaussian blob (sigma 2 px) of its own
    brightness splatted at its exact sub-pixel projection, a unit random
    descriptor a point; the camera on tests/test_tracker.py's orbit. Per
    frame: (GT pose, image, keypoints, descriptors, mask, point ids); the
    keypoints are the visible points' projections, with 0.2 px of noise
    after frame 0."""
    cfg = TRACKER
    rng = np.random.default_rng(11)
    n, S, N = cfg["points"], cfg["img"], cfg["points"]
    pts = ((rng.random((n, 3)) - 0.5) * cfg["cube"]).astype(np.float32)
    amp = 0.5 + 0.5 * np.sin(rng.random(n) * 2 * np.pi)
    desc = rng.standard_normal((n, cfg["desc"])).astype(np.float32)
    desc /= np.linalg.norm(desc, axis=1, keepdims=True)
    K = np.array([[cfg["focal"], 0, S / 2], [0, cfg["focal"], S / 2], [0, 0, 1]], np.float32)
    oy, ox = np.mgrid[-8:9, -8:9]
    frames = []
    for i in range(cfg["frames"]):
        ang = 0.02 * i
        pose = _look_at(np, np.array([np.cos(ang) * cfg["radius"], np.sin(ang) * cfg["radius"],
                                      0.35 + 0.002 * i])).astype(np.float32)
        pc = pts @ pose[:3, :3].T + pose[:3, 3]
        uv = pc @ K.T
        uv = uv[:, :2] / uv[:, 2:3]
        vis = (pc[:, 2] > 0.05) & (uv > 10).all(1) & (uv < S - 10).all(1)
        c = np.rint(uv[vis]).astype(np.int64)
        ys, xs = c[:, 1, None, None] + oy, c[:, 0, None, None] + ox
        d2 = (xs - uv[vis, 0, None, None]) ** 2 + (ys - uv[vis, 1, None, None]) ** 2
        image = np.zeros(S * S)
        np.add.at(image, (ys * S + xs).reshape(-1),
                  (amp[vis, None, None] * np.exp(-d2 / 8.0)).reshape(-1))
        image = np.clip(image, 0, 1).astype(np.float32).reshape(S, S)
        ids = np.nonzero(vis)[0][:N]
        kp = np.zeros((N, 2), np.float32)
        kp[:len(ids)] = uv[ids] + (rng.normal(size=(len(ids), 2)) * 0.2 if i else 0.0)
        ds = np.zeros((N, cfg["desc"]), np.float32)
        ds[:len(ids)] = desc[ids]
        m = np.zeros(N, bool)
        m[:len(ids)] = True
        frames.append((pose, image, kp, ds, m, ids))
    return pts, K, frames


def _pose_err(np, pose, gt):
    """(rotation error degrees, translation error cm), as query_pose_error."""
    tr = np.clip(np.trace(pose[:3, :3] @ gt[:3, :3].T), -1.0, 3.0)
    return float(np.degrees(np.arccos((tr - 1) / 2))), float(
        np.linalg.norm(pose[:3, 3] - gt[:3, 3]) * 100)


def _tracker_start(np, pts, K, frames, device):
    from onepose_tpu_torch.tracker import BATracker, TrackerConfig

    trk = BATracker(TrackerConfig(n_kpts=TRACKER["points"]), device=device)
    pose0, image0, kp, ds, m, ids0 = frames[0]
    p3d = np.full(TRACKER["points"], -1, np.int32)
    p3d[:len(ids0)] = np.arange(len(ids0))
    trk.initialize(image0, kp, ds, m, p3d, pts[ids0], pose0, K)
    return trk


def _tracker_run(torch, np, pts, K, frames, device):
    """Frames 1.. tracked from frame 0 (GT pose, 3D ids): (outputs, host ms
    of each track call, whether it was a keyframe-cadence frame)."""
    trk = _tracker_start(np, pts, K, frames, device)
    outs, ms, kf = [], [], []
    for _, image, kp, ds, m, _ in frames[1:]:
        kf.append(trk._frame_count % trk.cfg.kf_interval == 0)
        t0 = time.perf_counter()
        outs.append(trk.track(image, kp, ds, m, K))  # ends in its one host read
        ms.append((time.perf_counter() - t0) * 1e3)
    return trk, outs, ms, kf


def _tracker_syncs(torch, trk, frame, K) -> list:
    """Where one tracked frame syncs the host ("file:line" a sync, from
    torch.cuda's sync debug mode: `utils.profiling.host_syncs`), the
    tracker's state restored after."""
    from onepose_tpu_torch.utils.profiling import host_syncs

    saved = (trk.state, trk._frame_count, trk._use_motion_cnt)
    _, image, kp, ds, m, _ = frame
    try:
        return host_syncs(lambda: trk.track(image, kp, ds, m, K))
    finally:
        trk.state, trk._frame_count, trk._use_motion_cnt = saved


def _tracker_profile(torch, trk, frame, K, calls=3) -> tuple:
    """(CUDA kernels, device ms, wall ms) per tracked frame under
    torch.profiler, each call from the same state, and the top kernels."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    saved = (trk.state, trk._frame_count, trk._use_motion_cnt)
    _, image, kp, ds, m, _ = frame
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(calls):
            trk.state, trk._frame_count, trk._use_motion_cnt = saved
            trk.track(image, kp, ds, m, K)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3 / calls
    trk.state, trk._frame_count, trk._use_motion_cnt = saved
    kernels = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    by_name = {}
    for e in kernels:
        by_name[e.name] = by_name.get(e.name, 0.0) + e.time_range.elapsed_us() / 1e3 / calls
    busy = sum(by_name.values())
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:6]
    return len(kernels) // calls, busy, wall, top


def _tracker_blank(torch, np):
    """tests/test_tracker.py:123 on the card, at its own shapes (60 blobs at
    160 x 160; window 3, 64 slots): after the keyframe, a blank frame; the
    flow must fail and the motion prediction keep the pose finite and
    within 5 cm. (After a dense keyframe the blank frame's flow leaves most
    points where they were: a window round one blob is symmetric, so the
    LK step is near zero, and PnP keeps the last pose without the
    fallback.)"""
    from onepose_tpu_torch.tracker import BATracker, TrackerConfig

    rng = np.random.default_rng(1)
    img, n = 160, 60
    pts = ((rng.random((n, 3)) - 0.5) * 0.2).astype(np.float32)
    tex = rng.random(n) * 6.28
    K = np.array([[300.0, 0, img / 2], [0, 300.0, img / 2], [0, 0, 1]], np.float32)
    desc = rng.normal(size=(n, 16)).astype(np.float32)
    desc /= np.linalg.norm(desc, axis=-1, keepdims=True)
    pose0 = _look_at(np, np.array([0.6, 0.0, 0.35])).astype(np.float32)
    pc = pts @ pose0[:3, :3].T + pose0[:3, 3]
    uv = pc @ K.T
    uv = uv[:, :2] / uv[:, 2:3]
    vis = (pc[:, 2] > 0.05) & (uv > 10).all(1) & (uv < img - 10).all(1)
    ys, xs = np.mgrid[0:img, 0:img]
    image = np.zeros((img, img), np.float32)
    for p, ph in zip(uv[vis], tex[vis]):
        image += (0.5 + 0.5 * np.sin(ph)) * np.exp(-((xs - p[0]) ** 2 + (ys - p[1]) ** 2) / 8.0)
    image = np.clip(image, 0, 1).astype(np.float32)
    trk = BATracker(TrackerConfig(window_size=3, n_kpts=64, point_capacity=256, kf_interval=2,
                                  ransac_hyp=32, ba_iters=2), device=DEV)
    ids = np.nonzero(vis)[0][:64]
    kp, ds, m = np.zeros((64, 2), np.float32), np.zeros((64, 16), np.float32), np.zeros(64, bool)
    kp[:len(ids)], ds[:len(ids)], m[:len(ids)] = uv[ids], desc[ids], True
    p3d = np.full(64, -1, np.int32)
    p3d[:len(ids)] = np.arange(len(ids))
    trk.initialize(image, kp, ds, m, p3d, pts[ids], pose0, K)
    out = trk.track(np.zeros_like(image), np.zeros((64, 2), np.float32),
                    np.zeros((64, 16), np.float32), np.zeros(64, bool), K)
    _, t_blank = _pose_err(np, out["pose"], pose0)
    log(f"[tracker] blank frame (tests/test_tracker.py:123's scene): used_motion "
        f"{out['used_motion']}, pose finite {bool(np.isfinite(out['pose']).all())}, "
        f"{t_blank:.4f} cm from the last pose (< 5)")
    if not (out["used_motion"] and np.isfinite(out["pose"]).all() and t_blank < 5.0):
        fail("the blank-frame motion fallback failed")


def phase_tracker(torch):
    """BATracker at demo's width on the planted orbit: poses against the
    ground truth, the blank-frame fallback, ms per frame, kernels, busy
    share, host syncs, peak memory; then the card against the CPU."""
    import numpy as np

    from onepose_tpu_torch.ops.kernels import launch_counts, reset_launches

    t_phase = time.perf_counter()
    t0 = time.perf_counter()
    pts, K, frames = _tracker_scene(np)
    n_vis = [len(f[5]) for f in frames]
    log(f"[tracker] planted orbit: {TRACKER['frames']} frames of {TRACKER['img']}^2, "
        f"{TRACKER['points']} points ({min(n_vis)} to {max(n_vis)} visible a frame), "
        f"{TRACKER['desc']}-d descriptors, rendered in {time.perf_counter() - t0:.1f} s; "
        f"TrackerConfig defaults with n_kpts={TRACKER['points']} (demo's)")
    torch.cuda.synchronize()
    resident = torch.cuda.memory_allocated() / 2**30
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    trk, outs, ms, kf = _tracker_run(torch, np, pts, K, frames, DEV)
    counts = launch_counts()
    peak = torch.cuda.max_memory_allocated() / 2**30
    errs = [_pose_err(np, o["pose"], f[0]) for o, f in zip(outs, frames[1:])]
    r, t = np.array(errs).T
    c = trk.cfg
    log(f"[tracker] config: window {c.window_size}, {c.n_kpts} keypoint slots, capacity "
        f"{c.point_capacity}, {c.ransac_hyp} hypotheses, {c.ba_iters} BA iterations, keyframe "
        f"every {c.kf_interval}")
    log(f"[tracker] {len(outs)} tracked frames: flow_ok {sum(o['flow_ok'] for o in outs)}, "
        f"n_tracked {min(o['n_tracked'] for o in outs)} to {max(o['n_tracked'] for o in outs)}, "
        f"new points {sum(o['n_new_points'] for o in outs)}; against the ground truth: rotation "
        f"max {r.max():.4f} deg, translation max {t.max():.4f} cm, {(r < 1).mean():.0%} within "
        f"{TRACKER_ORACLE['fine_deg']} deg (want every frame within {TRACKER_ORACLE['max_cm']} "
        f"cm / {TRACKER_ORACLE['max_deg']} deg, more than half within 1 deg)")
    if not (r.max() < TRACKER_ORACLE["max_deg"] and t.max() < TRACKER_ORACLE["max_cm"]
            and (r < TRACKER_ORACLE["fine_deg"]).mean() > 0.5):
        fail("the tracker lost the planted orbit")
    every = np.array(ms)
    kfm, other = every[np.array(kf)], every[~np.array(kf)]
    log(f"[tracker] ms a tracked frame (host clock, each ends in its one read): first "
        f"{every[0]:.1f}, median of the rest {np.median(every[1:]):.1f} (keyframe-cadence "
        f"frames: median {np.median(kfm):.1f} over {len(kfm)}; others {np.median(other[1:]):.1f}"
        f" over {len(other) - 1}); peak device memory {peak:.3f} GiB ({resident:.3f} GiB "
        f"resident at the reset); kernel launches {counts} (want none: the tracker runs no "
        f"hand-written kernel)")
    if any(counts.values()):
        fail(f"the tracker launched {counts}")
    pose, image, kp, ds, m, ids = frames[-1]
    p3d = np.full(TRACKER["points"], -1, np.int32)
    p3d[:len(ids)] = ids
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    accepted = trk.update_kf(image, kp, ds, m, p3d, pose, K)
    torch.cuda.synchronize()
    log(f"[tracker] update_kf (a matcher-verified keyframe at the last frame's GT pose): "
        f"accepted {accepted}, {(time.perf_counter() - t0) * 1e3:.1f} ms")
    if not accepted:
        fail("update_kf rejected a keyframe at the ground-truth pose")

    mid = frames[len(frames) // 2]
    syncs = _tracker_syncs(torch, trk, mid, K)
    n_k, busy, wall, top = _tracker_profile(torch, trk, mid, K)
    where = ", ".join(f"{k} x{v}" for k, v in sorted(collections.Counter(syncs).items()))
    log(f"[tracker] one tracked frame: {len(syncs)} host syncs (torch.cuda sync debug mode) at "
        f"{where or 'none'}; "
        f"profiler over 3 calls: {n_k} CUDA kernels, {busy:.2f} ms of device time in "
        f"{wall:.2f} ms wall: busy {100 * busy / wall:.1f}%")
    for name, kms in top:
        log(f"[tracker] profiler top kernel: {kms:.3f} ms a frame  {name[:90]}")

    _tracker_blank(torch, np)

    # The card against the CPU: the same frames and draws.
    t0 = time.perf_counter()
    _, cpu_outs, cpu_ms, _ = _tracker_run(torch, np, pts, K, frames, "cpu")
    same = all(a[k] == b[k] for a, b in zip(outs, cpu_outs) for k in ("flow_ok", "used_motion"))
    first_kf = kf.index(True)  # frames before it track from the same keyframe on both
    counts_diff = [(i + 1, k, a[k], b[k]) for i, (a, b) in enumerate(zip(outs, cpu_outs))
                   for k in ("n_tracked", "n_new_points") if a[k] != b[k]]
    counts_ok = all(i > first_kf + 1 and abs(a - b) <= TRACKER_COUNT_REL * b
                    for i, _, a, b in counts_diff)
    worst = max(float(np.abs(a["pose"] - b["pose"]).max()) for a, b in zip(outs, cpu_outs))
    log(f"[tracker] card against CPU, {len(outs)} frames ({time.perf_counter() - t0:.1f} s on "
        f"the CPU, median {np.median(cpu_ms[1:]):.1f} ms a frame): flow_ok and used_motion "
        f"identical {same}; n_tracked and n_new_points differ on (frame, count, card, CPU) "
        f"{counts_diff} (none up to frame {first_kf + 1}, the first keyframe commit, and "
        f"within {TRACKER_COUNT_REL:.0%} after it: {counts_ok}); poses max abs diff "
        f"{worst:.3e} (<= {TRACKER_CARD_CPU_ABS})")
    if not (same and counts_ok and worst <= TRACKER_CARD_CPU_ABS):
        fail("the tracker on the card disagrees with the CPU")
    log(f"[tracker] phase tracker took {time.perf_counter() - t_phase:.1f} s")


# --- phase demo: the `demo` command ------------------------------------------


def _demo_sequence(np, w, root: Path, db_frames=None, frames=None) -> Path:
    """A demo sequence under root: phase cli's crops as the detector's DB
    (color/, poses_ba/, intrin_ba/), phase detect's full frames
    (color_full/, intrinsics.txt) and the object's box; the first
    `db_frames` / `frames` of each (copies), or all (links)."""
    import os
    import shutil

    seq = root / "obj" / "seq"
    seq.mkdir(parents=True)
    for src, subs, n in ((w["seq"], ("color", "poses_ba", "intrin_ba"), db_frames),
                         (w["query"], ("color_full",), frames)):
        for sub in subs:
            if n is None:
                os.symlink(src / sub, seq / sub)
                continue
            (seq / sub).mkdir()
            for f in range(n):
                name = f"{f}.png" if sub.startswith("color") else f"{f}.txt"
                shutil.copy(src / sub / name, seq / sub / name)
    shutil.copy(w["query"] / "intrinsics.txt", seq)
    shutil.copy(w["seq"].parent / "box3d_corners.txt", root / "obj")
    return seq


class _LaunchLog:
    """Kernel launches of wrapped calls, by a key of each call."""

    def __init__(self):
        self.by = {}

    def wrap(self, key):
        from onepose_tpu_torch.ops.kernels import launch_counts

        def outer(fn):
            def inner(*a, **k):
                before = launch_counts()
                out = fn(*a, **k)
                after = launch_counts()
                d = self.by.setdefault(key(a), {"calls": 0})
                d["calls"] += 1
                for n in after:
                    d[n] = d.get(n, 0) + after[n] - before[n]
                return out
            return inner
        return outer

    def per_call(self, key) -> dict:
        d = self.by.get(key, {"calls": 0})
        return {n: v / max(d["calls"], 1) for n, v in d.items() if n != "calls" and v}


def _demo(torch, np, seq: Path, anno: Path, out: Path, device, extra=()):
    """demo in the process: (summary, launches, peak GiB, seconds, the
    per-frame route, the launch log)."""
    from onepose_tpu_torch.cli import demo
    from onepose_tpu_torch.detector import feature_detector as fd
    from onepose_tpu_torch.runtime.pipeline import PosePipeline

    w = _world(np)
    route, log_ = [], _LaunchLog()

    def tagged(tag):
        def outer(fn):
            def inner(*a, **k):
                route.append(tag)
                return fn(*a, **k)
            return inner
        return outer

    size = DEMO["crop_size"]
    args = ["demo", f"data_dir={seq}", f"anno_dir={anno}", f"out_dir={out}",
            f"weights.superpoint={w['sp_ckpt']}", f"weights.matcher={w['gats_ckpt']}",
            f"device={device}", *(f"{k}={v}" for k, v in DEMO.items()), *extra]
    summary, counts, peak, sec = _command(torch, args, device, wraps=(
        (fd.FeatureObjectDetector, "detect_bbox", tagged("D")),
        (fd.FeatureObjectDetector, "previous_pose_detect", tagged("B")),
        (PosePipeline, "__call__", log_.wrap(lambda a: "matcher")),
        (demo, "_features", log_.wrap(lambda a: "crop" if a[1].shape[0] == size else "full"))))
    frames = json.loads((out / "results.json").read_text())["frames"]
    per_frame = [b + ("T" if f["tracked"] else "M") for b, f in zip(route, frames)]
    return summary, counts, peak, sec, per_frame, [f["conf"] for f in frames], log_


def phase_demo(torch, rows):
    """`python -m onepose_tpu_torch demo` on the card: (a) without tracking,
    (b) with tracking (keyframe every 5 frames), then the route of the first
    frames on the card against the CPU."""
    import numpy as np

    t_phase = time.perf_counter()
    w = _world(np)
    anno = _world_map(torch, np) / "anno"
    root = w["root"] / "demo"
    if "query" not in w:
        w["query"] = _query_scene(np, w["root"] / "query", DETECT_FRAMES)
    seq = _demo_sequence(np, w, root / "seq")
    F = DETECT_FRAMES
    db_batches = -(-CLI_SCENE["frames"] // 8)
    results = {}
    for label, extra in DEMO_RUNS:
        torch.cuda.synchronize()
        resident = torch.cuda.memory_allocated() / 2**30
        summary, counts, peak, sec, route, conf, launches = _demo(
            torch, np, seq, anno, root / f"out_{label}", DEV, extra)
        results[label] = (summary, route, launches)
        video = summary["video"] and Path(summary["video"]).is_file() and \
            Path(summary["video"]).stat().st_size > 0
        per_m, per_t = launches.per_call("matcher"), launches.per_call("crop")
        log(f"[demo] ({label}) {' '.join(extra)}: {F} frames of {DETECT_HW[1]}x{DETECT_HW[0]}, "
            f"DB {CLI_SCENE['frames']} crops; {sec:.2f} s in all; summary {summary}; route "
            f"{' '.join(route)} (D: full-frame detection, B: box from the previous pose; M: "
            f"matcher, T: tracker); peak device memory {peak:.3f} GiB ({resident:.3f} GiB "
            f"resident at the reset); video written {bool(video)}; launches {counts}; per "
            f"matcher frame {per_m}, per tracked frame {per_t}")
        s = summary
        if not (s["num_frames"] == F and s["n_matcher"] + s["n_flow_track"] == F and video
                and s["n_detect"] + s["n_box_track"] == F):
            fail(f"demo ({label}) did not serve every frame")
        want = {k: 0 for k in counts}
        want.update(nms=db_batches + s["n_detect"] + s["n_matcher"] + s["n_flow_track"],
                    gats=4 * s["n_matcher"], dual_softmax=s["n_matcher"])
        if counts != want or (s["n_flow_track"] and per_t != {"nms": 1.0}) or per_m != {
                "nms": 1.0, "gats": 4.0, "dual_softmax": 1.0}:
            fail(f"demo ({label}) launched {counts}, want {want}")
        if label == "b" and s["n_flow_track"] == 0:
            fail("demo (b) tracked no frame")
        for key, name in (("nms", "nms"), ("gats", "gats"), ("dual_softmax", "dual_softmax")):
            if key in rows:
                extra_ = rows[key].setdefault("extra", {})
                extra_[f"demo_{label}_launches"] = counts[name]
                extra_["demo_launches_per_matcher_frame"] = per_m.get(name, 0.0)
                if s["n_flow_track"]:
                    extra_["demo_launches_per_tracked_frame"] = per_t.get(name, 0.0)

    # The card against the CPU: the route and confidence of the first frames.
    for label, extra in DEMO_RUNS:
        got = []
        for i, dev in enumerate((DEV, "cpu")):
            small = _demo_sequence(np, w, root / f"small_{label}_{i}",
                                   db_frames=DEMO_SMALL["db_frames"], frames=DEMO_SMALL["frames"])
            t0 = time.perf_counter()
            _, _, _, _, route, conf, _ = _demo(torch, np, small, anno,
                                               root / f"small_out_{label}_{i}", dev, extra)
            got.append((route, conf))
            log(f"[demo] card against CPU ({label}), demo on {dev}: {DEMO_SMALL['frames']} frames, "
                f"{DEMO_SMALL['db_frames']}-frame DB, {time.perf_counter() - t0:.1f} s: route "
                f"{' '.join(route)}, confidence {conf}")
        if got[0] != got[1]:
            fail(f"demo ({label}) took another route on the card than on the CPU")
    log(f"[demo] phase demo took {time.perf_counter() - t_phase:.1f} s; random weights: the "
        f"poses say nothing of accuracy (phase tracker and phase infer (c) do)")


# --- phase cli, A15: convert, parse-scan, video2img, merge-anno ---------------


def _reference_state_dicts(np, torch, seed):
    """SuperPoint and GATsSPG (4 blocks) state_dicts with the reference's key
    names and shapes (what models/convert.py reads), weights drawn from a
    seed at 1 / sqrt(fan_in), biases zero."""
    rng = np.random.default_rng(seed)
    sp, gm = {}, {}

    def conv(sd, name, out, inp, *k):
        fan = inp * int(np.prod(k))
        sd[f"{name}.weight"] = torch.from_numpy(
            (rng.standard_normal((out, inp, *k)) / np.sqrt(fan)).astype(np.float32))
        sd[f"{name}.bias"] = torch.zeros(out)

    for name, out, inp in (("conv1a", 64, 1), ("conv1b", 64, 64), ("conv2a", 64, 64),
                           ("conv2b", 64, 64), ("conv3a", 128, 64), ("conv3b", 128, 128),
                           ("conv4a", 128, 128), ("conv4b", 128, 128), ("convPa", 256, 128),
                           ("convDa", 256, 128)):
        conv(sp, name, out, inp, 3, 3)
    conv(sp, "convPb", 65, 256, 1, 1)
    conv(sp, "convDb", 256, 256, 1, 1)
    d = 256
    for blk in range(4):
        base = 3 * blk
        gm[f"gnn.layers.{base}.W"] = torch.from_numpy(
            (rng.standard_normal((d, d)) / np.sqrt(d)).astype(np.float32))
        gm[f"gnn.layers.{base}.a"] = torch.from_numpy(
            (rng.standard_normal((2 * d, 1)) / np.sqrt(2 * d)).astype(np.float32))
        for layer in (base + 1, base + 2):
            for i in range(3):
                conv(gm, f"gnn.layers.{layer}.attn.proj.{i}", d, d, 1)
            conv(gm, f"gnn.layers.{layer}.attn.merge", d, d, 1)
            conv(gm, f"gnn.layers.{layer}.mlp.0", 2 * d, 2 * d, 1)
            conv(gm, f"gnn.layers.{layer}.mlp.3", d, 2 * d, 1)
    conv(gm, "final_proj", d, d, 1)
    return sp, {f"matcher.{k}": v for k, v in gm.items()}


def _host_command(argv) -> str:
    """One host command of the port in the process: its stdout's last line."""
    import contextlib
    import io

    from onepose_tpu_torch.__main__ import main as cli_main

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = cli_main(argv)
    out = buf.getvalue().strip().splitlines()
    if rc != 0 or not out:
        fail(f"{argv[0]} returned {rc} with output {out[-3:]}")
    return out[-1]


def _capture(np, root: Path, frames: int) -> Path:
    """A synthetic ARKit capture (tests/test_data.py:257-288 at phone size):
    intrinsics.txt, Box.txt (a 0.2 m box at the origin), ARposes.txt (the
    camera 0.5 m in front, moving sideways), Frames.m4v (noise frames of
    480 x 640 that cv2 writes)."""
    import cv2

    root.mkdir(parents=True)
    (root / "intrinsics.txt").write_text("".join(
        f"{i},{0.1 * i},600,600,320,240\n" for i in range(frames)))
    (root / "Box.txt").write_text("header\n0,0,0,0.2,0.2,0.2,1,0,0,0\n")
    (root / "ARposes.txt").write_text("".join(
        f"{0.1 * i},{0.01 * i},0,0.5,1,0,0,0\n" for i in range(frames)))
    writer = cv2.VideoWriter(str(root / "Frames.m4v"), cv2.VideoWriter_fourcc(*"mp4v"), 10,
                             (640, 480))
    if not writer.isOpened():
        fail("cv2 cannot write an .m4v here")
    rng = np.random.default_rng(8)
    for _ in range(frames):
        writer.write((rng.random((480, 640, 3)) * 255).astype(np.uint8))
    writer.release()
    return root


def _cli_a15(torch, np, w):
    """The host commands once each: convert (reference-layout weights from a
    seed at the shipped widths), infer reading the weight files against
    infer reading their conversions, parse-scan, video2img, merge-anno."""
    import argparse

    root = w["root"] / "a15"
    root.mkdir()
    t0 = time.perf_counter()
    sp_sd, gm_sd = _reference_state_dicts(np, torch, seed=4)
    sp_pth, gm_ckpt = root / "superpoint_v1.pth", root / "gats_spg.ckpt"
    torch.save(sp_sd, sp_pth)
    torch.save({"state_dict": gm_sd, "epoch": 9,
                "hyper_parameters": argparse.Namespace(lr=1e-3)}, gm_ckpt)
    converted = {}
    for model, src in (("superpoint", sp_pth), ("gats_spg", gm_ckpt)):
        converted[model] = root / f"{model}.msgpack"
        line = _host_command(["convert", f"model={model}", f"weights={src}",
                              f"out={converted[model]}"])
        log(f"[cli] convert {src.name}: {line}")
        if not converted[model].is_file():
            fail(f"convert wrote no {converted[model]}")

    sub = _cli_subsequence(w["seq"], root / "infer_seq", 16)
    anno = w["map_a"] / "anno"
    runs = []
    for label, sp_w, gm_w in (("weight files", sp_pth, gm_ckpt),
                              ("converted", converted["superpoint"], converted["gats_spg"])):
        vis = root / f"vis_{len(runs)}"
        metrics, counts, _, sec, _ = _infer(torch, [
            f"data_dir={sub}", f"anno_dir={anno}", "matcher=gats", f"weights.superpoint={sp_w}",
            f"weights.matcher={gm_w}", f"dump_vis3d={vis}"], DEV, label)
        runs.append((metrics, {p.parent.name: json.loads(p.read_text())
                               for p in vis.glob("*/camera.json")}))
        log(f"[cli] infer with the {label} ({Path(sp_w).name}, {Path(gm_w).name}), 16 frames: "
            f"{metrics}, {sec:.2f} s, launches {counts}")
    (m_a, v_a), (m_b, v_b) = runs
    if not (m_a == m_b and v_a == v_b and len(v_a) == 16):
        fail("infer reading the PyTorch weight files differs from infer reading their conversion")
    log("[cli] infer reading the .pth / .ckpt equals infer reading the converted .msgpack: "
        "metrics and every frame's dump_vis3d identical")

    cap = _capture(np, root / "capture", 8)
    line = _host_command(["parse-scan", f"data_dir={cap}", f"out_dir={root / 'parsed'}"])
    parsed = json.loads(line)
    crops = sorted((root / "parsed" / "color").glob("*.png"))
    log(f"[cli] parse-scan of an 8-frame capture: {parsed}, {len(crops)} crops")
    if parsed != {"num_frames": 8, "num_video_frames": 8} or len(crops) != 8:
        fail("parse-scan did not parse every frame")
    line = _host_command(["video2img", f"video_file={cap / 'Frames.m4v'}",
                          f"out_dir={root / 'frames'}", "downsample_rate=2"])
    log(f"[cli] video2img, every 2nd frame: {line}")
    if json.loads(line) != {"num_frames": 4}:
        fail("video2img did not extract every 2nd frame")
    indices = [w["map_a"] / "anno" / "anno_index.json", w["root"] / "out_b" / "anno" /
               "anno_index.json"]
    n = sum(len(json.loads(p.read_text())) for p in indices)
    line = _host_command(["merge-anno", f"indices={','.join(map(str, indices))}",
                          f"out={root / 'merged.json'}", f"coco_out={root / 'coco.json'}"])
    log(f"[cli] merge-anno of map (a)'s and (b)'s indices: {line} (want {n})")
    if json.loads(line)["num_annotations"] != n or not (root / "coco.json").is_file():
        fail("merge-anno lost annotations")
    log(f"[cli] the host commands took {time.perf_counter() - t0:.1f} s")


# --- phase multi: the multi-device work over torch.distributed -------------

MULTI_BA = dict(points=2441, cams=160, views=10, noise_pts=0.01, noise_cams=0.002, iters=10)
MULTI_PAIRS = (dict(label="k1024", frames=12, keypoints=1024, pairs=16, kernel="sinkhorn"),
               dict(label="k4096", frames=6, keypoints=4096, pairs=8, kernel="sinkhorn_stream"))
MULTI_RANKS = 2
# Tolerances of a meshed path against the same call without a mesh in (a),
# and of (b)'s two ranks against (a)'s one rank:
MULTI_CONF_ABS = 1e-5  # matcher conf, fp32: the sums over the shards add in another order
MULTI_BA_REL = 1e-5  # BA costs, of the initial cost (the final cost is what a cancellation leaves)
MULTI_BA_ABS = 1e-4  # BA points and cameras
MULTI_MATCH_AGREE = 0.99  # matches0 / matches1 agreement: conf sums part on near ties
# (b)'s ranks run SuperPoint at batch 4 against (a)'s 8, where cuDNN may take
# other algorithms: the dense maps of a rank's frames are held to (a)'s by
# BF16_SCORE_REL and BF16_DESC_ABS (phase main's bounds of bf16 against
# fp32: loose for either dtype here, the measured gaps are printed), fp32
# keypoints also by overlap. Matches are reported, not held: with random
# weights conf is near flat, and descriptors one rounding apart flip
# mutual-max ties.
MULTI_KPT_OVERLAP = 0.99
# Pair-matcher rows in (b): a rank's chunk holds half the pairs, so the
# Sinkhorn kernels' plan (blocks a pair) and their sums' order differ.
MULTI_PAIR_AGREE = 0.995
MULTI_TIMEOUT = 600  # seconds for (b)'s ranks
MULTI_WORKER = [sys.executable, str(ROOT / "chip_smoke.py")]  # + --multi-rank DIR: a rank of (b)


def _multi_ba_problem(np, torch, cfg, seed=0):
    """A BA window at run_mapping's width: points in a 0.2 cube, each seen by
    `views` of `cams` cameras on a ring, exact projections, perturbed
    starts; camera 0 fixed (the gauge), the others refined."""
    from onepose_tpu_torch.geometry.rotations import rotmat_to_angle_axis

    rng = np.random.default_rng(seed)
    P, W, V = cfg["points"], cfg["cams"], cfg["views"]
    pts = (rng.random((P, 3)) - 0.5) * 0.2
    f, c = 500.0, 256.0
    Rs, cams = [], []
    for i in range(W):
        ang = 2 * np.pi * i / W
        center = np.array([np.cos(ang), np.sin(ang), 0.5]) * 1.2
        pose = _look_at(np, center)
        Rs.append(pose[:3, :3])
        aa = rotmat_to_angle_axis(torch.from_numpy(pose[:3, :3].astype(np.float32))).numpy()
        cams.append(np.concatenate([aa, pose[:3, 3]]))
    Rs, cams = np.stack(Rs), np.stack(cams)
    pt_idx = np.repeat(np.arange(P), V)
    cam_idx = np.concatenate([rng.choice(W, V, replace=False) for _ in range(P)])
    pc = np.einsum("mij,mj->mi", Rs[cam_idx], pts[pt_idx]) + cams[cam_idx, 3:]
    feats = np.stack([f * pc[:, 0] / pc[:, 2] + c, f * pc[:, 1] / pc[:, 2] + c,
                      np.full(len(pc), f), np.full(len(pc), c), np.full(len(pc), c)], 1)
    fix = np.zeros(W, np.float32)
    fix[0] = 1.0
    cams0 = cams + rng.normal(size=cams.shape) * cfg["noise_cams"]
    cams0[0] = cams[0]
    return {"pts0": (pts + rng.normal(size=pts.shape) * cfg["noise_pts"]).astype(np.float32),
            "cams0": cams0.astype(np.float32), "features": feats.astype(np.float32),
            "pt_idx": pt_idx.astype(np.int32), "cam_idx": cam_idx.astype(np.int32), "fix": fix}


def _multi_inputs(torch, np) -> dict:
    """The main path's inputs at MAIN's width, a matcher batch against the
    annotation, a BA window and pair-matcher features, on the host."""
    g = torch.Generator(device=DEV).manual_seed(11)
    B, S, KP, HYP = MAIN["batch"], MAIN["size"], MAIN["keypoints"], MAIN["hypotheses"]
    anno = _annotation(torch, g, MAIN["points"], MAIN["leaves"], 256, DEV)
    d2 = torch.randn((B, KP, 256), generator=g, device=DEV)
    d2[:, :KP // 2] = anno.desc3d[None, :KP // 2] + 0.3 * d2[:, :KP // 2]  # planted matches
    d2 = d2 / torch.linalg.vector_norm(d2, dim=-1, keepdim=True)
    return {
        "imgs": _images(torch, g, B, S, DEV).cpu(),
        "K": torch.tensor([[500.0, 0, S / 2], [0, 500.0, S / 2], [0, 0, 1]]).repeat(B, 1, 1),
        "draws": torch.rand((B, HYP, 3), generator=g, device=DEV).cpu(),
        "anno": {k: getattr(anno, k).cpu() for k in ("points3d", "desc3d", "leaf_desc",
                                                       "mask3d", "leaf_mask")},
        "d2": d2.cpu(), "m2": (torch.rand((B, KP), generator=g, device=DEV) < 0.95).cpu(),
        "ba": _multi_ba_problem(np, torch, MULTI_BA),
        "pairs": {cfg["label"]: _pair_feats(np, cfg, seed=21 + i)
                  for i, cfg in enumerate(MULTI_PAIRS)},
    }


class _MultiWork:
    """Every meshed path of the multi-device work at the main path's width,
    over meshes of all the ranks: PosePipeline.sharded (bf16 and fp32,
    kernels on) over an n x 1 data mesh; the points-sharded and the
    tensor-parallel matcher (fp32, K2) over 1 x n; distributed BA over 1 x
    n at run_mapping's width; SuperGlue pair matching (K6 at 1024
    keypoints, K7 at 4096) over the data mesh; with `stages`, the
    StagePipeline of each serving pipeline (one process). `paths()` gives
    (name, meshed call, the same call without a mesh)."""

    def __init__(self, torch, np, inp, n, stages):
        from onepose_tpu_torch.models.gats_spg import GATsSPG
        from onepose_tpu_torch.parallel.mesh import make_mesh
        from onepose_tpu_torch.parallel.tensor_parallel import make_tp_mesh, shard_params
        from onepose_tpu_torch.runtime.pipeline import ObjectAnnotation

        self.torch, self.np, self.inp, self.n, self.stages = torch, np, inp, n, stages
        dev = self.dev = torch.device(DEV)
        self.data_mesh = make_mesh(n_data=n, n_points=1, device=DEV)
        self.pts_mesh = make_mesh(n_data=1, n_points=n, device=DEV)
        self.anno = ObjectAnnotation(**{k: v.to(dev) for k, v in inp["anno"].items()})
        self.imgs, self.K, self.draws = (inp[k].to(dev) for k in ("imgs", "K", "draws"))
        self.pipes = dict(zip(("bf16", "fp32"), _pipelines(
            torch, MAIN["blocks"], [(torch.bfloat16, True, DEV), (torch.float32, True, DEV)],
            max_keypoints=MAIN["keypoints"], ransac_hypotheses=MAIN["hypotheses"])))
        B, a = MAIN["batch"], self.anno
        self.margs = (inp["d2"].to(dev), a.desc3d[None].expand(B, -1, -1).contiguous(),
                      a.leaf_desc[None].expand(B, -1, -1, -1).contiguous(), inp["m2"].to(dev),
                      a.mask3d[None].expand(B, -1).contiguous(),
                      a.leaf_mask[None].expand(B, -1, -1).contiguous())
        m_sd = self.pipes["fp32"].matcher.state_dict()
        models = {}
        for name, mesh in (("dense", None), ("points", self.pts_mesh)):
            m = GATsSPG(num_blocks=MAIN["blocks"], gats_kernel=True,
                        match_threshold=MATCH_THRESHOLD, mesh=mesh)
            m.load_state_dict(m_sd)
            models[name] = m.to(dev).eval()
        models["tp"] = shard_params(models["dense"], make_tp_mesh(n, device=DEV))
        self.models = models
        self.chunks = {}  # pair matcher label -> its chunk (all ranks' pairs)

    def _matcher(self, name):
        with self.torch.inference_mode():
            return self.models[name](*self.margs)

    def _serve(self, label):
        p = self.pipes[label]
        return p(self.imgs, self.K, self.anno, draws=self.draws)

    def _stages(self, label, stages):
        micro, d, K = [self.imgs[:4], self.imgs[4:]], [self.draws[:4], self.draws[4:]], self.K[:4]
        if stages is None:
            return [self.pipes[label](m, K, self.anno, draws=x) for m, x in zip(micro, d)]
        return stages.run(micro, [K, K], draws=d)

    def _ba(self, meshed):
        from onepose_tpu_torch.ops.lm import ba_solve
        from onepose_tpu_torch.parallel.distributed_ba import (
            distributed_ba_solve,
            partition_obs_by_point,
        )

        np, torch, dev, ba = self.np, self.torch, self.dev, self.inp["ba"]
        t = {k: torch.from_numpy(v).to(dev) for k, v in ba.items()}
        if not meshed:
            return ba_solve(t["pts0"], t["cams0"], t["features"], t["pt_idx"], t["cam_idx"],
                            torch.ones(len(ba["pt_idx"]), dtype=torch.bool, device=dev),
                            fix_cam_mask=t["fix"], n_iters=MULTI_BA["iters"])
        P = ba["pts0"].shape[0]
        P_pad = -(-P // self.n) * self.n  # padded to the shard count, as run_mapping pads
        parts = partition_obs_by_point(P_pad, self.n, ba["features"], ba["pt_idx"],
                                       ba["cam_idx"], np.ones(len(ba["pt_idx"]), bool))
        out = distributed_ba_solve(
            self.pts_mesh, torch.from_numpy(np.pad(ba["pts0"], ((0, P_pad - P), (0, 0)))).to(dev),
            t["cams0"], *(torch.from_numpy(a).to(dev) for a in parts), fix_cam_mask=t["fix"],
            n_iters=MULTI_BA["iters"])
        return dict(out, points=out["points"][:P])

    def _pair_matcher(self, cfg, mesh):
        from onepose_tpu_torch.models.superglue import SuperGlue
        from onepose_tpu_torch.parallel.sfm_parallel import make_superglue_pair_matcher

        self.torch.manual_seed(5)
        sg = SuperGlue(match_threshold=MATCH_THRESHOLD)
        f = cfg["frames"] - 1
        pairs = self.np.stack([self.np.arange(cfg["pairs"]) % f,
                               self.np.arange(cfg["pairs"]) % f + 1], 1)
        match = make_superglue_pair_matcher(sg, self.inp["pairs"][cfg["label"]], mesh=mesh,
                                            pair_chunk=16, device=DEV)
        if mesh is not None:
            self.chunks[cfg["label"]] = match.chunk
        return lambda: match(pairs)

    def paths(self):
        from onepose_tpu_torch.parallel.stage_pipeline import StagePipeline

        out = []
        for label in ("bf16", "fp32"):
            run = self.pipes[label].sharded(self.data_mesh)
            out.append((f"sharded_{label}",
                        lambda run=run: run(self.imgs, self.K, self.anno, draws=self.draws),
                        lambda label=label: self._serve(label)))
        for name in ("points", "tp"):
            out.append((f"{name}_matcher", lambda name=name: self._matcher(name),
                        lambda: self._matcher("dense")))
        out.append(("distributed_ba", lambda: self._ba(True), lambda: self._ba(False)))
        for cfg in MULTI_PAIRS:
            out.append((f"pairs_{cfg['label']}", self._pair_matcher(cfg, self.data_mesh),
                        self._pair_matcher(cfg, None)))
        if self.stages:
            for label in ("bf16", "fp32"):
                st = StagePipeline(self.pipes[label], self.anno)
                out.append((f"stage_pipeline_{label}",
                            lambda st=st, label=label: self._stages(label, st),
                            lambda label=label: self._stages(label, None)))
        return out

    def want(self, path, counts) -> dict:
        """The launches a path must make (on each rank), the rest 0."""
        nb = MAIN["blocks"]
        want = dict.fromkeys(counts, 0)
        n_calls = 2 if path.startswith("stage_") else 1
        if path.endswith("bf16"):
            want.update(nms=n_calls, vgg_stage=4 * n_calls, gats_block=nb * n_calls,
                        dual_softmax=n_calls)
        elif path.endswith("fp32"):
            want.update(nms=n_calls, gats=nb * n_calls, dual_softmax=n_calls)
        elif path.endswith("_matcher"):
            want.update(gats=nb)
        elif path.startswith("pairs_"):
            cfg = next(c for c in MULTI_PAIRS if path == f"pairs_{c['label']}")
            want[cfg["kernel"]] = -(-cfg["pairs"] // self.chunks[cfg["label"]])  # one a chunk
        return want


def _multi_run(torch, work, path, call, rows, tag) -> tuple:
    """One meshed path: a warm-up, the launches of one call (0 just before
    it, read just after; the path's want, else a failure), and the median
    host ms of 3 synchronized calls. Returns (output, launches, ms)."""
    from onepose_tpu_torch.ops.kernels import launch_counts, reset_launches

    call()
    torch.cuda.synchronize()
    reset_launches()
    out = call()
    torch.cuda.synchronize()
    counts = launch_counts()
    if counts != work.want(path, counts):
        fail(f"multi {tag} {path} launched {counts}, want {work.want(path, counts)}")
    times = []
    for _ in range(3):
        t0 = time.perf_counter()
        call()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    launched = {k: v for k, v in counts.items() if v}
    for key, n in launched.items():
        if key in rows:
            rows[key].setdefault("extra", {})[f"multi_{tag}_{path}_launches"] = n
    return out, launched, statistics.median(times)


def _multi_check(torch, np, path, got, ref, raw=None) -> str:
    """`got` against `ref` at the stated tolerances (fails otherwise);
    returns what was compared. raw: for (b)'s serving, (this rank's dense
    maps, (a)'s maps of the same frames)."""
    if path.startswith("stage_"):
        for g, w in zip(got, ref):
            for k in ("pose", "num_inliers", "pnp_ok", "matches0"):
                if not torch.equal(g[k], w[k]):
                    fail(f"multi {path}: {k} differs from PosePipeline.__call__'s")
        return "2 micro-batches of 4: pose, num_inliers, pnp_ok, matches0 equal __call__'s"
    if path.startswith("sharded_"):
        ok = ref["pnp_ok"] & got["pnp_ok"]
        pose = float((got["pose"] - ref["pose"]).abs()[ok].max()) if bool(ok.any()) else 0.0
        agree = float((got["matches0"] == ref["matches0"]).float().mean())
        overlap = _keypoint_overlap(got, ref)
        if not (bool((got["num_matches"] > 0).all()) and bool(torch.isfinite(got["pose"]).all())):
            fail(f"multi {path}: a frame without a match or a pose that is not finite")
        line = (f"keypoint overlap {overlap:.4f}, matches0 agreement {agree:.4f}, pose max abs "
                f"diff {pose:.3e} where both solved")
        if path == "sharded_fp32" and overlap < MULTI_KPT_OVERLAP:
            fail(f"multi {path}: {line} (overlap >= {MULTI_KPT_OVERLAP})")
        if raw is not None:
            mine, theirs = raw
            s_rel = float(((mine["score_map"] - theirs["score_map"]).abs()
                           / theirs["score_map"].abs().clamp(min=1e-12)).max())
            d_abs = float((mine["descriptor_map"] - theirs["descriptor_map"]).abs().max())
            line += f"; this rank's dense maps: score max rel {s_rel:.3e}, desc max abs {d_abs:.3e}"
            if s_rel > BF16_SCORE_REL or d_abs > BF16_DESC_ABS:
                fail(f"multi {path}: {line} (<= {BF16_SCORE_REL}, {BF16_DESC_ABS})")
        return line
    if path.endswith("_matcher"):
        err = float((got["conf_matrix"] - ref["conf_matrix"]).abs().max())
        a0 = float((got["matches0"] == ref["matches0"]).float().mean())
        a1 = float((got["matches1"] == ref["matches1"]).float().mean())
        line = (f"conf max abs diff {err:.3e} (<= {MULTI_CONF_ABS}), matches0 / matches1 "
                f"agreement {a0:.4f} / {a1:.4f}, {int((got['matches0'] >= 0).sum())} matches")
        if err > MULTI_CONF_ABS or min(a0, a1) < MULTI_MATCH_AGREE:
            fail(f"multi {path}: {line}")
        return line
    if path == "distributed_ba":
        scale = float(ref["cost_initial"])
        cost = max(abs(float(got[k]) - float(ref[k])) for k in ("cost_initial", "cost_final"))
        pts = float((got["points"] - ref["points"]).abs().max())
        cams = float((got["cam_poses"] - ref["cam_poses"]).abs().max())
        line = (f"cost {scale:.4e} -> {float(got['cost_final']):.4e}, costs {cost:.3e} apart "
                f"(<= {MULTI_BA_REL} x the initial), points {pts:.3e}, cameras {cams:.3e} "
                f"(<= {MULTI_BA_ABS})")
        if cost > MULTI_BA_REL * scale or max(pts, cams) > MULTI_BA_ABS:
            fail(f"multi {path}: {line}")
        return line
    agree = float((np.asarray(got) == np.asarray(ref)).all(axis=1).mean())
    line = (f"{agree:.4f} of the match rows equal (>= {MULTI_PAIR_AGREE}), "
            f"{int((np.asarray(got) >= 0).sum())} matches")
    if agree < MULTI_PAIR_AGREE:
        fail(f"multi {path}: {line}")
    return line


def _host(tree):
    """A path's output with its tensors on the host."""
    import torch

    if isinstance(tree, dict):
        return {k: _host(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_host(v) for v in tree]
    return tree.cpu() if isinstance(tree, torch.Tensor) else tree


def _free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _multi_a(torch, np, rows, work_dir: Path) -> dict:
    """(a): a one-rank NCCL group on cuda:0, every meshed path against the
    same call without a mesh; writes the inputs and (a)'s outputs for (b)."""
    import torch.distributed as dist

    from onepose_tpu_torch.utils import comm

    inp = _multi_inputs(torch, np)
    torch.save(inp, work_dir / "inputs.pt")
    if DEV == "cuda":
        dist.init_process_group("nccl", init_method=f"tcp://localhost:{_free_port()}", rank=0,
                                world_size=1, timeout=comm.TIMEOUT,
                                device_id=torch.device("cuda", 0))
    else:  # a CPU rehearsal (DEV = "cpu")
        dist.init_process_group("gloo", init_method=f"tcp://localhost:{_free_port()}", rank=0,
                                world_size=1, timeout=comm.TIMEOUT)
    refs = {}
    try:
        log(f"[multi] (a) one rank, backend {dist.get_backend()}, world {dist.get_world_size()}, "
            f"at batch {MAIN['batch']}, {MAIN['size']}^2, {MAIN['keypoints']} keypoints, "
            f"{MAIN['points']} x {MAIN['leaves']} points, {MAIN['hypotheses']} hypotheses; BA "
            f"{MULTI_BA['points']} points x {MULTI_BA['cams']} cameras x {MULTI_BA['views']} views")
        work = _MultiWork(torch, np, inp, 1, stages=True)
        for path, call, plain in work.paths():
            got, launched, ms = _multi_run(torch, work, path, call, rows, "a")
            line = _multi_check(torch, np, path, got, plain())
            log(f"[multi] (a) {path}: launches {launched}, {ms:.2f} ms a call (median of 3); "
                f"against no mesh: {line}")
            refs[path] = _host(got)
        for label, pipe in work.pipes.items():
            refs[f"raw_{label}"] = _host({k: v.float() for k, v in _raw_maps(
                torch, pipe, work.imgs).items() if k in ("score_map", "descriptor_map")})
    finally:
        dist.destroy_process_group()
    torch.save(refs, work_dir / "refs.pt")
    return refs


def _multi_rank_main(torch, np, work_dir: Path, backend: str) -> int:
    """One rank of (b) (chip_smoke.py --multi-rank DIR --multi-backend B,
    started by phase multi with RANK / WORLD_SIZE / LOCAL_RANK / MASTER_* in
    its environment): each path over all the ranks against (a)'s outputs;
    writes rank<r>.json."""
    from onepose_tpu_torch.utils import comm

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    comm.init_distributed(device=DEV, backend=backend)
    rank, n = comm.get_rank(), comm.get_world_size()
    inp = torch.load(work_dir / "inputs.pt", weights_only=False)
    refs = torch.load(work_dir / "refs.pt", weights_only=False)
    work = _MultiWork(torch, np, inp, n, stages=False)
    rows, report = {}, {}
    B = MAIN["batch"]
    mine = slice(rank * B // n, (rank + 1) * B // n)
    for path, call, _ in work.paths():
        got, launched, ms = _multi_run(torch, work, path, call, rows, "b")
        raw = None
        if path.startswith("sharded_"):
            label = path.split("_")[1]
            maps = _raw_maps(torch, work.pipes[label], work.imgs[mine])
            raw = ({k: maps[k].float().cpu() for k in ("score_map", "descriptor_map")},
                   {k: v[mine] for k, v in refs[f"raw_{label}"].items()})
        line = _multi_check(torch, np, path, _host(got), refs[path], raw)
        report[path] = {"launches": launched, "ms": ms, "check": line}
    (work_dir / f"rank{rank}.json").write_text(json.dumps(report))
    comm.synchronize()
    torch.distributed.destroy_process_group()
    return 0


def _run_ranks(cmd: list, n: int, cards: int, work_dir: Path, tag: str, timeout: float) -> None:
    """`cmd` as n ranks of one world (RANK, WORLD_SIZE, LOCAL_RANK: r with
    `cards`, else 0 for ranks sharing the card; MASTER_*), each writing
    work_dir/<tag><r>.log; fails past `timeout` seconds (every rank
    killed) or when a rank exits non-zero."""
    import os

    port = _free_port()
    procs = []
    for r in range(n):
        env = dict(os.environ, RANK=str(r), WORLD_SIZE=str(n), LOCAL_RANK=str(r if cards else 0),
                   MASTER_ADDR="localhost", MASTER_PORT=str(port))
        out = open(work_dir / f"{tag}{r}.log", "w")
        procs.append((subprocess.Popen(cmd, env=env, stdout=out, stderr=subprocess.STDOUT,
                                       cwd=ROOT), out))
    deadline = time.perf_counter() + timeout
    try:
        for p, _ in procs:
            p.wait(timeout=max(1.0, deadline - time.perf_counter()))
    except subprocess.TimeoutExpired:
        fail(f"{' '.join(cmd[1:3])}: the ranks passed {timeout} s")
    finally:
        for p, out in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
            out.close()
    for r, (p, _) in enumerate(procs):
        if p.returncode != 0:
            text = (work_dir / f"{tag}{r}.log").read_text()
            fail(f"{' '.join(cmd[1:3])} rank {r} exited {p.returncode}:\n{text[-3000:]}")


def _multi_b(torch, rows, work_dir: Path, cards: int) -> None:
    """(b): MULTI_RANKS processes on the one card (NCCL refuses two ranks on
    one device), joined by gloo over CUDA tensors; or, with `cards`, one
    NCCL rank on each of that many cards. Each rank runs every meshed path
    on its share and is held to (a)'s outputs. The times of ranks sharing
    one card show that the paths run, not how they scale."""
    n = cards or MULTI_RANKS
    backend = "nccl" if cards else "gloo"
    if cards > torch.cuda.device_count():
        fail(f"multi (b): {cards} cards asked for, {torch.cuda.device_count()} present")
    _run_ranks([*MULTI_WORKER, "--multi-rank", str(work_dir), "--multi-backend", backend], n,
               cards, work_dir, "rank", MULTI_TIMEOUT)
    B, P = MAIN["batch"], MAIN["points"]
    where = (f"{n} ranks on {n} cards, NCCL" if cards else
             f"{n} ranks on one card, gloo over CUDA tensors (send and recv of CUDA tensors are "
             "not among gloo's: the ring attention's shift is an all-gather)")
    log(f"[multi] (b) {where}; each rank serves {B // n} of {B} frames and holds {P // n} of "
        f"{P} points" + ("" if cards else "; times of ranks sharing one card (no scaling claim)"))
    for r in range(n):
        report = json.loads((work_dir / f"rank{r}.json").read_text())
        for path, res in report.items():
            log(f"[multi] (b) rank {r} {path}: launches {res['launches']}, {res['ms']:.2f} ms a "
                f"call (median of 3); against (a): {res['check']}")
            for key, n in res["launches"].items():
                if key in rows:
                    rows[key].setdefault("extra", {})[f"multi_b_rank{r}_{path}_launches"] = n
        for key in ("nms", "gats", "vgg_stage", "sinkhorn"):
            if not any(res["launches"].get(key) for res in report.values()):
                fail(f"multi (b) rank {r} launched no {key}")


AUDIT_TIMEOUT = 300  # seconds for A17's ranks


def _multi_audit(work_dir: Path, cards: int) -> None:
    """A17 in (b)'s setting: `python -m onepose_tpu_torch.scripts.
    audit_collectives` on MULTI_RANKS ranks sharing the card over gloo (or
    one NCCL rank a card with `cards`); rank 0's last line must show the
    per-block volume equal at every N3 and each kind at its closed form."""
    from onepose_tpu_torch.scripts import audit_collectives as ac

    _run_ranks([sys.executable, "-m", "onepose_tpu_torch.scripts.audit_collectives",
                *(() if cards else ("--backend", "gloo"))], cards or MULTI_RANKS, cards,
               work_dir, "audit", AUDIT_TIMEOUT)
    lines = (work_dir / "audit0.log").read_text().strip().splitlines()
    for line in lines[:-1]:
        log(f"[multi] A17 audit: {line}")
    res = json.loads(lines[-1])["audit_collectives"]
    for name, closed in (("serving", lambda n3: ac.serving_closed_form(ac.B, ac.N2, n3)),
                         ("train_step", lambda n3: ac.train_closed_form())):
        runs = res[name]
        blocks = [r["block"] for r in runs.values()]
        if len(runs) != len(ac.N3S) or any(b != blocks[0] for b in blocks):
            fail(f"A17 {name}: the per-block volume differs between N3 {list(runs)}: {blocks}")
        for n3, r in runs.items():
            want = closed(int(n3))
            if r["block"] != want["block"] or r["head"] != want["head"]:
                fail(f"A17 {name} at N3 {n3}: {r}, closed form {want}")
        log(f"[multi] A17 {name}: per block {blocks[0]} at N3 {', '.join(runs)} (the closed "
            f"form's), head " + "; ".join(f"N3 {k}: {v['head']}" for k, v in runs.items()))


def phase_multi(torch, rows, cards: int = 0):
    import tempfile

    import numpy as np

    t0 = time.perf_counter()
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    log("[multi] TF32 off (cudnn and matmul), in (a) and in (b)'s ranks")
    work_dir = Path(tempfile.mkdtemp(prefix="chip_smoke_multi_"))
    try:
        _multi_a(torch, np, rows, work_dir)
        t1 = time.perf_counter()
        _multi_b(torch, rows, work_dir, cards)
        t2 = time.perf_counter()
        _multi_audit(work_dir, cards)
    finally:
        import shutil

        shutil.rmtree(work_dir, ignore_errors=True)
    log(f"[multi] (a) {t1 - t0:.1f} s, (b) {t2 - t1:.1f} s, A17's audit "
        f"{time.perf_counter() - t2:.1f} s")


# Phase bench: each entry point as `python <args>` from the repository's
# root, with the seconds it may take; "{capture}" stands for the A20
# capture's object directory.
BENCH_TRAIN_STEPS = 20
BENCH_RUNS = (
    ("bench", ["-m", "onepose_tpu_torch.bench"], 180),
    ("roofline", ["-m", "onepose_tpu_torch.scripts.roofline_audit", "--sweep"], 240),
    ("train_step", ["-m", "onepose_tpu_torch.scripts.bench_train_step", "8",
                    str(BENCH_TRAIN_STEPS)], 180),
    ("profile_pnp", ["-m", "onepose_tpu_torch.scripts.profile_pnp"], 180),
    ("pair_batching", ["-m", "onepose_tpu_torch.scripts.bench_pair_batching"], 240),
    ("matcher_parts", ["-m", "onepose_tpu_torch.scripts.bench_matcher_parts"], 180),
    ("mixed_attention", ["-m", "onepose_tpu_torch.scripts.bench_mixed_attention"], 180),
    ("sp_layers", ["-m", "onepose_tpu_torch.scripts.profile_sp_layers"], 180),
    ("superpoint_parts", ["-m", "onepose_tpu_torch.scripts.profile_superpoint_parts"], 180),
    ("demo_pipeline", ["-m", "onepose_tpu_torch.scripts.demo_pipeline", "{capture}",
                       "--with-tracking"], 420),
)
PNP_ROWS = ["pnp_fixed", "pnp_varying", "sample", "sample+p3p", "subset_score_sort",
            "full_score", "gn_refine"]
PAIR_N = 64  # bench_pair_batching's pairs
SP_PARTS = {"encoder only (bf16, K5)": {"vgg_stage": 4}, "encoder only (bf16, plain convs)": {},
            "full dense fwd (bf16, K5 + K1)": {"nms": 1, "vgg_stage": 4},
            "full dense fwd (bf16, plain)": {}, "simple_nms r=4 (fp32, K1)": {"nms": 1},
            "simple_nms r=4 (fp32, plain)": {}, "full dense fwd (fp32, K1)": {"nms": 1},
            "full dense fwd (fp32, plain)": {}}
MIXED_LAUNCHES = {"nms": 1, "vgg_stage": 4, "dual_softmax": 1}
# A20: scripts/demo_pipeline.sh's layout, a capture of phase cli's object
# rendered as phase detect renders its queries (full DETECT_HW frames,
# CLI_SCENE's focal length, the two rings) and written as ARKit files:
# `annotate` frames to map, `test` frames (a quarter step round) to demo,
# with tracking (depth cuts from a scan's hundreds of frames); map at
# configs/map.yaml's width with phase cli's weights, demo as phase demo (b).
A20 = dict(annotate=24, test=6)
BENCH_LAUNCHES = {"nms": 1, "vgg_stage": 4, "gats_block": 4, "dual_softmax": 1}
ROOFLINE_STAGES = ("superpoint_dense", "extract_keypoints", "gats_spg_matcher", "ransac_pnp",
                   "fused_pipeline")
ROOFLINE_SWEEP = [8, 16, 32, 64]


def _entry_point(args, timeout: int, env=None) -> tuple:
    """Run `python args` from the repository's root (with `env`): (stdout
    lines, the last line as JSON, seconds); fails on a non-zero exit."""
    t0 = time.perf_counter()
    res = subprocess.run([sys.executable, *args], cwd=ROOT, capture_output=True, text=True,
                         timeout=timeout, env=env)
    sec = time.perf_counter() - t0
    lines = res.stdout.strip().splitlines()
    if res.returncode != 0 or not lines:
        fail(f"{' '.join(args)} exited {res.returncode}:\n{res.stdout[-3000:]}\n"
             f"{res.stderr[-3000:]}")
    return lines, json.loads(lines[-1]), sec


def _arkit_capture(np, torch, root: Path, frames: int, offset: float) -> None:
    """An ARKit capture of phase cli's object under root (Frames.m4v,
    ARposes.txt, Box.txt, intrinsics.txt: the files parse-scan reads):
    `frames` full DETECT_HW frames rendered as `_query_scene` renders them,
    from cameras on the two rings `offset` of a step round; the object
    frame is the world frame (Box.txt's pose is the identity) and each
    camera's world->camera pose P is written as ARKit's camera->world
    pose, inv(P) with its y and z axes flipped."""
    import cv2

    from onepose_tpu_torch.geometry.rotations import rotmat_to_qvec

    obj, rng = _cli_object(np, CLI_SCENE, seed=0)
    h, w = DETECT_HW
    f_len = CLI_SCENE["focal"]
    K = np.array([[f_len, 0, w / 2], [0, f_len, h / 2], [0, 0, 1]])
    root.mkdir(parents=True)
    e = CLI_SCENE["cube"] * 1.2  # the box: the cube and a margin
    (root / "Box.txt").write_text(f"px,py,pz,ex,ey,ez,qw,qx,qy,qz\n0,0,0,{e},{e},{e},1,0,0,0\n")
    writer = cv2.VideoWriter(str(root / "Frames.m4v"), cv2.VideoWriter_fourcc(*"mp4v"), 10,
                             (w, h))
    if not writer.isOpened():
        fail("cv2 cannot write an .m4v here")
    poses, intrinsics = [], []
    for f in range(frames):
        pose, ang = _ring_pose(np, f, max(frames // 2, 1), offset=offset)
        T_cw = np.linalg.inv(pose)
        R = T_cw[:3, :3] @ np.diag([1.0, -1.0, -1.0])
        q = rotmat_to_qvec(torch.from_numpy(R)).numpy()
        poses.append(",".join(map(str, [0.1 * f, *T_cw[:3, 3], *q])))
        intrinsics.append(f"{f},{0.1 * f},{f_len},{f_len},{w / 2},{h / 2}")
        gray = _cli_frame(np, obj, rng, CLI_SCENE, pose, ang, K, (h, w))
        writer.write(np.repeat(gray[..., None], 3, axis=-1))
    writer.release()
    (root / "ARposes.txt").write_text("\n".join(poses) + "\n")
    (root / "intrinsics.txt").write_text("\n".join(intrinsics) + "\n")


def _a20_world(np, torch) -> tuple:
    """(the object directory, the environment with MAP_ARGS and DEMO_ARGS)
    of A20's run: <obj>-annotate and <obj>-test captures and phase cli's
    weights."""
    import os

    w = _world(np)
    obj = w["root"] / "a20" / "cup"
    t0 = time.perf_counter()
    _arkit_capture(np, torch, obj / "cup-annotate", A20["annotate"], 0.0)
    _arkit_capture(np, torch, obj / "cup-test", A20["test"], 0.25)
    log(f"[bench] A20 capture: {A20['annotate']} + {A20['test']} frames of {DETECT_HW[1]}x"
        f"{DETECT_HW[0]} as ARKit files in {time.perf_counter() - t0:.1f} s")
    env = dict(os.environ,
               MAP_ARGS=" ".join([f"weights.superpoint={w['sp_ckpt']}", "matcher=nn",
                                  _cache_arg(), "anno_format=npz", *_cli_args()]),
               DEMO_ARGS=" ".join([f"weights.superpoint={w['sp_ckpt']}",
                                   f"weights.matcher={w['gats_ckpt']}",
                                   *(f"{k}={v}" for k, v in DEMO.items()),
                                   *DEMO_RUNS[1][1]]))
    return obj, env


def _bench_checks(label: str, last: dict, smi: str) -> None:
    """The last line and the launch counts of the A16 to A20 entry points."""
    import numpy as np

    if label == "profile_pnp":
        out = last["profile_pnp"]
        by = {r["stage"]: r for r in out["rows"]}
        if list(by) != PNP_ROWS or out["launches"] != {}:
            fail(f"profile_pnp's rows {list(by)}, launches {out['launches']}")
        for r in out["rows"]:
            log(f"[bench] {smi}: profile_pnp {r['stage']}: {r['ms']:.3f} ms, {r['kernels']} CUDA "
                f"kernels ({r['device_ms']} device ms), {r['syncs']} host syncs "
                f"{r['sync_lines']}")
            if not (r["ms"] > 0 and r["kernels"]):
                fail(f"profile_pnp's {r['stage']} row: {r}")
        if by["gn_refine"]["syncs"]:
            fail(f"the Gauss-Newton refine syncs the host: {by['gn_refine']['sync_lines']}")
        log(f"[bench] {smi}: profile_pnp stage sum {out['stage_sum_ms']:.3f} ms against the "
            f"whole call {out['whole_ms']:.3f} ms")
    elif label == "pair_batching":
        for r in last["pair_batching"]["rows"]:
            serial = "serial" in r["label"]
            chunk = None if serial else int(r["label"].rsplit("=", 1)[1])
            want = ({} if r["label"].startswith("NN") else
                    {"sinkhorn": PAIR_N if serial else -(-PAIR_N // chunk)})
            if r["launches"] != want or (not serial and r["equal_to_serial"] is not True):
                fail(f"pair_batching {r['label']}: launches {r['launches']} (want {want}), "
                     f"equal to serial {r['equal_to_serial']}")
            log(f"[bench] {smi}: pair_batching {r['label']}: {r['ms_per_pair']:.2f} ms a pair, "
                f"{r['pairs_per_s']:.1f} pairs/s, {r['matches']} matches, launches "
                f"{r['launches']}")
    elif label == "matcher_parts":
        for r in last["matcher_parts"]["rows"]:
            want = {} if r["config"] == "fp32" else {
                k: v for k, v in (("gats_block", r["blocks"]), ("dual_softmax", 1)) if v}
            if r["launches"] != want or not r["ms"] > 0:
                fail(f"matcher_parts {r}: want launches {want}")
            log(f"[bench] {smi}: matcher_parts {r['config']} blocks {r['blocks']}: "
                f"{r['ms']:.3f} ms, launches {r['launches']}")
    elif label == "mixed_attention":
        out = last["mixed_attention"]
        if any(r["launches"] != MIXED_LAUNCHES for r in out["rows"]) or not (
                0 <= out["match_agreement"] <= 1 and np.isfinite(out["max_pose_delta"])):
            fail(f"mixed_attention: {out}")
        log(f"[bench] {smi}: mixed_attention frames/s "
            + ", ".join(f"mixed={r['mixed']} {r['frames_per_s']:.1f}" for r in out["rows"])
            + f"; speedup {out['speedup']:.3f}, match agreement {out['match_agreement']:.5f}, "
            f"max pose delta {out['max_pose_delta']:.3e}, the rule would flip: {out['flip']}")
    elif label == "sp_layers":
        out = last["sp_layers"]
        stacks = collections.Counter(r["stack"] for r in out["rows"])
        if stacks != {"layers": 13, "stages": 6} or set(out["launches"]) != {"nms", "vgg_stage"} \
                or not all(r["prefix_ms"] > 0 for r in out["rows"]):
            fail(f"sp_layers: rows {stacks}, launches {out['launches']}")
        for r in out["rows"]:
            log(f"[bench] {smi}: sp_layers {r['stack']} {r['layer']}: prefix "
                f"{r['prefix_ms']:.3f} ms, marginal {r['marginal_ms']:.3f} ms, "
                f"{r['gflop']:.1f} GFLOP")
    elif label == "superpoint_parts":
        rows = last["superpoint_parts"]["rows"]
        got = {r["part"]: r["launches"] for r in rows}
        if got != SP_PARTS or not all(r["ms"] > 0 for r in rows):
            fail(f"superpoint_parts launched {got}, want {SP_PARTS}")
        for r in rows:
            log(f"[bench] {smi}: superpoint_parts {r['part']}: {r['ms']:.3f} ms, launches "
                f"{r['launches']}")
    elif label == "demo_pipeline":
        out = last["demo_pipeline"]
        cmds = out["commands"]
        if [c["argv"][0] for c in cmds] != ["parse-scan", "parse-scan", "map", "demo"] or \
                any(c["rc"] for c in cmds) or not (out["video"] and Path(out["video"]).is_file()):
            fail(f"demo_pipeline: {out}")
        parsed = cmds[1]["summary"]["num_frames"]
        s = cmds[3]["summary"]
        want = {k: 0 for k in cmds[3]["launches"]}
        want.update(nms=-(-parsed // 8) + s["n_detect"] + s["n_matcher"] + s["n_flow_track"],
                    gats=4 * s["n_matcher"], dual_softmax=s["n_matcher"])
        map_want = {**dict.fromkeys(want, 0), "nms": -(-cmds[0]["summary"]["num_frames"] // 8)}
        if any(any(c["launches"].values()) for c in cmds[:2]) or \
                cmds[2]["launches"] != map_want or cmds[3]["launches"] != want or \
                not s["n_flow_track"]:
            fail(f"demo_pipeline's launches: {[c['launches'] for c in cmds]}, want map "
                 f"{map_want}, demo {want}")
        for c in cmds:
            log(f"[bench] {smi}: demo_pipeline {' '.join(c['argv'][:2])}: {c['seconds']:.1f} s, "
                f"summary {c['summary']}, launches {({k: v for k, v in c['launches'].items() if v})}")


def phase_bench(smi: str):
    """The measurement entry points on the card, each in its own process."""
    import numpy as np
    import torch

    from onepose_tpu_torch.ops.kernels import launch_counts

    out = {}
    for label, args, timeout in BENCH_RUNS:
        env = None
        if "{capture}" in args:
            obj, env = _a20_world(np, torch)
            args = [str(obj) if a == "{capture}" else a for a in args]
        lines, last, sec = _entry_point(args, timeout, env)
        for line in lines[:-1]:
            log(f"[bench] {label}: {line}")
        log(f"[bench] {label}: {sec:.1f} s; last line {json.dumps(last)[:2000]}")
        out[label] = (lines, last)
        _bench_checks(label, last, smi)

    lines, last = out["bench"]
    if set(last) != {"metric", "value", "unit", "vs_baseline"} or \
            last["metric"] != "pose_pipeline_frames_per_s" or last["unit"] != "frames/s":
        fail(f"the bench's last line is not bench.py's: {last}")
    if not (math.isfinite(last["value"]) and last["value"] > 0):
        fail(f"the bench's frames/s is {last['value']}")
    prefix = "[bench] launches in one call: "
    counts = json.loads(next(x for x in lines if x.startswith(prefix))[len(prefix):])
    want = {**dict.fromkeys(launch_counts(), 0), **BENCH_LAUNCHES}
    if counts != want:
        fail(f"the bench's call launched {counts}, want {want}")
    log(f"[bench] {smi}: pose_pipeline_frames_per_s {last['value']} (median of the windows, host "
        f"clock), launches of one call {counts}")

    roof = out["roofline"][1]["roofline"]
    if [r["stage"] for r in roof["rows"]] != list(ROOFLINE_STAGES):
        fail(f"the roofline's rows are {[r['stage'] for r in roof['rows']]}")
    for r in roof["rows"]:
        share = r["bound_ms"] / r["ms"]
        log(f"[bench] {smi}: roofline {r['stage']}: {r['ms']:.3f} ms, bound {r['bound_ms']:.4f} "
            f"ms ({r['bound_by']}), share of the bound {share:.4f}, MFU {100 * r['mfu']:.2f}%")
        if not share <= 1.0:
            fail(f"the roofline's {r['stage']} ran faster than its bound (share {share})")
    if [w["batch"] for w in roof["sweep"]] != ROOFLINE_SWEEP:
        fail(f"the roofline's sweep covered {roof['sweep']}")
    log(f"[bench] {smi}: stage sum {roof['stage_sum_ms']:.3f} ms (bound "
        f"{roof['stage_sum_bound_ms']:.4f}), whole call MFU {100 * roof['mfu']:.3f}%; sweep "
        + ", ".join(f"batch {w['batch']} {w['frames_per_s']:.1f} frames/s" for w in roof["sweep"]))

    train = out["train_step"][1]["train_step"]
    if len(train["losses"]) != BENCH_TRAIN_STEPS or not all(math.isfinite(x) for x in train["losses"]):
        fail(f"the train step's losses are {train['losses']}")
    log(f"[bench] {smi}: train step {train['dtype']} batch {train['batch']}: "
        f"{train['ms_per_step']:.2f} ms a step, losses finite")


# Phase sp_variants: the three front-end benchmarks at the scripts' shapes,
# each with the kernels its forms must launch and its calls a window (the
# modules' own ITERS); should the whole run near its time limit, cut these
# counts first.
SP_VARIANT_SHAPE = dict(b=8, img=512)
SP_VARIANTS = {"bench_sp_front": ({"nms", "vgg_stage"}, 50), "bench_sp_score": ({"nms"}, 50),
               "bench_sp_variants": ({"nms", "vgg_stage"}, 20)}
SP_VARIANT_WINDOWS = 5


def phase_sp_variants(smi: str):
    """The front-end forms of SuperPoint, each module's run in this process."""
    import importlib

    from onepose_tpu_torch.ops.kernels import launch_counts, reset_launches
    from onepose_tpu_torch.scripts._forms import row_line

    for name, (kernels, iters) in SP_VARIANTS.items():
        module = importlib.import_module(f"onepose_tpu_torch.scripts.{name}")
        t0 = time.perf_counter()
        reset_launches()  # this path's counts: 0 just before it, read just after
        out = module.run(DEV, **SP_VARIANT_SHAPE, iters=iters, windows=SP_VARIANT_WINDOWS)
        counts = {k: n for k, n in launch_counts().items() if n}
        for row in out["rows"]:
            log(f"[sp_variants] {smi}: {name} {row_line(row)}")
        bad = [r["form"] for r in out["rows"] if not r["ok"]]
        if bad:
            fail(f"{name}: forms out of tolerance or without their kernels: {bad}")
        if set(counts) != kernels:
            fail(f"{name} launched {counts}, want each of {sorted(kernels)}")
        log(f"[sp_variants] {name}: {time.perf_counter() - t0:.1f} s, launches over the run "
            f"{counts}" + (f"; fastest {out['fastest']}" if "fastest" in out else ""))


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--phases", default=",".join(PHASES),
                        help="comma-separated subset of " + ",".join(PHASES))
    parser.add_argument("--multi-cards", type=int, default=0,
                        help="phase multi (b) over this many cards, one NCCL rank a card "
                             "(default: two gloo ranks sharing the first card)")
    parser.add_argument("--multi-rank", default=None, help=argparse.SUPPRESS)
    parser.add_argument("--multi-backend", default="gloo", help=argparse.SUPPRESS)
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
    if args.multi_rank is not None:  # one rank of phase multi (b), started by the phase
        import numpy as np

        return _multi_rank_main(torch, np, Path(args.multi_rank), args.multi_backend)
    log(f"[env] python {sys.version.split()[0]}, torch {torch.__version__}, CUDA "
        f"{torch.version.cuda}, {torch.cuda.device_count()} device(s): "
        f"{torch.cuda.get_device_name(0)}")

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    log("[env] TF32 off (cudnn and matmul) for the parity phases")
    smi = phase_build()  # every other phase needs the kernels
    rows = {}
    try:
        if "kernels" in phases:
            rows = phase_kernels(torch, Timer(torch))
        if "ransac" in phases:
            phase_ransac(torch)
        if "main" in phases:
            phase_main(torch, rows)
        if "pairs" in phases:
            phase_pairs(torch, rows)
        if "map" in phases:
            phase_map(torch)
        if "cli" in phases:
            phase_cli(torch)
        if "train" in phases:
            phase_train(torch, rows)
        if "detect" in phases:
            phase_detect(torch, rows)
        if "infer" in phases:
            phase_infer(torch)
        if "tracker" in phases:
            phase_tracker(torch)
        if "demo" in phases:
            phase_demo(torch, rows)
        if "multi" in phases:
            phase_multi(torch, rows, args.multi_cards)
        if "bench" in phases:
            phase_bench(smi)
        if "sp_variants" in phases:
            phase_sp_variants(smi)
    finally:
        if "root" in _WORLD:
            import shutil

            shutil.rmtree(_WORLD["root"], ignore_errors=True)
    log(f"[total] {time.perf_counter() - t_start:.1f} s of command time, the build included")
    if set(phases) != set(PHASES):
        log(f"[partial] ran {phases} of {list(PHASES)}: no result line")
        return 0
    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err", "ms", "plain_ms",
            "bound_ms", "bound_by", "library_ms")
    print(json.dumps({"kernels": [{**{k: r[k] for k in keys}, **r.get("extra", {})}
                                  for r in rows.values()]}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
