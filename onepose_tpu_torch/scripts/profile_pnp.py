"""Where RANSAC-PnP's time, launches and host syncs sit on the card.

Port of `scripts/profile_pnp.py`: the whole `ransac_pnp` with fixed
draws (injected) and with varying draws (a CUDA generator), then each of
K9's two launches alone (`ops/kernels/ransac_pnp.py`, what `ransac_pnp`
runs on the card), at the JAX script's shapes and inputs: batch 8, 1000
matches (30% valid), 512 hypotheses, a 5 px threshold, K of f 600 and c
256, drawn by np.random.default_rng(0) in its order. The rows:
  pnp_fixed    the whole call, the draws injected
  pnp_varying  the whole call, the draws from the generator
  hypotheses   the draws and launch A (the valid-first order, the minimal
               samples, P3P, the preemptive scoring), as span
               `pnp.hypotheses` holds them
  refine       launch B (the stable keep, the second scoring, Gauss-Newton,
               the final stage) on one launch A's output, as span
               `pnp.refine` holds it
The stage sum (hypotheses, refine) is printed against the whole call with
varying draws. Each launch timed alone pays its own host work (the
checks, the launch, the perturbed input), which the whole call overlaps
with the card's, so the sum can read above the whole. The JAX script's
sub-stages of the plain version are not timed: the card never runs
them.

Each row: ms a call (CUDA events over TIMED_CALLS dependent calls, each
call's first input perturbed by the last output, after a warm-up), CUDA
kernels a call and their device ms (torch.profiler, one call), K9's
launches in one call, host syncs a call (torch.cuda's sync debug mode)
and the source line of each.
Prints a table, the card's name and power limit, and last
{"profile_pnp": {"card", "rows", "stage_sum_ms", "whole_ms"}}.

    python -m onepose_tpu_torch.scripts.profile_pnp
"""

from __future__ import annotations

import argparse
import json
import sys
from collections import Counter

import numpy as np
import torch

from onepose_tpu_torch._device import resolve_device
from onepose_tpu_torch.geometry.ransac import ransac_pnp
from onepose_tpu_torch.ops.kernels import launch_counts, reset_launches
from onepose_tpu_torch.ops.kernels import ransac_pnp as k9
from onepose_tpu_torch.scripts.roofline_audit import chain, time_stage
from onepose_tpu_torch.utils.profiling import card_line, device_busy, host_syncs

BATCH, N_KPTS, N_HYP, THRESHOLD, VALID = 8, 1000, 512, 5.0, 0.3
SCALE = 1000.0  # ransac_pnp's default: the points in mm inside
REFINE_ITERS = 5
TIMED_CALLS = 30
STAGE_SUM = ("hypotheses", "refine")


def make_inputs(batch: int = BATCH, n: int = N_KPTS, device="cuda") -> tuple:
    """(pts2d [B, N, 2], pts3d [B, N, 3], K [B, 3, 3], mask [B, N]): the JAX
    script's draws from default_rng(0), in its order."""
    rng = np.random.default_rng(0)
    K = np.broadcast_to(np.asarray([[600.0, 0, 256], [0, 600.0, 256], [0, 0, 1]], np.float32),
                        (batch, 3, 3)).copy()
    pts2d = (rng.random((batch, n, 2)) * 512).astype(np.float32)
    pts3d = (rng.normal(size=(batch, n, 3)) * 0.1).astype(np.float32)
    mask = rng.random((batch, n)) < VALID
    dev = resolve_device(device)
    return tuple(torch.from_numpy(x).to(dev) for x in (pts2d, pts3d, K, mask))


def build_stages(pts2d, pts3d, K, mask, generator, n_hyp: int = N_HYP,
                 threshold: float = THRESHOLD) -> dict:
    """name -> (fn, args): the whole call twice and K9's launches alone,
    launch B on the output of one launch A (made here with one draw of the
    generator, which the fixed-draw row reuses)."""
    b = pts2d.shape[0]

    def draw():
        return torch.rand((b, n_hyp, 3), generator=generator, device=generator.device)

    draws = draw()
    hyp = k9.hypotheses(pts2d, pts3d, K, mask, draws, threshold, SCALE)
    kw = dict(n_hyp=n_hyp, reproj_threshold=threshold)
    return {
        "pnp_fixed": (lambda p2: ransac_pnp(p2, pts3d, K, mask, draws=draws, **kw)["pose"],
                      (pts2d,)),
        "pnp_varying": (lambda p2: ransac_pnp(p2, pts3d, K, mask, generator=generator,
                                              **kw)["pose"], (pts2d,)),
        "hypotheses": (lambda p2: k9.hypotheses(p2, pts3d, K, mask, draw(), threshold,
                                                SCALE).counts, (pts2d,)),
        "refine": (lambda p2: k9.refine(hyp, p2, pts3d, K, mask, threshold, REFINE_ITERS,
                                        SCALE)["pose"], (pts2d,)),
    }


def _launches(fn, args) -> int:
    """K9's launches in one call of fn."""
    reset_launches()
    chain(fn, args, 1)
    return launch_counts()["ransac_pnp"]


def profile_row(name: str, fn, args) -> dict:
    """One row on the card: ms, CUDA kernels and their device ms, K9's
    launches, host syncs and where they are, each for one call."""
    ms = time_stage(fn, args) * 1e3
    busy = device_busy(lambda: chain(fn, args, 1))
    syncs = host_syncs(lambda: chain(fn, args, 1))
    return {"stage": name, "ms": ms, "kernels": None if busy is None else busy["kernels"],
            "device_ms": None if busy is None else busy["kernel_ms"],
            "launches": _launches(fn, args), "syncs": len(syncs),
            "sync_lines": dict(Counter(syncs))}


def summary(card: str, rows: list) -> dict:
    """The last line's object: stage_sum_ms adds STAGE_SUM's rows, whole_ms
    is the whole call with varying draws."""
    by = {r["stage"]: r for r in rows}
    return {"profile_pnp": {"card": card, "rows": rows,
                            "stage_sum_ms": sum(by[s]["ms"] for s in STAGE_SUM),
                            "whole_ms": by["pnp_varying"]["ms"]}}


def main(argv=None) -> int:
    argparse.ArgumentParser(description=__doc__.splitlines()[0]).parse_args(argv)
    dev = resolve_device("cuda")
    # As ransac_pnp runs: TF32 off (fp32_matmuls).
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    pts2d, pts3d, K, mask = make_inputs(device=dev)
    gen = torch.Generator(device=dev).manual_seed(0)
    card = card_line()
    print(f"card: {card}; batch={BATCH} matches={N_KPTS} ({VALID:.0%} valid) "
          f"hypotheses={N_HYP} threshold={THRESHOLD} px; {TIMED_CALLS} dependent calls a row "
          f"(CUDA events); kernels, K9 launches and syncs of one call", flush=True)
    print("| stage | ms | CUDA kernels | device ms | K9 launches | host syncs | where |")
    print("|---|---|---|---|---|---|---|")
    rows = []
    for name, (fn, args) in build_stages(pts2d, pts3d, K, mask, gen).items():
        r = profile_row(name, fn, args)
        rows.append(r)
        where = ", ".join(f"{k} x{v}" for k, v in r["sync_lines"].items()) or "-"
        print(f"| {name} | {r['ms']:.3f} | {r['kernels']} | "
              f"{r['device_ms'] if r['device_ms'] is None else round(r['device_ms'], 3)} | "
              f"{r['launches']} | {r['syncs']} | {where} |", flush=True)
    out = summary(card, rows)
    print(f"stage sum ({' + '.join(STAGE_SUM)}) {out['profile_pnp']['stage_sum_ms']:.3f} ms "
          f"against the whole call {out['profile_pnp']['whole_ms']:.3f} ms", flush=True)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
