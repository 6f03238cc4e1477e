"""GATsSPG's cost by parts on the card: the head alone, then 2 and 4 blocks.

Port of `scripts/bench_matcher_parts.py`: GATsSPG at [B, N2, N3, L, C] =
[8, 1000, 2000, 8, 256] with num_blocks 0 (projection, similarity and
the dual-softmax head), 2 and 4, on the JAX script's inputs (normal
descriptors and leaves from default_rng(0), every mask True), random
weights from seed 0. Two configurations:
- "fp32": the JAX script's (fp32, the GATs kernel off, the plain head);
- "bf16": the serving pipeline's matcher (bf16, fused blocks: K4, and
  the fused dual-softmax head: K3), which is what `PosePipeline` runs.
Each row is timed by CUDA events over ITERS dependent calls (each call's
2D descriptors perturbed by the last call's scores), after a warm-up;
the kernel launches of one call are counted. The difference between rows
is the blocks' share.

Prints the JAX script's lines, the card's name and power limit, and last
{"matcher_parts": {"card", "rows"}}.

    python -m onepose_tpu_torch.scripts.bench_matcher_parts
"""

from __future__ import annotations

import argparse
import json
import sys

import numpy as np
import torch

from onepose_tpu_torch._device import resolve_device
from onepose_tpu_torch.models.gats_spg import GATsSPG
from onepose_tpu_torch.ops.kernels import launch_counts, reset_launches
from onepose_tpu_torch.scripts.roofline_audit import chain, time_stage
from onepose_tpu_torch.utils.profiling import card_line

B, N2, N3, L, C = 8, 1000, 2000, 8, 256
ITERS = 30
BLOCKS = (0, 2, 4)
CONFIGS = {
    "fp32": dict(dtype=torch.float32),
    "bf16": dict(dtype=torch.bfloat16, block_fused=True, fused_match=True),
}


def make_inputs(b=B, n2=N2, n3=N3, leaves=L, c=C, device="cuda") -> tuple:
    """(desc2d, desc3d, leaf_desc, mask2d, mask3d, leaf_mask): the JAX
    script's draws from default_rng(0), in its order; every mask True."""
    rng = np.random.default_rng(0)
    dev = resolve_device(device)
    d2, d3, lv = (torch.from_numpy(rng.normal(size=s).astype(np.float32)).to(dev)
                  for s in ((b, n2, c), (b, n3, c), (b, n3, leaves, c)))
    masks = (torch.ones(s, dtype=torch.bool, device=dev) for s in ((b, n2), (b, n3),
                                                                      (b, n3, leaves)))
    return (d2, d3, lv, *masks)


def make_matcher(config: str, num_blocks: int, device, d_model: int = C) -> GATsSPG:
    """GATsSPG(num_blocks) in `config`, weights from seed 0, on device."""
    torch.manual_seed(0)
    model = GATsSPG(d_model=d_model, num_blocks=num_blocks, **CONFIGS[config])
    return model.to(device).eval()


def scores_fn(model: GATsSPG, inputs: tuple):
    """d2 -> matching_scores0 of the matcher on (d2, the other inputs)."""
    def fn(d2):
        return model(d2, *inputs[1:])["matching_scores0"]

    return fn


def main(argv=None) -> int:
    argparse.ArgumentParser(description=__doc__.splitlines()[0]).parse_args(argv)
    dev = resolve_device("cuda")
    inputs = make_inputs(device=dev)
    card = card_line()
    print(f"card: {card}; B={B} N2={N2} N3={N3} L={L} C={C}; {ITERS} dependent calls a row "
          f"(CUDA events)", flush=True)
    rows = []
    for config in CONFIGS:
        for nb in BLOCKS:
            fn = scores_fn(make_matcher(config, nb, dev), inputs)
            chain(fn, inputs[:1], 1)
            torch.cuda.synchronize()
            reset_launches()
            chain(fn, inputs[:1], 1)
            torch.cuda.synchronize()
            launches = {k: v for k, v in launch_counts().items() if v}
            ms = time_stage(fn, inputs[:1], ITERS) * 1e3
            rows.append({"config": config, "blocks": nb, "ms": ms, "launches": launches})
            print(f"{config} blocks={nb}: {ms:8.2f} ms/iter  launches {launches}", flush=True)
    print(json.dumps({"matcher_parts": {"card": card, "rows": rows}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
