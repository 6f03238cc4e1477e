"""Collective-volume audit of the port's points-sharded matcher and train step.

Port of `scripts/audit_collectives.py`, which parses the compiled HLO of
the mesh programs, sums the bytes of each collective kind, and checks the
design claim that a GNN block's volume does not depend on the sharded
point count (onepose_tpu/parallel/sharded_attention.py:69-71). The
port's collectives are explicit calls of `utils.comm`, so they are
counted where they run: `comm.record_collectives()` logs each call's
kind and the bytes of its result on the rank (what the HLO shapes give).

Two programs, each with 0 and BLOCKS GNN blocks, at each N3 asked for:
- serving: `GATsSPG(mesh=)` over a 1 x W mesh (the 3D points split over
  the W ranks), fp32, at [B, N2, N3, L, C] = [8, 1000, N3, 8, 256], one
  forward under inference_mode;
- the train step: `train.train_step.make_train_step(group=)`, data
  parallel over the W ranks (one frame each), at the same widths. The
  port trains only data-parallel: its points-sharded matcher runs
  forward (its collectives carry no gradient), where the JAX script
  audits the points-sharded train step.
The per-block volume is (blocks BLOCKS - blocks 0) / BLOCKS, which keeps
the head's volume out of it: the conf all-gather alone is B N2 N3 4 bytes
(64 MB at [8, 1000, 2000]). The run fails unless the per-block volume is
the same at every N3 and every kind (per block and the head) equals its
closed form from shapes (`serving_closed_form`, `train_closed_form`).

Runs on W >= 2 ranks, each resolving the card first:

    python -m torch.distributed.run --nproc-per-node 2 \\
        -m onepose_tpu_torch.scripts.audit_collectives [n3 ...]

(NCCL, one card a rank); two ranks sharing one card (NCCL refuses that)
take `--backend gloo`, as chip_smoke.py's phase multi (b) runs it. Rank 0
prints the table and, last, {"audit_collectives": {...}}.
"""

from __future__ import annotations

import argparse
import json
import sys

import numpy as np
import torch

from onepose_tpu_torch._device import resolve_device
from onepose_tpu_torch.models.gats_spg import GATsSPG
from onepose_tpu_torch.parallel.mesh import make_mesh
from onepose_tpu_torch.train.train_step import TrainConfig, create_train_state, make_train_step
from onepose_tpu_torch.utils import comm
from onepose_tpu_torch.utils.profiling import card_line

B, N2, LEAF, C, HEADS = 8, 1000, 8, 256, 4
BLOCKS = 4
N3S = (2000, 4000)
F32 = 4


def matcher_inputs(b: int, n2: int, n3: int, leaves: int, c: int, device) -> tuple:
    """(desc2d, desc3d, leaf_desc, mask2d, mask3d, leaf_mask): normal
    descriptors from default_rng(0) as the JAX script draws them, every
    mask True; the whole tensors, on every rank."""
    rng = np.random.default_rng(0)
    d2, d3, lv = (torch.from_numpy(rng.normal(size=s).astype(np.float32)).to(device)
                  for s in ((b, n2, c), (b, n3, c), (b, n3, leaves, c)))
    ones = (torch.ones(s, dtype=torch.bool, device=device)
            for s in ((b, n2), (b, n3), (b, n3, leaves)))
    return (d2, d3, lv, *ones)


def serving_totals(mesh, inputs: tuple, blocks: int) -> dict:
    """The collectives of one forward of GATsSPG(num_blocks=blocks, mesh=)
    (fp32, seeded weights, the same on every rank)."""
    torch.manual_seed(0)
    model = GATsSPG(d_model=inputs[0].shape[-1], num_blocks=blocks, mesh=mesh)
    model = model.to(mesh.device).eval()
    with torch.inference_mode(), comm.record_collectives() as log:
        model(*inputs)
    return log.totals()


def train_totals(group, inputs: tuple, blocks: int, device) -> dict:
    """The collectives of one data-parallel train step (the focal loss on
    conf_gt zeros but [:, 0, 0]) on this rank's frame of `inputs`."""
    rank, world = comm.get_rank(), comm.get_world_size()
    d2, d3, lv, m2, m3, lm = (x[rank::world] for x in inputs)
    conf_gt = torch.zeros((d2.shape[0], d2.shape[1], d3.shape[1]), device=device)
    conf_gt[:, 0, 0] = 1.0
    batch = dict(desc2d=d2, desc3d=d3, leaf_desc=lv, mask2d=m2, mask3d=m3, leaf_mask=lm,
                 conf_gt=conf_gt)
    cfg = TrainConfig(steps_per_epoch=10)
    model = GATsSPG(d_model=d2.shape[-1], num_blocks=blocks, fused_match=False)
    state = create_train_state(0, model, cfg, device=device)
    step = make_train_step(model, cfg, group=group)
    with comm.record_collectives() as log:
        step(state, batch)
    return log.totals()


def per_block(with_blocks: dict, head: dict, blocks: int) -> dict:
    """{kind: {calls, bytes}} of one block: the difference over `blocks`
    (kinds that the blocks add nothing to left out)."""
    out = {}
    for kind in sorted(set(with_blocks) | set(head)):
        a = with_blocks.get(kind, {"calls": 0, "bytes": 0})
        h = head.get(kind, {"calls": 0, "bytes": 0})
        if a != h:
            out[kind] = {k: (a[k] - h[k]) / blocks for k in ("calls", "bytes")}
    return out


def serving_closed_form(b: int, n2: int, n3: int, c: int = C, heads: int = HEADS) -> dict:
    """The sharded matcher's collectives from shapes, fp32 (D = c / heads):
    - a block: all-reduces of the linear attention's KV moment [B, H, D, D]
      and key sum [B, H, D] for the two attentions whose source is the
      sharded 3D stream (its self-attention, the 2D stream's
      cross-attention), and of the instance norm's count [B, 1, 1], sum
      and centred square sum [B, 1, 2C] in the two MLPs on the sharded 3D
      stream: 10 calls, independent of N3;
    - the head: the dual softmax's row max and exp-sum [B, N2, 1] (2
      all-reduces) and conf [B, N2, N3] all-gathered."""
    d = c // heads
    block = 2 * (b * heads * d * d + b * heads * d) + 2 * (b + 2 * b * 2 * c)
    return {"block": {"all_reduce": {"calls": 10, "bytes": F32 * block}},
            "head": {"all_gather": {"calls": 1, "bytes": F32 * b * n2 * n3},
                     "all_reduce": {"calls": 2, "bytes": F32 * 2 * b * n2}}}


def block_params(c: int = C) -> int:
    """Parameters of one GATsSPG block: the GATs layer's W [C, C] and a [2C];
    two AttentionalPropagations, each q, k, v, merge (4 (C^2 + C)) and
    the MLP 2C -> 2C -> C (4C^2 + 2C + 2C^2 + C)."""
    return c * c + 2 * c + 2 * (4 * (c * c + c) + 4 * c * c + 2 * c + 2 * c * c + c)


def train_closed_form(c: int = C) -> dict:
    """The data-parallel step's collectives from shapes: a block adds its
    fp32 gradients to the one gradient all-reduce (0 calls); the head is 4
    all-reduces (the focal loss's positive and negative counts, the
    metrics' 4 sums, and the gradients of final_proj, C^2 + C)."""
    return {"block": {"all_reduce": {"calls": 0, "bytes": F32 * block_params(c)}},
            "head": {"all_reduce": {"calls": 4, "bytes": F32 * (1 + 1 + 4 + c * c + c)}}}


def audit(mesh, group, n3s, b=B, n2=N2, leaves=LEAF, c=C, blocks=BLOCKS) -> dict:
    """Both programs at each N3: {"serving" | "train_step": {n3: {"head",
    "with_blocks", "block"}}}, on every rank."""
    out = {"serving": {}, "train_step": {}}
    for n3 in n3s:
        inputs = matcher_inputs(b, n2, n3, leaves, c, mesh.device)
        for name, totals in (("serving", lambda k: serving_totals(mesh, inputs, k)),
                             ("train_step", lambda k: train_totals(group, inputs, k,
                                                                   mesh.device))):
            head, full = totals(0), totals(blocks)
            out[name][n3] = {"head": head, "with_blocks": full,
                             "block": per_block(full, head, blocks)}
    return out


def check(result: dict, b=B, n2=N2, c=C) -> list:
    """What disagrees: a per-block volume that differs between the N3s, or
    a kind off its closed form; [] when all holds."""
    bad = []
    for name, runs in result.items():
        blocks = [r["block"] for r in runs.values()]
        if any(x != blocks[0] for x in blocks):
            bad.append(f"{name}: the per-block volume depends on N3: {blocks}")
        for n3, r in runs.items():
            want = (serving_closed_form(b, n2, n3, c) if name == "serving"
                    else train_closed_form(c))
            for part in ("block", "head"):
                if r[part] != want[part]:
                    bad.append(f"{name} at N3 {n3}, {part}: {r[part]}, closed form "
                               f"{want[part]}")
    return bad


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("n3", nargs="*", type=int, default=list(N3S),
                        help="3D point counts to audit (default 2000 4000)")
    parser.add_argument("--backend", default=None,
                        help="gloo for ranks sharing one card (default: NCCL)")
    args = parser.parse_args(argv)
    resolve_device("cuda")
    if not comm.init_distributed(device="cuda", backend=args.backend) or \
            comm.get_world_size() < 2:
        raise SystemExit("audit_collectives runs on 2 or more ranks: start it with "
                         "python -m torch.distributed.run --nproc-per-node N")
    world = comm.get_world_size()
    mesh = make_mesh(n_data=1, n_points=world, device="cuda")
    result = audit(mesh, torch.distributed.group.WORLD, args.n3)
    bad = check(result)
    card = card_line() if comm.is_main_process() else ""
    comm.synchronize()
    if comm.is_main_process():
        backend = torch.distributed.get_backend()
        print(f"card: {card}; {world} ranks, backend {backend}; B={B} N2={N2} L={LEAF} C={C} "
              f"heads={HEADS}; blocks 0 and {BLOCKS}; bytes of each collective's result on a "
              f"rank", flush=True)
        print("| program | N3 | part | kind | calls | bytes | MB |")
        print("|---|---|---|---|---|---|---|")
        for name, runs in result.items():
            for n3, r in runs.items():
                for part in ("head", "block"):
                    for kind, v in r[part].items():
                        print(f"| {name} | {n3} | {part} | {kind} | {v['calls']:g} | "
                              f"{v['bytes']:.0f} | {v['bytes'] / 1e6:.3f} |", flush=True)
        print(f"serving: replicated 2D-stream positions a block {N2}, sharded 3D-stream "
              f"positions {max(args.n3)} + {max(args.n3) * LEAF} (split over {world} ranks)")
        if not bad:
            print(json.dumps({"audit_collectives": {
                "card": card, "ranks": world, "backend": backend,
                "serving": {str(k): v for k, v in result["serving"].items()},
                "train_step": {str(k): v for k, v in result["train_step"].items()},
                "closed_form": {"serving": serving_closed_form(B, N2, max(args.n3)),
                                "train_step": train_closed_form()},
            }}), flush=True)
    torch.distributed.destroy_process_group()
    if bad:
        raise SystemExit("audit_collectives: " + "; ".join(bad))
    return 0


if __name__ == "__main__":
    sys.exit(main())
