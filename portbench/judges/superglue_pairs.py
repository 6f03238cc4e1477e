"""How `correct` is decided for a mapping cell (`entry: superglue_pairs`).

After the window, for a sample of the chunks it matched (drawn from the
seed), the plain reference (fp32, TF32 off) runs SuperGlue's GNN and the
log-space Sinkhorn on the same features and weights, a pair at a time,
and is compared with what the chunk returned, over the valid rows and
columns and the dustbins: `z_err`, the largest gap between the program's
log-assignment and the reference's, holds the GNN and K7 together; and
matches0 against the reference's mutual matches over the threshold
(`match_gap`, the share of keypoints whose match differs, over the
reference's matches).

The control (`control_outputs`) is the same reference with every
product's operands rounded to TF32 (`nets.tf32_round`), the next
precision below the configuration's fp32 with TF32 off.
"""

from __future__ import annotations

import torch

from portbench import scenes, weights
from portbench.reference import nets

NUMBERS = ("z_err", "match_gap")


def weights_for(cfg: dict, seed: int, device) -> dict:
    return weights.make(nets.superglue_specs(cfg["d_model"], cfg["num_layers"],
                                             tuple(cfg["keypoint_encoder"]),
                                             cfg["init"]["final_proj_scale"]),
                        scenes.sub_seed(seed, "superglue"), device)


def reference_pair(cfg: dict, w: dict, feats: dict, hw: tuple, i: int, j: int,
                   q=nets.ident) -> torch.Tensor:
    """The [M+1, N+1] log-assignment of frames i and j, each product's
    operands through q."""
    k, d, s, m = (feats[x] for x in ("keypoints", "descriptors", "scores", "mask"))
    sl0, sl1 = slice(i, i + 1), slice(j, j + 1)
    sim = nets.superglue_scores(w, k[sl0], k[sl1], d[sl0], d[sl1], s[sl0], s[sl1], hw, m[sl0],
                                m[sl1], cfg["num_layers"], cfg["num_heads"],
                                len(cfg["keypoint_encoder"]) + 1, q)
    return nets.log_sinkhorn(sim, w["bin_score"], m[sl0], m[sl1], cfg["sinkhorn_iterations"])[0]


def control_outputs(cfg: dict, w: dict, feats: dict, hw: tuple, chunk: tuple, q) -> dict:
    """The reference in the program's place, each product's operands
    through q."""
    ii, jj, _ = chunk
    z = torch.stack([reference_pair(cfg, w, feats, hw, int(i), int(j), q)
                     for i, j in zip(ii.tolist(), jj.tolist())])
    mm = nets.mutual_matches(z[:, :-1, :-1].exp(), cfg["match_threshold"], feats["mask"][ii])
    return {"log_assignment": z, "matches0": mm["matches0"]}


def judge(cfg: dict, scan: dict, items: list, w: dict) -> tuple:
    """(readings, stats) over the sampled chunks `items`, each (chunk
    index, outputs); only a chunk's real pairs are compared."""
    feats, hw = scan["feats"], scan["image_hw"]
    read = dict.fromkeys(NUMBERS, 0.0)
    stats = {"pairs": 0, "matches": 0, "reference_matches": 0, "assignment_max": 0.0}
    for ci, out in items:
        ii, jj, real = scan["chunks"][ci]
        for p in range(real):
            i, j = int(ii[p]), int(jj[p])
            zr = reference_pair(cfg, w, feats, hw, i, j)
            zp = out["log_assignment"][p].float()
            rows = torch.cat([feats["mask"][i], torch.ones(1, dtype=torch.bool, device=zr.device)])
            cols = torch.cat([feats["mask"][j], torch.ones(1, dtype=torch.bool, device=zr.device)])
            keep = rows[:, None] & cols[None, :]
            read["z_err"] = max(read["z_err"], float(((zp - zr).abs() * keep).max()))
            inner = keep[:-1, :-1]
            stats["assignment_max"] = max(stats["assignment_max"],
                                          float((zr[:-1, :-1].exp() * inner).max()))
            rm = nets.mutual_matches(zr[None, :-1, :-1].exp(), cfg["match_threshold"],
                                     feats["mask"][i][None])["matches0"][0]
            pm = out["matches0"][p].long()
            differ = feats["mask"][i] & (pm != rm)
            n_ref = int((rm >= 0).sum())
            read["match_gap"] = max(read["match_gap"], float(differ.sum()) / max(n_ref, 1))
            stats["pairs"] += 1
            stats["matches"] += int((pm >= 0).sum())
            stats["reference_matches"] += n_ref
    return read, stats
