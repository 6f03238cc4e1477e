"""How `correct` is decided for a serving cell (`entry: pose_pipeline`).

After the window, for a sample of the calls it finished (drawn from the
seed), the plain reference (fp32, TF32 off) works on the same frames,
weights, maps, K and RANSAC draws, a block of frames at a time:

- SuperPoint and keypoint extraction, from the frames: each keypoint's
  score against the reference's detector probability there
  (`kpt_score_rel`), how far it lies below the reference's k-th best score
  (`kpt_rank_gap`), and each descriptor against the reference's sampled at
  the same pixel (`desc_err`);
- the matcher (K4's blocks, the head and K3), on the program's own
  keypoints and descriptors, so that what SuperPoint got wrong is not
  carried into it: the blocks' outputs x2 and x3, which the call hands to
  the head and the runner keeps for the sampled calls, against the
  reference's blocks on the same inputs (`gnn2_err`, `gnn3_err`: the
  largest gap of a point over the median point's update, the norm of what
  the blocks added to their input); each match's score against the
  reference's confidence of that pair (`match_score_err`); and matches0
  against the reference's mutual matches: how far above the threshold the
  reference scored a point that the program left unmatched
  (`missed_match_margin`), and the share of points whose match differs
  (`match_gap`, over the reference's matches);
- the pose, against the reference's whole call on the frames (its own
  keypoints, matches and RANSAC-PnP with the same draws): the pose
  (`pose_gap`, Frobenius norm of the 4 x 4 difference) and the inlier
  count (`inlier_gap`, over the reference's).

Each number is a gap (0 is exact); those in `limits/<cell>.json` are held
against their limits there, the others are reported.

The control (`control_outputs`) is the reference in the program's place at
the next precision below the configuration's: the networks' bf16 as
float8 e4m3 operands of every product (`nets.fp8_round`), RANSAC-PnP's
fp32 (TF32 off) as TF32.
"""

from __future__ import annotations

import torch

from portbench import harness, scenes, weights
from portbench.reference import nets, ransac

NUMBERS = ("kpt_score_rel", "kpt_rank_gap", "desc_err", "gnn2_err", "gnn3_err",
           "match_score_err", "missed_match_margin", "match_gap", "pose_gap", "inlier_gap")
MATCHER_BIAS_SCALE = 0.0  # the assumed init: the matcher's Dense biases are zero


def weights_for(cfg: dict, seed: int, device) -> tuple:
    """(SuperPoint, GATsSPG) weights of the configuration from the seed."""
    init = cfg["init"]
    sp = weights.superpoint(cfg, scenes.sub_seed(seed, "superpoint"), device)
    gs = weights.make(nets.gats_spg_specs(cfg["d_model"], cfg["num_blocks"],
                                          init["mlp_out_scale"], MATCHER_BIAS_SCALE),
                      scenes.sub_seed(seed, "matcher"), device)
    return sp, gs


def _frames_anno(anno: dict, sl: slice, n: int) -> dict:
    """The maps of frames sl: a roster's own, or one object's broadcast."""
    if anno["mask3d"].dim() == 2:
        return {k: v[sl] for k, v in anno.items()}
    return {k: v[None].expand((n,) + v.shape) for k, v in anno.items()}


def _at(x: torch.Tensor, kp: torch.Tensor) -> torch.Tensor:
    """x [B, H, W] at integer keypoints kp [B, K, 2] (x, y)."""
    w = x.shape[-1]
    idx = kp[..., 1].long() * w + kp[..., 0].long()
    return torch.gather(x.flatten(1), 1, idx)


def _max(x: torch.Tensor, keep: torch.Tensor) -> float:
    return float(torch.where(keep, x, torch.zeros_like(x)).max()) if keep.any() else 0.0


def chain(cfg: dict, sp: dict, gs: dict, images, K, draws, a: dict, q=nets.ident,
          tf32: bool = False, d: dict = None) -> tuple:
    """The whole serving call in the reference, frames [n, ...] against their
    maps `a` ([n, N3, ...]), with operand rounding q and RANSAC-PnP under TF32
    or not: (outputs as the pipeline names them, (x2, x3)). `d` is the
    reference SuperPoint's output on the frames where it is already at hand."""
    d = d if d is not None else nets.superpoint(sp, images, cfg["nms_radius"], q)
    sel = nets.select_keypoints(d["score"], cfg["max_keypoints"], cfg["keypoint_threshold"],
                                cfg["border"])
    mask = sel["mask"]
    desc = nets.sample_descriptors(sel["keypoints"], d["desc"]) * mask[..., None]
    x2, x3 = nets.gats_spg_gnn(gs, desc, a["desc3d"], a["leaf_desc"], mask, a["mask3d"],
                               a["leaf_mask"], cfg["num_blocks"], cfg["num_heads"], q)
    conf = nets.gats_spg_conf(gs, x2, x3, mask, a["mask3d"], cfg["scale_factor"], q)
    mm = nets.mutual_matches(conf, cfg["match_threshold"], mask)
    hit = mm["matches0"] >= 0
    pts3d = torch.gather(a["points3d"], 1, mm["matches0"].clamp(min=0)[..., None].expand(-1, -1, 3))
    with harness.matmul_precision(torch, tf32):
        r = ransac.ransac_pnp(sel["keypoints"], pts3d, K, hit, draws=draws,
                              reproj_threshold=cfg["reproj_threshold"],
                              n_hyp=cfg["ransac_hypotheses"])
    out = {"keypoints": sel["keypoints"], "kpt_mask": mask, "kpt_scores": sel["scores"],
           "descriptors": desc, "matches0": mm["matches0"],
           "matching_scores0": torch.where(hit, mm["matching_scores0"], 0.0),
           "pose": r["pose"], "num_inliers": r["num_inliers"], "pnp_ok": r["ok"]}
    return out, (x2, x3)


def control_outputs(cfg: dict, sp: dict, gs: dict, batch: dict, q) -> tuple:
    """The control in the program's place for one batch: `chain` with
    operand rounding q and RANSAC-PnP under TF32."""
    n = batch["images"].shape[0]
    return chain(cfg, sp, gs, batch["images"], batch["K"], batch["draws"],
                 _frames_anno(batch["anno"], slice(0, n), n), q, tf32=True)


def judge(cfg: dict, pool: list, items: list, sp: dict, gs: dict, block: int = 16) -> tuple:
    """(readings {number: value}, stats) over the sampled calls `items`,
    each (pool index, outputs, (x2, x3)); the reference runs `block`
    frames at a time."""
    r, thr = cfg["nms_radius"], cfg["keypoint_threshold"]
    read = dict.fromkeys(NUMBERS, 0.0)
    stats = {"frames": 0, "pnp_ok": 0, "matches": 0, "reference_matches": 0}

    def worst(name, value):
        read[name] = max(read[name], float(value))

    for pi, out, (x2p, x3p) in items:
        batch = pool[pi]
        n = batch["images"].shape[0]
        for s in range(0, n, block):
            sl = slice(s, min(s + block, n))
            a = _frames_anno(batch["anno"], sl, sl.stop - sl.start)
            d = nets.superpoint(sp, batch["images"][sl], r)
            kp, m = out["keypoints"][sl], out["kpt_mask"][sl]
            pref = _at(d["prob"], kp)
            worst("kpt_score_rel", _max((out["kpt_scores"][sl] - pref).abs() / pref, m))
            sel = nets.select_keypoints(d["score"], cfg["max_keypoints"], thr, cfg["border"])
            n_ref = sel["mask"].sum(-1)
            kth = torch.where(sel["mask"], sel["scores"], torch.inf).amin(-1)
            t_ref = torch.where(n_ref == cfg["max_keypoints"], kth, torch.full_like(kth, thr))
            worst("kpt_rank_gap", _max((t_ref[:, None] - pref).clamp(min=0) / t_ref[:, None], m))
            dref = nets.sample_descriptors(kp, d["desc"]) * m[..., None]
            worst("desc_err", _max((out["descriptors"][sl] - dref).norm(dim=-1), m))

            din = out["descriptors"][sl].float()
            x2, x3 = nets.gats_spg_gnn(gs, din, a["desc3d"], a["leaf_desc"], m, a["mask3d"],
                                       a["leaf_mask"], cfg["num_blocks"], cfg["num_heads"])
            for name, xp, xr, x_in, keep in (("gnn2_err", x2p[sl], x2, din, m),
                                             ("gnn3_err", x3p[sl], x3, a["desc3d"].float(),
                                              a["mask3d"])):
                update = (xr - x_in).norm(dim=-1)[keep].median()
                worst(name, _max((xp.float() - xr).norm(dim=-1) / update, keep))
            conf = nets.gats_spg_conf(gs, x2, x3, m, a["mask3d"], cfg["scale_factor"])
            rm = nets.mutual_matches(conf, cfg["match_threshold"], m)
            pm = out["matches0"][sl].long()
            hit = pm >= 0
            at = torch.gather(conf, 2, pm.clamp(min=0)[..., None])[..., 0]
            worst("match_score_err", _max((out["matching_scores0"][sl] - at).abs(), hit))
            ref_hit = rm["matches0"] >= 0
            worst("missed_match_margin",
                  _max(rm["matching_scores0"] - cfg["match_threshold"], ref_hit & ~hit))
            differ = m & (pm != rm["matches0"]) & (hit | ref_hit)
            worst("match_gap", float(differ.sum()) / max(int(ref_hit.sum()), 1))

            ref, _ = chain(cfg, sp, gs, batch["images"][sl], batch["K"][sl],
                           batch["draws"][sl], a, d=d)
            worst("pose_gap", (out["pose"][sl] - ref["pose"]).flatten(1).norm(dim=-1).max())
            n_in = ref["num_inliers"]
            worst("inlier_gap", ((out["num_inliers"][sl] - n_in).abs() / n_in.clamp(min=1)).max())
            stats["frames"] += sl.stop - sl.start
            stats["pnp_ok"] += int(out["pnp_ok"][sl].sum())
            stats["matches"] += int(hit.sum())
            stats["reference_matches"] += int((ref["matches0"] >= 0).sum())
    return read, stats
