"""How `correct` is decided for a LightGlue mapping cell (`entry:
lightglue_pairs`), and the configuration's weights.

After the window, for a sample of the chunks the program matched (drawn
from the seed), the plain reference (`reference.lightglue`, fp32, TF32
off, b = 1) runs each real pair on the program's own input features (the
pair's valid keypoints) and weights, and is compared with what the chunk
returned:
- `lg_stop_gap`: pairs whose layers run differ from the reference's;
- `lg_kept_gap`: keypoints whose pruning decision at some layer differs;
- `lg_score_err`: the largest gap between the program's log assignment
  and the reference's, over the kept points and the dustbins;
- `lg_match_gap`: the share of matches0 that differs, over the valid
  keypoints whose match decision is sure (below), against the
  reference's matches (the largest over pairs).
A stop or pruning decision whose margin in the reference, in the logit of
the sigmoid it thresholds, lies under EPS is taught to the reference from
the program (`reference.lightglue.match_pair`'s `program`) and counted in
the stats (`taught`); so is a match decision whose margin in the log
assignment (its row's best over the second, its column's best over the
rest, or the filter's threshold) lies under EPS. A differing decision
outside it counts in the gaps, whose limits are 0. EPS is 0.01: the
program computes in fp32 (K8 in 3xTF32), and its log assignment sits
within 5.1e-4 of the reference's on 20 seeds (`lg_score_err`), so a
logit or a score moved by rounding moves by far less than EPS.

The control (`control_outputs`) is the same reference with every
product's operands rounded to TF32 (`nets.tf32_round`), the next
precision below the configuration's fp32 with TF32 off.

The weights (`weights_for`): PyTorch's default init from the seed
(`reference.lightglue.specs`), with the configuration's `init`: the final
projection at `final_proj_scale` times its bound, the scale that matches
the most on the scan's independent textures (some 30 to 60 mutual
matches a pair, against SuperGlue's hundreds through Sinkhorn's
marginals); the token-confidence and
matchability weights at `token_scale` and `matchability_scale` times
theirs, so that a logit's spread over the keypoints dwarfs EPS; and the
biases of both heads set from the scan (a data-dependent init): the
reference runs every pair of the scan layer by layer, as the program
would, and puts each bias where the raw logits' quantiles put the
configuration's shares on them (on a few pairs alone, the shares a seed
got spread by 1%, and the cell's rate with them):
- the token confidence after layer l: `stop_shares[l]` of the pairs
  still running stop there. Each pair stops from the bias at which
  fewer than 5% of its m + n points are unconfident on (its own
  threshold, `_stop_biases`); the bias lies halfway between the k-th
  and the (k + 1)-th of those over the running pairs. After a layer
  whose share is 0, `confident_share` of the points are confident, and
  no pair stops;
- the matchability after layer l, while an image of a running pair
  holds more than the floor: so many confident points unmatchable that
  `pruned_share` of those images' points are pruned; once none does,
  and at the last layer, 95% of the points matchable by 0.9 or more
  (the assignment's head).
Which pairs stop where differs from seed to seed, but how many stop
after each layer, and so the layers a pair on the scan, does not; the
kept share moves by far less than 1%.
"""

from __future__ import annotations

import math

import torch

from portbench import scenes, weights
from portbench.reference import lightglue as ref
from portbench.reference import nets

NUMBERS = ("lg_stop_gap", "lg_kept_gap", "lg_score_err", "lg_match_gap")
EPS = 0.01


def conf_of(cfg: dict) -> dict:
    """The reference's conf from the configuration."""
    return {"descriptor_dim": cfg["descriptor_dim"], "num_heads": cfg["num_heads"],
            "n_layers": cfg["n_layers"], "depth_confidence": cfg["depth_confidence"],
            "width_confidence": cfg["width_confidence"],
            "filter_threshold": cfg["filter_threshold"],
            "pruning_min_keypoints": cfg["pruning_min_keypoints"]}


def _pair_inputs(feats: dict, hw: tuple, i: int, j: int) -> tuple:
    """The valid keypoints of frames i and j: (kpts0, kpts1, desc0, desc1,
    size, valid slots 0, valid slots 1)."""
    k, d, m = feats["keypoints"], feats["descriptors"], feats["mask"]
    v0, v1 = m[i].nonzero()[:, 0], m[j].nonzero()[:, 0]
    size = (hw[1], hw[0])
    return k[i][v0], k[j][v1], d[i][v0], d[j][v1], size, v0, v1


def _stop_biases(ts: list, totals: list, tau: float, dc: float) -> torch.Tensor:
    """For each running pair (its kept points' raw token logits `ts[p]`,
    its valid points `totals[p]`), the least bias at which it stops: the
    stop test (1 - unconfident / total > dc) allows at most k = ceil((1 -
    dc) total) - 1 unconfident points, so the pair stops once its
    (k + 1)-th lowest logit reaches logit(tau)."""
    out = []
    for t, total in zip(ts, totals):
        k = math.ceil((1.0 - dc) * total) - 1
        out.append(-math.inf if t.numel() <= k else
                   ref.logit(tau) - float(t.sort().values[k]))
    return torch.tensor(out, dtype=torch.float64)


def _calibrate(w: dict, cfg: dict, feats: dict, hw: tuple, pairs: list) -> None:
    """Set the token-confidence and matchability biases in place (see the
    module)."""
    init, conf = cfg["init"], conf_of(cfg)
    heads, n_layers, floor = conf["num_heads"], conf["n_layers"], conf["pruning_min_keypoints"]
    wc, dc = conf["width_confidence"], conf["depth_confidence"]
    states = []  # a running pair: [x (both images), encodings, valid points m + n]
    for i, j in pairs:
        k0, k1, d0, d1, size, _, _ = _pair_inputs(feats, hw, i, j)
        states.append([[d0.float(), d1.float()],
                       [ref.posenc(w, ref.normalize_keypoints(k.float(), size)) for k in (k0, k1)],
                       len(k0) + len(k1)])
    bt = bz = 0.0
    for layer in range(n_layers):
        tok, mat = f"token_confidence.{layer}.token.0", f"log_assignment.{layer}.matchability"
        if not states:  # every pair has stopped: the later heads are never read
            w[f"{mat}.bias"].fill_(bz)
            if layer < n_layers - 1:
                w[f"{tok}.bias"].fill_(bt)
            continue
        for st in states:
            x, enc, _ = st
            blk = f"transformers.{layer}"
            x = [ref.self_block(w, f"{blk}.self_attn", x[a], enc[a], heads) for a in (0, 1)]
            st[0] = list(ref.cross_block(w, f"{blk}.cross_attn", x[0], x[1], heads))
        z = [[xa @ w[f"{mat}.weight"][0] for xa in st[0]] for st in states]
        if layer == n_layers - 1:
            bz = ref.logit(0.9) - float(torch.quantile(torch.cat(sum(z, [])), 0.05))
            w[f"{mat}.bias"].fill_(bz)
            break
        tau = ref.confidence_threshold(layer, n_layers)
        t = [[xa @ w[f"{tok}.weight"][0] for xa in st[0]] for st in states]
        need = _stop_biases([torch.cat(tp) for tp in t], [st[2] for st in states], tau, dc)
        k = round(init["stop_shares"][layer] * len(states))
        order = need.sort().values
        if k == 0:
            bt = ref.logit(tau) - float(torch.quantile(torch.cat(sum(t, [])),
                                                       1.0 - init["confident_share"]))
            if math.isfinite(float(order[0])):
                bt = min(bt, float(order[0]) - 1.0)
        elif k < len(states):
            bt = 0.5 * float(order[k - 1] + order[k])
        else:
            bt = float(order[-1]) + 1.0
        stops = need <= bt
        # Pruning: the images above the floor of the pairs that go on.
        big = [(t[p][a], z[p][a]) for p in range(len(states)) if not stops[p]
               for a in (0, 1) if states[p][0][a].shape[0] > floor]
        if big:
            tb, zb = torch.cat([b[0] for b in big]), torch.cat([b[1] for b in big])
            sure = tb + bt > ref.logit(tau)
            share = min(1.0, init["pruned_share"] / max(float(sure.float().mean()), 1e-9))
            bz = ref.logit(1 - wc) - float(torch.quantile(zb[sure], share))
        else:
            bz = ref.logit(0.9) - float(torch.quantile(torch.cat(sum(z, [])), 0.05))
        w[f"{tok}.bias"].fill_(bt)
        w[f"{mat}.bias"].fill_(bz)
        going = []
        for p, st in enumerate(states):
            if stops[p]:
                continue
            x, enc, _ = st
            for a in (0, 1):
                if x[a].shape[0] <= floor:
                    continue
                keep = ((torch.sigmoid(z[p][a] + bz) > 1 - wc)
                        | (torch.sigmoid(t[p][a] + bt) <= tau))
                x[a], enc[a] = x[a][keep], enc[a][:, keep]
            going.append(st)
        states = going


def weights_for(cfg: dict, seed: int, device, scan: dict) -> dict:
    """LightGlue's weights under upstream's names and layout (see the
    module): drawn from the seed, scaled, biases set on the scan."""
    conf, init = conf_of(cfg), cfg["init"]
    w = weights.make(ref.specs(conf["descriptor_dim"], conf["num_heads"], conf["n_layers"]),
                     scenes.sub_seed(seed, "lightglue"), device)
    for name in w:
        if name.endswith("final_proj.weight"):
            w[name] *= init["final_proj_scale"]
        elif name.endswith("token.0.weight"):
            w[name] *= init["token_scale"]
        elif name.endswith("matchability.weight"):
            w[name] *= init["matchability_scale"]
    with torch.no_grad():
        _calibrate(w, cfg, scan["feats"], scan["image_hw"], scan["pairs"])
    return w


def reference_pair(cfg: dict, w: dict, feats: dict, hw: tuple, i: int, j: int, q=nets.ident,
                   program: dict = None) -> dict:
    """The reference on frames i and j (their valid keypoints), each
    product's operands through q; `program` in the pair's valid order."""
    k0, k1, d0, d1, size, _, _ = _pair_inputs(feats, hw, i, j)
    return ref.match_pair(w, k0, k1, d0, d1, size, size, conf_of(cfg), q=q, program=program,
                          eps=EPS)


def _slots(r: dict, v0, v1, n0: int, n1: int) -> dict:
    """A reference result over the frames' keypoint slots: matches0 [n0]
    (slot indices of image 1, -1), pruned_at [n*] (-1 elsewhere), kept slots."""
    dev = v0.device
    m0 = torch.full((n0,), -1, dtype=torch.long, device=dev)
    if len(v1):
        m0[v0] = torch.where(r["matches0"] >= 0, v1[r["matches0"].clamp(min=0)], -1)
    p0 = torch.full((n0,), -1, dtype=torch.long, device=dev)
    p1 = torch.full((n1,), -1, dtype=torch.long, device=dev)
    p0[v0], p1[v1] = r["pruned_at0"], r["pruned_at1"]
    return {"matches0": m0, "pruned_at0": p0, "pruned_at1": p1, "ind0": v0[r["ind0"]],
            "ind1": v1[r["ind1"]]}


def control_outputs(cfg: dict, w: dict, feats: dict, hw: tuple, chunk: tuple, q) -> dict:
    """The reference in the program's place, each product's operands
    through q: the fields of `LightGlue.forward` that the judge reads."""
    ii, jj, _ = chunk
    n0 = n1 = feats["mask"].shape[1]
    out = {"matches0": [], "pruned_at0": [], "pruned_at1": [], "layers": [], "stopped_at": [],
           "assignments": []}
    for p, (i, j) in enumerate(zip(ii.tolist(), jj.tolist())):
        r = reference_pair(cfg, w, feats, hw, i, j, q)
        s = _slots(r, *_pair_inputs(feats, hw, i, j)[5:], n0, n1)
        for key in ("matches0", "pruned_at0", "pruned_at1"):
            out[key].append(s[key])
        out["layers"].append(r["layers"])
        out["stopped_at"].append(r["stopped_at"])
        if r["scores"] is not None:
            out["assignments"].append({"rows": [p], "scores": r["scores"][None],
                                       "ind0": s["ind0"][None], "ind1": s["ind1"][None],
                                       "len0": torch.tensor([len(s["ind0"])]),
                                       "len1": torch.tensor([len(s["ind1"])])})
    for key in ("matches0", "pruned_at0", "pruned_at1"):
        out[key] = torch.stack(out[key])
    return out


def program_assignment(out: dict, p: int):
    """(scores [l0 + 1, l1 + 1], kept slots 0, kept slots 1) of chunk row p,
    or None if it has none (an image with no point)."""
    for g in out["assignments"]:
        if p in g["rows"]:
            k = g["rows"].index(p)
            l0, l1 = int(g["len0"][k]), int(g["len1"][k])
            s = g["scores"][k]
            cols = torch.cat([torch.arange(l1, device=s.device),
                              torch.tensor([s.shape[1] - 1], device=s.device)])
            rows = torch.cat([torch.arange(l0, device=s.device),
                              torch.tensor([s.shape[0] - 1], device=s.device)])
            return s[rows][:, cols], g["ind0"][k][:l0], g["ind1"][k][:l1]
    return None


def _score_gap(prog, r: dict, kept: dict) -> float:
    """Largest |P_program - P_reference| over the points both kept (by
    slot) and the dustbins."""
    sp, i0, i1 = prog
    sr = r["scores"]

    def common(a, b):
        both = a[:, None] == b[None, :]
        ia, ib = both.any(1).nonzero()[:, 0], both.any(0).nonzero()[:, 0]
        return ia, ib

    a0, b0 = common(i0, kept["ind0"])
    a1, b1 = common(i1, kept["ind1"])
    end = torch.tensor([-1], device=sp.device)
    pa = sp[torch.cat([a0, end])][:, torch.cat([a1, end])]
    pb = sr[torch.cat([b0, end])][:, torch.cat([b1, end])]
    return float((pa - pb).abs().max())


def _sure_matches(r: dict, v0, n0: int, threshold: float) -> torch.Tensor:
    """[n0] slots of image 0 whose match decision in the reference lies
    outside EPS of every test it takes (the best score of its row over
    the second, its column's best over the rest, the threshold), in the
    log assignment's own units; pruned slots (-1 in both) count as sure."""
    sure = torch.ones(n0, dtype=torch.bool, device=v0.device)
    if r["scores"] is None or r["scores"].shape[0] < 2 or r["scores"].shape[1] < 3:
        return sure
    inner = r["scores"][:-1, :-1]
    top_r = inner.topk(2, dim=1).values
    j = inner.argmax(1)
    col = inner[:, j].T  # col[i] = column j(i)
    own = inner.gather(1, j[:, None])[:, 0]
    rival = col.clone()
    rival.scatter_(1, torch.arange(len(j), device=j.device)[:, None], float("-inf"))
    margin = torch.minimum(top_r[:, 0] - top_r[:, 1], (own - rival.amax(1)).abs())
    margin = torch.minimum(margin, (own - math.log(threshold)).abs())
    sure[v0[r["ind0"]]] = margin > EPS
    return sure


def judge(cfg: dict, scan: dict, items: list, w: dict) -> tuple:
    """(readings, stats) over the sampled chunks `items`, each (chunk
    index, outputs); only a chunk's real pairs are compared."""
    feats, hw = scan["feats"], scan["image_hw"]
    n = feats["mask"].shape[1]
    read = dict.fromkeys(NUMBERS, 0.0)
    stats = {"pairs": 0, "matches": 0, "reference_matches": 0, "taught": 0, "layers": 0,
             "kept_share": 0.0, "layers_seen": {}}
    for ci, out in items:
        ii, jj, real = scan["chunks"][ci]
        for p in range(real):
            i, j = int(ii[p]), int(jj[p])
            v0, v1 = _pair_inputs(feats, hw, i, j)[5:]
            program = {"stopped_at": out["stopped_at"][p], "pruned_at0": out["pruned_at0"][p][v0],
                       "pruned_at1": out["pruned_at1"][p][v1]}
            r = reference_pair(cfg, w, feats, hw, i, j, program=program)
            kept = _slots(r, v0, v1, n, n)
            read["lg_stop_gap"] += float(out["layers"][p] != r["layers"])
            read["lg_kept_gap"] += float(r["kept_faults"])
            prog = program_assignment(out, p)
            if prog is not None and r["scores"] is not None and out["layers"][p] == r["layers"]:
                read["lg_score_err"] = max(read["lg_score_err"], _score_gap(prog, r, kept))
            pm = out["matches0"][p].long()
            sure = _sure_matches(r, v0, n, cfg["filter_threshold"])
            differ = feats["mask"][i] & sure & (pm != kept["matches0"])
            n_ref = int((kept["matches0"] >= 0).sum())
            read["lg_match_gap"] = max(read["lg_match_gap"], float(differ.sum()) / max(n_ref, 1))
            stats["taught"] += int((feats["mask"][i] & ~sure & (pm != kept["matches0"])).sum())
            stats["pairs"] += 1
            stats["matches"] += int((pm >= 0).sum())
            stats["reference_matches"] += n_ref
            stats["taught"] += r["taught"]
            stats["layers"] += r["layers"]
            seen = stats["layers_seen"]
            seen[r["layers"]] = seen.get(r["layers"], 0) + 1
            stats["kept_share"] += (len(r["ind0"]) + len(r["ind1"])) / max(len(v0) + len(v1), 1)
    if stats["pairs"]:
        stats["layers"] /= stats["pairs"]
        stats["kept_share"] /= stats["pairs"]
    return read, stats
