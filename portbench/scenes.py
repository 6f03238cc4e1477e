"""The benchmark's traffic: inputs made on the device from the seed and a
traffic file's parameters, the same for the program and the reference.

`serve_pool` plants frames that the serving pipeline can match: each
object is seen in a few source images (random textures); the reference
SuperPoint (fp32) finds their keypoints, of which the best of each 16 x 16
block are lifted to 3D at random depths under each source's pose, and the
map's descriptors and leaves are the reference's descriptors there (the
leaves with noise). A crop is a source shifted by whole 8-pixel cells (so
SuperPoint's cell grid sees the same content) plus optional pixel noise,
with the principal point shifted alike: the source's pose is the crop's
true pose, and the planted keypoints project where the crop shows them.

`scan` is a mapping scan: frames on an orbit drawn from the seed, each
paired with its nearest views by viewing angle, the pair list deduplicated
to a fixed length and cut into fixed chunks as the port's pair matcher
cuts it; the frames' features are extracted by the reference SuperPoint.
"""

from __future__ import annotations

import hashlib
import math

import torch

from portbench.reference import nets


def sub_seed(seed: int, tag: str) -> int:
    """An independent 63-bit seed for one use (`tag`) of the run's seed."""
    return int.from_bytes(hashlib.sha256(f"{seed}:{tag}".encode()).digest()[:8], "little") >> 1


def _textures(n: int, img: int, g: torch.Generator, device) -> torch.Tensor:
    """[n, img, img, 1] random textures in [0, 1]: noise on a 4-pixel grid
    upsampled, plus a little fine noise."""
    coarse = torch.rand((n, 1, img // 4, img // 4), generator=g, device=device)
    x = torch.nn.functional.interpolate(coarse, size=(img, img), mode="bicubic",
                                        align_corners=False)
    x = x + 0.1 * torch.rand((n, 1, img, img), generator=g, device=device)
    lo = x.amin(dim=(1, 2, 3), keepdim=True)
    hi = x.amax(dim=(1, 2, 3), keepdim=True)
    return ((x - lo) / (hi - lo)).permute(0, 2, 3, 1).contiguous()


def _random_rotations(n: int, g: torch.Generator, device) -> torch.Tensor:
    q = torch.randn((n, 4), generator=g, device=device)
    w, x, y, z = (q / q.norm(dim=-1, keepdim=True)).unbind(-1)
    return torch.stack([
        1 - 2 * (y * y + z * z), 2 * (x * y - z * w), 2 * (x * z + y * w),
        2 * (x * y + z * w), 1 - 2 * (x * x + z * z), 2 * (y * z - x * w),
        2 * (x * z - y * w), 2 * (y * z + x * w), 1 - 2 * (x * x + y * y)], -1).reshape(n, 3, 3)


def intrinsics(img: int, focal: float, device, shift=None) -> torch.Tensor:
    """[n, 3, 3] pinhole K with the principal point at the centre plus
    `shift` [n, 2] pixels (x, y), or [3, 3] without a shift."""
    K = torch.tensor([[focal, 0.0, img / 2], [0.0, focal, img / 2], [0.0, 0.0, 1.0]],
                     device=device)
    if shift is None:
        return K
    K = K.expand(shift.shape[0], 3, 3).clone()
    K[:, :2, 2] += shift
    return K


def features(sp: dict, images: torch.Tensor, k: int, threshold: float, border: int,
             nms_radius: int, block: int = 16) -> dict:
    """The reference SuperPoint's keypoints [n, k, 2], scores, mask and
    descriptors [n, k, C] (0 at empty slots) of images [n, H, W, 1]."""
    outs = []
    for s in range(0, images.shape[0], block):
        d = nets.superpoint(sp, images[s:s + block], nms_radius)
        sel = nets.select_keypoints(d["score"], k, threshold, border)
        sel["descriptors"] = nets.sample_descriptors(sel["keypoints"], d["desc"]) * sel[
            "mask"][..., None]
        outs.append(sel)
    return {key: torch.cat([o[key] for o in outs]) for key in outs[0]}


def _spread(kp: torch.Tensor, mask: torch.Tensor, cell: int, k: int) -> torch.Tensor:
    """The first k valid keypoints (they come best first) that are each the
    best of their `cell` x `cell` pixel block: a map keeps no two points
    whose descriptors are near copies of each other."""
    block = (kp[:, 1].long() // cell) * 65536 + kp[:, 0].long() // cell
    order = torch.arange(kp.shape[0], device=kp.device)
    block = torch.where(mask, block, -1 - order)  # empty slots never share a block
    first = torch.full((int(block.max()) + 1,), kp.shape[0], device=kp.device, dtype=torch.long)
    valid = block >= 0
    first.scatter_reduce_(0, block[valid], order[valid], "amin")
    keep = valid & (first[block.clamp(min=0)] == order)
    return keep & (torch.cumsum(keep.long(), 0) <= k)


def _object_map(feats: dict, idx: slice, R: torch.Tensor, t: torch.Tensor, Kinv: torch.Tensor,
                n_points: int, n_valid: int, leaves: int, leaf_valid: torch.Tensor,
                tr: dict, g: torch.Generator, device) -> dict:
    """One object's map of n_points slots, the first n_valid valid: each
    source's best keypoints (an equal share) lifted to 3D, then distractor
    points if they run out."""
    kp, desc, mask = (feats[key][idx] for key in ("keypoints", "descriptors", "mask"))
    n_src = kp.shape[0]
    lo, hi = tr["depth"]
    pts, dsc = [], []
    per_source = -(-n_valid // n_src)
    for s in range(n_src):
        m = _spread(kp[s], mask[s], tr["map_spacing"], per_source)
        uv1 = torch.cat([kp[s][m], torch.ones_like(kp[s][m][:, :1])], dim=-1)
        z = lo + (hi - lo) * torch.rand((uv1.shape[0], 1), generator=g, device=device)
        cam = (uv1 @ Kinv.T) * z
        pts.append((cam - t[s]) @ R[s])  # world = R^T (cam - t)
        dsc.append(desc[s][m])
    pts, dsc = torch.cat(pts)[:n_valid], torch.cat(dsc)[:n_valid]
    c = desc.shape[-1]
    short = n_valid - pts.shape[0]
    if short > 0:  # distractors: random points and descriptors
        pts = torch.cat([pts, 0.1 * torch.randn((short, 3), generator=g, device=device)])
        dsc = torch.cat([dsc, nets.l2_normalize(torch.randn((short, c), generator=g,
                                                            device=device))])
    pad = n_points - n_valid
    points3d = torch.cat([pts, torch.zeros((pad, 3), device=device)])
    desc3d = torch.cat([dsc, torch.zeros((pad, c), device=device)])
    noise = tr["leaf_noise"] / math.sqrt(c) * torch.randn((n_points, leaves, c), generator=g,
                                                          device=device)
    leaf_desc = nets.l2_normalize(desc3d[:, None, :] + noise)
    mask3d = torch.arange(n_points, device=device) < n_valid
    leaf_mask = (torch.arange(leaves, device=device)[None, :] < leaf_valid[:, None]) & mask3d[:, None]
    return {"points3d": points3d, "desc3d": desc3d, "leaf_desc": leaf_desc, "mask3d": mask3d,
            "leaf_mask": leaf_mask}


def serve_pool(sp: dict, cfg: dict, tr: dict, seed: int, device) -> dict:
    """{"batches": [each {images, K, draws, anno, pose_true}], "stats"}.

    anno holds unbatched [N3, ...] fields for one object, or [B, N3, ...]
    per frame (`tr["per_frame_maps"]`) for a roster."""
    g = torch.Generator(device=device).manual_seed(sub_seed(seed, "scene"))
    img, b = cfg["image_size"], tr["batch"]
    n_obj, n_src = tr["objects"], tr["sources_per_object"]
    n_points, leaves = cfg["shape3d"], cfg["num_leaf"]
    src = _textures(n_obj * n_src, img, g, device)
    feats = features(sp, src, cfg["max_keypoints"], cfg["keypoint_threshold"], cfg["border"],
                     cfg["nms_radius"])
    K0 = intrinsics(img, cfg["focal"], device)
    R = _random_rotations(n_obj * n_src, g, device)
    t = torch.zeros((n_obj * n_src, 3), device=device)
    t[:, :2] = 0.02 * (2 * torch.rand((n_obj * n_src, 2), generator=g, device=device) - 1)
    # Every seed gets the same sizes in the same order (the order, too,
    # moves the kernels' time): the objects' valid points evenly spread
    # over the traffic's range, each point's valid leaves cycling through
    # theirs.
    lo, hi = tr["valid_points"]
    llo, lhi = tr["valid_leaves"]
    leaf_valid = llo + torch.arange(n_points, device=device) % (lhi - llo + 1)
    maps = []
    for o in range(n_obj):
        n_valid = lo + round(o * (hi - lo) / max(n_obj - 1, 1))
        sl = slice(o * n_src, (o + 1) * n_src)
        maps.append(_object_map(feats, sl, R[sl], t[sl], torch.linalg.inv(K0), n_points, n_valid,
                                leaves, leaf_valid, tr, g, device))
    batches = []
    per_obj = b // n_obj
    for _ in range(tr["pool"]):
        obj = torch.arange(b, device=device) // per_obj
        s = obj * n_src + torch.randint(0, n_src, (b,), generator=g, device=device)
        cells = tr["shift_cells"]
        shift = 8 * torch.randint(-cells, cells + 1, (b, 2), generator=g, device=device)
        images = torch.stack([torch.roll(src[i], (int(shift[j, 1]), int(shift[j, 0])), (0, 1))
                              for j, i in enumerate(s.tolist())])
        images = (images + tr["image_noise"] * torch.randn(images.shape, generator=g,
                                                           device=device)).clamp(0.0, 1.0)
        pose = torch.eye(4, device=device).repeat(b, 1, 1)
        pose[:, :3, :3], pose[:, :3, 3] = R[s], t[s]
        if tr["per_frame_maps"]:
            anno = {key: torch.stack([maps[o][key] for o in obj.tolist()]) for key in maps[0]}
        else:
            anno = maps[0]
        batches.append({
            "images": images.contiguous(), "K": intrinsics(img, cfg["focal"], device,
                                                           shift.float()),
            "draws": torch.rand((b, cfg["ransac_hypotheses"], 3), generator=g, device=device),
            "anno": anno, "pose_true": pose})
    stats = {"valid_points": [int(m["mask3d"].sum()) for m in maps],
             "valid_leaves": [float(m["leaf_mask"].sum()) for m in maps],
             "source_keypoints": int(feats["mask"].sum())}
    return {"batches": batches, "stats": stats}


def orbit_pairs(n_frames: int, covis: int, n_pairs: int, g: torch.Generator, device) -> list:
    """Frames on an orbit (azimuth evenly spread with jitter, elevation
    random), each paired with its `covis` nearest views by viewing angle;
    the pairs (i < j) deduplicated, the `n_pairs` of smallest angle kept
    (every seed the same number, so the same work), in order."""
    az = (torch.arange(n_frames, device=device) + 0.6 * (torch.rand(
        n_frames, generator=g, device=device) - 0.5)) * (2 * math.pi / n_frames)
    el = 0.2 + 0.6 * torch.rand(n_frames, generator=g, device=device)
    view = torch.stack([el.cos() * az.cos(), el.cos() * az.sin(), el.sin()], -1)
    angle = torch.arccos((view @ view.T).clamp(-1.0, 1.0))
    angle.fill_diagonal_(float("inf"))
    near = torch.topk(angle, covis, dim=1, largest=False).indices.tolist()
    pairs = {(min(i, j), max(i, j)) for i in range(n_frames) for j in near[i]}
    if len(pairs) < n_pairs:
        raise ValueError(f"the orbit gives {len(pairs)} pairs, the traffic asks {n_pairs}")
    return sorted(sorted(pairs, key=lambda p: float(angle[p]))[:n_pairs])


def scan(sp: dict, cfg: dict, tr: dict, seed: int, device, chunk: int) -> dict:
    """{"feats": {keypoints, descriptors, scores, mask} [F, N, ...],
    "image_hw", "pairs": [(i, j)], "chunks": [(ii, jj, n_real)]}: the chunks
    of `chunk` pairs in order, a last short one padded with its first pair,
    as the port's chunked matcher pads it."""
    g = torch.Generator(device=device).manual_seed(sub_seed(seed, "scene"))
    img, n = cfg["image_size"], tr["frames"]
    pairs = orbit_pairs(n, tr["covis"], tr["pairs"], g, device)
    frames = _textures(n, img, g, device)
    feats = features(sp, frames, cfg["max_keypoints"], cfg["keypoint_threshold"], cfg["border"],
                     cfg["nms_radius"])
    chunks = []
    for s in range(0, len(pairs), chunk):
        sel = pairs[s:s + chunk]
        real = len(sel)
        sel = sel + [sel[0]] * (chunk - real)
        ii = torch.tensor([p[0] for p in sel], device=device)
        jj = torch.tensor([p[1] for p in sel], device=device)
        chunks.append((ii, jj, real))
    return {"feats": feats, "image_hw": (img, img), "pairs": pairs, "chunks": chunks}
