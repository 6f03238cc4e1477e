"""K8 built from two source trees, timed in turns on the card.

Each `--build NAME=CSRC` names a directory holding a `flash_attention.cu`
(and the headers it includes) with the package's C interface: the
package's own `onepose_tpu_torch/csrc`, or another commit's unpacked by
`git archive`. Each is compiled as `ops/kernels/_build.py` compiles the
package's (nvcc, sm_90a, all at once) and launched through its C entry
points. At each shape, with 80% valid keys (inputs from a seed, shared by
the builds), TF32 off:

- each build's forward and q / k / v gradients (of sum(out * w)) are first
  held to the plain version: the forward within CARD_FWD_ABS, each
  gradient within CARD_BWD_REL x its max (`ops/kernels/flash_attention.py`'s
  tolerances, which chip_smoke.py holds the package to); beside them, the
  forward's and the plain version's distance from the plain version in
  float64, and the same for each gradient (relative to its max), a witness
  of which of the two an error belongs to;
- then, in turns over the builds in order and back (A, B, B, A), the
  forward and the backward alone (di = sum(o * do), then the dK / dV and
  the dQ kernels), and scaled_dot_product_attention's forward and
  backward with the same bool mask (the library yardstick);
- each time the median of WINDOWS single calls, each after a 256 MB L2
  flush, between CUDA events (`utils.profiling.FlushTimer`).

Bounds: 3 tf32 products for each fp32 flop at the kernel module's
TF32_OPS_PER_S, 4 B H N M D flops forward and 10 B H N M D backward over
the valid keys. The default shapes do the same work: SuperGlue's 256
channels at the SfM budget in K7's chunks of 7 pairs, as 4 heads of 64 (the
production row), 2 of 128 and 1 of 256; `--shape B N M H D` (repeated)
takes others.

Prints the card's name and power limit, a line a check and a turn, and last
{"compare_flash_builds": {"card", "windows", "rows": [{"build", "turn",
"shape", "fwd_ms", "bwd_ms"}], "sdpa": [{"turn", "shape", "fwd_ms",
"bwd_ms"}], "bounds": {shape: {"fwd_ms", "bwd_ms"}}, "checks": [...]}}.

    python -m onepose_tpu_torch.scripts.compare_flash_builds \\
        --build parent=/path/to/parent/onepose_tpu_torch/csrc \\
        --build change=onepose_tpu_torch/csrc [--shape 2 100 90 1 384 ...]
"""

from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
from pathlib import Path

import torch
import torch.nn.functional as F

from onepose_tpu_torch._device import resolve_device
from onepose_tpu_torch.ops.kernels import _build
from onepose_tpu_torch.ops.kernels import flash_attention as fa
from onepose_tpu_torch.utils.profiling import FlushTimer, card_line

SHAPES = ((7, 4096, 4096, 4, 64), (7, 4096, 4096, 2, 128), (7, 4096, 4096, 1, 256))
WINDOWS = 10


def build(builds: dict[str, Path], log=print) -> dict[str, ctypes.CDLL]:
    """Compile each source tree's flash_attention.cu (one nvcc each, all at
    once) into build/torch_kernels/ and bind its C entry points."""
    out_dir = _build.BUILD_DIR
    out_dir.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name, csrc in builds.items():
        so = out_dir / f"libflash_compare_{name}.so"
        procs[name] = (so, subprocess.Popen(
            [_build.nvcc_path(), *_build.NVCC_FLAGS, "-o", str(so), str(csrc / "flash_attention.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    libs = {}
    for name, (so, proc) in procs.items():
        text, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"compare_flash_builds: nvcc failed for {name}:\n{text}")
        libs[name] = _build.bind(so, "flash_attention")
        log(f"[build] {name}: {builds[name] / 'flash_attention.cu'} -> {so.name}")
    return libs


def make_inputs(shape, device: torch.device, seed: int = 0):
    """q, k, v, the cotangent w ([B, rows, H, D], normal) and the key mask
    (80% valid)."""
    b, n, m, h, d = shape
    g = torch.Generator(device=device).manual_seed(seed)
    q, k, v, w = (torch.randn((b, r, h, d), generator=g, device=device) for r in (n, m, m, n))
    mask = torch.rand((b, m), generator=g, device=device) < 0.8
    return q, k, v, w, mask


def _forward(lib, q, k, v, mask, scale):
    """(o, lse) from the build's forward entry point."""
    b, n, h, d = q.shape
    o, lse = torch.empty_like(q), torch.empty((b, n, h), device=q.device)
    err = lib.flash_attention_fwd_launch(
        _build.ptr(q), _build.ptr(k), _build.ptr(v), _build.ptr(mask), _build.ptr(o),
        _build.ptr(lse), b, n, k.shape[1], h, d, scale, _build.stream(q.device))
    _build.check(lib, err, "compare_flash_builds forward")
    return o, lse


def _backward(lib, q, k, v, mask, w, o, lse, scale):
    """(dq, dk, dv) from the build's two backward entry points, di = sum(o *
    w) as FlashAttention.backward computes it."""
    b, n, h, d = q.shape
    di = (o * w).sum(dim=-1)
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    common = tuple(_build.ptr(t) for t in (q, k, v, mask, w, lse, di))
    dims = (b, n, k.shape[1], h, d, scale, _build.stream(q.device))
    _build.check(lib, lib.flash_attention_bwd_dkv_launch(*common, _build.ptr(dk), _build.ptr(dv),
                                                         *dims), "compare_flash_builds dK / dV")
    _build.check(lib, lib.flash_attention_bwd_dq_launch(*common, _build.ptr(dq), *dims),
                 "compare_flash_builds dQ")
    return dq, dk, dv


def check(lib, q, k, v, w, mask) -> dict:
    """The build's forward and gradients against the plain version, and the
    forward's and the plain version's distances from it in float64."""
    scale = 1.0 / q.shape[-1] ** 0.5
    o, lse = _forward(lib, q, k, v, mask, scale)
    grads = _backward(lib, q, k, v, mask, w, o, lse, scale)
    ins = [t.detach().requires_grad_() for t in (q, k, v)]
    ref = fa.flash_attention_plain(*ins, mask, scale)
    ref_grads = torch.autograd.grad(ref, ins, w)
    ref = ref.detach()
    ins64 = [t.detach().double().requires_grad_() for t in (q, k, v)]
    ref64 = fa.flash_attention_plain(*ins64, mask, scale)
    grads64 = torch.autograd.grad(ref64, ins64, w.double())
    ref64 = ref64.detach()
    fwd = float((o - ref).abs().max())

    def rel_to(got, want):
        return [float((a.double() - r.double()).abs().max()) / max(float(r.abs().max()), 1e-30)
                for a, r in zip(got, want)]

    rel = rel_to(grads, ref_grads)
    return {"fwd_max_abs_err": fwd, "grad_rel_err": rel,
            "fwd_f64_err": float((o.double() - ref64).abs().max()),
            "plain_f64_err": float((ref.double() - ref64).abs().max()),
            "grad_f64_rel_err": rel_to(grads, grads64),
            "plain_grad_f64_rel_err": rel_to(ref_grads, grads64),
            "ok": fwd <= fa.CARD_FWD_ABS and max(rel) <= fa.CARD_BWD_REL}


def bounds(shape, mask) -> dict:
    b, n, m, h, d = shape
    work = n * h * d * int(mask.sum())  # multiply-adds of one [N, M] x D product, valid keys
    return {"fwd_ms": 3 * 4 * work / fa.TF32_OPS_PER_S * 1e3,
            "bwd_ms": 3 * 10 * work / fa.TF32_OPS_PER_S * 1e3}


def run(libs: dict[str, ctypes.CDLL], device: torch.device, shapes=SHAPES, windows=WINDOWS,
        log=print) -> dict:
    timer = FlushTimer(device)
    names = list(libs)
    order = names + names[::-1]  # A, B, B, A
    result = {"windows": windows, "rows": [], "sdpa": [], "bounds": {}, "checks": []}
    for shape in shapes:
        q, k, v, w, mask = make_inputs(shape, device)
        scale = 1.0 / shape[-1] ** 0.5
        result["bounds"][str(list(shape))] = bounds(shape, mask)
        for name in names:
            c = {"build": name, "shape": list(shape), **check(libs[name], q, k, v, w, mask)}
            result["checks"].append(c)
            log(f"[check] {name} {shape}: forward {c['fwd_max_abs_err']:.3e}, gradients "
                f"{', '.join(f'{r:.3e}' for r in c['grad_rel_err'])} -> "
                f"{'ok' if c['ok'] else 'DISAGREES'}; from float64: forward "
                f"{c['fwd_f64_err']:.3e}, plain version {c['plain_f64_err']:.3e}; gradients "
                f"from float64 {', '.join(f'{r:.3e}' for r in c['grad_f64_rel_err'])}, plain "
                f"version {', '.join(f'{r:.3e}' for r in c['plain_grad_f64_rel_err'])}")
        amask = mask[:, None, None, :]

        def sdpa(q_, k_, v_):
            return F.scaled_dot_product_attention(
                q_.transpose(1, 2), k_.transpose(1, 2), v_.transpose(1, 2), attn_mask=amask,
                scale=scale).transpose(1, 2)

        for turn, name in enumerate(order):
            lib = libs[name]
            fwd = timer(lambda: _forward(lib, q, k, v, mask, scale), reps=windows)
            o, lse = _forward(lib, q, k, v, mask, scale)
            bwd = timer(lambda: _backward(lib, q, k, v, mask, w, o, lse, scale), reps=windows)
            result["rows"].append({"build": name, "turn": turn, "shape": list(shape),
                                   "fwd_ms": fwd, "bwd_ms": bwd})
            with torch.no_grad():
                s_fwd = timer(lambda: sdpa(q, k, v), reps=windows)
            ins = [t.detach().requires_grad_() for t in (q, k, v)]
            out = sdpa(*ins)
            s_bwd = timer(lambda: torch.autograd.grad(out, ins, w, retain_graph=True), reps=windows)
            result["sdpa"].append({"turn": turn, "shape": list(shape), "fwd_ms": s_fwd,
                                   "bwd_ms": s_bwd})
            del o, lse, ins, out
            log(f"[time] turn {turn} {name} {shape}: forward {fwd:.4f} ms, backward {bwd:.4f} ms; "
                f"scaled_dot_product_attention {s_fwd:.4f} / {s_bwd:.4f} ms")
        bd = result["bounds"][str(list(shape))]
        log(f"[bound] {shape}: forward {bd['fwd_ms']:.4f} ms, backward {bd['bwd_ms']:.4f} ms")
    return result


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--build", action="append", required=True, metavar="NAME=CSRC",
                    help="a name and a directory holding flash_attention.cu (twice or more)")
    ap.add_argument("--windows", type=int, default=WINDOWS)
    ap.add_argument("--shape", type=int, nargs=5, action="append", metavar=("B", "N", "M", "H", "D"),
                    help="a shape [B, N, M, H, D] to compare at (repeated; default SHAPES)")
    ap.add_argument("--device", default="cuda", help="cuda (the kernels have no CPU form)")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    if device.type != "cuda":
        raise SystemExit("compare_flash_builds: times are the card's; run it with --device cuda")
    builds = dict(spec.split("=", 1) for spec in args.build)
    if len(builds) < 2:
        raise SystemExit("compare_flash_builds: name two builds or more")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = card_line()
    print(card)
    result = {"card": card, **run(build({k: Path(v) for k, v in builds.items()}), device,
                                  shapes=[tuple(x) for x in args.shape or SHAPES],
                                  windows=args.windows)}
    print(json.dumps({"compare_flash_builds": result}))
    if not all(c["ok"] for c in result["checks"]):
        raise SystemExit("compare_flash_builds: a build disagrees with the plain version")
    return result


if __name__ == "__main__":
    main()
