"""Where K8's warp-specialised kernels spend a tile, by phase, on the card.

Builds an instrumented copy of `csrc/flash_attention.cu` (into
`build/torch_kernels/`; the kernel source itself carries no counters):
`clock64` stamps at the phase boundaries of the six warp-specialised
kernels (heads of up to 64 channels, and the wide ones of 65 to 128 and
256), summed by thread 0 of each warpgroup over its tiles and over the
blocks. A consumer's tile:
  wait full       its stage's "full" barrier (the producer's split)
  first products  the score product (dK / dV and dQ: and dP), issue to wait
  partials        the wide kernels' sum of the slices' partial score tiles
                  (their wait for the other consumers and, at D = 256, the
                  other block of the cluster; 0 in the others)
  softmax         the online softmax (dK / dV, dQ: p and ds)
  last products   P V (dV and dK; dQ) and the fp32 adds
A producer's tile:
  wait TMA        the tile's TMA copies landing
  split           lo parts and transposed tiles, the handover
  wait empty      the consumers' release of the stage, then the next copies
The D <= 64 kernels run once at [7, 4096, 4096, 4, 64], the wide ones at
WIDE_SHAPE [7, 4096, 4096, 1, 256] (clusters of two blocks; --wide-shape
takes another, such as 7 4096 4096 2 128), with 80%
valid keys (inputs from a seed; di and lse stand in by do and lse of the
forward's shape: the phases do not depend on their values), each after a
warm-up.

Prints cycles a tile for each phase (the consumers' averaged over all of
them, the producer's over blocks), the instrumented kernel's ms (CUDA
events; the counters cost a little), the card's name and power limit, and
last {"profile_flash_phases": {"card", "shapes", "kernels": {name: {"ms",
"tiles", phase: cycles}}}}.

    python -m onepose_tpu_torch.scripts.profile_flash_phases [--wide-shape 7 4096 4096 2 128]
"""

from __future__ import annotations

import argparse
import ctypes
import json
import subprocess

import torch

from onepose_tpu_torch._device import resolve_device
from onepose_tpu_torch.ops.kernels import _build
from onepose_tpu_torch.utils.profiling import card_line

SHAPE = (7, 4096, 4096, 4, 64)  # [B, N, M, H, D]: SuperGlue's heads at the SfM budget
WIDE_SHAPE = (7, 4096, 4096, 1, 256)  # the same work as one head of 256 channels
CONSUMER = ("wait full", "first products", "partials", "softmax", "last products")
PRODUCER = ("wait TMA", "split", "wait empty")
KERNELS = ("flash_fwd_ws", "flash_bwd_dkv_ws", "flash_bwd_dq_ws",
           "flash_fwd_wide", "flash_bwd_dkv_wide", "flash_bwd_dq_wide")
_ROW = 9  # counters a kernel: 5 consumer phases, 3 producer phases, warpgroups that counted

_HEAD = f"""
__device__ unsigned long long g_phases[{len(KERNELS)}][{_ROW}];
#define PHASES_INIT unsigned long long _t = clock64(), _acc[8] = {{0, 0, 0, 0, 0, 0, 0, 0}};
#define PHASE(k) {{ const unsigned long long _n = clock64(); _acc[k] += _n - _t; _t = _n; }}
#define PHASES_PUT(id, lo, hi) {{ if ((threadIdx.x & 127) == 0) {{ \\
  for (int _i = lo; _i < hi; ++_i) atomicAdd(&g_phases[id][_i], _acc[_i]); \\
  if (lo == 0) atomicAdd(&g_phases[id][8], 1ull); }} }}
"""
_TAIL = f"""
extern "C" int flash_phases_read(unsigned long long* out) {{
  cudaError_t e = cudaMemcpyFromSymbol(out, g_phases, sizeof(g_phases));
  if (e != cudaSuccess) return e;
  static unsigned long long zero[{len(KERNELS) * _ROW}] = {{0}};
  return cudaMemcpyToSymbol(g_phases, zero, sizeof(zero));
}}
"""
# Per kernel: the lines after which the first products, the partials (the
# wide kernels) and the softmax (weights) end.
_ANCHORS = {
    "flash_fwd_ws": ("[=] { turn_pass(wg); });\n", None,
                     "online_softmax<T>(sc, valid, sl2, m_run, l_run, alpha);\n"),
    "flash_bwd_dkv_ws": ("mma3_raw<T>(dpt, fh, fl, vw, st + 2 * T * kCW, st + 3 * T * kCW, w, g, t);\n",
                         None, "dkv_weights<T>(sst, dpt, kvalid, lse_c, di_c, sl2);\n"),
    "flash_bwd_dq_ws": ("mma3_raw<T>(dp, fh, fl, dow, st + 2 * T * kCW, st + 3 * T * kCW, w, g, t);\n",
                        None, "dq_weights<T>(sc, dp, valid, lse_r, di_r, sl2);\n"),
    "flash_fwd_wide": ("slice_scores<T>(sc[0], fh, fl, qw, st, w, g, t);\n",
                       "sum_partials<CL>(sc, parts, recv, bars + 2, it, wg, rank);\n",
                       "online_softmax<T>(sc[0], valid, sl2, m_run, l_run, alpha);\n"),
    "flash_bwd_dkv_wide": ("slice_scores<T>(sd[1], fh, fl, vw, st + 2 * kTile, w, g, t);\n",
                           "sum_partials<CL>(sd, parts, recv, bars + 2, it, wg, rank);\n",
                           "dkv_weights<T>(sd[0], sd[1], kvalid, lse_c, di_c, sl2);\n"),
    "flash_bwd_dq_wide": ("slice_scores<T>(sd[1], fh, fl, dow, st + 2 * kTile, w, g, t);\n",
                          "sum_partials<CL>(sd, parts, recv, bars + 2, it, wg, rank);\n",
                          "dq_weights<T>(sd[0], sd[1], valid, lse_r, di_r, sl2);\n"),
}
# The producers' loops: head, end of the split, and the kernels' call.
_PRODUCERS = {
    "produce": ("    split(it);\n    stage_full(s);\n", "    produce(\n"),
    "produce_wide": ("    hopper::bar_arrive(bar_wide_full(s), kWsThreads);\n", "    produce_wide(\n"),
}


def _after(text: str, anchor: str, add: str, start: int = 0) -> str:
    i = text.find(anchor, start)
    if i < 0:
        raise RuntimeError(f"profile_flash_phases: {anchor.strip()!r} is no longer in the source")
    i += len(anchor)
    return text[:i] + add + text[i:]


def _instrument_producer(src: str, name: str, split_end: str) -> str:
    """A template parameter names the kernel's row; stamps around the TMA
    wait, the split and the wait for an empty stage."""
    head = f"template <typename Load, typename Split>\n__device__ __forceinline__ void {name}("
    if head not in src:
        raise RuntimeError(f"profile_flash_phases: {name}() is no longer in the source")
    src = src.replace(head, "template <int KID, typename Load, typename Split>\n"
                            f"__device__ __forceinline__ void {name}(")
    p0 = src.index(f"void {name}(")
    loop = src.index("  for (int it = 0; it < tiles; ++it) {\n", p0)
    src = src[:loop] + "  PHASES_INIT\n" + src[loop:]
    wait = "    hopper::mbar_wait(landed + s, (it >> 1) & 1);  // tile it's rows are in\n"
    src = _after(src, wait, "    PHASE(5)\n", p0)
    i = src.index("    }\n" + wait, p0) + len("    }\n")
    src = src[:i] + "    PHASE(7)\n" + src[i:]
    src = _after(src, split_end, "    PHASE(6)\n", p0)
    return _after(src, "    PHASE(6)\n  }\n", "  PHASES_PUT(KID, 5, 8)\n", p0)


def instrumented_source() -> str:
    """csrc/flash_attention.cu with the phase counters (see the module)."""
    src = (_build.CSRC / "flash_attention.cu").read_text()
    for name in ("common.cuh", "hopper.cuh"):
        src = src.replace(f'#include "{name}"', f'#include "{_build.CSRC / name}"')
    src = _after(src, "#include <initializer_list>\n", _HEAD)
    for name, (split_end, _) in _PRODUCERS.items():
        src = _instrument_producer(src, name, split_end)
    for kid, name in enumerate(KERNELS):
        wide = name.endswith("_wide")
        k0 = src.index("\n" + name + "(")
        k1 = src.index("\n}\n", k0)
        body = src[k0:k1]
        call = _PRODUCERS["produce_wide" if wide else "produce"][1]
        body = body.replace(call, call.replace("(\n", f"<{kid}>(\n"), 1)
        alloc = body.index("hopper::regs_alloc<")
        body = _after(body, ">();\n", "    PHASES_INIT\n", alloc)
        c0 = body.index("PHASES_INIT")
        full = ("      hopper::bar_sync(bar_wide_full(s), kWsThreads);\n" if wide
                else "    hopper::bar_sync(bar_full(s, wg), 256);\n")
        body = _after(body, full, "    PHASE(0)\n", c0)
        first, partials, soft = _ANCHORS[name]
        body = _after(body, first, "    PHASE(1)\n", c0)
        if partials is not None:
            body = _after(body, partials, "    PHASE(2)\n", c0)
        body = _after(body, soft, "    PHASE(3)\n", c0)
        # The consumer's tile loop ends at its last closing brace of that
        # depth; the counters go out before the consumer's branch (wide) or
        # the kernel (the others) ends.
        indent = "    " if wide else "  "
        end = body.index("\n  }\n  wide_end<CL>();") if wide else len(body)
        loop_end = body.rindex(f"\n{indent}}}\n", 0, end)
        body = body[:loop_end + 1] + "    PHASE(4)\n" + body[loop_end + 1:]
        put = f"\n    PHASES_PUT({kid}, 0, 5)"
        if wide:
            end = body.index("\n  }\n  wide_end<CL>();")
            body = body[:end] + put + body[end:]
        else:
            body += put
        src = src[:k0] + body + src[k1:]
    return src + _TAIL


def build(log=print) -> ctypes.CDLL:
    """Compile the instrumented copy (nvcc, as the kernels are) and bind it."""
    out_dir = _build.BUILD_DIR
    out_dir.mkdir(parents=True, exist_ok=True)
    cu, so = out_dir / "flash_phases.cu", out_dir / "libflash_phases.so"
    cu.write_text(instrumented_source())
    flags = [f for f in _build.NVCC_FLAGS if not f.startswith("--ptxas-options")]
    done = subprocess.run([_build.nvcc_path(), *flags, "-o", str(so), str(cu)],
                          capture_output=True, text=True)
    if done.returncode != 0:
        raise RuntimeError(f"profile_flash_phases: nvcc failed:\n{done.stdout}{done.stderr}")
    lib = _build.bind(so, "flash_attention")
    lib.flash_phases_read.argtypes = [ctypes.c_void_p]
    log(f"[build] {so.name}: instrumented flash_attention.cu compiled")
    return lib


def run(lib, device: torch.device, seed: int = 0, wide_shape=WIDE_SHAPE) -> dict:
    """{kernel: {"ms", "tiles", "shape", phase: cycles a tile}}: the D <= 64
    kernels at SHAPE, the wide ones at wide_shape."""
    g = torch.Generator(device=device).manual_seed(seed)
    stream = torch.cuda.current_stream(device).cuda_stream
    ptr = lambda t: t.data_ptr()  # noqa: E731
    counts = (ctypes.c_ulonglong * (len(KERNELS) * _ROW))()
    rows = {}
    for shape, names, (fwd_t, bwd_t) in ((SHAPE, KERNELS[:3], (64, 32)),
                                         (tuple(wide_shape), KERNELS[3:], (32, 16))):
        b, n, m, h, d = shape
        q, k, v, w = (torch.randn((b, r, h, d), generator=g, device=device) for r in (n, m, m, n))
        mask = torch.rand((b, m), generator=g, device=device) < 0.8
        o, lse = torch.empty_like(q), torch.empty((b, n, h), device=device)
        dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
        scale = 1.0 / d ** 0.5
        common = (ptr(q), ptr(k), ptr(v), ptr(mask))
        calls = (
            (lambda: lib.flash_attention_fwd_launch(
                *common, ptr(o), ptr(lse), b, n, m, h, d, scale, stream), m // fwd_t),
            (lambda: lib.flash_attention_bwd_dkv_launch(
                *common, ptr(w), ptr(lse), ptr(lse), ptr(dk), ptr(dv), b, n, m, h, d, scale,
                stream), n // bwd_t),
            (lambda: lib.flash_attention_bwd_dq_launch(
                *common, ptr(w), ptr(lse), ptr(lse), ptr(dq), b, n, m, h, d, scale, stream),
             m // bwd_t),
        )
        for name, (call, tiles) in zip(names, calls):
            kid = KERNELS.index(name)
            for _ in range(2):  # a warm-up, then the measured run
                lib.flash_phases_read(counts)  # zeroes the counters
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                start.record(stream=torch.cuda.current_stream(device))
                err = call()
                end.record(stream=torch.cuda.current_stream(device))
                torch.cuda.synchronize(device)
                if err != 0:
                    raise RuntimeError(f"profile_flash_phases: {name} failed ({err})")
            lib.flash_phases_read(counts)
            vals = list(counts)[kid * _ROW:(kid + 1) * _ROW]
            consumers = vals[8]  # warpgroups that counted: two a block
            row = {"ms": start.elapsed_time(end), "tiles": tiles, "shape": list(shape)}
            row.update({p: vals[i] / consumers / tiles for i, p in enumerate(CONSUMER)})
            row.update({p: vals[5 + i] / (consumers / 2) / tiles for i, p in enumerate(PRODUCER)})
            rows[name] = row
    return rows


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default="cuda", help="cuda (the kernels have no CPU form)")
    ap.add_argument("--wide-shape", type=int, nargs=5, default=list(WIDE_SHAPE),
                    metavar=("B", "N", "M", "H", "D"),
                    help="the wide kernels' shape (D of 65 to 128, or 256)")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    if device.type != "cuda":
        raise SystemExit("profile_flash_phases: the phases are the card's; run it with --device cuda")
    card = card_line()
    rows = run(build(), device, wide_shape=args.wide_shape)
    print(card)
    for name, row in rows.items():
        phases = ", ".join(f"{p} {row[p]:.0f}" for p in CONSUMER + PRODUCER)
        print(f"{name} {row['shape']}: {row['ms']:.4f} ms instrumented, {row['tiles']} tiles a block; "
              f"cycles a tile: {phases}")
    result = {"profile_flash_phases": {"card": card, "shapes": [list(SHAPE), args.wide_shape],
                                       "kernels": rows}}
    print(json.dumps(result))
    return result


if __name__ == "__main__":
    main()
