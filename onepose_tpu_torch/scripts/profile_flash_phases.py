"""Where K8's warp-specialised kernels spend a tile, by phase, on the card.

Builds an instrumented copy of `csrc/flash_attention.cu` (into
`build/torch_kernels/`; the kernel source itself carries no counters):
`clock64` stamps at the phase boundaries of the three warp-specialised
kernels (heads of up to 64 channels), summed by thread 0 of each
warpgroup over its tiles and over the blocks. A consumer's tile:
  wait full       its stage's "full" barrier (the producer's split)
  first products  the score product (dK / dV and dQ: and dP), issue to wait
  softmax         the online softmax (dK / dV, dQ: p and ds)
  last products   P V (dV and dK; dQ) and the fp32 adds
A producer's tile:
  wait TMA        the tile's TMA copies landing
  split           lo parts and transposed tiles, the handover
  wait empty      the consumers' release of the stage, then the next copies
Each kernel runs once at [7, 4096, 4096, 4, 64] with 80% valid keys (inputs
from a seed; di and lse stand in by do and lse of the forward's shape:
the phases do not depend on their values), after a warm-up.

Prints cycles a tile for each phase (the consumers' averaged over both,
the producer's over blocks), the instrumented kernel's ms (CUDA events;
the counters cost a little), the card's name and power limit, and last
{"profile_flash_phases": {"card", "shape", "kernels": {name: {"ms", "tiles", phase: cycles}}}}.

    python -m onepose_tpu_torch.scripts.profile_flash_phases
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
CONSUMER = ("wait full", "first products", "softmax", "last products")
PRODUCER = ("wait TMA", "split", "wait empty")
KERNELS = ("flash_fwd_ws", "flash_bwd_dkv_ws", "flash_bwd_dq_ws")

_HEAD = """
__device__ unsigned long long g_phases[3][8];
#define PHASES_INIT unsigned long long _t = clock64(), _acc[8] = {0, 0, 0, 0, 0, 0, 0, 0};
#define PHASE(k) { const unsigned long long _n = clock64(); _acc[k] += _n - _t; _t = _n; }
#define PHASES_PUT(id, lo, hi) { if ((threadIdx.x & 127) == 0) { \\
  for (int _i = lo; _i < hi; ++_i) atomicAdd(&g_phases[id][_i], _acc[_i]); \\
  if (lo == 0) atomicAdd(&g_phases[id][7], 1ull); } }
"""
_TAIL = """
extern "C" int flash_phases_read(unsigned long long* out) {
  cudaError_t e = cudaMemcpyFromSymbol(out, g_phases, sizeof(unsigned long long) * 24);
  if (e != cudaSuccess) return e;
  static unsigned long long zero[24] = {0};
  return cudaMemcpyToSymbol(g_phases, zero, sizeof(zero));
}
"""
# Per kernel: the line after which the first products end and the one
# after which the softmax (weights) ends.
_ANCHORS = {
    "flash_fwd_ws": ("[=] { turn_pass(wg); });\n",
                     "online_softmax<T>(sc, valid, sl2, m_run, l_run, alpha);\n"),
    "flash_bwd_dkv_ws": ("mma3_raw<T>(dpt, fh, fl, vw, st + 2 * T * kCW, st + 3 * T * kCW, w, g, t);\n",
                         "dkv_weights<T>(sst, dpt, kvalid, lse_c, di_c, sl2);\n"),
    "flash_bwd_dq_ws": ("mma3_raw<T>(dp, fh, fl, dow, st + 2 * T * kCW, st + 3 * T * kCW, w, g, t);\n",
                        "dq_weights<T>(sc, dp, valid, lse_r, di_r, sl2);\n"),
}


def _after(text: str, anchor: str, add: str, start: int = 0) -> str:
    i = text.find(anchor, start)
    if i < 0:
        raise RuntimeError(f"profile_flash_phases: {anchor.strip()!r} is no longer in the source")
    i += len(anchor)
    return text[:i] + add + text[i:]


def instrumented_source() -> str:
    """csrc/flash_attention.cu with the phase counters (see the module)."""
    src = (_build.CSRC / "flash_attention.cu").read_text()
    for name in ("common.cuh", "hopper.cuh"):
        src = src.replace(f'#include "{name}"', f'#include "{_build.CSRC / name}"')
    src = _after(src, "#include <initializer_list>\n", _HEAD)
    # The producer's loop (shared): a template parameter names the kernel's row.
    head = "template <typename Load, typename Split>\n__device__ __forceinline__ void produce("
    if head not in src:
        raise RuntimeError("profile_flash_phases: produce() is no longer in the source")
    src = src.replace(head, "template <int KID, typename Load, typename Split>\n"
                            "__device__ __forceinline__ void produce(")
    p0 = src.index("void produce(")
    src = _after(src, "  hopper::bar_sync(kBarProducer, 128);  // the mbarriers are initialised\n",
                 "  PHASES_INIT\n", p0)
    src = _after(src, "    }\n    hopper::mbar_wait(landed + s, (it >> 1) & 1);  // tile it's rows are in\n",
                 "    PHASE(4)\n", p0)
    src = src.replace("    }\n    hopper::mbar_wait(landed + s, (it >> 1) & 1);",
                      "    }\n    PHASE(6)\n    hopper::mbar_wait(landed + s, (it >> 1) & 1);", 1)
    src = _after(src, "    split(it);\n    stage_full(s);\n", "    PHASE(5)\n", p0)
    src = _after(src, "    PHASE(5)\n  }\n", "  PHASES_PUT(KID, 4, 7)\n", p0)
    for kid, name in enumerate(KERNELS):
        k0 = src.index("\n" + name + "(")
        k1 = src.index("\n}\n", k0)
        body = src[k0:k1]
        body = body.replace("    produce(\n", f"    produce<{kid}>(\n", 1)
        body = _after(body, "  hopper::regs_alloc<kConsumerRegs>();\n", "  PHASES_INIT\n")
        c0 = body.index("PHASES_INIT")
        body = _after(body, "    hopper::bar_sync(bar_full(s, wg), 256);\n", "    PHASE(0)\n", c0)
        first, soft = _ANCHORS[name]
        body = _after(body, first, "    PHASE(1)\n", c0)
        body = _after(body, soft, "    PHASE(2)\n", c0)
        loop_end = body.rindex("\n  }\n")
        body = body[:loop_end + 1] + "    PHASE(3)\n" + body[loop_end + 1:]
        body += f"\n  PHASES_PUT({kid}, 0, 4)"
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
    lib = ctypes.CDLL(str(so))
    for fn, (args, res) in _build.SIGNATURES["flash_attention"].items():
        getattr(lib, fn).argtypes, getattr(lib, fn).restype = args, res
    lib.flash_phases_read.argtypes = [ctypes.c_void_p]
    log(f"[build] {so.name}: instrumented flash_attention.cu compiled")
    return lib


def run(lib, device: torch.device, seed: int = 0) -> dict:
    """{kernel: {"ms", "tiles", phase: cycles a tile}} at SHAPE."""
    b, n, m, h, d = SHAPE
    g = torch.Generator(device=device).manual_seed(seed)
    q, k, v, w = (torch.randn((b, r, h, d), generator=g, device=device) for r in (n, m, m, n))
    mask = torch.rand((b, m), generator=g, device=device) < 0.8
    o, lse = torch.empty_like(q), torch.empty((b, n, h), device=device)
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    stream = torch.cuda.current_stream(device).cuda_stream
    ptr, scale = (lambda t: t.data_ptr()), 1.0 / d ** 0.5
    common = (ptr(q), ptr(k), ptr(v), ptr(mask))
    calls = {
        "flash_fwd_ws": (lambda: lib.flash_attention_fwd_launch(
            *common, ptr(o), ptr(lse), b, n, m, h, d, scale, stream), m // 64),
        "flash_bwd_dkv_ws": (lambda: lib.flash_attention_bwd_dkv_launch(
            *common, ptr(w), ptr(lse), ptr(lse), ptr(dk), ptr(dv), b, n, m, h, d, scale, stream),
            n // 32),
        "flash_bwd_dq_ws": (lambda: lib.flash_attention_bwd_dq_launch(
            *common, ptr(w), ptr(lse), ptr(lse), ptr(dq), b, n, m, h, d, scale, stream), m // 32),
    }
    counts = (ctypes.c_ulonglong * 24)()
    rows = {}
    for kid, name in enumerate(KERNELS):
        call, tiles = calls[name]
        for _ in range(2):  # a warm-up, then the measured run
            lib.flash_phases_read(counts)  # zeroes the counters
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record(stream=torch.cuda.current_stream(device))
            err = call()
            end.record(stream=torch.cuda.current_stream(device))
            torch.cuda.synchronize(device)
            if err != 0:
                raise RuntimeError(f"profile_flash_phases: {name} failed ({err})")
        lib.flash_phases_read(counts)
        vals = list(counts)[kid * 8:kid * 8 + 8]
        consumers = vals[7]  # warpgroups that counted: two a block
        row = {"ms": start.elapsed_time(end), "tiles": tiles}
        row.update({p: vals[i] / consumers / tiles for i, p in enumerate(CONSUMER)})
        row.update({p: vals[4 + i] / (consumers / 2) / tiles for i, p in enumerate(PRODUCER)})
        rows[name] = row
    return rows


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default="cuda", help="cuda (the kernels have no CPU form)")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    if device.type != "cuda":
        raise SystemExit("profile_flash_phases: the phases are the card's; run it with --device cuda")
    card = card_line()
    rows = run(build(), device)
    print(card)
    for name, row in rows.items():
        phases = ", ".join(f"{p} {row[p]:.0f}" for p in CONSUMER + PRODUCER)
        print(f"{name}: {row['ms']:.4f} ms instrumented, {row['tiles']} tiles a block; "
              f"cycles a tile: {phases}")
    result = {"profile_flash_phases": {"card": card, "shape": list(SHAPE), "kernels": rows}}
    print(json.dumps(result))
    return result


if __name__ == "__main__":
    main()
