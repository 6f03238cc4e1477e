"""Build the port's CUDA kernels with nvcc and bind them with ctypes.

Each `csrc/<name>.cu` becomes its own shared library with a plain C
interface, compiled for Hopper (`sm_90a`) into `build/torch_kernels/` at
the repository root the first time a kernel is needed. The file name
carries a hash of the sources and flags, so an edited kernel is rebuilt and
a stale library is never loaded. `build()` starts one nvcc per source, all
at once, and waits for them together.

Every C entry point returns `cudaGetLastError()` after its launches;
`check()` raises on a non-zero code, since a refused launch never runs and
a later synchronize would not report it.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import threading
from functools import lru_cache
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parents[2] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "torch_kernels"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
    "--ptxas-options=-v",  # registers / shared memory / spills in the build log
)
KERNELS = ("score_path", "gats", "dual_softmax", "vgg_stage", "gats_block", "sinkhorn",
           "sinkhorn_stream", "flash_attention", "ransac_pnp")
# Flags of one source only, after NVCC_FLAGS. RANSAC-PnP rounds every
# product and sum on its own, as the plain version's tensor ops do: no FMA
# contraction (see csrc/ransac_pnp.cu).
EXTRA_FLAGS = {"ransac_pnp": ("-fmad=false",)}

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
# C entry points of each library: name -> (argtypes, restype).
SIGNATURES = {
    "score_path": {
        "nms_launch": ([_P, _P, _I, _I, _I, _I, _P], _I),
        "nms_large_launch": ([_P] * 4 + [_I] * 5 + [_P], _I),
    },
    "gats": {
        "gats_launch": ([_P, _P, _P, _P, _P, _I, _I, _I, _F, _P], _I),
    },
    "dual_softmax": {
        "dual_softmax_launch": ([_P] * 3 + [_I] * 3 + [_F] + [_I] * 6 + [_P] * 11, _I),
    },
    "vgg_stage": {
        "vgg_stage_launch": ([_P] * 6 + [_I] * 7 + [_P], _I),
        "vgg_stage_tile_rows": ([_I] * 3, _I),
    },
    "gats_block": {
        "gats_block_launch": ([_P] + [_I] * 6 + [_F, _I, _I, _P], _I),
        "gats_block_num_ptrs": ([], _I),
        "gats_block_gemm_launch": ([_P] * 4 + [_I] * 4 + [_P], _I),
    },
    "sinkhorn": {
        "sinkhorn_max_blocks": ([_I] * 3, _I),
        "sinkhorn_launch": ([_P] * 8 + [_I] * 10 + [_P], _I),
    },
    "sinkhorn_stream": {
        "sinkhorn_stream_max_blocks": ([_I] * 3, _I),
        "sinkhorn_stream_launch": ([_P, _I] + [_P] * 7 + [_I] * 13 + [_P], _I),
        "sinkhorn_stream_wide_max_blocks": ([], _I),
        "sinkhorn_stream_wide_launch": ([_P, _I] + [_P] * 7 + [_I] * 8 + [_P], _I),
        "sinkhorn_stream_cluster_max_clusters": ([_I] * 3, _I),
        "sinkhorn_stream_cluster_launch": ([_P, _I] + [_P] * 7 + [_I] * 14 + [_P], _I),
    },
    "flash_attention": {
        "flash_attention_fwd_launch": ([_P] * 6 + [_I] * 5 + [_F, _P], _I),
        "flash_attention_bwd_dkv_launch": ([_P] * 9 + [_I] * 5 + [_F, _P], _I),
        "flash_attention_bwd_dq_launch": ([_P] * 8 + [_I] * 5 + [_F, _P], _I),
    },
    "ransac_pnp": {
        "ransac_pnp_hypotheses_launch": ([_P] * 5 + [_I] * 3 + [_F, _F] + [_P] * 3, _I),
        "ransac_pnp_refine_launch": ([_P] * 6 + [_I] * 3 + [_F, _F, _I, _I] + [_P] * 10, _I),
    },
}

_libs: dict[str, ctypes.CDLL] = {}
_lock = threading.Lock()


def nvcc_path() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    for cand in ([Path(home) / "bin" / "nvcc"] if home else []) + [
        Path("/usr/local/cuda/bin/nvcc")
    ]:
        if cand.exists():
            return str(cand)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: set CUDA_HOME to the CUDA toolkit")
    return found


def library_path(name: str) -> Path:
    h = hashlib.sha256()
    for src in sorted(CSRC.glob("*.cuh")) + [CSRC / f"{name}.cu"]:
        h.update(src.name.encode())
        h.update(src.read_bytes())
    h.update(" ".join(NVCC_FLAGS + EXTRA_FLAGS.get(name, ())).encode())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


@lru_cache(maxsize=None)
def variants(name: str, macro: str = "VARIANTS") -> dict[tuple[int, int], int]:
    """The instantiations that `csrc/<name>.cu` lists in its X-macro `macro`
    (VARIANTS, or K7's CLUSTER_VARIANTS), as X(W, KC, RS): (warps a group,
    chunks a thread) -> rows a group step. The source's pick functions
    expand the same lists, so a plan that chooses from this table names
    only a compiled kernel."""
    text = (CSRC / f"{name}.cu").read_text()
    found = re.search(rf"^#define {macro}\(X\)((?:.*\\\n)*.*)$", text, re.M)
    if found is None:
        raise RuntimeError(f"csrc/{name}.cu defines no {macro}(X) list")
    table = {(int(w), int(kc)): int(rs)
             for w, kc, rs in re.findall(r"X\((\d+),\s*(\d+),\s*(\d+)\)", found.group(1))}
    if not table:
        raise RuntimeError(f"csrc/{name}.cu: {macro}(X) lists no instantiation")
    return table


def build(names=KERNELS) -> dict[str, str]:
    """Compile every named kernel source that is not built yet, one nvcc
    process per source, all running at once. Returns the compiler log of
    each source compiled now; raises with the logs if any failed."""
    jobs = {}
    for name in names:
        out = library_path(name)
        if out.exists():
            continue
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
        cmd = [nvcc_path(), *NVCC_FLAGS, *EXTRA_FLAGS.get(name, ()), "-o", str(tmp),
               str(CSRC / f"{name}.cu")]
        proc = subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True
        )
        jobs[name] = (proc, tmp, out)
    logs, failed = {}, []
    for name, (proc, tmp, out) in jobs.items():
        logs[name], _ = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"--- {name} (nvcc exit {proc.returncode})\n{logs[name]}")
        else:
            os.replace(tmp, out)  # atomic: a reader never sees half a library
    if failed:
        raise RuntimeError("kernel build failed:\n" + "\n".join(failed))
    return logs


def load(name: str) -> ctypes.CDLL:
    """The loaded library for `csrc/<name>.cu`, built first if needed."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            build([name])
            lib = _libs[name] = bind(library_path(name), name)
        return lib


def bind(path: Path, name: str) -> ctypes.CDLL:
    """Load the shared library at `path` and give its C entry points the
    types of `csrc/<name>.cu`'s (a copy of that source built elsewhere
    binds the same way)."""
    lib = ctypes.CDLL(str(path))
    lib.kernel_error_string.argtypes = [ctypes.c_int]
    lib.kernel_error_string.restype = ctypes.c_char_p
    for fn, (argtypes, restype) in SIGNATURES[name].items():
        getattr(lib, fn).argtypes = argtypes
        getattr(lib, fn).restype = restype
    return lib


def check(lib: ctypes.CDLL, err: int, what: str) -> None:
    if err != 0:
        msg = lib.kernel_error_string(err).decode()
        raise RuntimeError(f"{what}: CUDA error {err} ({msg})")


def resident_blocks(lib: ctypes.CDLL, fn: str, *args: int) -> int:
    """Blocks of a cooperative kernel resident on the card at once, from
    the library's occupancy entry point `fn` called with `args` (negative:
    a CUDA error)."""
    n = getattr(lib, fn)(*map(int, args))
    if n < 0:
        check(lib, -n, fn)
    return n


SMS = 132  # H100 SXM streaming multiprocessors: the plans' count for a CPU replay
SMEM_PER_BLOCK = 232448  # bytes of shared memory one block may use on Hopper


def device_sms(device: torch.device) -> int:
    """Streaming multiprocessors of a CUDA device (what the kernels' plans
    spread their blocks over); SMS for a CPU tensor, whose plans are only
    replayed."""
    if torch.device(device).type != "cuda":
        return SMS
    return torch.cuda.get_device_properties(device).multi_processor_count


def ptr(t: torch.Tensor) -> ctypes.c_void_p:
    return ctypes.c_void_p(t.data_ptr())


def stream(device: torch.device) -> ctypes.c_void_p:
    return ctypes.c_void_p(torch.cuda.current_stream(device).cuda_stream)


def require_cuda_input(t: torch.Tensor, what: str, ndim: int, dtype=torch.float32):
    """Raise unless `t` is what a kernel takes: a contiguous CUDA tensor of
    `dtype` (fp32 unless the kernel takes bf16 there) and rank `ndim`, 16-byte aligned, that needs no gradient (the
    kernels are forward-only)."""
    if t.device.type != "cuda":
        raise ValueError(f"{what}: expected a CUDA tensor, got {t.device}")
    if t.dtype != dtype:
        raise ValueError(f"{what}: expected {dtype}, got {t.dtype}")
    if t.dim() != ndim:
        raise ValueError(f"{what}: expected rank {ndim}, got shape {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{what}: expected a contiguous tensor")
    if t.data_ptr() % 16:
        raise ValueError(f"{what}: data pointer is not 16-byte aligned")
    if t.requires_grad:
        raise RuntimeError(
            f"{what}: the CUDA kernel is forward-only; run under "
            "torch.no_grad() / torch.inference_mode()"
        )


def require_inference(what: str, *tensors) -> None:
    """Raise if autograd is recording and any of `tensors` needs a gradient:
    the kernels are forward-only, as the JAX package's are (no VJP)."""
    if torch.is_grad_enabled() and any(t is not None and t.requires_grad for t in tensors):
        raise RuntimeError(
            f"{what}: the CUDA kernel is forward-only; run under "
            "torch.no_grad() / torch.inference_mode()"
        )
