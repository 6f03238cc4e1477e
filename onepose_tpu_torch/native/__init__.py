"""The SfM host path's union-find core in C++, built by g++ at first use.

Port of onepose_tpu/native/__init__.py (its union-find half; the frame
loader comes with `infer`). `union_find.cpp` is compiled into
`build/torch_native/` at the repository root, never into the package
directory; the file name carries a hash of the source and flags, so an
edited source is rebuilt and a stale library never loaded. Without g++
(or when the build fails) the same functions run in Python, with the same
labels: union to the minimum root, path halving, a full flatten at the
end. `backend()` says which one runs.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

import numpy as np

SOURCE = Path(__file__).resolve().with_name("union_find.cpp")
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "torch_native"
GXX_FLAGS = ("-O3", "-shared", "-fPIC", "-std=c++17")

_lock = threading.Lock()
_lib: ctypes.CDLL | None = None
_unavailable = False  # g++ missing or the build failed: the Python versions run


def library_path() -> Path:
    h = hashlib.sha256(SOURCE.read_bytes())
    h.update(" ".join(GXX_FLAGS).encode())
    return BUILD_DIR / f"libunion_find-{h.hexdigest()[:16]}.so"


def _build(out: Path) -> bool:
    gxx = shutil.which("g++")
    if gxx is None:
        return False
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    try:
        subprocess.run([gxx, *GXX_FLAGS, str(SOURCE), "-o", str(tmp)], check=True,
                       capture_output=True, timeout=120)
    except (OSError, subprocess.SubprocessError):
        return False
    os.replace(tmp, out)  # atomic: a reader never sees half a library
    return True


def get_lib() -> ctypes.CDLL | None:
    """The loaded library, built first if needed; None without g++."""
    global _lib, _unavailable
    with _lock:
        if _lib is not None or _unavailable:
            return _lib
        out = library_path()
        if not out.exists() and not _build(out):
            _unavailable = True
            return None
        try:
            lib = ctypes.CDLL(str(out))
        except OSError:
            _unavailable = True
            return None
        i64 = np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS")
        lib.uf_connected_components.argtypes = [ctypes.c_int64, i64, i64, ctypes.c_int64, i64]
        lib.uf_connected_components.restype = None
        lib.uf_merge_close.argtypes = [
            ctypes.c_int64, np.ctypeslib.ndpointer(np.float64, flags="C_CONTIGUOUS"), i64, i64,
            ctypes.c_int64, ctypes.c_double, i64]
        lib.uf_merge_close.restype = None
        _lib = lib
        return _lib


def backend() -> str:
    """"g++" when the C++ core runs, "python" for the fallback."""
    return "g++" if get_lib() is not None else "python"


def _find(parent: np.ndarray, x: int) -> int:
    while parent[x] != x:
        parent[x] = parent[parent[x]]
        x = parent[x]
    return x


def _union(parent: np.ndarray, a: int, b: int) -> None:
    ra, rb = _find(parent, a), _find(parent, b)
    if ra != rb:
        parent[max(ra, rb)] = min(ra, rb)


def connected_components_py(n: int, ea: np.ndarray, eb: np.ndarray) -> np.ndarray:
    """Root labels [n] of the edge graph (ea[i] -- eb[i]) in Python."""
    parent = np.arange(n, dtype=np.int64)
    for a, b in zip(np.asarray(ea).tolist(), np.asarray(eb).tolist()):
        _union(parent, a, b)
    for i in range(n):
        parent[i] = _find(parent, i)
    return parent


def merge_close_py(xyz: np.ndarray, cand_a: np.ndarray, cand_b: np.ndarray,
                   thr: float) -> np.ndarray:
    """Root labels [n] of the candidate pairs closer than thr, in Python."""
    xyz = np.asarray(xyz, np.float64)
    n = len(xyz)
    parent = np.arange(n, dtype=np.int64)
    thr2 = thr * thr
    for a, b in zip(np.asarray(cand_a).tolist(), np.asarray(cand_b).tolist()):
        d = xyz[a] - xyz[b]
        if d[0] * d[0] + d[1] * d[1] + d[2] * d[2] < thr2:
            _union(parent, a, b)
    for i in range(n):
        parent[i] = _find(parent, i)
    return parent


def connected_components(n: int, ea: np.ndarray, eb: np.ndarray) -> np.ndarray:
    """Root labels [n] (each the minimum member index) of the edge graph."""
    lib = get_lib()
    if lib is None:
        return connected_components_py(n, ea, eb)
    ea = np.ascontiguousarray(ea, np.int64)
    eb = np.ascontiguousarray(eb, np.int64)
    if len(ea) != len(eb) or (len(ea) and (min(ea.min(), eb.min()) < 0
                                           or max(ea.max(), eb.max()) >= n)):
        raise ValueError(f"connected_components: edges must pair indices in [0, {n})")
    parent = np.empty(n, np.int64)
    lib.uf_connected_components(n, ea, eb, len(ea), parent)
    return parent


def merge_close(xyz: np.ndarray, cand_a: np.ndarray, cand_b: np.ndarray,
                thr: float) -> np.ndarray:
    """Root labels [n] of the union of candidate pairs closer than thr."""
    lib = get_lib()
    if lib is None:
        return merge_close_py(xyz, cand_a, cand_b, thr)
    xyz = np.ascontiguousarray(xyz, np.float64)
    n = len(xyz)
    cand_a = np.ascontiguousarray(cand_a, np.int64)
    cand_b = np.ascontiguousarray(cand_b, np.int64)
    if xyz.shape != (n, 3) or len(cand_a) != len(cand_b) or (
            len(cand_a) and (min(cand_a.min(), cand_b.min()) < 0
                             or max(cand_a.max(), cand_b.max()) >= n)):
        raise ValueError(f"merge_close: xyz must be [n, 3] and candidates in [0, {n})")
    parent = np.empty(n, np.int64)
    lib.uf_merge_close(n, xyz, cand_a, cand_b, len(cand_a), thr * thr, parent)
    return parent
