"""The host cores in C++, built by g++ at first use: the SfM union-find and
the image decoder.

Port of onepose_tpu/native/__init__.py. `union_find.cpp` and
`frame_loader.cpp` are compiled into one library under
`build/torch_native/` at the repository root, never into the package
directory, as the JAX package builds its own: the first attempt links
libpng, libjpeg and zlib for the decoder; where that fails (no codec
headers or libraries), the second builds the union-find core alone. The
file name carries a hash of the sources and flags, so an edited source is
rebuilt and a stale library never loaded. Without g++ (or when both builds
fail) the union-find runs in Python, with the same labels: union to the
minimum root, path halving, a full flatten at the end; image decoding then
falls back to cv2 (`data.paths.load_gray`). `backend()` says which one runs.
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

HERE = Path(__file__).resolve().parent
SOURCE = HERE / "union_find.cpp"
LOADER_SOURCE = HERE / "frame_loader.cpp"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "torch_native"
GXX_FLAGS = ("-O3", "-shared", "-fPIC", "-std=c++17", "-pthread")
CODEC_LIBS = ("-lpng", "-ljpeg", "-lz")

_lock = threading.Lock()
_lib: ctypes.CDLL | None = None
_unavailable = False  # g++ missing or every build failed: the Python versions run


def _sources(codecs: bool) -> list[Path]:
    return [SOURCE, LOADER_SOURCE] if codecs else [SOURCE]


def library_path(codecs: bool = True) -> Path:
    """The library with the decoder (codecs=True) or the union-find core alone."""
    h = hashlib.sha256()
    for src in _sources(codecs):
        h.update(src.read_bytes())
    h.update(" ".join(GXX_FLAGS + (CODEC_LIBS if codecs else ())).encode())
    name = "libonepose_native" if codecs else "libunion_find"
    return BUILD_DIR / f"{name}-{h.hexdigest()[:16]}.so"


def _build(out: Path, codecs: bool) -> bool:
    gxx = shutil.which("g++")
    if gxx is None:
        return False
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    cmd = [gxx, *GXX_FLAGS, *map(str, _sources(codecs)), *(CODEC_LIBS if codecs else ()),
           "-o", str(tmp)]
    try:
        subprocess.run(cmd, check=True, capture_output=True, timeout=120)
    except (OSError, subprocess.SubprocessError):
        return False
    os.replace(tmp, out)  # atomic: a reader never sees half a library
    return True


def _bind(lib: ctypes.CDLL) -> None:
    i64 = np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS")
    lib.uf_connected_components.argtypes = [ctypes.c_int64, i64, i64, ctypes.c_int64, i64]
    lib.uf_connected_components.restype = None
    lib.uf_merge_close.argtypes = [
        ctypes.c_int64, np.ctypeslib.ndpointer(np.float64, flags="C_CONTIGUOUS"), i64, i64,
        ctypes.c_int64, ctypes.c_double, i64]
    lib.uf_merge_close.restype = None
    if hasattr(lib, "fl_probe"):
        lib.fl_probe.restype = ctypes.c_int
        lib.fl_probe.argtypes = [ctypes.c_char_p,
                                 np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")]
        lib.fl_read_gray.restype = ctypes.c_int
        lib.fl_read_gray.argtypes = [ctypes.c_char_p,
                                     np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS"),
                                     ctypes.c_int64]
        lib.fl_create.restype = ctypes.c_void_p
        lib.fl_create.argtypes = [ctypes.POINTER(ctypes.c_char_p), ctypes.c_int64, ctypes.c_int,
                                  ctypes.c_int, ctypes.c_void_p, ctypes.c_int, ctypes.c_int]
        lib.fl_next.restype = ctypes.c_int
        lib.fl_next.argtypes = [ctypes.c_void_p,
                                np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS"),
                                ctypes.c_int64,
                                np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")]
        lib.fl_destroy.restype = None
        lib.fl_destroy.argtypes = [ctypes.c_void_p]


def get_lib() -> ctypes.CDLL | None:
    """The loaded library, built first if needed (with the decoder where the
    codecs link); None without g++."""
    global _lib, _unavailable
    with _lock:
        if _lib is not None or _unavailable:
            return _lib
        for codecs in (True, False):
            out = library_path(codecs)
            if out.exists() or _build(out, codecs):
                try:
                    lib = ctypes.CDLL(str(out))
                except OSError:
                    continue
                _bind(lib)
                _lib = lib
                return _lib
        _unavailable = True
        return None


def backend() -> str:
    """"g++ with codecs" (union-find and decoder), "g++" (union-find only)
    or "python" (the fallback)."""
    lib = get_lib()
    if lib is None:
        return "python"
    return "g++ with codecs" if hasattr(lib, "fl_probe") else "g++"


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
