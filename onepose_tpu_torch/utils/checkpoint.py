"""Checkpoint save/load with step indexing and pruning, in the JAX package's
format.

Port of onepose_tpu/utils/checkpoint.py. The JAX package writes its
parameter trees as the JAX package's msgpack checkpoints (ndarray ext type
1): a msgpack map of nested string-keyed maps whose leaves are ext type 1
(an ndarray packed as the msgpack array [shape, dtype name, C-order
bytes]), ext type 3 (a numpy scalar, packed the same way with shape []),
or plain msgpack scalars; lists and tuples are stored as maps keyed "0",
"1", ...; an array above MAX_CHUNK_SIZE bytes is stored as the map
{"__msgpack_chunked_array__": true, "shape": {"0": ...}, "chunks": {"0":
flat chunk, ...}}. This module reads and writes that format with its own
codec (the standard library's `struct` and numpy), so either package loads
the other's checkpoints; for a tree of numpy arrays it writes the same
bytes as the JAX package.

`load_checkpoint` returns the nested dict of numpy arrays;
`models.bridge` turns a parameter tree into a state_dict.
"""

from __future__ import annotations

import os
import os.path as osp
import re
import struct
from collections.abc import Mapping
from glob import glob
from typing import Any, Optional

import numpy as np
import torch

_CKPT_RE = re.compile(r"ckpt_(\d+)\.msgpack$")
MAX_CHUNK_SIZE = 2**30  # bytes of one array leaf before it is chunked
EXT_NDARRAY, EXT_NPSCALAR = 1, 3
CHUNKED = "__msgpack_chunked_array__"


# -- msgpack encoding -------------------------------------------------------


def _head(out: bytearray, n: int, fix: int, fix_max: int, codes: tuple) -> None:
    """A length header: the fix form below fix_max, else 8/16/32-bit forms
    (codes[0] may be None where the format has no 8-bit form)."""
    if n < fix_max:
        out.append(fix | n)
    elif codes[0] is not None and n <= 0xFF:
        out += struct.pack(">BB", codes[0], n)
    elif n <= 0xFFFF:
        out += struct.pack(">BH", codes[1], n)
    else:
        out += struct.pack(">BI", codes[2], n)


def _pack_int(out: bytearray, v: int) -> None:
    if 0 <= v < 0x80:
        out.append(v)
    elif -0x20 <= v < 0:
        out += struct.pack(">b", v)
    elif -0x80 <= v < 0:
        out += struct.pack(">Bb", 0xD0, v)
    elif 0 <= v <= 0xFF:
        out += struct.pack(">BB", 0xCC, v)
    elif -0x8000 <= v < 0:
        out += struct.pack(">Bh", 0xD1, v)
    elif 0 <= v <= 0xFFFF:
        out += struct.pack(">BH", 0xCD, v)
    elif -0x80000000 <= v < 0:
        out += struct.pack(">Bi", 0xD2, v)
    elif 0 <= v <= 0xFFFFFFFF:
        out += struct.pack(">BI", 0xCE, v)
    elif -(2**63) <= v < 0:
        out += struct.pack(">Bq", 0xD3, v)
    elif 0 <= v < 2**64:
        out += struct.pack(">BQ", 0xCF, v)
    else:
        raise OverflowError(f"integer {v} does not fit msgpack's 64 bits")


def _pack_ext(out: bytearray, code: int, data: bytes) -> None:
    n = len(data)
    fixext = {1: 0xD4, 2: 0xD5, 4: 0xD6, 8: 0xD7, 16: 0xD8}
    if n in fixext:
        out.append(fixext[n])
    elif n <= 0xFF:
        out += struct.pack(">BB", 0xC7, n)
    elif n <= 0xFFFF:
        out += struct.pack(">BH", 0xC8, n)
    else:
        out += struct.pack(">BI", 0xC9, n)
    out += struct.pack(">b", code)
    out += data


def _ndarray_bytes(arr: np.ndarray) -> bytes:
    out = bytearray()
    _pack(out, [list(arr.shape), arr.dtype.name, arr.tobytes("C")])
    return bytes(out)


def _pack(out: bytearray, x: Any) -> None:
    if x is None:
        out.append(0xC0)
    elif x is True or x is False:
        out.append(0xC3 if x else 0xC2)
    elif type(x) is int:
        _pack_int(out, x)
    elif type(x) is float:
        out += struct.pack(">Bd", 0xCB, x)
    elif type(x) is str:
        b = x.encode("utf-8")
        _head(out, len(b), 0xA0, 32, (0xD9, 0xDA, 0xDB))
        out += b
    elif isinstance(x, (bytes, bytearray, memoryview)):
        b = bytes(x)
        _head(out, len(b), 0, 0, (0xC4, 0xC5, 0xC6))
        out += b
    elif isinstance(x, (list, tuple)):
        _head(out, len(x), 0x90, 16, (None, 0xDC, 0xDD))
        for v in x:
            _pack(out, v)
    elif isinstance(x, dict):
        _head(out, len(x), 0x80, 16, (None, 0xDE, 0xDF))
        for k, v in x.items():
            _pack(out, k)
            _pack(out, v)
    elif isinstance(x, np.ndarray):
        if x.dtype.hasobject or x.dtype.isalignedstruct:
            raise ValueError("object and structured dtypes cannot be stored")
        _pack_ext(out, EXT_NDARRAY, _ndarray_bytes(x))
    elif isinstance(x, np.generic):
        _pack_ext(out, EXT_NPSCALAR, _ndarray_bytes(np.asarray(x)))
    else:
        raise TypeError(f"cannot store a {type(x).__name__} in a checkpoint")


def _chunk(arr: np.ndarray) -> dict:
    flat = arr.reshape(-1)
    size = max(1, int(MAX_CHUNK_SIZE / arr.dtype.itemsize))
    chunks = [flat[i:i + size] for i in range(0, flat.shape[0], size)]
    return {CHUNKED: True, "shape": {str(i): int(d) for i, d in enumerate(arr.shape)},
            "chunks": {str(i): c for i, c in enumerate(chunks)}}


def _state(x: Any) -> Any:
    """The stored form: mappings with string keys, lists and tuples as maps
    keyed by index, tensors as numpy arrays, arrays above MAX_CHUNK_SIZE
    chunked."""
    if isinstance(x, Mapping):
        keys = [str(k) for k in x]
        if len(set(keys)) != len(keys):
            raise ValueError(f"keys without a unique string form: {list(x)}")
        return {str(k): _state(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return {str(i): _state(v) for i, v in enumerate(x)}
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu().numpy()
    if isinstance(x, np.ndarray) and x.nbytes > MAX_CHUNK_SIZE:
        return _chunk(x)
    return x


def msgpack_serialize(tree: Any) -> bytes:
    """The checkpoint bytes of a tree of mappings, lists and array leaves."""
    out = bytearray()
    _pack(out, _state(tree))
    return bytes(out)


# -- msgpack decoding -------------------------------------------------------


class _Reader:
    def __init__(self, data: bytes):
        self.buf = memoryview(data)
        self.pos = 0

    def take(self, n: int) -> memoryview:
        if self.pos + n > len(self.buf):
            raise ValueError("truncated msgpack data")
        b = self.buf[self.pos:self.pos + n]
        self.pos += n
        return b

    def unpack(self, fmt: str):
        return struct.unpack(fmt, self.take(struct.calcsize(fmt)))[0]

    def read(self) -> Any:
        c = self.unpack(">B")
        if c <= 0x7F:
            return c
        if c >= 0xE0:
            return c - 0x100
        if 0x80 <= c <= 0x8F:
            return self._map(c & 0x0F)
        if 0x90 <= c <= 0x9F:
            return [self.read() for _ in range(c & 0x0F)]
        if 0xA0 <= c <= 0xBF:
            return str(self.take(c & 0x1F), "utf-8")
        simple = {0xC0: None, 0xC2: False, 0xC3: True}
        if c in simple:
            return simple[c]
        scalars = {0xCA: ">f", 0xCB: ">d", 0xCC: ">B", 0xCD: ">H", 0xCE: ">I", 0xCF: ">Q",
                   0xD0: ">b", 0xD1: ">h", 0xD2: ">i", 0xD3: ">q"}
        if c in scalars:
            return self.unpack(scalars[c])
        lengths = {0xC4: ">B", 0xC5: ">H", 0xC6: ">I", 0xD9: ">B", 0xDA: ">H", 0xDB: ">I",
                   0xDC: ">H", 0xDD: ">I", 0xDE: ">H", 0xDF: ">I", 0xC7: ">B", 0xC8: ">H",
                   0xC9: ">I"}
        fixext = {0xD4: 1, 0xD5: 2, 0xD6: 4, 0xD7: 8, 0xD8: 16}
        if c in fixext:
            return self._ext(fixext[c])
        if c not in lengths:
            raise ValueError(f"unknown msgpack type byte 0x{c:02x}")
        n = self.unpack(lengths[c])
        if c in (0xC4, 0xC5, 0xC6):
            return bytes(self.take(n))
        if c in (0xD9, 0xDA, 0xDB):
            return str(self.take(n), "utf-8")
        if c in (0xDC, 0xDD):
            return [self.read() for _ in range(n)]
        if c in (0xDE, 0xDF):
            return self._map(n)
        return self._ext(n)

    def _map(self, n: int) -> dict:
        out = {}
        for _ in range(n):
            k = self.read()
            out[k] = self.read()
        return out

    def _ext(self, n: int) -> Any:
        code = self.unpack(">b")
        data = bytes(self.take(n))
        if code not in (EXT_NDARRAY, EXT_NPSCALAR):
            raise ValueError(f"unknown msgpack ext type {code}")
        shape, name, raw = _Reader(data).read()
        if name == "bfloat16":  # numpy has no bfloat16: widened exactly to float32
            bits = np.frombuffer(raw, np.uint16).astype(np.uint32) << 16
            arr = bits.view(np.float32)
        else:
            arr = np.frombuffer(raw, np.dtype(name)).copy()
        arr = arr.reshape(shape)
        return arr[()] if code == EXT_NPSCALAR else arr


def _unchunk(x: Any) -> Any:
    if isinstance(x, dict):
        if CHUNKED in x:
            shape = tuple(x["shape"][str(i)] for i in range(len(x["shape"])))
            chunks = [x["chunks"][str(i)] for i in range(len(x["chunks"]))]
            return np.concatenate(chunks).reshape(shape)
        return {k: _unchunk(v) for k, v in x.items()}
    return x


def msgpack_restore(data: bytes) -> Any:
    """The tree stored in checkpoint bytes: nested dicts of numpy leaves."""
    reader = _Reader(data)
    tree = reader.read()
    if reader.pos != len(data):
        raise ValueError(f"{len(data) - reader.pos} bytes after the msgpack object")
    return _unchunk(tree)


def _check_like(tree: Any, target: Any, path: str = "") -> None:
    """Raise unless `tree` has `target`'s keys at every level and its shapes."""
    if isinstance(target, (list, tuple)):
        target = {str(i): v for i, v in enumerate(target)}
    if isinstance(target, Mapping):
        if not isinstance(tree, Mapping):
            raise ValueError(f"checkpoint has a leaf at {path or '/'}, the target a subtree")
        want, got = {str(k) for k in target}, set(tree)
        if want != got:
            raise ValueError(f"checkpoint keys at {path or '/'} differ from the target's: "
                             f"missing {sorted(want - got)}, extra {sorted(got - want)}")
        for k, v in target.items():
            _check_like(tree[str(k)], v, f"{path}/{k}")
        return
    shape = tuple(getattr(target, "shape", ()))
    if tuple(np.shape(tree)) != shape:
        raise ValueError(f"checkpoint shape {tuple(np.shape(tree))} at {path} differs from the "
                         f"target's {shape}")


# -- checkpoints ------------------------------------------------------------


def save_checkpoint(ckpt_dir: str, target: Any, step: int, keep: int = 200) -> str:
    """Serialize a tree to <ckpt_dir>/ckpt_<step>.msgpack; keep the newest
    `keep` checkpoints."""
    os.makedirs(ckpt_dir, exist_ok=True)
    path = osp.join(ckpt_dir, f"ckpt_{step}.msgpack")
    data = msgpack_serialize(target)
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        f.write(data)
    os.replace(tmp, path)
    ckpts = sorted(
        glob(osp.join(ckpt_dir, "ckpt_*.msgpack")),
        key=lambda p: int(_CKPT_RE.search(p).group(1)),
    )
    for old in ckpts[:-keep]:
        os.remove(old)
    return path


def latest_checkpoint(ckpt_dir: str) -> Optional[str]:
    ckpts = [p for p in glob(osp.join(ckpt_dir, "ckpt_*.msgpack")) if _CKPT_RE.search(p)]
    if not ckpts:
        return None
    return max(ckpts, key=lambda p: int(_CKPT_RE.search(p).group(1)))


def load_checkpoint(path: str, target: Any = None) -> Any:
    """The stored tree (nested dicts of numpy arrays). Given a `target`
    tree (an example of the expected structure: mappings, lists, anything
    with a `.shape` at the leaves), its keys and shapes are checked and a
    mismatch raises ValueError."""
    with open(path, "rb") as f:
        tree = msgpack_restore(f.read())
    if target is not None:
        _check_like(tree, target)
    return tree


def checkpoint_step(path: str) -> int:
    m = _CKPT_RE.search(path)
    return int(m.group(1)) if m else -1
