"""Python interface to the native image decoder and threaded frame loader
(`frame_loader.cpp`).

Port of onepose_tpu/native/frame_loader.py:
- `read_gray` decodes one PNG or JPEG file to BT.601 grayscale float32 in
  [0, 1] through libpng / libjpeg;
- `FrameLoader` streams decoded (and optionally affine-warped) frames in
  order while C++ worker threads run file IO, decode and warp ahead of the
  consumer (`fl_create` / `fl_next` / `fl_destroy`). Where the library was
  built without the codecs (no libpng / libjpeg headers, as on the card's
  machine), the class decodes with cv2 on the calling thread, with the
  same output (BT.601 grayscale, inverse-map bilinear warp, zero border,
  [0, 1] float): a host decoder, not a device path. `backend` says which
  one runs, and the first frame of an iteration logs it.
"""

from __future__ import annotations

import ctypes
import logging
from typing import Optional, Sequence

import numpy as np

from onepose_tpu_torch.native import get_lib

log = logging.getLogger(__name__)


def native_available() -> bool:
    """True when the library was built with the PNG / JPEG codecs."""
    lib = get_lib()
    return lib is not None and hasattr(lib, "fl_probe")


def read_gray(path: str) -> Optional[np.ndarray]:
    """Decode one image to grayscale float32 [H, W] in [0, 1] natively.

    Returns None if the library has no codecs or the file does not decode
    (the caller falls back to cv2)."""
    if not native_available():
        return None
    lib = get_lib()
    hw = np.zeros(2, np.int32)
    if not lib.fl_probe(path.encode(), hw):
        return None
    out = np.empty(int(hw[0]) * int(hw[1]), np.float32)
    if not lib.fl_read_gray(path.encode(), out, out.size):
        return None
    return out.reshape(int(hw[0]), int(hw[1]))


class FrameLoader:
    """Ordered prefetching frame iterator.

    Args:
      paths: image files (PNG or JPEG).
      out_hw: output (H, W); None keeps each frame's size (then all frames
        must share the first frame's size).
      affines: optional [N, 2, 3] OUTPUT->SOURCE affines (the `inv=True`
        result of geometry.transforms.get_affine_transform), one a frame;
        requires out_hw.
      n_threads / queue_cap: worker threads and frames decoded ahead.

    Iterating yields (index, frame [H, W] float32, or None where a frame
    does not decode)."""

    def __init__(
        self,
        paths: Sequence[str],
        out_hw: Optional[tuple] = None,
        affines: Optional[np.ndarray] = None,
        n_threads: int = 2,
        queue_cap: int = 4,
    ):
        if affines is not None and out_hw is None:
            raise ValueError("affines requires out_hw")
        self.paths = [str(p) for p in paths]
        self.out_hw = tuple(out_hw) if out_hw else None
        self.affines = (np.ascontiguousarray(affines, np.float32).reshape(-1, 6)
                        if affines is not None else None)
        if self.affines is not None and len(self.affines) != len(self.paths):
            raise ValueError("one affine per frame required")
        self.n_threads = n_threads
        self.queue_cap = queue_cap
        self._lib = get_lib() if self.paths else None
        self._native = self._lib is not None and hasattr(self._lib, "fl_create")
        self._handle = None

    @property
    def backend(self) -> str:
        """"native" (the C++ worker threads) or "cv2" (the calling thread)."""
        return "native" if self._native else "cv2"

    def __iter__(self):
        if not self.paths:
            return
        log.info("FrameLoader: %d frames through the %s decoder", len(self.paths), self.backend)
        if self._native:
            yield from self._iter_native()
        else:
            yield from self._iter_cv2()

    # -- native path -------------------------------------------------------
    def _iter_native(self):
        lib = self._lib
        enc = [p.encode() for p in self.paths]
        names = (ctypes.c_char_p * len(enc))(*enc)  # the C side copies them
        oh, ow = self.out_hw if self.out_hw else (0, 0)
        aff = None if self.affines is None else self.affines.ctypes.data_as(ctypes.c_void_p)
        self._handle = lib.fl_create(names, len(enc), oh, ow, aff, self.n_threads,
                                     self.queue_cap)
        try:
            hw = self.out_hw
            src_hw = np.zeros(2, np.int32)
            for i in range(len(self.paths)):
                if hw is None:
                    # The first frame that decodes fixes the size of all.
                    probe = np.zeros(2, np.int32)
                    if not lib.fl_probe(enc[i], probe):
                        yield i, None
                        continue
                    hw = (int(probe[0]), int(probe[1]))
                out = np.empty(hw, np.float32)
                rc = lib.fl_next(self._handle, out.reshape(-1), out.size, src_hw)
                if rc == 1:
                    yield i, out
                elif rc == 0:
                    yield i, None
                else:
                    return
        finally:
            lib.fl_destroy(self._handle)
            self._handle = None

    # -- cv2 path ----------------------------------------------------------
    def _iter_cv2(self):
        import cv2

        for i, p in enumerate(self.paths):
            img = cv2.imread(p, cv2.IMREAD_GRAYSCALE)
            if img is None:
                yield i, None
                continue
            img = img.astype(np.float32) / 255.0
            if self.affines is not None:
                h, w = self.out_hw
                img = cv2.warpAffine(img, self.affines[i].reshape(2, 3), (w, h),
                                     flags=cv2.INTER_LINEAR | cv2.WARP_INVERSE_MAP)
            elif self.out_hw and img.shape != self.out_hw:
                h, w = self.out_hw
                img = cv2.resize(img, (w, h), interpolation=cv2.INTER_LINEAR)
            yield i, img
