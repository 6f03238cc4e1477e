"""Python interface to the native image decoder (`frame_loader.cpp`).

Port of onepose_tpu/native/frame_loader.py, its one-shot half: `read_gray`
decodes one PNG or JPEG file to BT.601 grayscale float32 in [0, 1] through
libpng / libjpeg. The threaded prefetching `FrameLoader` of the same
source comes with the port's `infer`.
"""

from __future__ import annotations

from typing import Optional

import numpy as np

from onepose_tpu_torch.native import get_lib


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
