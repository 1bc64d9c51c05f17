"""ctypes loader and builder of the native host-side blockify
(native/blockify.cpp, the source the JAX package builds too).

The library is built with g++ at first use into build/torch_native/ of the
checkout, under a name keyed by a hash of the source and the flags. g++
writes a temporary file that is then renamed into place, so processes that
load it at once (parallel test workers) never read a half-written library.
When g++ or the source is missing, or the build fails, `available()` is
False and utils/image.py uses its NumPy path.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import subprocess
import tempfile

import numpy as np

_REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
SOURCE = os.path.join(_REPO, "native", "blockify.cpp")
BUILD_DIR = os.path.join(_REPO, "build", "torch_native")
GXX_FLAGS = ("-O3", "-fPIC", "-shared")

_U8P = ctypes.POINTER(ctypes.c_uint8)
_I64 = ctypes.c_int64


def library_path() -> str:
    with open(SOURCE, "rb") as f:
        digest = hashlib.sha256(f.read() + " ".join(GXX_FLAGS).encode())
    return os.path.join(BUILD_DIR,
                        f"libckblockify-{digest.hexdigest()[:16]}.so")


def _build(path: str) -> None:
    os.makedirs(BUILD_DIR, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    try:
        subprocess.run(["g++", *GXX_FLAGS, SOURCE, "-o", tmp], check=True,
                       capture_output=True, timeout=300)
        os.replace(tmp, path)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)


@functools.lru_cache(maxsize=1)
def _lib():
    try:
        path = library_path()
        if not os.path.exists(path):
            _build(path)
        lib = ctypes.CDLL(path)
    except (OSError, subprocess.SubprocessError):
        return None
    for name in ("ck_blockify", "ck_unblockify"):
        fn = getattr(lib, name)
        fn.argtypes = [_U8P, _I64, _I64, _U8P]
        fn.restype = None
    return lib


def available() -> bool:
    return _lib() is not None


def _check_image(image: np.ndarray) -> None:
    if (image.dtype != np.uint8 or image.ndim != 3 or image.shape[2] != 4
            or not image.flags.c_contiguous):
        raise ValueError(f"expected a C-contiguous uint8 [H, W, 4] image, "
                         f"got {image.dtype} {image.shape}")


def blockify(image: np.ndarray) -> np.ndarray:
    """C-contiguous uint8 [H, W, 4] -> [ceil(H/4)*ceil(W/4), 16, 4] blocks,
    raster order, edge-clamped."""
    _check_image(image)
    h, w, _ = image.shape
    out = np.empty((((h + 3) // 4) * ((w + 3) // 4), 16, 4), dtype=np.uint8)
    _lib().ck_blockify(image.ctypes.data_as(_U8P), h, w,
                       out.ctypes.data_as(_U8P))
    return out


def unblockify(blocks: np.ndarray, h: int, w: int) -> np.ndarray:
    """[ceil(h/4)*ceil(w/4), 16, 4] blocks -> uint8 [h, w, 4]."""
    blocks = np.ascontiguousarray(blocks, dtype=np.uint8)
    if blocks.shape != (((h + 3) // 4) * ((w + 3) // 4), 16, 4):
        raise ValueError(f"{blocks.shape} blocks do not tile {h}x{w}")
    out = np.empty((h, w, 4), dtype=np.uint8)
    _lib().ck_unblockify(blocks.ctypes.data_as(_U8P), h, w,
                         out.ctypes.data_as(_U8P))
    return out
