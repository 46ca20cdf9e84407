"""ctypes loader for the port's host helper, ``csrc/host/gif_lzw.cpp``.

The GIF image data (LZW) of ``utils.image.encode_gif``: Pillow's codes and
sub-blocks. The library is built with ``g++ -O2 -fPIC -shared`` at first use
into ``python_ray_tracer_tpu_torch/build/`` (its name carries a hash of the
source and the flags; ``utils.build_once`` keeps concurrent processes from
building it twice). It needs no library beyond the C++ runtime, and
:func:`gif_lzw` raises with the compiler's output where it cannot be built:
the GIF writer has no other route.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
import time

import numpy as np

from .build_once import build_once

PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
HOST_DIR = os.path.join(PKG_DIR, "csrc", "host")
BUILD_DIR = os.path.join(PKG_DIR, "build")

SOURCE = "gif_lzw.cpp"
CXX_FLAGS = ("-O2", "-fPIC", "-shared")

_lock = threading.Lock()
_lib: ctypes.CDLL | None = None
_error: RuntimeError | None = None
# Seconds g++ took for the library in this process; None when it was already built.
BUILD_SECONDS: float | None = None


def library_path() -> str:
    """Where the library for the current source and flags lives."""
    h = hashlib.sha256(" ".join(CXX_FLAGS).encode())
    with open(os.path.join(HOST_DIR, SOURCE), "rb") as f:
        h.update(f.read())
    return os.path.join(BUILD_DIR, f"librt_host_gif_{h.hexdigest()[:16]}.so")


def build() -> str:
    """Compile the library if it is missing; its path. Raises
    ``RuntimeError`` with g++'s output if the build fails."""
    def make(tmp: str) -> None:
        global BUILD_SECONDS
        cmd = ["g++", *CXX_FLAGS, "-o", tmp, os.path.join(HOST_DIR, SOURCE)]
        t0 = time.perf_counter()
        try:
            proc = subprocess.run(cmd, capture_output=True, text=True, timeout=300)
        except (OSError, subprocess.SubprocessError) as e:
            raise RuntimeError(f"g++ could not run: {' '.join(cmd)}\n{e}") from e
        BUILD_SECONDS = time.perf_counter() - t0
        if proc.returncode != 0:
            raise RuntimeError(f"g++ failed (rc {proc.returncode}): {' '.join(cmd)}\n"
                               f"{proc.stdout}{proc.stderr}")
    return build_once(library_path(), make)


def load() -> ctypes.CDLL:
    """The library, built and loaded on first use. A failure raises
    ``RuntimeError`` and is kept: every later call in this process raises it
    again without another build."""
    global _lib, _error
    with _lock:
        if _lib is None and _error is None:
            try:
                lib = ctypes.CDLL(build())
                lib.rt_gif_lzw.restype = ctypes.c_int64
                lib.rt_gif_lzw.argtypes = [ctypes.c_void_p, ctypes.c_int32, ctypes.c_int32,
                                           ctypes.c_int64, ctypes.c_int32, ctypes.c_void_p,
                                           ctypes.c_int64]
                _lib = lib
            except OSError as e:
                _error = RuntimeError(f"{SOURCE} cannot be built or loaded: {e}")
            except RuntimeError as e:
                _error = e
        if _error is not None:
            raise _error
        return _lib


def gif_lzw(idx: np.ndarray, *, interlace: bool = False) -> bytes:
    """GIF image data of the ``(h, w)`` uint8 palette indices ``idx``: the
    minimum code size 8, Pillow's LZW codes in 255-byte sub-blocks, and the
    zero-length terminator. ``interlace`` feeds the rows in GIF's four-pass
    order."""
    arr = np.ascontiguousarray(idx, dtype=np.uint8)
    if arr.ndim != 2 or arr.size == 0:
        raise ValueError(f"expected non-empty (h, w) uint8 indices, got {arr.shape}")
    lib = load()
    h, w = arr.shape
    n = arr.size
    data = (n + n // 1024 + 8) * 12 // 8 + 2        # every code at 12 bits, clears included
    out = np.empty(data + data // 255 + 2, np.uint8)
    got = lib.rt_gif_lzw(arr.ctypes.data, w, h, arr.strides[0], int(interlace),
                         out.ctypes.data, out.size)
    if got <= 0:
        raise RuntimeError(f"rt_gif_lzw returned {got} for a {w}x{h} frame "
                           f"into {out.size} bytes")
    return b"\x08" + out[:got].tobytes() + b"\x00"
