"""Build and load the port's CUDA kernels (``python_ray_tracer_tpu_torch/csrc/``).

The ``.cu`` sources are compiled with ``nvcc``, one process per source, all
started together, and linked into one shared library with a plain C interface,
bound with ``ctypes`` (no PyTorch headers, so a build takes seconds). The
library name carries a hash of the sources and flags: a source change builds a
new library, and an ``flock`` keeps concurrent processes from building the same
one twice. Nothing is built at import; :func:`load_library` builds on first use
and raises with the compiler's stderr if it cannot.
"""
from __future__ import annotations

import ctypes
import fcntl
import glob
import hashlib
import os
import shutil
import subprocess
import threading

PKG_DIR = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
CSRC_DIR = os.path.join(PKG_DIR, "csrc")
BUILD_DIR = os.path.join(PKG_DIR, "build")

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC")

_lock = threading.Lock()
_lib: ctypes.CDLL | None = None


def find_nvcc() -> str:
    """Path of ``nvcc``: ``$CUDA_HOME/bin``, then ``PATH``, then /usr/local/cuda."""
    cands = []
    if os.environ.get("CUDA_HOME"):
        cands.append(os.path.join(os.environ["CUDA_HOME"], "bin", "nvcc"))
    cands += [shutil.which("nvcc") or "", "/usr/local/cuda/bin/nvcc"]
    for c in cands:
        if c and os.path.isfile(c) and os.access(c, os.X_OK):
            return c
    raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on PATH); "
                       "the CUDA kernels cannot be built")


def _sources():
    srcs = sorted(glob.glob(os.path.join(CSRC_DIR, "*.cu")))
    hdrs = sorted(glob.glob(os.path.join(CSRC_DIR, "*.cuh")))
    if not srcs:
        raise RuntimeError(f"no CUDA sources under {CSRC_DIR}")
    return srcs, hdrs


def library_path() -> str:
    """Where the library for the current sources and flags lives."""
    srcs, hdrs = _sources()
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in srcs + hdrs:
        with open(p, "rb") as f:
            h.update(os.path.basename(p).encode() + b"\0" + f.read())
    return os.path.join(BUILD_DIR, f"librt_kernels_{h.hexdigest()[:16]}.so")


def build() -> str:
    """Compile the kernels if the library for the current sources is missing.
    Returns its path; raises ``RuntimeError`` with nvcc's stderr on failure."""
    so = library_path()
    if os.path.isfile(so):
        return so
    nvcc = find_nvcc()
    srcs, _ = _sources()
    os.makedirs(BUILD_DIR, exist_ok=True)
    with open(os.path.join(BUILD_DIR, ".lock"), "w") as lockf:
        fcntl.flock(lockf, fcntl.LOCK_EX)
        if os.path.isfile(so):       # built by another process while we waited
            return so
        tmp = f"{so}.{os.getpid()}.tmp"
        objs = [f"{tmp}.{os.path.basename(src)}.o" for src in srcs]
        try:
            procs = [(cmd, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                            stderr=subprocess.PIPE, text=True))
                     for cmd in ([nvcc, *NVCC_FLAGS, "-I", CSRC_DIR, "-c", "-o",
                                  obj, src] for src, obj in zip(srcs, objs))]
            results = [(cmd, p, *p.communicate()) for cmd, p in procs]
            for cmd, p, _, err in results:
                if p.returncode != 0:
                    raise RuntimeError(f"nvcc failed (rc {p.returncode}): "
                                       f"{' '.join(cmd)}\n{err}")
            cmd = [nvcc, *NVCC_FLAGS, "-shared", "-o", tmp, *objs]
            proc = subprocess.run(cmd, capture_output=True, text=True)
            if proc.returncode != 0:
                raise RuntimeError(f"nvcc failed (rc {proc.returncode}): "
                                   f"{' '.join(cmd)}\n{proc.stderr}")
            os.replace(tmp, so)
        finally:
            for f in objs:
                if os.path.exists(f):
                    os.remove(f)
    return so


def load_library() -> ctypes.CDLL:
    """Build (if needed) and load the kernel library, with every C entry
    point's signature declared."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(build())
            vp, ci = ctypes.c_void_p, ctypes.c_int
            lib.rt_render_fwd.restype = ci
            lib.rt_render_fwd.argtypes = [vp, vp, ci, vp, ci, vp, ci, vp,
                                          ci, ci, ci, ci, ci, ci, ci,
                                          vp, vp, ci, vp, vp, ci, vp, vp, ci, vp]
            lib.rt_render_list.restype = ci
            lib.rt_render_list.argtypes = [vp, vp, ci, vp, ci, vp, ci, vp, vp, ci, vp,
                                           ci, ci, ci, ci, ci, ci, vp]
            lib.rt_hit_extents.restype = ci
            lib.rt_hit_extents.argtypes = [vp, vp, ci, vp, ci, vp, ci, ci, ci, ci, ci,
                                           vp, vp, ci, vp, vp, ci, vp]
            lib.rt_render_bwd.restype = ci
            lib.rt_render_bwd.argtypes = [vp, vp, ci, vp, ci, vp, ci, vp, vp,
                                          vp, ci, ci, ci, ci, ci, ci, ci, ci,
                                          ci, vp]
            lib.rt_reduce_rows.restype = ci
            lib.rt_reduce_rows.argtypes = [vp, ci, ci, vp, vp]
            cf = ctypes.c_float
            lib.rt_soft_fwd.restype = ci
            lib.rt_soft_fwd.argtypes = [vp, vp, ci, vp, ci, vp, ci, cf, vp, ci, ci, vp]
            lib.rt_soft_bwd.restype = ci
            lib.rt_soft_bwd.argtypes = [vp, vp, ci, vp, ci, vp, ci, cf, vp, vp, ci, ci,
                                        ci, ci, ci, ci, ci, ci, ci, vp]
            lib.rt_soft_bwd_smem.restype = ctypes.c_longlong
            lib.rt_soft_bwd_smem.argtypes = [ci] * 8
            lib.rt_soft_bwd_attrs.restype = ci
            lib.rt_soft_bwd_attrs.argtypes = [vp, vp]
            lib.rt_error_string.restype = ctypes.c_char_p
            lib.rt_error_string.argtypes = [ci]
            _lib = lib
        return _lib
