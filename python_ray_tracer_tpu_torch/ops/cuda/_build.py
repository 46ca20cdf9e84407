"""Build and load the port's CUDA kernels (``python_ray_tracer_tpu_torch/csrc/``).

The ``.cu`` sources are compiled with ``nvcc``, one process per source, all
started together, and linked into one shared library with a plain C interface,
bound with ``ctypes`` (no PyTorch headers, so a build takes seconds). The
library name carries a hash of the sources and flags: a source change builds a
new library, and an ``flock`` a library keeps concurrent processes from
building the same one twice. Nothing is built at import; :func:`load_library`
builds on first use and raises with the compiler's stderr if it cannot, or if
the library's bounce-tree shape is not ``cull_tables.LEAF`` / ``FAN`` or
its light cells' is not ``light_cells_cuda.R`` / ``K``. :func:`build` also
takes a subset of the sources and extra ``-D`` flags, for ``chip_smoke.py``'s
kernels of other tree and light-cell shapes and hit-extent group sizes; the
package loads only the default library.
"""
from __future__ import annotations

import ctypes
import glob
import hashlib
import os
import shutil
import subprocess
import threading
import time

from ...utils.build_once import build_once

PKG_DIR = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
CSRC_DIR = os.path.join(PKG_DIR, "csrc")
BUILD_DIR = os.path.join(PKG_DIR, "build")

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC")

_lock = threading.Lock()
_lib: ctypes.CDLL | None = None
# Seconds each source's nvcc took in this process's last build (file name ->
# seconds from the start of the build to that process's exit), and the link's.
BUILD_SECONDS: dict = {}


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


def _sources(names=None):
    srcs = sorted(glob.glob(os.path.join(CSRC_DIR, "*.cu")))
    hdrs = sorted(glob.glob(os.path.join(CSRC_DIR, "*.cuh")))
    if names is not None:
        srcs = [os.path.join(CSRC_DIR, n) for n in names]
        missing = [p for p in srcs if not os.path.isfile(p)]
        if missing:
            raise RuntimeError(f"no such CUDA sources: {missing}")
    if not srcs:
        raise RuntimeError(f"no CUDA sources under {CSRC_DIR}")
    return srcs, hdrs


def library_path(sources=None, defines=()) -> str:
    """Where the library for the current sources and flags lives (``sources``:
    file names under csrc/, default all; ``defines``: extra nvcc flags)."""
    srcs, hdrs = _sources(sources)
    h = hashlib.sha256(" ".join((*NVCC_FLAGS, *defines)).encode())
    for p in srcs + hdrs:
        with open(p, "rb") as f:
            h.update(os.path.basename(p).encode() + b"\0" + f.read())
    return os.path.join(BUILD_DIR, f"librt_kernels_{h.hexdigest()[:16]}.so")


def build(sources=None, defines=()) -> str:
    """Compile the kernels if the library for the current sources is missing.
    Returns its path; raises ``RuntimeError`` with nvcc's stderr on failure.
    ``sources`` and ``defines`` as for :func:`library_path`."""
    so = library_path(sources, defines)
    if os.path.isfile(so):
        return so
    nvcc = find_nvcc()
    srcs, _ = _sources(sources)
    flags = (*NVCC_FLAGS, *defines)

    def make(tmp: str) -> None:
        objs = [f"{tmp}.{os.path.basename(src)}.o" for src in srcs]
        try:
            t0 = time.perf_counter()
            procs = [(src, cmd, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                                 stderr=subprocess.PIPE, text=True))
                     for src, cmd in ((src, [nvcc, *flags, "-I", CSRC_DIR, "-c", "-o",
                                             obj, src]) for src, obj in zip(srcs, objs))]
            seconds, errs = {}, {}

            def wait(src, p):
                errs[src] = p.communicate()[1]
                seconds[os.path.basename(src)] = time.perf_counter() - t0
            waits = [threading.Thread(target=wait, args=(src, p)) for src, _, p in procs]
            for w in waits:
                w.start()
            for w in waits:
                w.join()
            for src, cmd, p in procs:
                if p.returncode != 0:
                    raise RuntimeError(f"nvcc failed (rc {p.returncode}): "
                                       f"{' '.join(cmd)}\n{errs[src]}")
            cmd = [nvcc, *flags, "-shared", "-o", tmp, *objs]
            t1 = time.perf_counter()
            proc = subprocess.run(cmd, capture_output=True, text=True)
            seconds["link"] = time.perf_counter() - t1
            BUILD_SECONDS.clear()
            BUILD_SECONDS.update(seconds)
            if proc.returncode != 0:
                raise RuntimeError(f"nvcc failed (rc {proc.returncode}): "
                                   f"{' '.join(cmd)}\n{proc.stderr}")
        finally:
            for f in objs:
                if os.path.exists(f):
                    os.remove(f)
    return build_once(so, make)


def declare(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Declare the signature of every C entry point that ``lib`` holds."""
    vp, ci, cf = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    tables = [vp, vp, ci, vp, vp, ci, ci, vp, vp, ci, vp, vp, vp]   # lists, tree, light cells
    sigs = {
        "rt_render_fwd": (ci, [vp, vp, ci, vp, ci, vp, ci, vp, ci, ci, ci, ci, ci, ci, ci,
                               ci, *tables, vp]),
        "rt_render_list": (ci, [vp, vp, ci, vp, ci, vp, ci, vp, vp, ci, vp, ci, ci, ci, ci,
                                ci, ci, *tables, vp]),
        "rt_render_fwd_global": (ci, [vp, vp, ci, vp, ci, vp, ci, vp, ci, ci, ci, ci, ci, ci,
                                      ci, *tables, vp]),
        "rt_render_list_global": (ci, [vp, vp, ci, vp, ci, vp, ci, vp, vp, ci, vp, ci, ci, ci,
                                       ci, ci, *tables, vp]),
        "rt_tree_shape": (None, [ctypes.POINTER(ci), ctypes.POINTER(ci)]),
        "rt_light_cells": (ci, [vp, ci, vp, ci, vp, vp, vp, ci, vp]),
        "rt_light_cells_shape": (None, [ctypes.POINTER(ci), ctypes.POINTER(ci)]),
        "rt_hit_extents": (ci, [vp, vp, ci, vp, ci, vp, vp, ci, ci, ci, ci, ci, ci, vp, vp,
                                ci, vp, vp, ci, ci, vp]),
        "rt_shadow_lists": (ci, [vp, vp, vp, ci, vp, vp, ci, vp, ci, ci, ci, vp, vp, ci, vp]),
        "rt_render_bwd": (ci, [vp, vp, ci, vp, ci, vp, ci, vp, vp, vp, ci, ci, ci, ci, ci,
                               ci, ci, ci, ci, ci, ci, ci, ci, *tables, ci, vp, vp]),
        "rt_render_bwd_rows": (ci, [vp, vp, ci, vp, ci, vp, ci, vp, vp, vp, ci, ci, ci, ci, ci,
                                    ci, ci, ci, ci, ci, vp, *tables, vp, vp]),
        "rt_reduce_rows": (ci, [vp, ci, ci, vp, vp]),
        "rt_soft_fwd": (ci, [vp, vp, ci, vp, ci, vp, ci, cf, vp, ci, ci, ci, vp]),
        "rt_soft_fwd_cap": (ci, [ci, ci, ci, ci]),
        "rt_soft_bwd": (ci, [vp, vp, ci, vp, ci, vp, ci, cf, vp, vp, ci, ci, ci, ci, ci, ci,
                             ci, ci, ci, ci, ci, vp, vp]),
        "rt_soft_bwd_smem": (ctypes.c_longlong, [ci] * 10),
        "rt_soft_bwd_attrs": (ci, [vp, vp]),
        "rt_error_string": (ctypes.c_char_p, [ci]),
    }
    for name, (res, args) in sigs.items():
        if hasattr(lib, name):
            fn = getattr(lib, name)
            fn.restype, fn.argtypes = res, args
    return lib


def tree_shape(lib: ctypes.CDLL):
    """``(leaf, fan)``: the bounce-tree shape ``lib``'s kernels were built for."""
    leaf, fan = ctypes.c_int(), ctypes.c_int()
    lib.rt_tree_shape(ctypes.byref(leaf), ctypes.byref(fan))
    return leaf.value, fan.value


def light_cells_shape(lib: ctypes.CDLL):
    """``(r, k)``: the light cells' shape ``lib``'s kernels were built for."""
    r, k = ctypes.c_int(), ctypes.c_int()
    lib.rt_light_cells_shape(ctypes.byref(r), ctypes.byref(k))
    return r.value, k.value


def load_library() -> ctypes.CDLL:
    """Build (if needed) and load the kernel library, with every C entry
    point's signature declared."""
    global _lib
    with _lock:
        if _lib is None:
            from . import light_cells_cuda as lc
            from .cull_tables import FAN, LEAF
            lib = declare(ctypes.CDLL(build()))
            if tree_shape(lib) != (LEAF, FAN):
                raise RuntimeError(f"kernel library built for bounce-tree shape "
                                   f"{tree_shape(lib)}, cull_tables has {(LEAF, FAN)}")
            if light_cells_shape(lib) != (lc.R, lc.K):
                raise RuntimeError(f"kernel library built for light cells "
                                   f"{light_cells_shape(lib)}, light_cells_cuda has "
                                   f"{(lc.R, lc.K)}")
            _lib = lib
        return _lib
