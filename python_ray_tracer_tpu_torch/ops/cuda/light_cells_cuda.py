"""The light cells of the render kernel's bounce shadow rays, through the
hand-written CUDA kernel ``csrc/light_cells.cu``.

For each light, an axial cube map of ``R x R`` direction cells on each of its
3 faces (a direction ``d`` and ``-d`` share a cell); a cell's row holds, in
ascending index, every sphere that a shadow ray toward that light whose
direction the kernel files under the cell can report, on either side of the
light (the light buffer of Haines and Greenberg, 1986).
``csrc/rt_common.cuh`` (``occluded_cells``) derives the test and its margin and
reads the rows; a ray with ``|o| + reach`` past the header's ``s_max``, a
degenerate direction or an overflowed row (count ``-1``) takes the sweep of
before (the bounce tree from ``render_cuda.GROUP_MIN_SPHERES`` spheres, every
sphere below). No TPU kernel builds such a table.

:func:`light_cells_cuda` takes CUDA tensors only (``ValueError`` on others,
before any launch); :func:`light_cells_plain` is the plain version, by its own
name. The plain version computes
the kernel's float32 test operation for operation (one IEEE rounding each, no
fused multiply-add), so the two produce the same rows integer for integer.
:func:`occluded_cells_plain` is the plain lookup traversal that mirrors the
kernel's (the cell of a direction, the scale check, the row or the fallback),
the tests' and ``chip_smoke.py``'s reference; nothing on the card path uses it.
"""
from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from ..intersect import _dot
from ...utils.config import require_cuda
from . import cull_tables as ct
from . import render_cuda

# Mirrors of csrc/rt_common.cuh's constexprs: the cells' shape (LC_R, LC_K; the
# loader checks the library's), S_max / reach, the margin m / S_max, the cells'
# growth, the test's slack / S_max, the "holds the light" guard and the
# reach's rounding up.
R = 64
K = 32
SCALE = 4.0
MARGIN = 1.5e-3
GROW = 2.0 ** -20
TAU = 2.0 ** -14
HOLDS = 1.0 - 2.0 ** -10
REACH_UP = 1.0 + 2.0 ** -20
_ROW_BLOCK = 2048        # rows a chunk of the plain build
# Kernel launches; a plain counter, reset with reset_launch_counts().
LAUNCHES = {"light_cells": 0}
# Of those, the launches in the chunked form.
GLOBAL_LAUNCHES = {"light_cells": 0}
# The kernel stages 5 floats a sphere (and 32 bytes of its own) in a block's
# 227 KB; past that, CHUNK spheres at a time (csrc/light_cells.cu).
STAGED_WORDS = 5
CHUNK = 2048


def reset_launch_counts() -> None:
    LAUNCHES["light_cells"] = 0
    GLOBAL_LAUNCHES["light_cells"] = 0


def chunk_spheres(ns: int) -> int:
    """Spheres the kernel stages at a time: 0 (all of them, the staged form)
    where their terms fit a block (``render_cuda.scene_form``'s rule), up to
    11620 spheres; else :data:`CHUNK` (the chunked form, the same rows). On
    the card the staged form is the faster one at 100 spheres and the slower
    at 5000 (``chip_smoke.py`` phase 23 ``[size-form]``, PERF.md §6); where
    the two cross is not measured."""
    return CHUNK if render_cuda.scene_form(ns, 0, 0, False, 4 * STAGED_WORDS * ns + 32,
                                           render_cuda.SMEM_BLOCK) else 0


class LightCells(NamedTuple):
    """The rows as the kernels take them: ``idx (rows * k,)`` and ``cnt
    (rows,)`` int32, row ``(light * 3 + face) * r * r + iu * r + iv`` (count
    ``-1``: overflowed; slots past a count hold 0), and ``hdr (2,)`` float32,
    the scene's reach and ``s_max``."""
    idx: torch.Tensor
    cnt: torch.Tensor
    hdr: torch.Tensor


def n_rows(nl: int, r: int = R) -> int:
    """Rows of the light cells of ``nl`` lights (``nl`` csrc/rt_common.cuh
    ``LC_ROWS``)."""
    return nl * 3 * r * r


def _f32(x: float, dev) -> torch.Tensor:
    return torch.tensor(x, dtype=torch.float32, device=dev)


def _rsqrt(x: torch.Tensor) -> torch.Tensor:
    return torch.reciprocal(torch.sqrt(x))


def cell_cones(r: int = R, dev="cpu") -> torch.Tensor:
    """``(3 r r, 5)`` float32: each cell's central direction (x, y, z) and the
    cosine and sine of the largest angle from it to a corner of the cell's
    square grown by :data:`GROW`, as ``light_cells.cu`` ``cell_cone`` computes
    them."""
    cell = torch.arange(3 * r * r, device=dev)
    face, iu, iv = cell // (r * r), (cell // r) % r, cell % r
    step = _f32(2.0 / r, dev)
    u0, v0 = iu.float() * step - 1.0, iv.float() * step - 1.0
    mu, mv = u0 + 0.5 * step, v0 + 0.5 * step
    grow = _f32(GROW, dev)
    lo, hi = (u0 - grow, v0 - grow), ((u0 + step) + grow, (v0 + step) + grow)
    one = torch.ones_like(mu)
    ic = _rsqrt((mu * mu + mv * mv) + one)
    ca, cc, cz = mu * ic, mv * ic, ic
    cb, sb = one.clone(), torch.zeros_like(mu)
    for k in range(4):
        a, b = (hi[0] if k & 1 else lo[0]), (hi[1] if k & 2 else lo[1])
        iq = _rsqrt((a * a + b * b) + one)
        qa, qb, qz = a * iq, b * iq, iq
        dot = (ca * qa + cc * qb) + cz * qz
        x, y, z = cc * qz - cz * qb, cz * qa - ca * qz, ca * qb - cc * qa
        cb = torch.minimum(cb, dot)
        sb = torch.maximum(sb, torch.sqrt((x * x + y * y) + z * z))
    gx = torch.where(face == 0, cz, ca)
    gy = torch.where(face == 0, ca, torch.where(face == 1, cz, cc))
    gz = torch.where(face == 2, cz, cc)
    return torch.stack([gx, gy, gz, cb, sb], dim=1)


def scene_reach(centers, radii, lights) -> torch.Tensor:
    """The largest ``|c| + r`` and ``|l|``, rounded up (float32, 0-dim)."""
    dev = lights.device
    parts = [torch.zeros(1, dtype=torch.float32, device=dev)]
    if centers.shape[0]:
        parts.append(torch.sqrt(_dot(centers, centers)) + radii)
    if lights.shape[0]:
        parts.append(torch.sqrt(_dot(lights, lights)))
    return torch.cat(parts).amax() * _f32(REACH_UP, dev)


def light_cells_plain(centers, radii, lights, *, margin: float = MARGIN, tau: float = TAU,
                      r: int = R, k: int = K) -> LightCells:
    """The light cells with plain tensor ops on the inputs' device: for light
    ``l`` and each cell, every sphere ``j`` with ``w = c_j - l``, ``rho = r_j +
    m`` (``m = margin s_max``) that either holds the light (``rho^2 >= (1 -
    2^-10) |w|^2``) or passes ``|c^ . w| + tau >= cb sqrt(|w|^2 - rho^2) - sb
    rho`` (:func:`cell_cones`; ``tau = TAU s_max``), in the kernel's float32
    operations. ``margin``, ``tau``, ``r`` and ``k`` other than the defaults
    are for the tests (a kernel built with ``-DRT_LC_R`` / ``-DRT_LC_K`` takes
    the matching ``r`` and ``k``)."""
    dev = lights.device
    ns, nl = centers.shape[0], lights.shape[0]
    reach = scene_reach(centers, radii, lights)
    s_max = _f32(SCALE, dev) * reach
    m, tau = _f32(margin, dev) * s_max, _f32(tau, dev) * s_max
    cones = cell_cones(r, dev)
    idx = torch.zeros((n_rows(nl, r), k), dtype=torch.int32, device=dev)
    cnt = torch.zeros(n_rows(nl, r), dtype=torch.int32, device=dev)
    per = 3 * r * r
    for li in range(nl):
        w = centers - lights[li]
        ww = _dot(w, w)
        rho = radii + m
        rr = rho * rho
        holds = rr >= ww * _f32(HOLDS, dev)
        p = torch.where(holds, torch.full_like(ww, -1.0), torch.sqrt(ww - rr))
        for c0 in range(0, per, _ROW_BLOCK):
            cn = cones[c0:c0 + _ROW_BLOCK]
            x = ((cn[:, 0:1] * w[None, :, 0] + cn[:, 1:2] * w[None, :, 1]) +
                 cn[:, 2:3] * w[None, :, 2]).abs()
            keep = (p[None] < 0.0) | ((x + tau) >= (cn[:, 3:4] * p[None] -
                                                    cn[:, 4:5] * rho[None]))
            rows = slice(li * per + c0, li * per + c0 + cn.shape[0])
            got, cnt[rows] = ct._compact(keep, torch.arange(ns, device=dev)[None], k)
            idx[rows, :min(k, ns)] = got.reshape(cn.shape[0], -1)
    return LightCells(idx.reshape(-1).contiguous(), cnt,
                      torch.stack([reach, s_max]).contiguous())


def light_cell_of(d: torch.Tensor, r: int = R) -> torch.Tensor:
    """``(n,)`` int64: the cell of a light's rows that each direction ``d
    (n, 3)`` float32 is filed under, ``(face * r + iu) * r + iv``, or -1, as
    csrc/rt_common.cuh ``light_cell`` computes it."""
    dx, dy, dz = d.unbind(-1)
    ax, ay, az = dx.abs(), dy.abs(), dz.abs()
    ok = ((ax + ay) + az) <= 2.0
    fx = (ax >= ay) & (ax >= az)
    fy = ~fx & (ay >= az)
    face = torch.where(fx, 0, torch.where(fy, 1, 2))
    m = torch.where(fx, dx, torch.where(fy, dy, dz))
    p = torch.where(fx, dy, dx)
    q = torch.where(fx | fy, dz, dy)
    ok = ok & (m.abs() >= 0.5)
    m = torch.where(ok, m, torch.ones_like(m))
    half = _f32(0.5 * r, d.device)
    iu = torch.clamp((((p / m) + 1.0) * half).to(torch.int64), max=r - 1)
    iv = torch.clamp((((q / m) + 1.0) * half).to(torch.int64), max=r - 1)
    return torch.where(ok, (face * r + iu) * r + iv, torch.full_like(iu, -1))


def occluded_cells_plain(cells: LightCells, o, d, light: int, centers, radii, *,
                         compat: bool, cheap: bool, tree=None, r: int = R, k: int = K):
    """The kernel's bounce shadow sweep toward light ``light``
    (``occluded_cells``) over spheres only, for rays ``o + t d`` (``(n, 3)``
    float32): the row of the direction's cell where ``|o| + reach <= s_max``,
    the cell exists and the row did not overflow; else the sweep of before,
    :func:`cull_tables.tree_occluded_plain` with ``tree``, every sphere
    without. Returns ``(occluded, fallback, tests)``, each ``(n,)``: whether a
    sphere blocks the ray, whether it took the fallback, and the sphere tests
    it made up to its first occluder."""
    ns = centers.shape[0]
    dev = o.device
    occ_all = ct.sphere_occludes_plain(o, d, centers, radii, compat=compat, cheap=cheap)
    cell = light_cell_of(d, r)
    reach, s_max = cells.hdr[0], cells.hdr[1]
    big_s = torch.sqrt(_dot(o, o)) + reach
    row = light * 3 * r * r + cell.clamp(min=0)
    cnt = cells.cnt.long()[row]
    use = (cell >= 0) & (big_s <= s_max) & (cnt >= 0)
    slots = cells.idx.reshape(-1, k).long()[row]                     # (n, k)
    valid = torch.arange(k, device=dev)[None, :] < cnt[:, None]
    hit = torch.gather(occ_all, 1, torch.where(valid, slots, 0)) & valid
    listed = hit.any(dim=1)
    listed_tests = torch.where(listed, hit.int().argmax(dim=1) + 1, cnt.clamp(min=0))
    occ, tests = listed.clone(), listed_tests.long()
    fall = ~use
    if bool(fall.any()):
        if tree is not None:
            back, _, back_tests = ct.tree_occluded_plain(tree, o[fall], d[fall], centers,
                                                         radii, compat=compat, cheap=cheap)
        else:
            back = occ_all[fall].any(dim=1)
            back_tests = torch.where(back, occ_all[fall].int().argmax(dim=1) + 1,
                                     torch.full_like(back, ns, dtype=torch.int64))
        occ[fall], tests[fall] = back, back_tests.long()
    return occ, fall, tests


def _check(name, t, dtype, numel, dev):
    if t.device != dev or t.dtype != dtype or t.dim() != 1 or t.numel() != numel or \
            not t.is_contiguous():
        raise ValueError(f"light cells {name}: expected a contiguous {dtype} ({numel},) "
                         f"tensor on {dev}, got {t.dtype} {tuple(t.shape)} on {t.device}")


def check_cells(cells: LightCells, nl: int, dev) -> None:
    """Raise on light cells the kernels do not take (the shape R x K this
    package's kernels are built for, ``nl >= 1`` lights)."""
    if nl < 1:
        raise ValueError("light cells need a light")
    _check("indices", cells.idx, torch.int32, n_rows(nl) * K, dev)
    _check("counts", cells.cnt, torch.int32, n_rows(nl), dev)
    _check("header", cells.hdr, torch.float32, 2, dev)


def launch(out: LightCells, sph, lts, ns: int, nl: int, lib=None,
           chunk: int | None = None) -> LightCells:
    """Launch the kernel on the current stream into ``out`` (checked here)
    from the render kernel's SoA tables ``sph (7, *)`` and ``lts (3, nl)`` on
    the current device. ``lib``: a library built with other ``-DRT_LC_R`` /
    ``-DRT_LC_K`` (chip_smoke.py's sweep; ``out`` then unchecked), default
    the package's. ``chunk``: spheres staged at a time (default
    :func:`chunk_spheres`; 0 all at once). Counts the launch in
    :data:`LAUNCHES`."""
    from ._build import load_library
    if lib is None:
        lib = load_library()
        check_cells(out, nl, sph.device)
    chunk = chunk_spheres(ns) if chunk is None else chunk
    rc = lib.rt_light_cells(sph.data_ptr(), ns, lts.data_ptr(), nl, out.idx.data_ptr(),
                            out.cnt.data_ptr(), out.hdr.data_ptr(), chunk,
                            ctypes.c_void_p(torch.cuda.current_stream().cuda_stream))
    if rc != 0:
        raise RuntimeError(f"light-cell kernel failed: CUDA error {rc} "
                           f"({lib.rt_error_string(rc).decode()})")
    LAUNCHES["light_cells"] += 1
    if chunk:
        GLOBAL_LAUNCHES["light_cells"] += 1
    return out


def empty(nl: int, dev, r: int = R, k: int = K) -> LightCells:
    """Uninitialised rows for :func:`launch`."""
    return LightCells(torch.empty(n_rows(nl, r) * k, dtype=torch.int32, device=dev),
                      torch.empty(n_rows(nl, r), dtype=torch.int32, device=dev),
                      torch.empty(2, dtype=torch.float32, device=dev))


def light_cells_cuda(sph, lts, ns: int, nl: int) -> LightCells:
    """The light cells of a scene from the render kernel's SoA tables (
    ``render_cuda.scene_tables``: ``sph (7, *)``, ``lts (3, nl)``), CUDA
    tensors only (``ValueError`` on others): one launch of the kernel, no
    host sync."""
    dev = require_cuda("light_cells_cuda", sph, lts)
    if nl < 1:
        raise ValueError("light cells need a light")
    with torch.cuda.device(dev):
        return launch(empty(nl, dev), sph, lts, ns, nl)
