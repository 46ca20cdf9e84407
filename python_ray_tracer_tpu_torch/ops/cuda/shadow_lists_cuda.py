"""The shadow lists of the render kernel through the hand-written CUDA
kernel ``csrc/shadow_lists.cu``.

Per (tile, light), the spheres that can block a shadow ray from a point of the
tile's hit box (a row of the hit-extent kernel, ``hit_extents_cuda``) toward
the light or beyond it (per (tile, level, light) for the lists of L trace
levels, whose hit-extent rows are ``tile * L + level``), from the largest
apparent size from the light down; the rules, the slots and the counts are
``cull_tables.shadow_visibility_lists``' (the JAX package's
``_shadow_visibility_lists``, plain ``jnp`` outside any kernel there: no TPU
kernel computes these lists). The kernel reads the hit-extent kernel's rows
and scale where they lie on the card, so the render path builds its lists with
two launches and no host sync.

:func:`shadow_lists_cuda` takes CUDA tensors only (``ValueError`` on others,
before any launch); ``cull_tables.shadow_visibility_lists`` is the plain
function, by its own name. The kernel computes the
plain function's float32 operations in its order, one IEEE rounding each and
no fused multiply-add, so the two give the same rows integer for integer on
the same hit-extent rows; ``chip_smoke.py`` (``[lists]``) and
``tests/test_torch_card.py`` hold it to that.
"""
from __future__ import annotations

import ctypes

import torch

from . import cull_tables as ct
from . import render_cuda
from .hit_extents_cuda import check_scale
from ...utils.config import require_cuda

# Kernel launches; a plain counter, reset with reset_launch_counts().
LAUNCHES = {"shadow_lists": 0}
# Of those, the launches in the chunked form.
GLOBAL_LAUNCHES = {"shadow_lists": 0}
# The kernel stages 6 words a sphere in a block's 227 KB; past that, CHUNK
# positions of a light's order at a time (csrc/shadow_lists.cu).
STAGED_WORDS = 6
CHUNK = 2048


def reset_launch_counts() -> None:
    LAUNCHES["shadow_lists"] = 0
    GLOBAL_LAUNCHES["shadow_lists"] = 0


def chunk_spheres(ns: int) -> int:
    """Spheres the kernel stages at a time: 0 (all of them, the staged form)
    where they fit a block (``render_cuda.scene_form``'s rule), up to 9685
    spheres; else :data:`CHUNK` (the chunked form, the same rows)."""
    return CHUNK if render_cuda.scene_form(ns, 0, 0, False, 4 * STAGED_WORDS * ns,
                                           render_cuda.SMEM_BLOCK) else 0


def _check(name, t, dtype, shape, dev):
    if t.device != dev or t.dtype != dtype or tuple(t.shape) != tuple(shape) or \
            not t.is_contiguous():
        raise ValueError(f"shadow lists {name}: expected a contiguous {dtype} "
                         f"{tuple(shape)} tensor on {dev}, got {t.dtype} "
                         f"{tuple(t.shape)} on {t.device}")


def launch(idx, cnt, ext, scale, lights, centers, radii, order, *, k: int,
           compat: bool, chunk: int | None = None):
    """Launch the kernel on the current stream into ``idx (T * nl * k,)`` and
    ``cnt (T * nl,)`` int32 from the hit-extent rows ``ext (T, 8)`` (``T``
    the tiles, or the tiles times the listed levels) and their ``scale
    (1,)``, the scene's ``lights (nl, 3)``, ``centers (ns, 3)`` and ``radii
    (ns,)`` (float32) and each light's sphere order ``order
    (nl, ns)`` int32 (``cull_tables.light_order``), all on one CUDA device
    and checked here; ``k = min(K, ns)`` slots a row. ``chunk``: spheres
    staged at a time (default :func:`chunk_spheres`; 0 all at once). Counts
    the launch in :data:`LAUNCHES`. Returns ``(idx, cnt)``."""
    from ._build import load_library
    dev = ext.device
    T, nl, ns = ext.shape[0], lights.shape[0], centers.shape[0]
    if T < 1 or nl < 1 or not 1 <= k <= ns:
        raise ValueError(f"shadow lists: {T} tiles, {nl} lights, k={k} for {ns} spheres")
    _check("hit-extent rows", ext, torch.float32, (T, 8), dev)
    check_scale(scale, dev)
    _check("lights", lights, torch.float32, (nl, 3), dev)
    _check("centers", centers, torch.float32, (ns, 3), dev)
    _check("radii", radii, torch.float32, (ns,), dev)
    _check("order", order, torch.int32, (nl, ns), dev)
    _check("indices", idx, torch.int32, (T * nl * k,), dev)
    _check("counts", cnt, torch.int32, (T * nl,), dev)
    lib = load_library()
    chunk = chunk_spheres(ns) if chunk is None else chunk
    rc = lib.rt_shadow_lists(
        ext.data_ptr(), scale.data_ptr(), lights.data_ptr(), nl, centers.data_ptr(),
        radii.data_ptr(), ns, order.data_ptr(), T, k, int(compat), idx.data_ptr(),
        cnt.data_ptr(), chunk, ctypes.c_void_p(torch.cuda.current_stream().cuda_stream))
    if rc != 0:
        raise RuntimeError(f"shadow-list kernel failed: CUDA error {rc} "
                           f"({lib.rt_error_string(rc).decode()})")
    LAUNCHES["shadow_lists"] += 1
    if chunk:
        GLOBAL_LAUNCHES["shadow_lists"] += 1
    return idx, cnt


def shadow_lists_cuda(ext, scale, lights, centers, radii, *, K: int, compat: bool):
    """Per-(tile, light) occluder lists ``(idx (T * nl * k,), cnt (T * nl,))``
    int32, ``k = min(K, ns)``, row ``tile * nl + light`` (with L levels
    ``(tile * L + level) * nl + light``), from the hit-extent rows ``ext (T,
    8)`` and their ``scale`` (``(1,)``: the boxes'
    largest coordinate magnitude, as ``hit_extents_cuda`` writes it), CUDA
    tensors only (``ValueError`` on others): one launch of the kernel, no
    host sync."""
    dev = require_cuda("shadow_lists_cuda", ext, scale, lights, centers, radii)
    T, nl, ns = ext.shape[0], lights.shape[0], centers.shape[0]
    k = min(K, ns)
    lights, centers, radii = (t.contiguous() for t in (lights, centers, radii))
    with torch.cuda.device(dev):
        order = ct.light_order(lights, centers, radii).to(torch.int32)
        return launch(torch.empty(T * nl * k, dtype=torch.int32, device=dev),
                      torch.empty(T * nl, dtype=torch.int32, device=dev), ext, scale,
                      lights, centers, radii, order, k=k, compat=compat)
