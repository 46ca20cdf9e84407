"""Adaptive-AA render through the hand-written CUDA worklist kernel
(``csrc/render_fwd_kernel.cuh`` ``render_list_kernel``).

Counterpart of ``python_ray_tracer_tpu/ops/pallas/render_adaptive.py``
``render_image_adaptive`` (TPU kernel ``_make_list_kernel``). A frame is:

  1. the large-scene tables above ``CULL_MIN_SPHERES`` spheres
     (:func:`render_cuda.large_scene_tables`, with the hit-extent kernel over
     the AA lattice), then the centers pass: :func:`render_cuda.render_packed`
     in mode ``aa_none`` on those tables (the AA lattice's shadow lists hold
     the centers' ones, so its frame is ``render_image_cuda(aliasing=False)``'s);
  2. the glue, PyTorch ops on the card (``ops/adaptive.py``): the stored to
     (r, g, b) channel swap under compat, the curvature flags, the tent image
     and the static-budget compaction (a cumulative sum and a binary search:
     no host sync, the flagged count stays on the device);
  3. one launch of the worklist kernel on the same tables, which writes the
     9-sample average of each listed pixel into the tent image in place.

The TPU design traced a list of fractional sample coordinates into a sample
buffer and scattered the combined rows with XLA; here each thread of the
kernel owns one listed pixel, derives its coordinates from the flat index and
writes its 12 bytes itself. :func:`render_image_adaptive_cuda` takes CUDA
tensors only: on tensors anywhere else it raises ``ValueError`` and launches
nothing (the plain version is ``ops/adaptive.render_image_adaptive_plain``, by
its own name).
"""
from __future__ import annotations

import ctypes

import torch

from ..adaptive import budget_slots, stored_to_rgb, tent_and_worklist
from . import render_cuda
from ...utils.config import require_cuda

# Worklist kernel launches; a plain counter, reset with reset_launch_counts().
LAUNCHES = {"render_list": 0}
# Of those, the launches in the global form.
GLOBAL_LAUNCHES = {"render_list": 0}


def reset_launch_counts() -> None:
    LAUNCHES["render_list"] = 0
    GLOBAL_LAUNCHES["render_list"] = 0


def launch_list(out, params, tables, counts, idx, flagged, *, depth: int, compat: bool,
                cheap_shadow: bool, vis=None, shadow=None, tree=None,
                cells=None, form: int | None = None) -> torch.Tensor:
    """Launch the worklist kernel on the current stream: for each of the first
    ``min(flagged, len(idx))`` slots of ``idx`` (int32 flat indices ``x * H +
    y``), write that pixel's 9-sample AA average into ``out (W, H, 3)`` (the
    tent image) in place. ``params``, ``tables`` and ``counts`` as
    :func:`render_cuda.packed_inputs` returns them; ``flagged`` an int32
    tensor of one element on the same device, read by the kernel. A scene of
    more than ``CULL_MIN_SPHERES`` spheres runs the large-scene instantiation
    (the pinned arithmetic), which takes ``vis``, ``shadow``, ``tree`` and
    ``cells`` as :func:`render_cuda.large_scene_tables` returns them for
    ``aliasing=True`` (checked here; each None sweeps all spheres), in the
    form the render kernel takes for the scene (``render_cuda.scene_form``;
    ``form``: another, the same bits). Counts the launch in
    :data:`LAUNCHES`."""
    from ._build import load_library
    from .hit_extents_cuda import check_tables, table_args
    from .cull_tables import tile_grid
    dev = out.device
    if out.dtype != torch.float32 or out.dim() != 3 or out.shape[2] != 3 or \
            not out.is_contiguous():
        raise ValueError(f"out must be a contiguous float32 (W, H, 3) tensor, got "
                         f"{out.dtype} {tuple(out.shape)}")
    for name, t, n in (("idx", idx, None), ("flagged", flagged, 1)):
        if t.device != dev or t.dtype != torch.int32 or not t.is_contiguous() or \
                (n is not None and t.numel() != n):
            raise ValueError(f"{name} must be a contiguous int32 tensor on {dev}"
                             f"{'' if n is None else ' of one element'}, got {t.dtype} "
                             f"{tuple(t.shape)} on {t.device}")
    if idx.dim() != 1 or idx.numel() < 1:
        raise ValueError(f"idx must be a non-empty vector, got shape {tuple(idx.shape)}")
    lib = load_library()
    W, H = out.shape[0], out.shape[1]
    (sph, pln, lts), (ns, npl, nl) = tables, counts
    n_tx, n_ty = tile_grid(W, H)
    check_tables(vis, shadow, tree, n_tiles=n_tx * n_ty, ns=ns, nl=nl, dev=dev, cells=cells)
    v, sh, g, c = table_args(vis, shadow, tree, cells)
    large = ns > render_cuda.CULL_MIN_SPHERES
    if form is None:
        form = render_cuda.scene_form(ns, npl, nl, tree is not None) if large else 0
    if form and not large:
        raise ValueError(f"a scene of {ns} spheres has no global form")
    args = (params.data_ptr(), sph.data_ptr(), ns, pln.data_ptr(), npl, lts.data_ptr(), nl,
            idx.data_ptr(), flagged.data_ptr(), idx.numel(), out.data_ptr(), W, H, depth,
            int(compat), int(cheap_shadow))
    stream = ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)
    if form:
        rc = lib.rt_render_list_global(*args, *v, *sh, *g, *c, stream)
    else:
        rc = lib.rt_render_list(*args, int(large), *v, *sh, *g, *c, stream)
    if rc != 0:
        raise RuntimeError(f"worklist kernel failed: CUDA error {rc} "
                           f"({lib.rt_error_string(rc).decode()})")
    LAUNCHES["render_list"] += 1
    if form:
        GLOBAL_LAUNCHES["render_list"] += 1
    return out


def worklist_inputs(camera, scene, *, depth: int, compat: bool, eps: float,
                    budget_frac: float):
    """The adaptive frame's steps before the worklist launch, on CUDA inputs:
    ``(packed, tabs, tent, idx, flagged, dropped)``, the :func:`render_cuda.
    packed_inputs`, the large-scene tables ``(vis, shadow, tree, cells)`` (built once,
    for the AA lattice, and taken by both launches), the tent image, the
    K-slot worklist and the two counts (device tensors). Runs the centers pass
    (the render kernel in mode ``aa_none``) and the glue ops."""
    packed = render_cuda.packed_inputs(camera, scene, depth=depth, compat=compat)
    W, H = camera.resolution
    with torch.cuda.device(packed[0].device):
        tabs = render_cuda.large_scene_tables(camera, scene, depth=depth, aliasing=True,
                                              compat=compat, packed=packed)
    centers = render_cuda.render_packed(camera, scene, packed, depth=depth, mode="aa_none",
                                        compat=compat, tabs=tabs)
    return (packed, tabs, *tent_and_worklist(stored_to_rgb(centers, compat), compat=compat,
                                             eps=eps, K=budget_slots(W, H, budget_frac)))


def render_image_adaptive_cuda(camera, scene, *, depth: int = 2, compat: bool = True,
                               eps: float = 1.0 / 255, budget_frac: float = 0.25,
                               with_stats: bool = False):
    """Adaptive-AA render -> float ``(w, h, 3)`` (the layout of
    ``render_image_cuda(aliasing=True)``). ``eps``: the curvature threshold
    in [0, 1] color units (1/255 is one uint8 step); ``eps < 0`` flags every
    interior pixel, and with ``budget_frac=1`` the frame is then the
    per-sample AA render's. ``budget_frac``: the worklist's static length as a
    share of the pixels; pixels flagged past it keep the tent value. Returns
    ``image`` or ``(image, {"flagged": n, "dropped": n})``, the counts as
    0-dim int32 tensors on the image's device (reading them is the caller's
    sync). CUDA tensors only (``ValueError`` on others)."""
    require_cuda("render_image_adaptive_cuda", camera.position)
    packed, (vis, shadow, tree, cells), out, idx, flagged, dropped = worklist_inputs(
        camera, scene, depth=depth, compat=compat, eps=eps, budget_frac=budget_frac)
    with torch.cuda.device(out.device):
        launch_list(out, *packed, idx, flagged, depth=depth, compat=compat,
                    cheap_shadow=render_cuda.shadow_cheap_ok(scene, compat), vis=vis,
                    shadow=shadow, tree=tree, cells=cells)
    if with_stats:
        return out, {"flagged": flagged, "dropped": dropped}
    return out
