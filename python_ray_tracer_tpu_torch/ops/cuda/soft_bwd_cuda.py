"""Scene and camera gradients of the soft render through the hand-written CUDA
backward kernel (``csrc/soft_bwd.cu``).

Counterpart of ``python_ray_tracer_tpu/ops/pallas/soft_bwd.py``. The kernel
takes each pixel's soft forward values once (a lane-private table of its live
objects), reverse-sweeps them with hand-derived adjoints (the
sigmoid-cancelling identities: no division by ``1 - alpha``), skips every term
that is exactly 0, and reduces each gradient slot once a window of spheres or
a chunk of objects into the flat vector of ``render_bwd_cuda.grad_layout``;
``rt_reduce_rows`` sums the per-block partials in a fixed order, so two runs
give the same bits. :func:`plan` picks the block shape and the chunk sizes from
the scene's counts. Two kernel modes:

  * ``cot``: an image cotangent in (:func:`soft_scene_grads_cuda`);
  * ``fused``: the training step in one launch: render, MSE against the
    target, loss slot, reverse sweep (:func:`soft_loss_and_grads_cuda`).

Both fill the camera slots; the ``refl``, ``spec`` and ``shin`` slots stay 0
(the soft scope has no mirror bounce and no Phong). The plain versions
(:func:`soft_scene_grads_plain`, :func:`soft_loss_and_grads_plain`) are
``torch.autograd`` of ``ops/soft.py`` packed into the same layout, reached by
their own names; the wrappers take CUDA tensors only and raise ``ValueError``
on others, before any launch. Every entry point takes the slice form of
``soft_bwd._soft_grads_pallas`` (``x_offset`` / ``local_width``: a slice's
partials over the frame's denominator, as ``render_bwd_cuda``'s).
"""
from __future__ import annotations

import ctypes
import math
from typing import NamedTuple

import torch

from ..soft import render_image_soft
from ...utils.config import require_cuda
from . import render_cuda, soft_cuda
from .render_bwd_cuda import (BLOCKS_PER_SM, H100_SMS, SM_SMEM, _autograd_flat,
                              grad_groups, n_grads, slice_mse, unflatten_grads)

MODES = ("cot", "fused")
# Kernel launches per mode and plain-version calls; plain counters, reset with
# reset_launch_counts().
LAUNCHES = {m: 0 for m in MODES}
# Of those, the launches in the third form (rows in device memory).
ROWS_LAUNCHES = {m: 0 for m in MODES}
PLAIN_CALLS = {"soft_scene_grads": 0, "soft_loss_and_grads": 0}

BLOCK_Y = 16                 # threads a block along the image's y axis
MAX_OBJECTS = 1 << 21        # spheres and planes a launch indexes (soft_bwd.cu GI_BITS)
SMEM_LIMIT = 227 * 1024     # shared memory a block can have on Hopper


def reset_launch_counts() -> None:
    for m in MODES:
        LAUNCHES[m] = 0
        ROWS_LAUNCHES[m] = 0
    for k in PLAIN_CALLS:
        PLAIN_CALLS[k] = 0


# --- the plain version: autograd of ops/soft.py -----------------------------------

def soft_scene_grads_plain(camera, scene, g_image, *, tau: float = 0.05,
                           row_chunk: int | None = None,
                           bounce_depth: int = 0, x_offset: int = 0,
                           local_width: int | None = None) -> torch.Tensor:
    """Plain version of the cotangent mode: the vector-Jacobian product of
    ``render_image_soft`` (of the slice ``x_offset`` / ``local_width``) with
    ``g_image (w, h, 3)``, as a flat vector of ``grad_layout`` (camera slots
    included). ``row_chunk`` bounds its memory (checkpointed blocks,
    :func:`..soft.render_image_soft`)."""
    PLAIN_CALLS["soft_scene_grads"] += 1

    def objective(cam, sc):
        img = render_image_soft(cam, sc, tau=tau, row_chunk=row_chunk,
                                bounce_depth=bounce_depth, x_offset=x_offset,
                                local_width=local_width)
        return (img * g_image.detach()).sum(), None
    return _autograd_flat(camera, scene, objective)


def soft_loss_and_grads_plain(camera, scene, target, *, tau: float = 0.05,
                              row_chunk: int | None = None,
                              bounce_depth: int = 0, x_offset: int = 0,
                              local_width: int | None = None) -> torch.Tensor:
    """Plain version of the fused mode: ``mean((render - target)^2)`` and its
    gradient, as a flat vector with the loss in the trailing slot; for a
    slice, its part of the frame's MSE (``render_bwd_cuda.slice_mse``)."""
    PLAIN_CALLS["soft_loss_and_grads"] += 1

    def objective(cam, sc):
        img = render_image_soft(cam, sc, tau=tau, row_chunk=row_chunk,
                                bounce_depth=bounce_depth, x_offset=x_offset,
                                local_width=local_width)
        loss = slice_mse(img, target.detach(), camera.resolution[0])
        return loss, loss
    return _autograd_flat(camera, scene, objective)


# The JAX package's rule for the soft backward kernel against autodiff
# (tests/test_soft_bwd.py:30-70): every scene leaf |d| <= 5e-6 * max(max|g|, 1)
# + 5e-3 |g| (reassociation noise is relative to the leaf's accumulated sum);
# camera position atol 1e-5, rotation atol 1e-3, both rtol 5e-3; fov, a heavily
# cancelling lane sum, atol 3e-5 alone; the loss rel 1e-5.
CAMERA_ATOL = {"camera.position": 1e-5, "camera.rotation": 1e-3}


def soft_grad_rule(flat: torch.Tensor, ref: torch.Tensor, ns: int, npl: int, nl: int,
                   ref64: torch.Tensor | None = None) -> dict:
    """Hold a flat gradient against a reference under the rule above:
    ``{group: (max |d| / allowance, ok)}``, ok when the ratio is <= 1. With
    ``ref64`` (the plain version in float64) the allowances come from it, and
    each element may lie within its allowance of ``ref`` or of ``ref64``
    (soft_cuda.image_rule's reason): never farther than that from both."""
    def groups(f):
        return grad_groups(f.detach().double().cpu(), ns, npl, nl)
    got = groups(flat)
    want = groups(ref if ref64 is None else ref64)
    alt = None if ref64 is None else groups(ref)
    out = {}
    for path, b in want.items():
        d = (got[path] - b).abs()
        if alt is not None:
            d = torch.minimum(d, (got[path] - alt[path]).abs())
        if path == "camera.fov":
            allow = torch.full_like(b, 3e-5)
        elif path == "loss":
            allow = 1e-5 * b.abs()
        elif path in CAMERA_ATOL:
            allow = CAMERA_ATOL[path] + 5e-3 * b.abs()
        else:
            scale = max(float(b.abs().max()), 1.0) if b.numel() else 1.0
            allow = 5e-6 * scale + 5e-3 * b.abs()
        ratio = float((d / allow).max()) if d.numel() else 0.0
        out[path] = (ratio, ratio <= 1.0)
    return out


# --- the kernel ------------------------------------------------------------------

class Plan(NamedTuple):
    """One soft backward launch's shape: ``nt`` threads a block (16 along y),
    ``cap`` live objects a pixel keeps in its table at once, ``cj`` spheres a
    window of the lane-private slab, ``store_vis`` (the table keeps one
    transmission a light), the block's shared memory in bytes and ``staged``
    (the sphere table and three values a sphere in shared memory; else the
    global form reads the table from device memory and computes the values
    where it needs them, soft_bwd.cu) and ``device_rows`` (the third form:
    the global form with the warps' rows in a device-memory scratch buffer
    of :func:`scratch_floats` floats)."""
    nt: int
    cap: int
    cj: int
    store_vis: bool
    smem: int
    staged: bool = True
    device_rows: bool = False


N_TFIXED = 6                 # table fields besides the transmissions (soft_bwd.cu)


def smem_bytes(ns: int, npl: int, nl: int, fused: bool, nt: int, cap: int, cj: int,
               store_vis: bool, staged: bool = True, device_rows: bool = False) -> int:
    """Shared memory of one block (``rt_soft_bwd_smem``): the scene (with the
    sphere table and three floats a sphere, 10 words, only when ``staged``), a
    row of gradient slots a warp (not with ``device_rows``), and each thread's
    table and slab."""
    nf = N_TFIXED + (nl if store_vis else 0)
    rows = 0 if device_rows else (nt // 32) * n_grads(ns, npl, nl, fused)
    return 4 * (render_cuda.N_PARAMS + (10 * ns if staged else 0) + 9 * npl + 3 * nl
                + rows + nt * (nf * cap + 7 * cj))


def scratch_floats(ns: int, npl: int, nl: int, fused: bool, W: int, H: int,
                   shape: Plan) -> int:
    """Device memory of a launch's rows (floats): the third form's blocks x
    warps x n_grads, else 0. The third form's grid is the card's size
    (:func:`n_blocks`), so this is bounded by the scene, not the frame: at
    128 threads, 132 x 4 rows, about 14.8 KB a sphere (242 MB at 16384
    spheres, 969 MB at 65536)."""
    if not shape.device_rows:
        return 0
    return n_blocks(W, H, shape) * (shape.nt // 32) * n_grads(ns, npl, nl, fused)


def plan(ns: int, npl: int, nl: int, fused: bool = True, staged: bool | None = None,
         device_rows: bool | None = None) -> Plan:
    """The block shape and chunk sizes for a scene: the first plan that fits
    a block's shared memory, the staged form first and then the global one
    (past 3388 spheres at 1 plane and 3 lights), within a form taking the most
    threads a block (128, 64, 32), then stored transmissions, then the most
    live objects a chunk (``cap``, up to 32 and the object count: a pixel with
    more live objects than that forms its weights from fresh covers) and the
    widest window (``cj``, up to 16 spheres), halving the larger of the two
    until they fit. On the card (``chip_smoke.py`` phase 12's plan sweep,
    PERF.md §6) this is the fastest plan of the sweep on the demo scene and
    17% slower than the fastest at 100 spheres, where no simple rule picked
    the best. The global form is slower than the staged one on every scene
    both take (phase 22's ``[repair-form]``), with the same plan or its own,
    hence staged first; ``staged`` True or False: that form's plan alone.
    Where neither form fits (past 8228 spheres at 1 plane and 3 lights) the
    third form, the global form with the warps' rows in device memory and a
    grid of the card's size (:func:`n_blocks`), by the same rule (``device_rows`` True: that form alone; False: never).
    Raises ``ValueError`` where no form fits, or for :data:`MAX_OBJECTS`
    objects and more."""
    if ns + npl >= MAX_OBJECTS:
        raise ValueError(f"the soft backward kernel indexes fewer than {MAX_OBJECTS} "
                         f"objects, got {ns + npl}")
    forms = [(f, False) for f in ((True, False) if staged is None else (staged,))]
    if device_rows:
        forms = []
    if device_rows is not False and staged is not True:
        forms.append((False, True))
    for form, rows in forms:
        for nt in (128, 64, 32):
            for sv in (True, False):
                cap, cj = max(1, min(ns + npl, 32)), max(1, min(ns, 16))
                while True:
                    smem = smem_bytes(ns, npl, nl, fused, nt, cap, cj, sv, form, rows)
                    if smem <= SMEM_LIMIT:
                        return Plan(nt, cap, cj, sv, smem, form, rows)
                    if cap == cj == 1:
                        break
                    if cap >= cj:
                        cap //= 2
                    else:
                        cj //= 2
    raise ValueError(f"scene (ns={ns}, npl={npl}, nl={nl}) needs "
                     f"{smem_bytes(ns, npl, nl, fused, 32, 1, 1, False, False, True)} B "
                     f"of shared memory in the soft backward kernel, a block has at most "
                     f"{SMEM_LIMIT} B")


def n_blocks(W: int, H: int, p: Plan, n_sm: int = H100_SMS) -> int:
    """Thread blocks of one soft backward launch (rows of its partial sums):
    one a pixel group of 16 x ``nt / 16`` pixels; in the third form a grid of
    the card's size, as the hard backward's (``render_bwd_cuda.plan``): as
    many blocks as ``n_sm`` multiprocessors hold, up to ``BLOCKS_PER_SM``
    each, at most one a group, each walking groups b, b + blocks, ..."""
    groups = math.ceil(H / BLOCK_Y) * math.ceil(W / (p.nt // BLOCK_Y))
    if not p.device_rows:
        return groups
    per_sm = max(1, min(BLOCKS_PER_SM, SM_SMEM // (p.smem + 1024)))
    return min(groups, n_sm * per_sm)


def _check(camera, scene, image, tau, name: str, fused: bool, lw: int) -> Plan:
    dev = soft_cuda.check_inputs(camera, scene, tau)
    W, H = lw, camera.resolution[1]
    if image.device != dev or image.dtype != torch.float32:
        raise ValueError(f"{name} must be float32 on {dev}, got {image.dtype} on "
                         f"{image.device}")
    if tuple(image.shape) != (W, H, 3):
        raise ValueError(f"{name} has shape {tuple(image.shape)}, expected {(W, H, 3)}")
    return plan(scene.spheres.count, scene.planes.count, scene.lights.count, fused)


def launch(out, partial, params, tables, counts, *, image, W: int, H: int, tau: float,
           mode: str, shape: Plan, W_global: int | None = None,
           scratch=None) -> torch.Tensor:
    """Launch the soft backward kernel and its reduction on the current stream
    for inputs already packed and checked: ``out (n_grads,)``, ``partial
    (n_grads * n_blocks,)``, ``params`` (clean-mode grid), the
    ``scene_tables``, the object counts, ``image`` (the cotangent, or in
    ``fused`` the target), all float32, contiguous, on the current device, and
    the launch's :class:`Plan` (the third form's rows go to ``scratch``, a
    float32 buffer of at least :func:`scratch_floats`, allocated here where
    None). ``W``: the slice's width where ``W_global`` (the frame's, default
    ``W``) is wider, its offset the packed ``P_X0``. Counts the launch in
    :data:`LAUNCHES`."""
    from ._build import load_library
    lib = load_library()
    (sph, pln, lts), (ns, npl, nl) = tables, counts
    rows = n_blocks(W, H, shape)
    stream = ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)
    if shape.device_rows:
        need = scratch_floats(ns, npl, nl, mode == "fused", W, H, shape)
        if scratch is None:
            scratch = torch.empty(need, dtype=torch.float32, device=out.device)
        if scratch.dtype != torch.float32 or scratch.device != out.device or \
                scratch.numel() < need or not scratch.is_contiguous():
            raise ValueError(f"soft backward scratch: expected {need} contiguous float32 "
                             f"on {out.device}")
    rc = lib.rt_soft_bwd(params.data_ptr(), sph.data_ptr(), ns, pln.data_ptr(), npl,
                         lts.data_ptr(), nl, float(tau), image.data_ptr(),
                         partial.data_ptr(), rows, out.shape[0], W, H,
                         W if W_global is None else W_global, int(mode == "fused"),
                         shape.nt, shape.cap, shape.cj, int(shape.store_vis),
                         int(shape.staged),
                         scratch.data_ptr() if shape.device_rows else None, stream)
    if rc == 0:
        rc = lib.rt_reduce_rows(partial.data_ptr(), rows, out.shape[0], out.data_ptr(),
                                stream)
    if rc != 0:
        raise RuntimeError(f"soft backward kernel ({mode}) failed: CUDA error {rc} "
                           f"({lib.rt_error_string(rc).decode()})")
    LAUNCHES[mode] += 1
    if shape.device_rows:
        ROWS_LAUNCHES[mode] += 1
    return out


def _run(camera, scene, image, *, tau, mode, shape, x_offset=0, lw=None):
    dev = camera.position.device
    Wg, H = camera.resolution
    W = Wg if lw is None else lw
    counts = (scene.spheres.count, scene.planes.count, scene.lights.count)
    n = n_grads(*counts, mode == "fused")
    with torch.cuda.device(dev), torch.no_grad():
        params = render_cuda.pack_params(camera, scene, False, x_offset).to(dev)
        out = torch.empty(n, device=dev)
        partial = torch.empty(n * n_blocks(W, H, shape), device=dev)
        return launch(out, partial, params, render_cuda.scene_tables(scene), counts,
                      image=image.contiguous(), W=W, H=H, tau=tau, mode=mode,
                      shape=shape, W_global=Wg)


def soft_scene_grads_cuda(camera, scene, g_image, *, tau: float = 0.05,
                          return_camera: bool = False, x_offset: int = 0,
                          local_width: int | None = None):
    """Image cotangent ``(w, h, 3)`` -> ``Scene`` gradients (with
    ``return_camera``: ``(scene_g, camera_g)``), as
    ``soft_bwd.soft_scene_grads_pallas``; with ``x_offset`` / ``local_width``
    the slice's cotangent and partials. CUDA tensors only (``ValueError`` on
    others; :func:`soft_scene_grads_plain` is the plain version): mode
    ``cot``."""
    require_cuda("soft_scene_grads_cuda", camera.position)
    ns, npl, nl = scene.spheres.count, scene.planes.count, scene.lights.count
    lw = render_cuda.slice_width(camera, x_offset, local_width)
    shape = _check(camera, scene, g_image, tau, "g_image", False, lw)
    flat = _run(camera, scene, g_image, tau=tau, mode="cot", shape=shape,
                x_offset=x_offset, lw=lw)
    return unflatten_grads(flat, ns, npl, nl, camera.resolution,
                           return_camera=return_camera, fused_loss=False)


def soft_loss_and_grads_cuda(camera, scene, target, *, tau: float = 0.05,
                             return_camera: bool = False, x_offset: int = 0,
                             local_width: int | None = None):
    """The soft training step's ``(loss, scene_g)`` (with ``return_camera``:
    ``(loss, scene_g, camera_g)``) for ``loss = mean((render_soft -
    target)^2)``, as ``soft_bwd.soft_loss_and_grads_pallas``; with
    ``x_offset`` / ``local_width`` the slice's target, and its partials over
    the frame's denominator. CUDA tensors only (``ValueError`` on others;
    :func:`soft_loss_and_grads_plain` is the plain version): mode ``fused``."""
    require_cuda("soft_loss_and_grads_cuda", camera.position)
    ns, npl, nl = scene.spheres.count, scene.planes.count, scene.lights.count
    lw = render_cuda.slice_width(camera, x_offset, local_width)
    shape = _check(camera, scene, target, tau, "target", True, lw)
    flat = _run(camera, scene, target, tau=tau, mode="fused", shape=shape,
                x_offset=x_offset, lw=lw)
    return unflatten_grads(flat, ns, npl, nl, camera.resolution,
                           return_camera=return_camera, fused_loss=True)
