"""Soft-visibility render through the hand-written CUDA kernel
(``csrc/soft_fwd.cu``).

Counterpart of ``python_ray_tracer_tpu/ops/pallas/soft_pallas.py``: one launch
covers the clean-mode ray generation, sigmoid sphere coverage, opaque planes,
soft shadow transmission, ambient + Lambert shading and the order-free
front-to-back compositing. :func:`render_image_soft_cuda` takes CUDA tensors
only: on tensors anywhere else it raises ``ValueError`` and launches nothing
(the plain PyTorch version is :func:`render_image_soft_plain`, ``ops/soft.py``,
by its own name).
:func:`render_image_soft_fast` is the differentiable form
(``soft_pallas.render_image_soft_fast``): the soft forward kernel forward, the
soft backward kernel (``soft_bwd_cuda``, cotangent form, camera included)
backward. There is no light-count fallback: neither kernel has such a limit.
"""
from __future__ import annotations

import ctypes

import torch

from ...models.camera import Camera
from ...models.scene import Scene
from ...utils.config import require_cuda
from ..soft import render_image_soft
from . import render_cuda

# Kernel launches and plain-version calls; plain counters, reset with
# reset_launch_counts().
LAUNCHES = {"soft_fwd": 0}
# Of those, the launches in the global form.
GLOBAL_LAUNCHES = {"soft_fwd": 0}
PLAIN_CALLS = {"render_image_soft": 0}
NT = 128                       # threads a block (csrc/soft_fwd.cu)


def reset_launch_counts() -> None:
    LAUNCHES["soft_fwd"] = 0
    GLOBAL_LAUNCHES["soft_fwd"] = 0
    PLAIN_CALLS["render_image_soft"] = 0


def render_image_soft_plain(camera, scene, *, tau: float = 0.05,
                            row_chunk: int | None = None,
                            bounce_depth: int = 0) -> torch.Tensor:
    """The plain version (``ops/soft.render_image_soft``), counted in
    :data:`PLAIN_CALLS`. The mirror bounce (``bounce_depth=1``) exists only
    here: no kernel of either package covers it."""
    PLAIN_CALLS["render_image_soft"] += 1
    return render_image_soft(camera, scene, tau=tau, row_chunk=row_chunk,
                             bounce_depth=bounce_depth)


def check_inputs(camera, scene, tau: float):
    """The render wrapper's input checks (device, dtype, shapes) plus ``tau >
    0``; returns the device."""
    dev = require_cuda("the soft kernels", camera.position)
    render_cuda._check_inputs(camera, scene, dev)
    if not float(tau) > 0.0:
        raise ValueError(f"tau must be > 0, got {tau}")
    W, H = camera.resolution
    if W < 1 or H < 1:
        raise ValueError(f"empty resolution {camera.resolution}")
    return dev


def render_image_soft_cuda(camera, scene, *, tau: float = 0.05) -> torch.Tensor:
    """Soft render -> float ``(w, h, 3)``, as :func:`..soft.render_image_soft`
    (clean orientation and channels), for CUDA tensors only (``ValueError``
    on others): the soft forward kernel on the current stream."""
    require_cuda("render_image_soft_cuda", camera.position)
    dev = check_inputs(camera, scene, tau)
    W, H = camera.resolution
    with torch.cuda.device(dev):
        params = render_cuda.pack_params(camera, scene, compat=False).to(dev)
        out = torch.empty((W, H, 3), dtype=torch.float32, device=dev)
        counts = (scene.spheres.count, scene.planes.count, scene.lights.count)
        return launch(out, params, render_cuda.scene_tables(scene), counts, tau=tau)


def staged_bytes(ns: int, npl: int, nl: int) -> int:
    """Shared memory of a block of the staged form at its smallest table
    (csrc/soft_fwd.cu: the scene and 4 floats a thread)."""
    return 4 * (render_cuda.N_PARAMS + 7 * ns + 9 * npl + 3 * nl + NT * 4)


def form(ns: int, npl: int, nl: int) -> int:
    """The kernel's form (``render_cuda.scene_form``): staged wherever the
    staged form fits a block (up to 8220 spheres at 1 plane and 3 lights),
    else global."""
    return render_cuda.scene_form(ns, npl, nl, False, staged_bytes(ns, npl, nl),
                                  render_cuda.SMEM_BLOCK)


def launch(out, params, tables, counts, *, tau: float,
           staged: bool | None = None) -> torch.Tensor:
    """Launch the soft forward kernel on the current stream for inputs already
    packed and checked by :func:`render_image_soft_cuda`: ``out (W, H, 3)``,
    ``params`` (packed with the clean-mode grid), the ``scene_tables`` and the
    object counts ``(ns, npl, nl)``, all float32 and contiguous on the current
    device, in the form :func:`form` gives (``staged``: that form).
    Counts the launch in :data:`LAUNCHES` (and :data:`GLOBAL_LAUNCHES`)."""
    from ._build import load_library
    lib = load_library()
    W, H = out.shape[0], out.shape[1]
    (sph, pln, lts), (ns, npl, nl) = tables, counts
    staged = form(ns, npl, nl) == 0 if staged is None else staged
    rc = lib.rt_soft_fwd(params.data_ptr(), sph.data_ptr(), ns, pln.data_ptr(), npl,
                         lts.data_ptr(), nl, float(tau), out.data_ptr(), W, H, int(staged),
                         ctypes.c_void_p(torch.cuda.current_stream().cuda_stream))
    if rc != 0:
        raise RuntimeError(f"soft forward kernel failed: CUDA error {rc} "
                           f"({lib.rt_error_string(rc).decode()})")
    LAUNCHES["soft_fwd"] += 1
    if not staged:
        GLOBAL_LAUNCHES["soft_fwd"] += 1
    return out


# The kernel's image against the plain version's: max abs <= 2e-4 (about 30
# (1 - alpha) factors amplify float32 reassociation to ~1e-4,
# tests/test_soft.py:141-144) and <= 0.1% of uint8 pixels off by more than 1
# level. Where b = sqrt(|L|^2 - t_ca^2) cancels (a sphere far along the ray) a
# steep sigmoid turns float32 rounding into ~1e-4 of color in the plain version
# itself, and the FMA-contracted kernel rounds differently again: on an H100,
# pixel (42, 4) red of a 40-sphere 96x64 frame at tau 0.02 reads 0.12753832 in
# the kernel, 0.12730998 in the plain float32 version and 0.12743462 in
# float64, so the kernel is 2.28e-4 off the plain float32 version and 1.04e-4
# off the exact value. So each element must lie within IMAGE_ATOL of the plain
# version in float32 OR in float64: never farther than that from both.
IMAGE_ATOL = 2e-4


def image_rule(out, plain, plain64) -> dict:
    """Hold a kernel image against the plain version in float32 and float64:
    every element within ``IMAGE_ATOL`` of ``plain`` or of ``plain64``, and
    the uint8 frames of ``out`` and ``plain`` differ by more than 1 level at
    <= 0.1% of pixels. Returns the numbers (``ratio``: the worst element's
    nearer distance over IMAGE_ATOL), the elements farthest from the plain
    float32 version (``worst``) and from float64 (``worst64``), each as x, y,
    channel and the kernel's, plain float32 and float64 values, and ``ok``."""
    d32 = (out - plain).abs()
    d64 = (out.double() - plain64).abs()
    ratio = float(torch.minimum(d32.double(), d64).max()) / IMAGE_ATOL
    fa = torch.clamp(torch.round(out * 255.0), 0, 255)
    fb = torch.clamp(torch.round(plain * 255.0), 0, 255)
    flipped = int(((fa - fb).abs().amax(-1) > 1).sum())

    def at(i):
        x, y, ch = i // (out.shape[1] * 3), (i // 3) % out.shape[1], i % 3
        return {"x": x, "y": y, "channel": ch, "kernel": float(out[x, y, ch]),
                "plain32": float(plain[x, y, ch]), "plain64": float(plain64[x, y, ch])}
    finite = bool(torch.isfinite(out).all())
    return {"max_abs_err": float(d32.max()), "max_abs_err_f64": float(d64.max()),
            "plain_err_f64": float((plain.double() - plain64).abs().max()),
            "ratio": ratio, "flipped": flipped, "worst": at(int(torch.argmax(d32))),
            "worst64": at(int(torch.argmax(d64))), "finite": finite,
            "ok": ratio <= 1.0 and flipped <= 1e-3 * out.shape[0] * out.shape[1] and finite}


def as_double(camera, scene):
    """The camera and scene in float64, for the plain version's float64 run."""
    cam = Camera(camera.position.double(), camera.rotation.double(), camera.fov.double(),
                 camera.resolution)
    return cam, Scene.from_leaves([t.double() for t in scene.leaves()])


class _RenderImageSoftFast(torch.autograd.Function):
    """Soft forward kernel forward; soft backward kernel (cotangent form, camera
    slots included) backward. Inputs after the two settings: the camera's
    position, rotation and fov, then the scene's 12 tensors in dataclass
    order."""

    @staticmethod
    def forward(ctx, resolution, tau, *leaves):
        camera, scene = render_cuda._assemble(resolution, leaves)
        ctx.settings = (resolution, tau)
        ctx.save_for_backward(*leaves)
        return render_image_soft_cuda(camera, scene, tau=tau)

    @staticmethod
    def backward(ctx, g):
        from .soft_bwd_cuda import soft_scene_grads_cuda
        resolution, tau = ctx.settings
        camera, scene = render_cuda._assemble(resolution, ctx.saved_tensors)
        scene_g, cam_g = soft_scene_grads_cuda(camera, scene, g.float().contiguous(),
                                               tau=tau, return_camera=True)
        return (None, None, cam_g.position, cam_g.rotation, cam_g.fov,
                *scene_g.leaves())


def render_image_soft_fast(camera, scene, tau: float = 0.05) -> torch.Tensor:
    """Differentiable soft render -> float ``(w, h, 3)`` of CUDA tensors (others
    raise ``ValueError``; autograd of :func:`render_image_soft_plain` is the
    plain version): the forward is the soft forward kernel and the backward
    the soft backward kernel, for the scene and the camera alike."""
    require_cuda("render_image_soft_fast", camera.position)
    return _RenderImageSoftFast.apply(tuple(camera.resolution), float(tau),
                                      camera.position, camera.rotation, camera.fov,
                                      *scene.leaves())
