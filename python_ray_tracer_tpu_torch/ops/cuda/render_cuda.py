"""Forward render through the hand-written CUDA kernel (``csrc/render_fwd.cu``).

Counterpart of ``python_ray_tracer_tpu/ops/pallas/render_pallas.py`` for small
and mid-size scenes: one launch covers ray generation, closest hit, shading with
shadow rays, mirror bounces and the AA accumulation with the compat swaps. Three
kernel modes:

  * ``aa_none``: no AA (the TPU ``_make_kernel`` at S=1);
  * ``aa_per_sample``: 9 samples walked per thread (``_make_kernel`` at S=9);
  * ``aa_shared``: the 4 shared half-offset sample grids of
    ``_make_kernel_aa_shared``, evaluated per block into shared memory.

:func:`render_image_cuda` runs the plain PyTorch version (``ops/render.py``) for
tensors on the CPU; for CUDA tensors it launches the kernel or raises. Camera,
grid and material scalars are packed on the host into the TPU kernel's ``_P_*``
parameter layout (:func:`pack_params`). :func:`render_image_fast` is the
differentiable form (``render_pallas.render_image_fast``): the render kernel
forward, the backward kernel (``render_bwd_cuda``) for its gradient.
"""
from __future__ import annotations

import ctypes

import numpy as np
import torch

from ...models.camera import Camera
from ...models.scene import Scene
from ..render import render_image
from ..intersect import FAR

# AA half-offsets in (x, y) index space; s=0 is the primary (center) sample
# (reference kernels.py:32-50).
AA_OFFSETS = ((0.0, 0.0), (-0.5, 0.0), (0.5, 0.0), (0.0, 0.5), (0.0, -0.5),
              (-0.5, 0.5), (0.5, 0.5), (-0.5, -0.5), (0.5, -0.5))

# params vector layout (same as the TPU kernel's; mirrored in csrc/rt_common.cuh)
P_ORIGIN = 0      # 3: camera origin
P_ROT = 3         # 9: rotation, row-major
P_FOCAL = 12
P_Y0, P_DY, P_Z0, P_DZ = 13, 14, 15, 16
P_AMB, P_LAMB, P_REFL = 17, 18, 19
P_SPEC, P_SHIN = 20, 21   # Phong specular/shininess (clean mode only)
P_X0 = 22         # x offset of a ray-parallel slice: packed as 0, not read
P_OFFS = 23       # 2*9: AA offsets
N_PARAMS = P_OFFS + 2 * len(AA_OFFSETS)

MODES = ("aa_none", "aa_per_sample", "aa_shared")   # C enum order
# Kernel launches per mode; a plain counter, reset with reset_launch_counts().
LAUNCHES = {m: 0 for m in MODES}

# Largest scene the kernel stages in shared memory (227 KB a block, less the
# shared-AA sample grids).
_SMEM_LIMIT = 227 * 1024 - 3 * 4 * 1089


def reset_launch_counts() -> None:
    for m in MODES:
        LAUNCHES[m] = 0


def pack_params(camera, scene, compat: bool) -> torch.Tensor:
    """The 41-float parameter vector (``render_pallas._pack_params``), computed
    on the CPU in float32 whatever the device of the inputs."""
    cam = camera.to("cpu")
    m = scene.materials
    focal, y0, dy, z0, dz = cam.grid_params(compat)
    mats = torch.stack([m.ambient, m.lambert, m.reflection, m.specular,
                        m.shininess]).to("cpu", torch.float32)
    return torch.cat([
        cam.position.float(), cam.rotation.float().reshape(-1),
        torch.stack([focal, y0, dy, z0, dz]), mats,
        torch.zeros(1, dtype=torch.float32),
        torch.tensor(AA_OFFSETS, dtype=torch.float32).reshape(-1)])


def shadow_cheap_ok(scene, compat: bool) -> bool:
    """Whether the sqrt-free shadow test is exact for this scene
    (``render_pallas._shadow_cheap_ok``): always in clean mode; in compat mode
    only if every radius is < FAR/2, else a shadow segment can sit inside a
    ball whose selected root passes the 999 clip."""
    if not compat:
        return True
    r = scene.spheres.radius.detach().cpu().numpy()
    return bool(np.all(r < 0.5 * FAR))


def scene_tables(scene):
    """SoA tables ``sph (7,ns)``, ``pln (9,npl)``, ``lts (3,nl)`` on the scene's
    device, with albedo in [0,1] (a zero column stands in for an empty set)."""
    s, p, l = scene.spheres, scene.planes, scene.lights
    dev = scene.device

    def table(parts, rows, n):
        if n == 0:
            return torch.zeros((rows, 1), device=dev)
        return torch.cat(parts).float().contiguous()
    sph = table([s.center.T, s.radius[None], s.albedo.T], 7, s.count)
    pln = table([p.origin.T, p.normal.T, p.albedo.T], 9, p.count)
    lts = table([l.position.T], 3, l.count)
    return sph, pln, lts


def _check_inputs(camera, scene, dev):
    tensors = {"camera.position": camera.position, "camera.rotation": camera.rotation,
               "camera.fov": camera.fov}
    for grp in ("spheres", "planes", "lights", "materials"):
        obj = getattr(scene, grp)
        for k, v in vars(obj).items():
            tensors[f"scene.{grp}.{k}"] = v
    for name, t in tensors.items():
        if t.device != dev:
            raise ValueError(f"{name} is on {t.device}, expected {dev}")
        if t.dtype != torch.float32:
            raise TypeError(f"{name} has dtype {t.dtype}, expected float32")
    ns, npl, nl = scene.spheres.count, scene.planes.count, scene.lights.count
    shapes = {"spheres.center": (scene.spheres.center, (ns, 3)),
              "spheres.radius": (scene.spheres.radius, (ns,)),
              "spheres.albedo": (scene.spheres.albedo, (ns, 3)),
              "planes.origin": (scene.planes.origin, (npl, 3)),
              "planes.normal": (scene.planes.normal, (npl, 3)),
              "planes.albedo": (scene.planes.albedo, (npl, 3)),
              "lights.position": (scene.lights.position, (nl, 3)),
              "camera.rotation": (camera.rotation, (3, 3)),
              "camera.position": (camera.position, (3,))}
    for name, (t, want) in shapes.items():
        if tuple(t.shape) != want:
            raise ValueError(f"{name} has shape {tuple(t.shape)}, expected {want}")
    smem = 4 * (N_PARAMS + 7 * ns + 9 * npl + 3 * nl)
    if smem > _SMEM_LIMIT:
        raise ValueError(f"scene needs {smem} B of shared memory, the kernel "
                         f"stages at most {_SMEM_LIMIT} B")


def render_image_cuda(camera, scene, *, depth: int = 2, aliasing: bool = True,
                      compat: bool = True, aa_share: bool = True) -> torch.Tensor:
    """Render -> float ``(w, h, 3)`` image, as :func:`..render.render_image`.

    CPU tensors take the plain PyTorch version. CUDA tensors launch the kernel
    on the current stream (mode ``aa_shared`` when ``aliasing and aa_share``,
    ``aa_per_sample`` for AA without sharing, else ``aa_none``)."""
    dev = camera.position.device
    if dev.type == "cpu":
        return render_image(camera, scene, depth=depth, aliasing=aliasing,
                            compat=compat)
    if dev.type != "cuda":
        raise ValueError(f"render_image_cuda takes CPU or CUDA tensors, got {dev}")
    if depth < 0:
        raise ValueError(f"depth must be >= 0, got {depth}")
    _check_inputs(camera, scene, dev)
    W, H = camera.resolution
    if W < 1 or H < 1:
        raise ValueError(f"empty resolution {camera.resolution}")
    mode = ("aa_shared" if aa_share else "aa_per_sample") if aliasing else "aa_none"
    params = pack_params(camera, scene, compat).to(dev)
    out = torch.empty((W, H, 3), dtype=torch.float32, device=dev)
    counts = (scene.spheres.count, scene.planes.count, scene.lights.count)
    with torch.cuda.device(dev):
        return launch(out, params, scene_tables(scene), counts, depth=depth,
                      mode=mode, compat=compat,
                      cheap_shadow=shadow_cheap_ok(scene, compat))


def launch(out, params, tables, counts, *, depth: int, mode: str, compat: bool,
           cheap_shadow: bool) -> torch.Tensor:
    """Launch the kernel on the current stream for inputs already packed and
    checked by :func:`render_image_cuda`: ``out (W, H, 3)``, ``params
    (N_PARAMS,)``, the :func:`scene_tables` and the object counts
    ``(ns, npl, nl)``, all tensors float32 and contiguous on the current
    device. Counts the launch in :data:`LAUNCHES`."""
    from ._build import load_library
    lib = load_library()
    W, H = out.shape[0], out.shape[1]
    (sph, pln, lts), (ns, npl, nl) = tables, counts
    rc = lib.rt_render_fwd(
        params.data_ptr(), sph.data_ptr(), ns, pln.data_ptr(), npl,
        lts.data_ptr(), nl, out.data_ptr(), W, H, depth,
        MODES.index(mode), int(compat), int(cheap_shadow),
        ctypes.c_void_p(torch.cuda.current_stream().cuda_stream))
    if rc != 0:
        raise RuntimeError(f"render kernel ({mode}) failed: CUDA error {rc} "
                           f"({lib.rt_error_string(rc).decode()})")
    LAUNCHES[mode] += 1
    return out


class _RenderImageFast(torch.autograd.Function):
    """Render kernel forward; backward kernel (cotangent mode, camera slots
    included) backward. Inputs after the four settings: the camera's position,
    rotation and fov, then the scene's 12 tensors in dataclass order."""

    @staticmethod
    def forward(ctx, resolution, depth, aliasing, compat, *leaves):
        camera, scene = _assemble(resolution, leaves)
        ctx.settings = (resolution, depth, aliasing, compat)
        ctx.save_for_backward(*leaves)
        return render_image_cuda(camera, scene, depth=depth, aliasing=aliasing,
                                 compat=compat)

    @staticmethod
    def backward(ctx, g):
        from .render_bwd_cuda import scene_grads_cuda
        resolution, depth, aliasing, compat = ctx.settings
        camera, scene = _assemble(resolution, ctx.saved_tensors)
        scene_g, cam_g = scene_grads_cuda(camera, scene, g.float().contiguous(),
                                          depth=depth, compat=compat,
                                          aliasing=aliasing, return_camera=True)
        return (None, None, None, None, cam_g.position, cam_g.rotation, cam_g.fov,
                *scene_g.leaves())


def _assemble(resolution, leaves):
    pos, rot, fov, *s = leaves
    return Camera(pos, rot, fov, resolution), Scene.from_leaves(s)


def render_image_fast(camera, scene, depth: int = 2, aliasing: bool = True,
                      compat: bool = True) -> torch.Tensor:
    """Differentiable render -> float ``(w, h, 3)``. CPU tensors take the plain
    version (differentiated by autograd); on CUDA tensors the forward is the
    render kernel and the backward is the backward kernel, for the scene and
    the camera alike. No light-count fallback: the kernel has no such limit."""
    if camera.position.device.type == "cpu":
        return render_image(camera, scene, depth=depth, aliasing=aliasing,
                            compat=compat)
    return _RenderImageFast.apply(tuple(camera.resolution), depth, aliasing, compat,
                                  camera.position, camera.rotation, camera.fov,
                                  *scene.leaves())
