"""Inverse rendering: fit scene parameters, or the camera, to a target image by
gradient descent.

PyTorch counterpart of ``python_ray_tracer_tpu/train.py`` on one device. Two
backends; every entry point defaults to ``"cuda"``:

  * ``"cuda"``: the hand-written kernels. ``fused=True`` runs each step as one
    backward-kernel launch that renders, forms the MSE loss and its cotangent
    and reverse-sweeps (``loss_and_scene_grads_cuda``; with AA the render
    kernel runs first); ``fused=False`` runs the render kernel and then the
    backward kernel on the cotangent. The backend needs a card
    (``utils.config.resolve_backend`` raises without one) and CUDA tensors:
    like every kernel wrapper, these entry points raise ``ValueError`` on
    tensors anywhere else.
  * ``"torch"``: autograd of the plain renderer (:func:`pixel_loss`), on the
    tensors' own device.

The optimizer is ``torch.optim.Adam(lr)`` over the trainable leaves only. That
is optax Adam on masked gradients (``train._mask_grads``): a leaf whose
gradient is always zero never moves.

:func:`fit_scene_soft` fits through the soft-visibility renderer with tau
annealed toward hard: on ``"cuda"`` each step is one launch of the fused soft
backward kernel (``soft_loss_and_grads_cuda``) and each stage's target one
launch of the soft forward kernel.

With a ``mesh`` (``parallel.make_mesh``) :func:`fit_scene` and
:func:`fit_scene_soft` take ray-parallel steps
(:func:`cuda_value_and_grad_sharded`, :func:`soft_value_and_grad_sharded`):
each rank runs the fused kernel on its vertical slice of the target, its loss
and gradients partials over the frame's denominator, and one all-reduce of the
flat gradient vector with the loss beside it sums them. Every rank then takes
the same Adam step.
"""
from __future__ import annotations

from typing import Callable, Dict, List, Optional, Sequence

import torch

from .models.camera import Camera, euler_rotation
from .models.scene import LEAF_PATHS, Scene
from .ops.cuda.render_bwd_cuda import (flatten_grads, loss_and_scene_grads_cuda,
                                       scene_grads_cuda, unflatten_grads)
from .ops.cuda.render_cuda import render_image_cuda
from .ops.cuda.soft_bwd_cuda import soft_loss_and_grads_cuda
from .ops.cuda.soft_cuda import (render_image_soft_cuda, render_image_soft_fast,
                                 render_image_soft_plain)
from .ops.render import render_image
from .parallel.distributed import all_reduce_sum
from .parallel.render_sharded import local_target, make_loss_fn
from .utils.config import require_cuda, resolve_backend
from .utils.metrics import MetricsLogger

CAMERA_KEYS = ("position", "euler", "fov")


def _backend(backend: str, what: str, *tensors: torch.Tensor) -> str:
    """``resolve_backend(backend)`` (``"cuda"`` without a card raises); on
    ``"cuda"`` every tensor must lie on the card (``require_cuda``)."""
    if resolve_backend(backend) == "cuda":
        require_cuda(f"{what}(backend='cuda')", *tensors)
    return backend


def pixel_loss(camera, target, *, depth: int = 2, aliasing: bool = False,
               compat: bool = True, row_chunk: Optional[int] = None) -> Callable:
    """``loss(scene) -> scalar`` mean-squared pixel error of the plain renderer
    (``row_chunk``: its column blocks, ``ops.render.render_image``)."""
    def loss(scene):
        img = render_image(camera, scene, depth=depth, aliasing=aliasing,
                           compat=compat, row_chunk=row_chunk)
        return torch.mean((img - target) ** 2)
    return loss


def soft_pixel_loss(camera, target, *, tau: float = 0.05, row_chunk: Optional[int] = None,
                    backend: str = "cuda", bounce_depth: int = 0) -> Callable:
    """Silhouette-aware ``loss(scene) -> scalar`` through the soft-visibility
    renderer (``train.soft_pixel_loss``); the target should come from the same
    renderer. On ``"cuda"`` the render is :func:`render_image_soft_fast` (the
    soft forward kernel, and the soft backward kernel for its gradient).
    ``bounce_depth=1`` renders through the plain version on either backend,
    counted in ``soft_cuda.PLAIN_CALLS``: no kernel of either package covers
    the mirror bounce."""
    _backend(backend, "soft_pixel_loss", camera.position, target)
    if backend == "cuda" and bounce_depth == 0:
        def loss(scene):
            return torch.mean((render_image_soft_fast(camera, scene, tau) - target) ** 2)
        return loss

    def loss(scene):
        img = render_image_soft_plain(camera, scene, tau=tau, row_chunk=row_chunk,
                                      bounce_depth=bounce_depth)
        return torch.mean((img - target) ** 2)
    return loss


def soft_value_and_grad(camera, target, *, tau: float, backend: str = "cuda",
                        bounce_depth: int = 0) -> Callable:
    """``scene -> (loss, scene_grads)`` of the soft pixel loss: on ``"cuda"``
    one launch of the fused soft backward kernel (render, MSE, reverse sweep);
    otherwise, and for ``bounce_depth=1``, autograd of
    :func:`soft_pixel_loss`'s plain version."""
    _backend(backend, "soft_value_and_grad", camera.position, target)
    if backend == "cuda" and bounce_depth == 0:
        def value_and_grad(scene):
            return soft_loss_and_grads_cuda(camera, scene, target, tau=tau)
        return value_and_grad
    return autograd_value_and_grad(soft_pixel_loss(camera, target, tau=tau,
                                                   backend=backend,
                                                   bounce_depth=bounce_depth))


def trainable_paths(trainable: Optional[Sequence[str]]) -> List[str]:
    """Leaf paths that receive updates. ``trainable`` entries are top-level
    fields (``"spheres"``) or dotted leaf paths (``"spheres.center"``); None
    trains everything."""
    if trainable is None:
        return list(LEAF_PATHS)
    unknown = [t for t in trainable if t not in LEAF_PATHS and
               not any(p.startswith(t + ".") for p in LEAF_PATHS)]
    if unknown:
        raise ValueError(f"unknown trainable fields {unknown}")
    return [p for p in LEAF_PATHS if p in trainable or p.split(".")[0] in trainable]


def cuda_value_and_grad(camera, target, *, depth: int = 2, compat: bool = True,
                        aliasing: bool = False, fused: bool = True, aa_form: str = "one",
                        cheap_shadow: bool | None = None, **culls) -> Callable:
    """``scene -> (loss, scene_grads)`` through the kernels
    (``train.pallas_value_and_grad``); ``aa_form`` (the fused AA step's form),
    ``cheap_shadow`` (None: ``render_cuda.shadow_cheap_ok``, as the wrappers
    resolve it) and the cull keywords ``culls`` (``cull``, ``shadow_lists``,
    ``group_cull``) go to the wrappers."""
    if fused:
        def value_and_grad(scene):
            return loss_and_scene_grads_cuda(camera, scene, target, depth=depth,
                                             compat=compat, aliasing=aliasing,
                                             aa_form=aa_form, cheap_shadow=cheap_shadow,
                                             **culls)
        return value_and_grad

    def value_and_grad(scene):
        img = render_image_cuda(camera, scene, depth=depth, aliasing=aliasing,
                                compat=compat, cheap_shadow=cheap_shadow, **culls)
        diff = img - target
        loss = torch.mean(diff ** 2)
        grads = scene_grads_cuda(camera, scene, 2.0 * diff / diff.numel(), depth=depth,
                                 compat=compat, aliasing=aliasing,
                                 cheap_shadow=cheap_shadow, **culls)
        return loss, grads
    return value_and_grad


def _summed(mesh, loss, scene_g):
    """``(loss, scene_g)`` summed over the mesh's ranks: the flat gradient
    vector (``render_bwd_cuda.flatten_grads``) with the loss in its trailing
    slot, in one all-reduce."""
    flat = all_reduce_sum(flatten_grads(scene_g, None, loss.detach()), mesh)
    ns, npl, nl = (scene_g.spheres.center.shape[0], scene_g.planes.origin.shape[0],
                   scene_g.lights.position.shape[0])
    return unflatten_grads(flat, ns, npl, nl, (1, 1), return_camera=False, fused_loss=True)


def cuda_value_and_grad_sharded(camera, mesh, *, depth: int = 2, compat: bool = True,
                                aliasing: bool = False,
                                cheap_shadow: bool | None = None) -> Callable:
    """``(scene, target) -> (loss, scene_grads)`` over a mesh
    (``train.pallas_value_and_grad_sharded``): the fused kernel
    (``loss_and_scene_grads_cuda``'s slice form, with ``cheap_shadow``) on
    this rank's columns of ``target`` (the frame's, or the slice itself),
    then one all-reduce of its gradient and loss partials. Every rank gets
    the frame's loss and gradient."""
    x0, lw = mesh.slice(camera.resolution[0])

    def value_and_grad(scene, target):
        loss, grads = loss_and_scene_grads_cuda(
            camera, scene, local_target(target, camera, mesh).contiguous(), depth=depth,
            compat=compat, aliasing=aliasing, x_offset=x0, local_width=lw,
            cheap_shadow=cheap_shadow)
        return _summed(mesh, loss, grads)
    return value_and_grad


def soft_value_and_grad_sharded(camera, mesh, *, tau: float = 0.05) -> Callable:
    """``(scene, target) -> (loss, scene_grads)`` of the soft pixel loss over a
    mesh (``train.soft_value_and_grad_sharded``): the fused soft backward
    kernel on this rank's columns, then one all-reduce."""
    x0, lw = mesh.slice(camera.resolution[0])

    def value_and_grad(scene, target):
        loss, grads = soft_loss_and_grads_cuda(
            camera, scene, local_target(target, camera, mesh).contiguous(), tau=tau,
            x_offset=x0, local_width=lw)
        return _summed(mesh, loss, grads)
    return value_and_grad


def autograd_value_and_grad_sharded(loss_fn: Callable, mesh) -> Callable:
    """``scene -> (loss, scene_grads)``: autograd of a slice's loss part
    (``parallel.make_loss_fn``), then the same one all-reduce."""
    vg = autograd_value_and_grad(loss_fn)

    def value_and_grad(scene):
        return _summed(mesh, *vg(scene))
    return value_and_grad


def autograd_value_and_grad(loss_fn: Callable) -> Callable:
    """``scene -> (loss, scene_grads)`` by autograd of ``loss_fn(scene)``."""
    def value_and_grad(scene):
        leaves = [t.detach().requires_grad_(True) for t in scene.leaves()]
        loss = loss_fn(Scene.from_leaves(leaves))
        grads = torch.autograd.grad(loss, leaves, allow_unused=True)
        return loss.detach(), Scene.from_leaves(
            [torch.zeros_like(t) if g is None else g for t, g in zip(leaves, grads)])
    return value_and_grad


def make_train_step(scene: Scene, value_and_grad: Callable, *, lr: float,
                    trainable: Optional[Sequence[str]] = None) -> Callable:
    """``step() -> loss``: one Adam step on ``scene``'s trainable leaves, in
    place, with the gradients of ``value_and_grad(scene) -> (loss,
    scene_grads)`` (:func:`cuda_value_and_grad` or
    :func:`autograd_value_and_grad`). The step's state is exposed for
    checkpoints (``utils.checkpoint``, ``utils.faults.resilient_fit``):
    ``step.scene`` (the scene it updates), ``step.optimizer`` (the
    ``torch.optim.Adam``) and ``step.trainable`` (the leaf paths it
    updates, in the optimizer's parameter order)."""
    paths = trainable_paths(trainable)
    index = [LEAF_PATHS.index(p) for p in paths]
    params = [scene.leaves()[i] for i in index]
    opt = torch.optim.Adam(params, lr=lr)

    def step():
        loss, grads = value_and_grad(scene)
        g = grads.leaves()
        for i, p in zip(index, params):
            p.grad = g[i].detach().to(p.dtype).reshape(p.shape)
        opt.step()
        return loss
    step.scene, step.optimizer, step.trainable = scene, opt, tuple(paths)
    return step


def _log(logger, i, steps, log_every, loss):
    if logger is not None and (i % log_every == 0 or i == steps - 1):
        logger.log(i, loss=loss)


def fit_scene(init_scene: Scene, camera, target, *, steps: int = 200,
              lr: float = 2e-2, depth: int = 2, aliasing: bool = False,
              compat: bool = True, trainable: Optional[Sequence[str]] = ("spheres",),
              backend: str = "cuda", fused: bool = True, mesh=None,
              logger: Optional[MetricsLogger] = None, log_every: int = 20):
    """Run the inverse-render optimization; returns ``(scene, losses)``.
    ``init_scene`` is not modified. ``trainable`` selects the leaves that
    receive updates (default: sphere geometry and albedo). With a ``mesh``
    each step is ray-parallel: :func:`cuda_value_and_grad_sharded` on
    ``"cuda"`` (the fused step; ``fused=False`` has no sharded form),
    autograd of ``parallel.make_loss_fn`` and the same all-reduce on
    ``"torch"``; ``target`` is the frame's or this rank's slice."""
    _backend(backend, "fit_scene", camera.position, target, init_scene.materials.ambient)
    scene = Scene.from_leaves([t.detach().clone() for t in init_scene.leaves()])
    if mesh is not None:
        if backend == "cuda":
            if not fused:
                raise ValueError("the sharded step is the fused one (fused=True)")
            vg_sh = cuda_value_and_grad_sharded(camera, mesh, depth=depth, compat=compat,
                                                aliasing=aliasing)

            def vg(s):
                return vg_sh(s, target)
        else:
            vg = autograd_value_and_grad_sharded(
                make_loss_fn(camera, target, mesh, depth=depth, aliasing=aliasing,
                             compat=compat), mesh)
    elif backend == "cuda":
        vg = cuda_value_and_grad(camera, target, depth=depth, compat=compat,
                                 aliasing=aliasing, fused=fused)
    else:
        vg = autograd_value_and_grad(pixel_loss(camera, target, depth=depth,
                                                aliasing=aliasing, compat=compat))
    step = make_train_step(scene, vg, lr=lr, trainable=trainable)
    losses = []
    for i in range(steps):
        losses.append(float(step()))
        _log(logger, i, steps, log_every, losses[-1])
    return scene, losses


def fit_scene_soft(init_scene: Scene, camera, target_scene: Scene, *, steps: int = 200,
                   lr: float = 1e-2, taus: Sequence[float] = (0.15, 0.05, 0.02),
                   trainable: Optional[Sequence[str]] = ("spheres.center",),
                   logger: Optional[MetricsLogger] = None, backend: str = "cuda",
                   bounce_depth: int = 0, mesh=None):
    """Coarse-to-fine soft-visibility fitting, tau annealed toward hard
    (``train.fit_scene_soft``): ``max(1, steps // len(taus))`` steps per tau,
    each stage against a target re-rendered from ``target_scene`` at that tau
    (the soft forward kernel on ``"cuda"``), with a new Adam per stage.
    ``bounce_depth=1`` adds the depth-1 mirror bounce; the bounce has no kernel
    in either package, so its targets and steps run the plain version on both
    backends (counted in ``soft_cuda.PLAIN_CALLS`` and
    ``soft_bwd_cuda.PLAIN_CALLS``). With a ``mesh`` each step is
    ray-parallel (:func:`soft_value_and_grad_sharded` on ``"cuda"``, else
    autograd of ``parallel.make_loss_fn(soft=True)``, which has no bounce, and
    the one all-reduce); every rank renders the stage's whole target, since
    the soft forward kernel has no slice form (nor has the JAX package's).
    ``init_scene`` is not modified. The logger's line per stage gives its tau
    and its first and last loss. Returns ``(scene, losses)``."""
    _backend(backend, "fit_scene_soft", camera.position, init_scene.materials.ambient,
             target_scene.materials.ambient)
    scene = Scene.from_leaves([t.detach().clone() for t in init_scene.leaves()])
    losses: List[float] = []
    per_stage = max(1, steps // len(taus))
    for tau in taus:
        with torch.no_grad():
            if backend == "cuda" and bounce_depth == 0:
                target = render_image_soft_cuda(camera, target_scene, tau=tau)
            else:
                target = render_image_soft_plain(camera, target_scene, tau=tau,
                                                 bounce_depth=bounce_depth)
        if mesh is None:
            vg = soft_value_and_grad(camera, target, tau=tau, backend=backend,
                                     bounce_depth=bounce_depth)
        elif backend == "cuda" and bounce_depth == 0:
            vg = (lambda v, t: lambda s: v(s, t))(
                soft_value_and_grad_sharded(camera, mesh, tau=tau), target)
        else:
            if bounce_depth:
                raise ValueError("the sharded soft step has no mirror bounce "
                                 "(bounce_depth=0)")
            vg = autograd_value_and_grad_sharded(
                make_loss_fn(camera, target, mesh, soft=True, tau=tau), mesh)
        step = make_train_step(scene, vg, lr=lr, trainable=trainable)
        for _ in range(per_stage):
            losses.append(float(step()))
        if logger is not None:
            logger.log(len(losses), tau=float(tau), first_loss=losses[-per_stage],
                       loss=losses[-1])
    return scene, losses


def camera_of(p: Dict[str, torch.Tensor], resolution) -> Camera:
    """Camera of :func:`fit_camera`'s parameters ``{position, euler (radians),
    fov}``."""
    e = p["euler"]
    return Camera(p["position"], euler_rotation(e[0], e[1], e[2], is_radians=True,
                                                device=e.device),
                  p["fov"], tuple(resolution))


def camera_value_and_grad(scene, target, resolution, *, depth: int = 1,
                          compat: bool = True, aliasing: bool = False,
                          backend: str = "cuda",
                          cheap_shadow: bool | None = None) -> Callable:
    """``params -> (loss, grads)`` for camera-pose fitting
    (``train.camera_value_and_grad``). With ``backend="cuda"`` the backward
    kernel's camera slots (its ``cheap_shadow`` as the wrapper takes it) are
    chained to the Euler angles by autograd of ``euler_rotation`` (a 3x3
    Jacobian on the card, next to nothing beside the render); with
    ``"torch"`` the whole loss is differentiated by autograd."""
    _backend(backend, "camera_value_and_grad", target, scene.materials.ambient)
    if backend == "cuda":
        def value_and_grad(p):
            e = p["euler"].detach().requires_grad_(True)
            rot = euler_rotation(e[0], e[1], e[2], is_radians=True, device=e.device)
            cam = Camera(p["position"].detach(), rot.detach(), p["fov"].detach(),
                         tuple(resolution))
            loss, _, cam_g = loss_and_scene_grads_cuda(
                cam, scene, target, depth=depth, compat=compat, aliasing=aliasing,
                return_camera=True, cheap_shadow=cheap_shadow)
            (euler_g,) = torch.autograd.grad(rot, e, grad_outputs=cam_g.rotation)
            return loss, {"position": cam_g.position, "euler": euler_g, "fov": cam_g.fov}
        return value_and_grad

    def value_and_grad(p):
        q = {k: p[k].detach().requires_grad_(True) for k in CAMERA_KEYS}
        img = render_image(camera_of(q, resolution), scene, depth=depth,
                           aliasing=aliasing, compat=compat)
        loss = torch.mean((img - target) ** 2)
        grads = torch.autograd.grad(loss, [q[k] for k in CAMERA_KEYS])
        return loss.detach(), dict(zip(CAMERA_KEYS, grads))
    return value_and_grad


def fit_camera(init_camera, scene, target, *, steps: int = 300, lr: float = 1e-2,
               depth: int = 1, aliasing: bool = False, compat: bool = True,
               fit_fov: bool = False, logger: Optional[MetricsLogger] = None,
               log_every: int = 20, backend: str = "cuda"):
    """Inverse rendering with respect to the camera: recover its pose from a
    target image (``train.fit_camera``). Optimizes position and Euler angles
    (the rotation is rebuilt by ``euler_rotation`` every step, so it stays a
    rotation) and, with ``fit_fov``, the fov. ``init_camera``'s rotation is
    taken to come from ``euler_rotation``; its angles are recovered with the
    reference's transposed Ry (``Ry_ref(t) = Ry_std(-t)``, so ``R[2, 0] =
    +sin(pitch)``). Returns ``(fitted_camera, losses)``."""
    _backend(backend, "fit_camera", init_camera.position, target, scene.materials.ambient)
    R = init_camera.rotation.detach().float()
    pitch0 = torch.asin(torch.clamp(R[2, 0], -1.0, 1.0))
    yaw0 = torch.atan2(R[1, 0], R[0, 0])
    roll0 = torch.atan2(R[2, 1], R[2, 2])
    params = {"position": init_camera.position.detach().clone().float(),
              "euler": torch.stack([roll0, pitch0, yaw0]),
              "fov": init_camera.fov.detach().clone().float()}
    resolution = init_camera.resolution
    vg = camera_value_and_grad(scene, target, resolution, depth=depth, compat=compat,
                               aliasing=aliasing, backend=backend)
    keys = CAMERA_KEYS if fit_fov else CAMERA_KEYS[:2]
    opt = torch.optim.Adam([params[k] for k in keys], lr=lr)
    losses = []
    for i in range(steps):
        loss, grads = vg(params)
        for k in keys:
            params[k].grad = grads[k].detach().reshape(params[k].shape)
        opt.step()
        losses.append(float(loss))
        _log(logger, i, steps, log_every, losses[-1])
    return camera_of(params, resolution), losses
