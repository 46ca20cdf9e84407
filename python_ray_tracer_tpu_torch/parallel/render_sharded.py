"""The ray-parallel render and render-to-loss (``parallel/render_sharded.py``
of the JAX package).

:func:`render_image_sharded` renders this rank's slice through the kernels'
slice form (``render_cuda.render_image_cuda(x_offset=, local_width=)``) with
no communication; :func:`..distributed.gather_framebuffer` assembles the
frame. :func:`make_loss_fn` is a slice's part of the frame's MSE through the
plain renderer, for autograd; the caller's step all-reduces its gradients
(``train.fit_scene(mesh=)``).
"""
from __future__ import annotations

import torch

from ..ops.cuda.render_bwd_cuda import slice_mse
from ..ops.cuda.render_cuda import render_image_cuda
from ..ops.render import render_image
from ..ops.soft import render_image_soft
from ..utils.config import require_cuda, resolve_backend
from .mesh import Mesh



def local_target(target: torch.Tensor, camera, mesh: Mesh) -> torch.Tensor:
    """This rank's columns of ``target``: the frame's ``(W, H, 3)`` sliced, or
    a slice given as it is."""
    x0, lw = mesh.slice(camera.resolution[0])
    if target.shape[0] == camera.resolution[0]:
        return target[x0:x0 + lw]
    if target.shape[0] != lw:
        raise ValueError(f"target has {target.shape[0]} columns: neither the frame's "
                         f"{camera.resolution[0]} nor the slice's {lw}")
    return target


def render_image_sharded(camera, scene, mesh: Mesh, *, depth: int = 2,
                         aliasing: bool = True, compat: bool = True,
                         backend: str = "cuda", aa_share: bool = True) -> torch.Tensor:
    """This rank's ``(W / n, H, 3)`` slice of the frame, with no
    communication: ``backend="cuda"`` through ``render_image_cuda``'s slice
    form (the kernels: a card and CUDA tensors, else it raises), ``"torch"``
    through the plain renderer on the tensors' own device."""
    x0, lw = mesh.slice(camera.resolution[0])
    if resolve_backend(backend) == "cuda":
        require_cuda("render_image_sharded(backend='cuda')", camera.position,
                     scene.materials.ambient)
        return render_image_cuda(camera, scene, depth=depth, aliasing=aliasing,
                                 compat=compat, aa_share=aa_share, x_offset=x0,
                                 local_width=lw)
    return render_image(camera, scene, depth=depth, aliasing=aliasing, compat=compat,
                        x_offset=x0, local_width=lw)


def make_loss_fn(camera, target, mesh: Mesh, *, depth: int = 2, aliasing: bool = True,
                 compat: bool = True, soft: bool = False, tau: float = 0.05):
    """``loss(scene) -> scalar``: this rank's part of the frame's pixel MSE
    (its slice's squared error over the frame's ``W * H * 3``), through the
    plain renderer for autograd; ``soft`` renders the slice with the soft
    renderer at ``tau``. The parts of all ranks sum to the frame's loss and
    their gradients to its gradient: the caller all-reduces them."""
    x0, lw = mesh.slice(camera.resolution[0])
    tgt = local_target(target, camera, mesh)

    def loss(scene):
        if soft:
            img = render_image_soft(camera, scene, tau=tau, x_offset=x0, local_width=lw)
        else:
            img = render_image(camera, scene, depth=depth, aliasing=aliasing,
                               compat=compat, x_offset=x0, local_width=lw)
        return slice_mse(img, tgt, camera.resolution[0])
    return loss
