"""python_ray_tracer_tpu_torch — the ray tracer ported to PyTorch and CUDA.

A port of ``python_ray_tracer_tpu`` (JAX/Pallas) for NVIDIA Hopper cards: the
plain PyTorch modules mirror the JAX package's ``models``/``ops``/``utils``
module by module and are the reference path; the render kernels are
hand-written CUDA C++ (``csrc/``), built with nvcc at first use and bound with
ctypes (``ops/cuda``). This package imports torch and numpy, never jax.

The backward kernel (``csrc/render_bwd.cu``) gives scene and camera gradients;
``render_image_fast`` is the differentiable render, and ``train`` fits scenes
and cameras with it. The soft-visibility renderer (``ops/soft.py``) has its
forward and backward kernels (``csrc/soft_fwd.cu``, ``csrc/soft_bwd.cu``),
``render_image_soft_fast`` and ``train.fit_scene_soft``. Adaptive AA
(``ops/adaptive.py``) traces the 9 samples of the flagged pixels only, through
the worklist kernel (``render_image_adaptive_cuda``). ``parallel`` shards
renders and training steps by vertical slices over ``torch.distributed``;
``animation`` renders camera trajectories. ``utils.checkpoint`` saves and
loads path-keyed trees (the JAX package's format, Adam's state in optax's
layout), ``utils.faults`` resumes fits from them after faults, and
``utils.profiling`` traces the kernels.

Objects are made on the card unless the caller says otherwise: every
constructor's ``device=None`` is the CUDA device (``utils.config.resolve_device``,
which raises without one), every kernel wrapper takes CUDA tensors only, and
``backend="cuda"`` is every entry point's default. A CPU run passes
``device="cpu"`` and ``backend="torch"`` (``--backend torch`` on the CLI).

Entry point: ``python -m python_ray_tracer_tpu_torch.cli render|fit|animate``.
"""
# utils first: the models take their default device from utils.config, and
# utils.checkpoint imports the models.
from .utils.config import RenderConfig, require_cuda, resolve_backend, resolve_device
from .models.scene import (Scene, Spheres, Planes, Lights, Materials, default_scene,
                           random_scene, RED, GREEN, BLUE, YELLOW, GREY, MAGENTA)
from .models.camera import (Camera, default_camera, euler_rotation, rotation_x,
                            rotation_y, rotation_z)
from .ops.render import render_image, render_rays, to_framebuffer
from .ops.shade import sample, trace_once, reflect
from .ops.intersect import intersect_spheres, intersect_planes, closest_hit, any_hit
from .ops.cuda.render_cuda import (render_image_cuda, render_image_fast, pack_params,
                                   shadow_cheap_ok)
from .ops.cuda.render_bwd_cuda import (grad_layout, scene_grads_cuda,
                                       loss_and_scene_grads_cuda)
from .ops.adaptive import render_image_adaptive_plain
from .ops.cuda.adaptive_cuda import render_image_adaptive_cuda
from .ops.soft import render_image_soft, render_rays_soft
from .ops.cuda.soft_cuda import render_image_soft_cuda, render_image_soft_fast
from .ops.cuda.soft_bwd_cuda import soft_scene_grads_cuda, soft_loss_and_grads_cuda
from .train import fit_scene, fit_scene_soft, fit_camera
from .utils.metrics import MetricsLogger
from .utils.image import save_png, framebuffer_to_array
from .utils.checkpoint import save_pytree, load_pytree
from .utils.timing import time_fn, rays_per_image

__version__ = "0.1.0"

__all__ = [
    "Scene", "Spheres", "Planes", "Lights", "Materials", "default_scene",
    "random_scene", "Camera", "default_camera", "euler_rotation", "rotation_x",
    "rotation_y", "rotation_z", "render_image", "render_rays", "to_framebuffer",
    "sample", "trace_once", "reflect", "intersect_spheres", "intersect_planes",
    "closest_hit", "any_hit", "render_image_cuda", "render_image_fast",
    "pack_params", "shadow_cheap_ok", "grad_layout", "scene_grads_cuda",
    "loss_and_scene_grads_cuda", "render_image_adaptive_plain",
    "render_image_adaptive_cuda", "render_image_soft", "render_rays_soft",
    "render_image_soft_cuda", "render_image_soft_fast", "soft_scene_grads_cuda",
    "soft_loss_and_grads_cuda", "fit_scene", "fit_scene_soft", "fit_camera",
    "MetricsLogger", "save_pytree", "load_pytree",
    "RenderConfig", "resolve_backend", "resolve_device", "require_cuda", "save_png",
    "framebuffer_to_array", "time_fn", "rays_per_image",
    "RED", "GREEN", "BLUE", "YELLOW", "GREY", "MAGENTA",
]
