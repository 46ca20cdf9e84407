"""The port's plain soft renderer and its gradients against the JAX package's
soft Pallas kernels themselves (interpret mode): the forward kernel
(soft_pallas._make_soft_kernel) and the backward kernel
(soft_bwd._make_soft_bwd_kernel, camera slots included), on
tests/test_soft_bwd.py's 3-sphere / 2-plane / 2-light scene at 24x16. The image
is held at rtol 1e-4 / atol 1e-5 (tests/test_soft_bwd.py:209-210, the soft
kernel on a plane scene), the flat gradient under the JAX package's soft
kernel rule (soft_bwd_cuda.soft_grad_rule). The CUDA kernels are held to the
plain version on a card (tests/test_torch_card.py, chip_smoke.py)."""
import jax.numpy as jnp
import numpy as np
import torch

import python_ray_tracer_tpu as jrt
from python_ray_tracer_tpu_torch.ops.cuda import render_bwd_cuda as rb
from python_ray_tracer_tpu_torch.ops.cuda import soft_bwd_cuda as sb
from python_ray_tracer_tpu_torch.ops.soft import render_image_soft

from .test_torch_render import to_torch
from .test_torch_soft import TAU, assert_soft_rule, flat_of_jax, noise, small_scene_jax

torch.set_num_threads(1)


def test_plain_matches_pallas_soft_kernels_interpret():
    """The plain version against the JAX soft forward kernel and soft backward
    kernel themselves (Pallas interpret mode), small scene 24x16: the image
    and the flat gradient (camera slots included) under the rule."""
    from python_ray_tracer_tpu.ops.pallas.soft_bwd import soft_scene_grads_pallas
    from python_ray_tracer_tpu.ops.pallas.soft_pallas import render_image_soft_pallas
    res = (24, 16)
    cam_j, scene_j = jrt.default_camera(res), small_scene_jax()
    img_k = np.asarray(render_image_soft_pallas(cam_j, scene_j, tau=TAU, interpret=True))
    g = noise(res, seed=0)
    scene_g, cam_g = soft_scene_grads_pallas(cam_j, scene_j, jnp.asarray(g), tau=TAU,
                                             interpret=True, return_camera=True)
    cam, scene = to_torch(cam_j, scene_j)
    np.testing.assert_allclose(render_image_soft(cam, scene, tau=TAU).numpy(), img_k,
                               rtol=1e-4, atol=1e-5)
    flat = sb.soft_scene_grads_plain(cam, scene, torch.from_numpy(g), tau=TAU)
    assert_soft_rule(flat, flat_of_jax(scene_g, cam_g, res), scene)
    groups = rb.grad_groups(flat_of_jax(scene_g, cam_g, res), 3, 2, 2)
    for leaf in ("materials.reflection", "materials.specular", "materials.shininess"):
        assert float(groups[leaf]) == 0.0
