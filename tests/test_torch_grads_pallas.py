"""The port's plain version of the backward kernel against the JAX Pallas
backward kernel itself, in interpret mode, under the JAX package's kernel rule
(tests/test_pallas_bwd.py): geometry, light and camera leaves max|d| / max|g|
< 5e-2 (a.e. gradients with the grazing clamp differ from autodiff's
root-formula values at a few silhouette pixels), albedo, plane and material
leaves rtol 1e-3 / atol 1e-7, the loss rel 1e-5. The CUDA kernel is held to the
plain version under the same rule on a card (tests/test_torch_card.py,
chip_smoke.py)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import python_ray_tracer_tpu as jrt
from python_ray_tracer_tpu.ops.pallas.render_bwd import (loss_and_scene_grads_pallas,
                                                         scene_grads_pallas)
from python_ray_tracer_tpu_torch.ops.cuda import render_bwd_cuda as rb

from .test_torch_grads import (assert_kernel_rule, leaf_groups, noise, port_groups,
                               two_sphere_scene_jax)
from .test_torch_render import to_torch

torch.set_num_threads(1)


def test_plain_grads_match_pallas_kernel_fused():
    """2-sphere scene 16x16, depth 1, no AA: the plain version against the
    JAX fused training-step kernel (loss_and_scene_grads_pallas, interpret)."""
    scene_j, cam_j = two_sphere_scene_jax(), jrt.default_camera((16, 16))
    target = noise((16, 16), seed=1)
    loss_k, gs_k, gc_k = loss_and_scene_grads_pallas(
        cam_j, scene_j, jnp.asarray(target), depth=1, compat=True, interpret=True,
        tile_w=8, tile_h=16, return_camera=True)
    cam, scene = to_torch(cam_j, scene_j)
    flat = rb.loss_and_scene_grads_plain(cam, scene, torch.from_numpy(target), depth=1)
    got, loss = port_groups(flat, scene)
    assert float(loss) == pytest.approx(float(loss_k), rel=1e-5)
    assert_kernel_rule(got, leaf_groups(gs_k, gc_k))


def test_plain_grads_match_pallas_kernel_aa_cotangent():
    """2-sphere scene 16x16, depth 1, AA: the plain version against the JAX
    kernel's per-sample AA cotangent form (scene_grads_pallas, interpret)."""
    scene_j, cam_j = two_sphere_scene_jax(), jrt.default_camera((16, 16))
    g = (noise((16, 16), seed=2) - 0.5) * np.float32(1e-2)
    gs_k, gc_k = scene_grads_pallas(cam_j, scene_j, jnp.asarray(g), depth=1, compat=True,
                                    aliasing=True, aa_share=False, interpret=True,
                                    tile_w=8, tile_h=16, return_camera=True)
    cam, scene = to_torch(cam_j, scene_j)
    flat = rb.scene_grads_plain(cam, scene, torch.from_numpy(g), depth=1, aliasing=True)
    got, loss = port_groups(flat, scene)
    assert loss is None
    assert_kernel_rule(got, leaf_groups(gs_k, gc_k))
