"""The backward kernel's AA lattice (csrc/render_bwd_kernel.cuh COT_AA and
FUSED_AA), checked on the CPU through its plain form.

The AA modes trace each 16x16 tile's 1089 distinct sample positions (the
forward's C, U, V and UV grids) once, each with the sum of the shares of the
in-tile pixels whose 3x3 stencil holds it
(render_bwd_cuda.lattice_cotangents). That scatter must be exactly the
adjoint of the forward's combine (render_bwd_cuda.lattice_combine, the
aa_shared store): <combine(samples), g> == <samples, scatter(g)> to float64
rounding, compat and clean, on images whose sides are not multiples of 16 and
on images 1 and 2 pixels wide (all border). The plain lattice gradient
(autograd through the lattice chains' colors, weighted by the scatter) is the
plain 9-sample VJP up to float rounding, and the JAX package's shared-sample
backward kernel (scene_grads_pallas with aa_share, in interpret mode) under
its kernel rule (tests/test_pallas_bwd.py), at depth 0: its interpret trace
takes ~30 s there and ~80 s at depth 1, past this file's minute (the bounces
are held by the 9-sample test above).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import python_ray_tracer_tpu as jrt
import python_ray_tracer_tpu_torch as trt
from python_ray_tracer_tpu.ops.pallas.render_bwd import scene_grads_pallas
from python_ray_tracer_tpu_torch.ops.cuda import render_bwd_cuda as rb
from python_ray_tracer_tpu_torch.ops.render import render_rays

from .test_torch_grads import (assert_kernel_rule, leaf_groups, noise, port_groups,
                               two_sphere_scene_jax)
from .test_torch_render import to_torch

torch.set_num_threads(1)

SIZES = [(37, 21), (16, 16), (1, 5), (2, 33), (33, 2), (1, 1), (17, 40)]


@pytest.mark.parametrize("size", SIZES)
@pytest.mark.parametrize("compat", [True, False])
def test_lattice_cotangents_are_the_adjoint_of_the_combine(size, compat):
    W, H = size
    rng = np.random.default_rng(W * 100 + H)
    samples = torch.from_numpy(rng.normal(size=(rb.n_tiles(W, H), rb.LATTICE, 3)))
    g = torch.from_numpy(rng.normal(size=(W, H, 3)))
    lhs = float((rb.lattice_combine(samples, W, H, compat) * g).sum())
    rhs = float((samples * rb.lattice_cotangents(g, W, H, compat)).sum())
    scale = float(samples.abs().sum() * g.abs().max())
    assert abs(lhs - rhs) <= 1e-14 * scale, (lhs, rhs)


@pytest.mark.parametrize("size", [(1, 5), (2, 33)])
def test_images_one_or_two_pixels_wide_take_the_centres_alone(size):
    """Every pixel of such an image is on the border ring: only the C grid
    carries a cotangent, the pixel's own (channel-swapped in compat)."""
    W, H = size
    g = torch.from_numpy(np.random.default_rng(3).normal(size=(W, H, 3)))
    cot = rb.lattice_cotangents(g, W, H, True)
    assert bool((cot[:, 256:] == 0).all())
    want = rb._tiled(g[..., [0, 2, 1]], W, H).reshape(cot.shape[0], 256, 3)
    assert torch.equal(cot[:, :256], want)


@pytest.mark.parametrize("compat", [True, False])
def test_lattice_combine_of_the_traced_lattice_is_the_aa_render(compat):
    """The lattice positions are the 9-sample positions: combining the traced
    lattice gives render_image(aliasing=True) to float32 rounding."""
    W, H = 37, 21
    cam, scene = trt.default_camera((W, H), device="cpu"), trt.default_scene(device="cpu")
    pos = rb.lattice_positions(W, H)
    colors = render_rays(pos.reshape(-1, 2), cam, scene, depth=2, compat=compat)
    img = rb.lattice_combine(colors.reshape(pos.shape[0], rb.LATTICE, 3), W, H, compat)
    ref = trt.render_image(cam, scene, depth=2, aliasing=True, compat=compat)
    assert float((img - ref).abs().max()) <= 1e-6


@pytest.mark.parametrize("compat", [True, False])
def test_plain_lattice_gradient_matches_the_9_sample_vjp(compat):
    """32x32, demo scene, Phong on in clean mode: the lattice form against
    scene_grads_plain(aliasing=True) under the kernel rule."""
    mats = trt.Materials.build(0.05, 0.6, 0.3, 0.0 if compat else 0.6, 8.0, device="cpu")
    scene, cam = trt.default_scene(mats, device="cpu"), trt.default_camera((32, 32), device="cpu")
    g = torch.from_numpy((noise((32, 32), seed=5) - 0.5) * np.float32(1e-2))
    lattice = rb.scene_grads_lattice_plain(cam, scene, g, depth=2, compat=compat)
    per_sample = rb.scene_grads_plain(cam, scene, g, depth=2, compat=compat, aliasing=True)
    rule = rb.grad_rule(lattice, per_sample, 6, 1, 3)
    assert all(ok for _, ok in rule.values()), rule
    assert all(r < 1e-4 for r, _ in rule.values()), rule


def test_plain_lattice_gradient_matches_pallas_aa_share():
    """2-sphere scene 16x16, depth 0: the lattice form against the JAX
    kernel's shared-sample AA cotangent form (scene_grads_pallas, aa_share,
    interpret; its narrow tile_w=24)."""
    scene_j, cam_j = two_sphere_scene_jax(), jrt.default_camera((16, 16))
    g = (noise((16, 16), seed=2) - 0.5) * np.float32(1e-2)
    gs_k, gc_k = scene_grads_pallas(cam_j, scene_j, jnp.asarray(g), depth=0, compat=True,
                                    aliasing=True, aa_share=True, interpret=True,
                                    tile_w=24, tile_h=16, return_camera=True)
    cam, scene = to_torch(cam_j, scene_j)
    flat = rb.scene_grads_lattice_plain(cam, scene, torch.from_numpy(g), depth=0)
    got, loss = port_groups(flat, scene)
    assert loss is None
    assert_kernel_rule(got, leaf_groups(gs_k, gc_k))
