"""The port's plain soft-visibility renderer (ops/soft.py) and its gradients on
the CPU, against the JAX package's jnp soft path (its soft Pallas kernels in
interpret mode: tests/test_torch_soft_pallas.py).

Images: atol 2e-5 (tests/test_soft.py:125); 2e-4 for the 28-sphere scene,
where about 30 (1 - alpha) factors amplify float32 reassociation
(tests/test_soft.py:144); rtol 1e-4 with atol 1e-5 for the 2-plane scene, as
tests/test_soft_bwd.py:209-210 holds the soft kernel on its plane scene (its
pixels reach 1.3, and at a few of them the float32 rounding of either package
moves the color by more than 2e-5, the JAX package on some and the port on
others).
Gradients: the JAX package's rule for its soft backward kernel
(tests/test_soft_bwd.py:30-70, soft_bwd_cuda.soft_grad_rule): every scene leaf
|d| <= 5e-6 max(max|g|, 1) + 5e-3 |g|, camera position atol 1e-5 and rotation
atol 1e-3 (rtol 5e-3), fov atol 3e-5, the loss rel 1e-5, at that test's tau
0.08 and N(0, 1) cotangent.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import python_ray_tracer_tpu as jrt
from python_ray_tracer_tpu.ops.soft import render_image_soft as jax_soft
from python_ray_tracer_tpu_torch import bridge
from python_ray_tracer_tpu_torch.ops.cuda import render_bwd_cuda as rb
from python_ray_tracer_tpu_torch.ops.cuda import soft_bwd_cuda as sb
from python_ray_tracer_tpu_torch.ops.soft import render_image_soft, row_chunk_for

from .test_torch_render import to_torch

torch.set_num_threads(1)

TAU = 0.08


def small_scene_jax():
    """tests/test_soft_bwd.py::_scene_small: 3 spheres, 2 planes, 2 lights."""
    return jrt.Scene(
        jrt.Spheres.build([([3.0, 0.2, 0.5], 0.8, jrt.RED), ([4.0, -0.6, 0.2], 0.6, jrt.GREEN),
                           ([5.0, 0.9, -0.3], 1.0, jrt.BLUE)]),
        jrt.Planes.build([([0.0, 0.0, -1.2], [0.0, 0.0, 1.0], jrt.GREY),
                          ([12.0, 0.0, 0.0], [-1.0, 0.1, 0.05], jrt.YELLOW)]),
        jrt.Lights.build([[0.0, 3.0, 5.0], [-2.0, -4.0, 6.0]]),
        jrt.Materials.build(ambient=0.15, lambert=0.7))


def degenerate_scene_jax():
    """tests/test_soft_bwd.py:124-145: a saturated cover behind a big sphere
    and a plane right in front of the camera (w == 0 behind it)."""
    return jrt.Scene(
        jrt.Spheres.build([([3.0, 0.0, 0.0], 1.4, jrt.RED), ([8.0, 0.0, 0.0], 1.0, jrt.GREEN)]),
        jrt.Planes.build([([1.0, 0.0, 0.0], [-1.0, 0.0, 0.0], jrt.GREY)]),
        jrt.Lights.build([[0.0, 0.0, 8.0]]), jrt.Materials.build(ambient=0.2, lambert=0.6))


def ties_scene_jax():
    """The camera at (-2, 0, 2) inside two spheres: both blend depths clamp to
    1e-4 with alpha > 0, so the stable tie-break (lower index in front)
    decides their weights; a third sphere lies behind the camera (alpha 0)."""
    return jrt.Scene(
        jrt.Spheres.build([([-1.9, 0.0, 2.0], 0.5, jrt.RED), ([-1.95, 0.1, 2.0], 0.6, jrt.GREEN),
                           ([3.0, 0.0, 1.0], 1.0, jrt.BLUE), ([-6.0, 0.0, 2.0], 1.0, jrt.YELLOW)]),
        jrt.Planes.build([([0.0, 0.0, -1.0], [0.0, 0.0, 1.0], jrt.GREY)]),
        jrt.Lights.build([[0.0, 2.0, 6.0]]), jrt.Materials.build(ambient=0.3, lambert=0.6))


SCENES = {
    "demo": lambda: jrt.default_scene(jrt.Materials.build(ambient=0.1)),
    "small": small_scene_jax,
    "dense28": lambda: jrt.random_scene(jax.random.key(4), n_spheres=28, n_lights=1),
    "ties": ties_scene_jax,
    "degenerate": degenerate_scene_jax,
}
TOL = {"dense28": dict(rtol=0, atol=2e-4), "small": dict(rtol=1e-4, atol=1e-5)}
TOL_DEFAULT = dict(rtol=0, atol=2e-5)


def noise(res, seed):
    return np.random.default_rng(seed).normal(size=(*res, 3)).astype(np.float32)


def flat_of_jax(scene_g, cam_g, res):
    """A JAX (scene, camera) gradient pytree -> the port's flat vector."""
    sg = bridge.scene_from_leaves([np.asarray(x) for x in jax.tree_util.tree_leaves(scene_g)],
                                  device="cpu")
    cg = bridge.camera_from_arrays(cam_g.position, cam_g.rotation, cam_g.fov, res, device="cpu")
    return rb.flatten_grads(sg, cg)


def assert_soft_rule(flat, ref, scene):
    counts = (scene.spheres.count, scene.planes.count, scene.lights.count)
    rule = sb.soft_grad_rule(flat, ref, *counts)
    assert all(ok for _, ok in rule.values()), {k: v for k, (v, ok) in rule.items() if not ok}


@pytest.mark.parametrize("bounce_depth", [0, 1])
@pytest.mark.parametrize("tau", [0.15, 0.05, 0.02])
@pytest.mark.parametrize("name", ["demo", "small", "dense28"])
def test_render_image_soft_matches_jax(name, tau, bounce_depth):
    cam_j, scene_j = jrt.default_camera((24, 16)), SCENES[name]()
    ref = np.asarray(jax_soft(cam_j, scene_j, tau=tau, bounce_depth=bounce_depth))
    cam, scene = to_torch(cam_j, scene_j)
    out = render_image_soft(cam, scene, tau=tau, bounce_depth=bounce_depth).numpy()
    np.testing.assert_allclose(out, ref, **TOL.get(name, TOL_DEFAULT))


@pytest.mark.parametrize("name", ["demo", "small", "dense28", "ties", "degenerate"])
def test_render_image_soft_32x32_matches_jax(name):
    cam_j, scene_j = jrt.default_camera((32, 32)), SCENES[name]()
    ref = np.asarray(jax_soft(cam_j, scene_j, tau=0.05))
    cam, scene = to_torch(cam_j, scene_j)
    whole = render_image_soft(cam, scene, tau=0.05, row_chunk=32)
    np.testing.assert_allclose(whole.numpy(), ref, **TOL.get(name, TOL_DEFAULT))
    chunked = render_image_soft(cam, scene, tau=0.05, row_chunk=7)
    torch.testing.assert_close(chunked, whole, rtol=0, atol=1e-6)


@pytest.mark.parametrize("name", ["small", "demo", "ties", "degenerate"])
def test_soft_grads_match_jax_vjp(name):
    """Autograd of the plain version (soft_scene_grads_plain, camera slots
    included) against jax.vjp of the jnp soft path on the same cotangent."""
    res = (24, 16)
    cam_j, scene_j = jrt.default_camera(res), SCENES[name]()
    g = noise(res, seed=0)
    _, vjp = jax.vjp(lambda c, s: jax_soft(c, s, tau=TAU), cam_j, scene_j)
    cam_g, scene_g = vjp(jnp.asarray(g))
    cam, scene = to_torch(cam_j, scene_j)
    flat = sb.soft_scene_grads_plain(cam, scene, torch.from_numpy(g), tau=TAU)
    assert bool(torch.isfinite(flat).all())
    assert_soft_rule(flat, flat_of_jax(scene_g, cam_g, res), scene)


def test_soft_loss_and_grads_match_jax():
    """The fused form's plain version: MSE loss and its gradient against
    jax.value_and_grad of the jnp path."""
    res = (24, 16)
    cam_j, scene_j = jrt.default_camera(res), small_scene_jax()
    target = np.random.default_rng(2).uniform(size=(*res, 3)).astype(np.float32)

    def loss_j(c, s):
        return jnp.mean((jax_soft(c, s, tau=TAU) - target) ** 2)
    l_j, (gc_j, gs_j) = jax.value_and_grad(loss_j, argnums=(0, 1))(cam_j, scene_j)
    cam, scene = to_torch(cam_j, scene_j)
    flat = sb.soft_loss_and_grads_plain(cam, scene, torch.from_numpy(target), tau=TAU)
    want = torch.cat([flat_of_jax(gs_j, gc_j, res), torch.tensor([float(l_j)])])
    assert_soft_rule(flat, want, scene)


def test_row_chunk_gradients_equal_whole_frame():
    """Checkpointed row blocks give the whole frame's gradients."""
    cam, scene = to_torch(jrt.default_camera((20, 12)), small_scene_jax())
    g = torch.from_numpy(noise((20, 12), seed=3))
    whole = sb.soft_scene_grads_plain(cam, scene, g, tau=TAU)
    chunked = sb.soft_scene_grads_plain(cam, scene, g, tau=TAU, row_chunk=6)
    torch.testing.assert_close(chunked, whole, rtol=1e-4, atol=1e-6)   # sum order
    assert row_chunk_for((20, 12), scene) is None
    assert row_chunk_for((512, 512), bridge.scene_from_leaves(
        [np.asarray(x) for x in jax.tree_util.tree_leaves(
            jrt.random_scene(jax.random.key(0), n_spheres=100))], device="cpu")) < 512


def test_soft_bounce_gradient_matches_jax():
    """bounce_depth=1: the reflection coefficient's gradient through the
    plain version against jax.grad (tests/test_soft.py::test_soft_bounce_sees_reflections)."""
    scene_j = jrt.Scene(
        jrt.Spheres.build([([3.0, 0.0, 1.0], 1.0, jrt.RED)]),
        jrt.Planes.build([([0.0, 0.0, -0.5], [0.0, 0.0, 1.0], jrt.GREY)]),
        jrt.Lights.build([[0.0, 2.0, 6.0]]),
        jrt.Materials.build(ambient=0.3, lambert=0.5, reflection=0.5))
    cam_j = jrt.default_camera((16, 16))
    g_j = jax.grad(lambda s: jnp.sum(jax_soft(cam_j, s, tau=0.05, bounce_depth=1)))(scene_j)
    cam, scene = to_torch(cam_j, scene_j)
    flat = sb.soft_scene_grads_plain(cam, scene, torch.ones(16, 16, 3), tau=0.05,
                                     bounce_depth=1)
    refl = float(rb.grad_groups(flat, 1, 1, 1)["materials.reflection"])
    assert abs(refl) > 1e-3
    assert refl == pytest.approx(float(g_j.materials.reflection), rel=1e-4)


def test_soft_work_counts_each_term_once():
    """utils.timing.soft_work, the soft kernels' bound: the live-term counts
    are the same in one block or column by column and nest as the render's
    terms do (a live sphere is ahead, a lit light's object is live); the fused
    step's work is the cotangent's plus the loss and the color sum, never a
    second forward pass; spheres behind the camera need no sigmoid."""
    from python_ray_tracer_tpu_torch.utils import timing
    cam, scene = to_torch(jrt.default_camera((12, 10)), small_scene_jax())
    ns, npl, nl = scene.spheres.count, scene.planes.count, scene.lights.count
    c = timing.soft_live_counts(cam, scene, TAU)
    assert c == timing.soft_live_counts(cam, scene, TAU, block=1)
    assert c["px"] == 120 and 0 < c["live_s"] <= c["front"] <= 120 * ns
    assert c["live_p"] <= 120 * npl and c["pairs_s"] <= c["pairs"]
    assert 0 < c["lit"] <= (c["live_s"] + c["live_p"]) * nl
    assert 0 < c["shadow_live"] <= c["shadow_front"] <= c["lit"] * ns
    (fwd, fwd_b), (cot, cot_b), (fused, fused_b) = (
        timing.soft_work(cam, scene, TAU, m, c) for m in ("fwd", "cot", "fused"))
    live = c["live_s"] + c["live_p"]
    assert fused - cot == live * timing.ACCUMULATE + c["px"] * timing.LOSS
    assert cot > fwd - live * timing.ACCUMULATE and fused_b == cot_b + 4 > fwd_b
    behind = _behind_camera(scene)
    assert timing.soft_live_counts(cam, behind, TAU)["front"] == 0
    assert timing.soft_live_counts(cam, behind, TAU)["live_s"] == 0


def _behind_camera(scene):
    """``scene`` with every sphere moved 20 units behind the default camera."""
    moved = scene.spheres.center + torch.tensor([-20.0, 0.0, 0.0])
    return type(scene)(type(scene.spheres)(moved, scene.spheres.radius,
                                           scene.spheres.albedo),
                       scene.planes, scene.lights, scene.materials)
