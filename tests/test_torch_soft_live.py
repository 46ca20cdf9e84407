"""What the soft backward kernel's exact skips and its launch planner rest on,
checked on the CPU.

The skips (csrc/soft_bwd.cu) leave out only terms that are exactly 0: an
object whose weight is 0 (alpha 0 on every ray: wholly off-frame, or behind the
camera), a light whose Lambert term is never positive, an occluder whose alpha
is 0, a sphere hidden behind another's saturated alpha (a == 1.0f). Each
premise is held here in both references, the port's plain version (autograd of
ops/soft.py) and the JAX package's jnp soft path (jax.vjp), on the same seeded
cotangent: the slots such objects and lights own are exactly 0 in both.

The planner (soft_bwd_cuda.plan) is pure Python: every plan it returns fits a
block's 227 KB of shared memory and the block limits, and it raises only where
the first port's kernel raised (4 warps of gradient rows did not fit).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import python_ray_tracer_tpu as jrt
from python_ray_tracer_tpu.ops.soft import render_image_soft as jax_soft
from python_ray_tracer_tpu_torch.ops.cuda import render_bwd_cuda as rb
from python_ray_tracer_tpu_torch.ops.cuda import soft_bwd_cuda as sb

from .test_torch_render import to_torch
from .test_torch_soft import flat_of_jax

torch.set_num_threads(1)

SEEN = [([2.2, 0.3, 1.0], 1.0, jrt.RED), ([0.6, -0.8, 0.5], 0.5, jrt.GREEN)]
OFF_FRAME = ([2.0, 40.0, 1.0], 0.3, jrt.BLUE)     # far outside the view and every shadow ray
BEHIND = ([-8.0, 0.0, -3.0], 0.5, jrt.YELLOW)     # behind the camera, under the plane
PLANE = ([5, 0, 0], [0, 0, 1], jrt.GREY)


def dead_scene():
    return jrt.Scene(jrt.Spheres.build(SEEN + [OFF_FRAME, BEHIND]), jrt.Planes.build([PLANE]),
                     jrt.Lights.build([[2.5, -2.0, 3.0], [5.0, 0.1, 6.0]]),
                     jrt.Materials.build())


def backlit_scene():
    """Only the plane in view; light 1 lies under it."""
    return jrt.Scene(jrt.Spheres.build([OFF_FRAME, BEHIND]), jrt.Planes.build([PLANE]),
                     jrt.Lights.build([[2.5, -2.0, 3.0], [3.0, 0.0, -4.0]]),
                     jrt.Materials.build())


def eclipsed_scene():
    """At tau 0.02 the big sphere's alpha is 1.0f over the small one."""
    return jrt.Scene(jrt.Spheres.build([([2.0, 0.0, 1.0], 1.0, jrt.RED),
                                        ([6.0, 0.0, -1.0], 0.1, jrt.GREEN)]),
                     jrt.Planes.build([PLANE]), jrt.Lights.build([[2.5, -2.0, 3.0]]),
                     jrt.Materials.build())


def both_grads(scene_j, tau, res=(24, 16)):
    """The flat gradient of <render, g> for a seeded N(0, 1) cotangent g: the
    port's plain version and jax.vjp of the JAX package's jnp path."""
    cam_j = jrt.default_camera(res)
    g = np.random.default_rng(0).normal(size=(*res, 3)).astype(np.float32)
    _, vjp = jax.vjp(lambda c, s: jax_soft(c, s, tau=tau), cam_j, scene_j)
    cam_g, scene_g = vjp(jnp.asarray(g))
    cam, scene = to_torch(cam_j, scene_j)
    counts = (scene.spheres.count, scene.planes.count, scene.lights.count)
    plain = sb.soft_scene_grads_plain(cam, scene, torch.from_numpy(g), tau=tau)
    return {"plain": rb.grad_groups(plain, *counts),
            "jax": rb.grad_groups(flat_of_jax(scene_g, cam_g, res), *counts)}


def sphere_slots(groups, rows):
    return torch.cat([groups["spheres.center"][rows], groups["spheres.radius"][rows, None],
                      groups["spheres.albedo"][rows]], dim=1)


@pytest.mark.parametrize("tau", [0.15, 0.05])
def test_dead_spheres_have_exactly_zero_slots(tau):
    """Skips A(i) and A(iii): a sphere off-frame or behind the camera has alpha
    0 on every primary and shadow ray, so its 7 slots are exactly 0; the
    spheres in view have gradients."""
    for who, groups in both_grads(dead_scene(), tau).items():
        assert bool((sphere_slots(groups, [2, 3]) == 0).all()), who
        assert bool((sphere_slots(groups, [0, 1]).abs().amax(dim=1) > 0).all()), who


def test_unlit_light_has_exactly_zero_slots():
    """Skip A(ii): a light under the only surface in view has a Lambert term
    <= 0 at every composited point, so its 3 slots are exactly 0; the light
    above has gradients."""
    for who, groups in both_grads(backlit_scene(), 0.15).items():
        assert bool((groups["lights.position"][1] == 0).all()), who
        assert float(groups["lights.position"][0].abs().max()) > 0, who


def test_eclipsed_sphere_has_exactly_zero_slots():
    """Skip A(i) through an occluder with a == 1.0f: the small sphere's weight
    is exactly 0 wherever its alpha is not, so its slots are exactly 0."""
    for who, groups in both_grads(eclipsed_scene(), 0.02).items():
        assert bool((sphere_slots(groups, [1]) == 0).all()), who
        assert float(sphere_slots(groups, [0]).abs().max()) > 0, who


# --- the planner ----------------------------------------------------------------

def first_port_raised(ns, npl, nl):
    """The first port's check: the scene and 4 warp rows of the fused gradient
    in one block's shared memory (its _check, before the planner)."""
    smem = 4 * (41 + 7 * ns + 9 * npl + 3 * nl + 4 * rb.n_grads(ns, npl, nl, True))
    return smem > 227 * 1024


@pytest.mark.parametrize("ns", [0, 1, 6, 16, 17, 100, 256, 1000, 1600])
def test_plan_fits_a_block(ns):
    for nl in (0, 1, 3, 20):
        for fused in (True, False):
            p = sb.plan(ns, 1, nl, fused)
            assert p.nt in (32, 64, 128) and p.nt % sb.BLOCK_Y == 0
            assert 1 <= p.cap <= max(ns + 1, 1) and 1 <= p.cj <= max(ns, 1)
            assert p.smem == sb.smem_bytes(ns, 1, nl, fused, p.nt, p.cap, p.cj, p.store_vis)
            assert p.smem <= 227 * 1024
            assert p.store_vis      # these scenes keep one transmission a light
            assert sb.n_blocks(1000, 1000, p) == -(-1000 // 16) * -(-1000 // (p.nt // 16))


def test_plan_prefers_whole_scenes_on_the_demo():
    """The demo scene's plan holds every object in one chunk and every sphere
    in one window (the fastest plan measured on the card)."""
    assert sb.plan(6, 1, 3) == sb.Plan(128, 7, 6, True, sb.plan(6, 1, 3).smem)


@pytest.mark.parametrize("npl,nl", [(1, 3), (0, 0), (1, 20), (4, 1)])
def test_plan_raises_only_where_the_first_port_did(npl, nl):
    """At the largest sphere count the first port took and one past it, and
    for light counts up to the largest it took without spheres."""
    ns_max = next(n for n in range(3000) if first_port_raised(n + 1, npl, nl))
    for ns in (ns_max - 1, ns_max):
        p = sb.plan(ns, npl, nl)
        assert p.smem <= 227 * 1024
    assert first_port_raised(ns_max + 1, npl, nl)
    nl_max = next(n for n in range(5000) if first_port_raised(0, npl, n + 1))
    assert sb.plan(0, npl, nl_max).smem <= 227 * 1024
    with pytest.raises(ValueError, match="shared memory"):
        sb.plan(0, npl, 100_000)


# --- the soft forward's skips -----------------------------------------------------
#
# csrc/soft_fwd.cu drops an object's primary cover and a shadow occluder's
# cover where t_ca <= 0 or where the squared closest-approach distance |v|^2
# (v = L - t_ca d) exceeds (r (1 + 90 tau))^2, and a light whose Lambert term
# is <= 0. Each such term must be exactly 0 in the plain float32 version.

def _kernel_dead(o, d, center, radius, tau):
    """The forward kernel's test, in float32: True where it drops the cover."""
    L = center - o[..., None, :]
    t_ca = (L * d[..., None, :]).sum(-1)
    v = L - t_ca[..., None] * d[..., None, :]
    rd = radius * (1.0 + 90.0 * tau)
    return ~(t_ca > 0.0) | ((v * v).sum(-1) > rd * rd)


@pytest.mark.parametrize("tau", [0.15, 0.05, 0.02])
def test_soft_forward_skips_only_exact_zeros(tau):
    """On the scenes above and the demo scene: every primary cover and every
    shadow cover the forward kernel drops has alpha exactly 0 in the plain
    float32 version (ops/soft.py's _sphere_soft_cover), and every light it
    does not sweep has a Lambert term of exactly 0 there; the drops are many."""
    from python_ray_tracer_tpu_torch.ops.intersect import _dot
    from python_ray_tracer_tpu_torch.ops.soft import _norm, _sphere_soft_cover
    scenes = [dead_scene(), backlit_scene(), eclipsed_scene(), jrt.default_scene()]
    dropped = 0
    for scene_j in scenes:
        cam, scene = to_torch(jrt.default_camera((40, 28)), scene_j)
        d = cam.ray_directions(torch.stack(torch.meshgrid(
            torch.arange(40.0), torch.arange(28.0), indexing="ij"), dim=-1), compat=False)
        o = cam.ray_origin().expand(d.shape)
        c, r = scene.spheres.center, scene.spheres.radius
        alpha, t = _sphere_soft_cover(o, d, c, r, tau)
        dead = _kernel_dead(o, d, c, r, tau)
        assert bool((alpha[dead] == 0).all())
        dropped += int(dead.sum())
        # the live spheres' points, toward every light
        P = o[..., None, :] + t[..., None] * d[..., None, :]          # (w, h, ns, 3)
        N = (P - c) / _norm(P - c)
        Ld = scene.lights.position - P[..., None, :]                  # (w, h, ns, nl, 3)
        Ld = Ld / _norm(Ld)
        lam = scene.materials.lambert * _dot(Ld, N[..., None, :])
        relu = torch.where(lam > 0.0, lam, torch.zeros_like(lam))
        assert bool((relu[~(lam > 0.0)] == 0).all())
        a_sh, _ = _sphere_soft_cover(P[..., None, :], Ld, c, r, tau)  # (w, h, ns, nl, ns)
        dead_sh = _kernel_dead(P[..., None, :], Ld, c, r, tau)
        assert bool((a_sh[dead_sh] == 0).all())
        dropped += int(dead_sh.sum())
    assert dropped > 0
