"""The capsule-and-cone test on the CPU, and ``render_image_cuda(shadow_cull=
True)``. The JAX package's runtime capsule cull (``_any_hit_capsule``) and its
shadow lists (``_shadow_visibility_lists``) share one test: a sphere can block
a shadow ray from a box of origins only if it meets the capsule around the
segment from the box to the light or the cone past the light. The port keeps
that test in its shadow lists (``cull_tables.shadow_rows``, the plain version
of csrc/shadow_lists.cu) and culls the sweeps that have no list with its light
cells and bounce tree, so ``shadow_cull`` changes no launch. Here: the lists'
test on a box (a hit-extent row) keeps every sphere that blocks a shadow ray
from any sampled point of the box through the light and on past it, on the
scene with an occluder planted beyond a light, in clean mode and on the scene
scaled by 1e4, and keeps every sphere for a light inside the box; and the JAX
package's render with ``shadow_cull=True`` in interpret mode against the
port's plain render at the goldens' uint8 rule (``tests/torch_goldens.py``:
max diff <= 1 level, < 1% of pixels changed).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import python_ray_tracer_tpu as jrt
import python_ray_tracer_tpu_torch as trt
from python_ray_tracer_tpu.ops.pallas.render_pallas import render_image_pallas
from python_ray_tracer_tpu_torch.ops.cuda import cull_tables as ct

from .test_torch_render import to_torch
from .torch_goldens import compare_frames

torch.set_num_threads(1)


def _planted(n=60, s=1.0):
    """n seeded spheres plus a large one 4 units beyond light 0 (as seen from
    (0, 0, 2)), every length times s."""
    base = trt.random_scene(n, generator=torch.Generator().manual_seed(11), device="cpu")
    L0 = base.lights.position[0]
    u = L0 - torch.tensor([0.0, 0.0, 2.0])
    beyond = L0 + 4.0 * u / u.norm()
    sph = trt.Spheres(torch.cat([base.spheres.center, beyond[None]]) * s,
                      torch.cat([base.spheres.radius, torch.tensor([1.5])]) * s,
                      torch.cat([base.spheres.albedo, torch.tensor([[1.0, 0.0, 0.0]])]))
    return trt.Scene(sph, trt.Planes(base.planes.origin * s, base.planes.normal,
                                     base.planes.albedo),
                     trt.Lights(base.lights.position * s), base.materials)


def _boxes(n_boxes, s, seed=0):
    """Boxes of origins on and above the ground: a corner in [-8, 8]^2 x [0,
    2] and sides up to 1.5 (a warp's shadow origins), every length times s."""
    g = torch.Generator().manual_seed(seed)
    lo = torch.rand((n_boxes, 3), generator=g) * torch.tensor([16.0, 16.0, 2.0]) - \
        torch.tensor([8.0, 8.0, 0.0])
    hi = lo + torch.rand((n_boxes, 3), generator=g) * 1.5
    return lo * s, hi * s


def _blockers(scene, P, light, compat):
    """Spheres that block a shadow ray from any of the points P toward the
    light (either form of the test; occluders beyond the light count)."""
    d = scene.lights.position[light] - P
    d = d / d.norm(dim=-1, keepdim=True)
    C, R = scene.spheres.center, scene.spheres.radius
    occ = torch.zeros(C.shape[0], dtype=torch.bool)
    for cheap in (True, False):
        occ |= ct.sphere_occludes_plain(P, d, C, R, compat=compat, cheap=cheap).any(dim=0)
    return occ


def _points(lo, hi, n, seed):
    """The 8 corners of the box and n points inside it."""
    g = torch.Generator().manual_seed(seed)
    corners = torch.stack([torch.where(torch.tensor([(c >> i) & 1 for i in range(3)],
                                                    dtype=torch.bool), hi, lo)
                           for c in range(8)])
    return torch.cat([corners, lo + torch.rand((n, 3), generator=g) * (hi - lo)])


def _keep(lo, hi, scene, compat):
    """``(B, nl, ns)``: the lists' decisions for boxes ``lo``/``hi`` as
    hit-extent rows (each with hits), in sphere index order."""
    ext = torch.cat([lo, hi, torch.full((lo.shape[0], 1), 5.0),
                     torch.zeros((lo.shape[0], 1))], dim=1)
    rows = ct.shadow_rows(ext, scene.lights.position, scene.spheres.center,
                          scene.spheres.radius, compat=compat)
    keep = torch.zeros_like(rows.keep)
    return keep.scatter_(2, rows.order[None].expand_as(rows.keep), rows.keep)


@pytest.mark.parametrize("compat,s", [(True, 1.0), (False, 1.0), (False, 1e4)])
def test_capsule_keeps_every_blocker(compat, s):
    """For 48 boxes and each light: every sphere that blocks a ray from a
    sampled point of the box (its corners and 200 points inside) is kept;
    the capsule drops most spheres of most boxes; the sphere planted beyond
    light 0 blocks some box's rays and is kept there. The scene scaled by 1e4
    in clean mode (in compat mode the far clip at 999 leaves it no shadow)."""
    scene = _planted(s=s)
    ns = scene.spheres.count
    lo, hi = _boxes(48, s)
    keep = _keep(lo, hi, scene, compat)
    assert keep.shape == (48, 3, ns)
    assert float(keep.float().mean()) < 0.5
    planted_blocks = 0
    for b in range(48):
        P = _points(lo[b], hi[b], 200, seed=b)
        for light in range(3):
            blk = _blockers(scene, P, light, compat)
            assert not bool((blk & ~keep[b, light]).any()), (b, light)
            planted_blocks += int(light == 0 and bool(blk[ns - 1]))
    assert planted_blocks > 0


def test_capsule_keeps_everything_for_a_light_in_the_box():
    """A box that holds the light (or comes within two of its half-diagonals)
    has no cone: every sphere is kept for that light; a box farther off, and
    the other lights, keep fewer."""
    scene = _planted()
    L0 = scene.lights.position[0]
    lo = torch.stack([L0 - 0.5, L0 + torch.tensor([3.0, 3.0, 3.0])])
    hi = torch.stack([L0 + 0.5, L0 + torch.tensor([4.0, 4.0, 4.0])])
    keep = _keep(lo, hi, scene, True)
    assert bool(keep[0, 0].all()) and not bool(keep[1, 0].all())
    assert not bool(keep[0, 1].all())


def test_pallas_shadow_cull_against_the_plain_render():
    """tests/test_pallas.py's shadow-cull scene (18 seeded spheres and one
    planted beyond light 0), 16x8, depth 0, no AA, compat: the JAX render with
    the capsule on, in interpret mode, against the port's plain render."""
    base = jrt.random_scene(jax.random.key(5), n_spheres=18)
    L0 = np.asarray(base.lights.position)[0]
    u = L0 - np.array([0.0, 0.0, 2.0])
    beyond = (L0 + 4.0 * u / np.linalg.norm(u)).astype(np.float32)
    sp = base.spheres
    scene_j = dataclasses.replace(base, spheres=dataclasses.replace(
        sp, center=jnp.concatenate([sp.center, jnp.asarray([beyond])]),
        radius=jnp.concatenate([sp.radius, jnp.asarray([1.5])]),
        albedo=jnp.concatenate([sp.albedo, jnp.asarray([[1.0, 0.0, 0.0]])])))
    cam_j = jrt.Camera.build((16, 8), [-7, 0, 3], [0, -20, 0])
    img_j = np.asarray(render_image_pallas(cam_j, scene_j, depth=0, aliasing=False,
                                           compat=True, tile_w=8, tile_h=8, interpret=True,
                                           shadow_cull=True))
    cam, scene = to_torch(cam_j, scene_j)
    img = trt.render_image(cam, scene, depth=0, aliasing=False, compat=True)
    fb_j = trt.to_framebuffer(torch.as_tensor(img_j.copy()))
    compare_frames(trt.to_framebuffer(img).numpy(), fb_j.numpy(), "shadow_cull_16x8")
    # the kernel wrapper refuses the CPU tensors, shadow_cull on or not
    with pytest.raises(ValueError, match="render_image_cuda takes CUDA tensors, got cpu"):
        trt.render_image_cuda(cam, scene, depth=0, aliasing=False, shadow_cull=True)
