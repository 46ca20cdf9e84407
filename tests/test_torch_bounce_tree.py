"""The bounce sweeps' box tree (ops/cuda/cull_tables.py ``bounce_tree``) on the
CPU: its boxes against its members, its order against the JAX package's
Morton groups, and its plain traversals (``tree_closest_hit_plain``,
``tree_occluded_plain``, which mirror csrc/rt_common.cuh ``closest_hit_tree``
and ``occluded_tree``) against the full sweep of the same sphere tests.

Tolerances. None: the tree's closest hit must be the full sweep's, t bits and
sphere index, and its any-hit the full any-hit, on every ray, because the slab
test widens each box by what the sphere tests' float32 rounding can reach
(rt_common.cuh derives the margin). The rays include bounce origins hundreds
of units out on the ground plane (where the hoisted quadratic is noisiest),
rays that graze member spheres within that rounding, planted exact ties
(copies of a sphere, swept in both index orders), and rays with an exact 0
(or subnormal) direction component from origins far off that axis's 0, ground
bounces of a camera at y = 3 among them.
"""
import jax
import numpy as np
import pytest
import torch

import python_ray_tracer_tpu as jrt
import python_ray_tracer_tpu_torch as trt
from python_ray_tracer_tpu.ops.pallas import render_pallas as jp
from python_ray_tracer_tpu_torch.ops import intersect
from python_ray_tracer_tpu_torch.ops.cuda import cull_tables as ct
from python_ray_tracer_tpu_torch.ops.intersect import BIG, FAR
from python_ray_tracer_tpu_torch.ops.shade import BIAS, _surface_attributes, reflect

from .test_torch_render import to_torch

torch.set_num_threads(1)


def _scene(n, seed=0):
    return trt.random_scene(n, generator=torch.Generator().manual_seed(seed), device="cpu")


def _tied(n, seed=0):
    """n seeded spheres, then 4 copies of sphere 0 and 2 of sphere 1 (exact
    t ties between distinct indices)."""
    s = _scene(n, seed).spheres
    pick = torch.tensor([0, 0, 0, 0, 1, 1])
    return torch.cat([s.center, s.center[pick]]), torch.cat([s.radius, s.radius[pick]])


def _rays(centers, radii, n, seed):
    """Rays of four kinds, ``n`` each, float32 ``(4 n, 3)`` origins and unit
    directions: from inside the scene's box in any direction; from the
    ground plane 200-800 units out toward the scene; from inside the box
    aimed at a sphere's silhouette, off it by up to 2e-3 (S) of the margin's
    scale; from far out aimed at a silhouette the same way."""
    g = np.random.default_rng(seed)
    ns = centers.shape[0]
    c, r = centers.double().numpy(), radii.double().numpy()
    lo, hi = c.min(0) - 1.0, c.max(0) + 1.0

    def unit(v):
        return v / np.linalg.norm(v, axis=-1, keepdims=True)

    near_o = g.uniform(lo, hi, (n, 3))
    th, dist = g.uniform(0, 2 * np.pi, n), g.uniform(200, 800, n)
    far_o = np.stack([dist * np.cos(th), dist * np.sin(th), np.full(n, 2e-4)], axis=1)
    outs = [(near_o, unit(g.normal(size=(n, 3)))),
            (far_o, unit(g.uniform(lo, hi, (n, 3)) - far_o))]
    for o in (g.uniform(lo, hi, (n, 3)), far_o):
        j = g.integers(0, ns, n)
        to_c = c[j] - o
        dist = np.linalg.norm(to_c, axis=1)
        side = unit(np.cross(to_c, g.normal(size=(n, 3))))
        S = np.linalg.norm(o, axis=1) + np.abs(c).sum(1).max()
        # aim at a point beside the sphere, r + e off its center, e within
        # +-2e-3 S of the silhouette (the margin is 1.5e-3 S)
        e = g.uniform(-2e-3, 2e-3, n) * S
        target = c[j] + side * (r[j] + e)[:, None]
        d = unit(target - o)
        keep = dist > r[j] + 0.01
        outs.append((o[keep], d[keep]))
    o = np.concatenate([a for a, _ in outs]).astype(np.float32)
    d = np.concatenate([b for _, b in outs]).astype(np.float32)
    return torch.from_numpy(o), torch.from_numpy(d)


def _full_closest(o, d, centers, radii, compat):
    """The full sweep's winner: the least (t, index) of the valid hits, the
    strict `<` of an ascending sweep."""
    t, ok = ct.sphere_hits_plain(o, d, centers, radii, compat=compat)
    t = torch.where(ok, t, torch.full_like(t, float("inf")))
    tmin, obj = t.min(dim=1)
    none = torch.isinf(tmin)
    return (torch.where(none, torch.full_like(tmin, FAR if compat else BIG), tmin),
            torch.where(none, torch.full_like(obj, -1), obj))


@pytest.mark.parametrize("n,leaf,fan", [(17, 4, 8), (100, 4, 8), (300, 8, 16), (257, 8, 8),
                                        (1000, ct.LEAF, ct.FAN)])
def test_tree_boxes_hold_members_and_leaves(n, leaf, fan):
    scene = _scene(n, seed=n)
    c, r = scene.spheres.center, scene.spheres.radius
    tree = ct.bounce_tree(c, r, leaf=leaf, fan=fan)
    nl_ = -(-n // leaf)
    n_par = -(-nl_ // fan)
    assert tree.n_leaves == nl_
    assert tree.perm.dtype == torch.int32 and tree.perm.shape == (nl_ * leaf,)
    assert tree.box.dtype == torch.float32
    assert tree.box.shape == (ct.tree_box_words(nl_, fan),) == (1 + 6 * (n_par + nl_),)
    nodes = tree.box[1:].reshape(-1, 6).double()
    par, lvs = nodes[:n_par], nodes[n_par:]
    perm = tree.perm.long().reshape(nl_, leaf)
    # every member ball, inflated as the groups' balls are, inside its leaf's box
    cm, rm = c.double()[perm], r.double()[perm][..., None] * 1.001 + 1e-3
    assert bool((cm - rm >= lvs[:, None, 0:3]).all() and (cm + rm <= lvs[:, None, 3:6]).all())
    # every leaf box inside its parent's
    p_of = torch.arange(nl_) // fan
    assert bool((lvs[:, 0:3] >= par[p_of, 0:3]).all() and (lvs[:, 3:6] <= par[p_of, 3:6]).all())
    # pad slots repeat the last leaf's last real member
    pad = nl_ * leaf - n
    if pad:
        assert set(perm[-1, leaf - pad:].tolist()) == {int(perm.reshape(-1)[n - 1])}
    # reach bounds |c| + r from above
    assert float(tree.box[0]) >= float((c.double().norm(dim=1) + r.double()).max())


@pytest.mark.parametrize("n,leaf", [(24, 4), (100, 8), (301, 4)])
def test_tree_order_is_the_morton_order_of_the_jax_groups(n, leaf):
    """The permutation covers every sphere once (pad slots aside) and is the
    JAX package's Morton order (``_sphere_groups`` with groups of ``leaf``,
    unordered), on a JAX scene brought across."""
    scene_j = jrt.random_scene(jax.random.key(3), n_spheres=n)
    _, scene = to_torch(jrt.Camera.build((8, 8), [-7, 0, 3], [0, -15, 0]), scene_j)
    tree = ct.bounce_tree(scene.spheres.center, scene.spheres.radius, leaf=leaf)
    perm = tree.perm.tolist()
    assert sorted(perm[:n]) == list(range(n))
    perm_j, _ = jp._sphere_groups(scene_j.spheres.center, scene_j.spheres.radius,
                                  group_size=leaf, order_from=None)
    assert perm[:n] == np.asarray(perm_j)[:n].tolist()


@pytest.mark.parametrize("compat", [True, False])
@pytest.mark.parametrize("n,leaf,fan", [(60, 4, 8), (300, 4, 8), (300, 8, 16)])
def test_tree_closest_hit_is_the_full_sweep(compat, n, leaf, fan):
    centers, radii = _tied(n, seed=n)
    tree = ct.bounce_tree(centers, radii, leaf=leaf, fan=fan)
    o, d = _rays(centers, radii, 300, seed=n + int(compat))
    want_t, want_obj = _full_closest(o, d, centers, radii, compat)
    ties = 0
    # the built tree, and the same boxes with each leaf's members in reverse
    # order (ties then meet the higher index first)
    rev = tree._replace(perm=tree.perm.reshape(-1, leaf).flip(1).reshape(-1).contiguous())
    for tr in (tree, rev):
        t, obj, boxes, spheres = ct.tree_closest_hit_plain(tr, o, d, centers, radii,
                                                           compat=compat, fan=fan)
        assert torch.equal(t, want_t) and torch.equal(obj, want_obj)
        strict = ct.tree_closest_hit_plain(tr, o, d, centers, radii, compat=compat,
                                           tie=False, fan=fan)[1]
        ties += int((strict != want_obj).sum())
        assert float(spheres.double().mean()) < 0.5 * n
    assert ties > 0          # the planted ties occur, and only the tie rule keeps them
    assert int((want_obj >= n).sum()) == 0     # copies never win over their originals
    assert int((want_obj >= 0).sum()) > o.shape[0] // 4


@pytest.mark.parametrize("compat,cheap", [(True, True), (True, False), (False, True)])
def test_tree_any_hit_is_the_full_any_hit(compat, cheap):
    centers, radii = _tied(200, seed=7)
    tree = ct.bounce_tree(centers, radii)
    o, d = _rays(centers, radii, 300, seed=11)
    want = ct.sphere_occludes_plain(o, d, centers, radii, compat=compat,
                                    cheap=cheap).any(dim=1)
    got, boxes, spheres = ct.tree_occluded_plain(tree, o, d, centers, radii, compat=compat,
                                                 cheap=cheap)
    assert torch.equal(got, want)
    assert 0 < int(want.sum()) < want.numel()
    assert float(spheres.double().mean()) < 0.5 * centers.shape[0]


def test_slab_margin_reaches_the_sphere_tests_rounding():
    """Far-origin rays that graze a sphere: the full sweep reports hits that
    lie beyond the member's box in exact arithmetic (so a box without the
    margin would drop them), and the tree still finds every one."""
    c = torch.tensor([[0.3, -0.2, 1.0]])
    r = torch.tensor([0.5])
    tree = ct.bounce_tree(c, r, leaf=1, fan=1)
    g = np.random.default_rng(5)
    th = g.uniform(0, 2 * np.pi, 4000)
    o = np.stack([600 * np.cos(th), 600 * np.sin(th), np.full_like(th, 2e-4)], 1)
    to_c = c.double().numpy()[0] - o
    side = np.cross(to_c, [0.0, 0.0, 1.0])
    side /= np.linalg.norm(side, axis=1, keepdims=True)
    e = g.uniform(-0.2, 0.2, th.size)
    tgt = c.double().numpy()[0] + side * (0.5 + e)[:, None]
    d = tgt - o
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    o32, d32 = torch.from_numpy(o.astype(np.float32)), torch.from_numpy(d.astype(np.float32))
    t, ok = ct.sphere_hits_plain(o32, d32, c, r, compat=True)
    # the exact distance of each reported ray's line from the center
    oo, dd = o32.double().numpy(), d32.double().numpy()
    w = c.double().numpy()[0] - oo
    rho = np.linalg.norm(w - (w * dd).sum(1, keepdims=True) * dd, axis=1)
    beyond = ok[:, 0].numpy() & (rho > 0.5 * 1.001 + 1e-3)
    assert beyond.sum() > 0
    got_t, got_obj, _, _ = ct.tree_closest_hit_plain(tree, o32, d32, c, r, compat=True,
                                                     fan=1)
    want_t, want_obj = _full_closest(o32, d32, c, r, True)
    assert torch.equal(got_obj, want_obj) and torch.equal(got_t, want_t)


def _axis_rays(centers, n, axis, seed):
    """``(o, d)``, float32: ``n`` rays from inside the scene's box and ``n``
    from up to 300 units out, with direction component ``axis`` exactly 0
    (every third -0.0 or a subnormal) and that origin coordinate set within
    the spheres' span on that axis, at |o| > 1 there; and ``n`` rays along the
    other two axes alone (two components exactly 0)."""
    g = np.random.default_rng(seed)
    c = centers.double().numpy()
    lo, hi = c.min(0), c.max(0)
    o = np.concatenate([g.uniform(lo - 1.0, hi + 1.0, (n, 3)),
                        g.uniform(-300.0, 300.0, (n, 3)),
                        g.uniform(lo - 1.0, hi + 1.0, (n, 3))])
    v = g.uniform(lo[axis], hi[axis], 3 * n)
    o[:, axis] = np.where(np.abs(v) > 1.0, v, 1.0 + 1e-3)
    d = g.normal(size=(3 * n, 3))
    d[2 * n:, (axis + 1) % 3] = 0.0
    d[:, axis] = 0.0
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    o32, d32 = o.astype(np.float32), d.astype(np.float32)
    d32[0::3, axis] = -0.0
    d32[1::3, axis] = np.float32(1e-40)
    return torch.from_numpy(o32), torch.from_numpy(d32)


@pytest.mark.parametrize("compat", [True, False])
@pytest.mark.parametrize("axis", [0, 1, 2])
def test_tree_sweeps_axis_parallel_rays(compat, axis):
    """Where a direction component is 0 the kernels' slab slope is clamped;
    with a clamp at FLT_MAX, ``(-o - delta) / d`` overflowed wherever |o| > 1
    on that axis and every box was dropped. The tree's closest hit and any-hit
    must stay the full sweep's."""
    centers, radii = _tied(200, seed=3)
    tree = ct.bounce_tree(centers, radii)
    o, d = _axis_rays(centers, 200, axis, seed=axis)
    assert bool((d[:, axis] == 0).sum() >= 2 * d.shape[0] // 3)
    want_t, want_obj = _full_closest(o, d, centers, radii, compat)
    t, obj, _, _ = ct.tree_closest_hit_plain(tree, o, d, centers, radii, compat=compat)
    assert torch.equal(t, want_t) and torch.equal(obj, want_obj)
    assert int((want_obj >= 0).sum()) > o.shape[0] // 10
    want = ct.sphere_occludes_plain(o, d, centers, radii, compat=compat, cheap=True).any(1)
    got = ct.tree_occluded_plain(tree, o, d, centers, radii, compat=compat, cheap=True)[0]
    assert torch.equal(got, want)


@pytest.mark.parametrize("compat", [True, False])
def test_tree_sweeps_a_ground_bounce_with_an_exact_zero(compat):
    """A camera at y = 3 with no rotation about the x axis, at 129 x 65: the
    center column (x = 64) has primary direction y exactly 0, and its bounces
    off the ground plane keep it, from origins at y = 3. Their closest hits
    through the tree are the full sweep's, and some of them hit a sphere."""
    scene = _scene(1000)
    cam = trt.Camera.build((129, 65), [-12.0, 3.0, 3.0], [0.0, -15.0, 0.0], device="cpu")
    px = torch.stack(torch.meshgrid(torch.arange(129.0), torch.arange(65.0),
                                    indexing="ij"), -1).reshape(-1, 2)
    d = cam.ray_directions(px, compat=compat)
    o = cam.ray_origin().expand(d.shape)
    h = intersect.closest_hit(o, d, scene, compat=compat)
    P = o + torch.where(h["hit"], h["t"], torch.zeros_like(h["t"]))[..., None] * d
    _, N = _surface_attributes(P, h, scene)
    d2 = reflect(d, N)
    o2 = P + BIAS * N + BIAS * d2
    zero = h["hit"] & (d2[:, 1] == 0)
    assert int(zero.sum()) >= 10 and bool((o2[zero, 1] > 2.9).all())
    c, r = scene.spheres.center, scene.spheres.radius
    want_t, want_obj = _full_closest(o2[h["hit"]], d2[h["hit"]], c, r, compat)
    t, obj, _, _ = ct.tree_closest_hit_plain(ct.bounce_tree(c, r), o2[h["hit"]],
                                             d2[h["hit"]], c, r, compat=compat)
    assert torch.equal(t, want_t) and torch.equal(obj, want_obj)
    assert int((want_obj[zero[h["hit"]]] >= 0).sum()) >= 10
