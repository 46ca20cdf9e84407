"""Shadow lists at the bounce levels (``render_image_cuda(shadow_list_levels=L)``)
on the CPU: the hit-extent rows of L levels and the lists over them against the
JAX package's hit-extent kernel in interpret mode and its
``_shadow_visibility_lists``, the level count's clamp and the row layout, the
shared-memory bands that the listed levels move, and the coverage that makes
the lists exact at every listed level.

Tolerances. Counts and list entries are integers and must be equal. Hit boxes
against the Pallas kernel: 1e-5 absolute at level 0 (tests/test_torch_large_scene.py's
rule: its hoisted quadratic against the plain root form, at scene scale ~10);
at the bounce level, whose ray carries the level-0 point's difference through a
reflection to a ground hit ~10 units on, hit_extents_cuda.extent_rule (the
rule the card holds the hit-extent kernel to: 1e-3 + 1e-6 m^2).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import python_ray_tracer_tpu as jrt
import python_ray_tracer_tpu_torch as trt
from python_ray_tracer_tpu.ops.pallas import render_pallas as jp
from python_ray_tracer_tpu_torch import bridge
from python_ray_tracer_tpu_torch.ops.cuda import cull_tables as ct
from python_ray_tracer_tpu_torch.ops.cuda import hit_extents_cuda as hx
from python_ray_tracer_tpu_torch.ops.cuda import render_bwd_cuda as rb
from python_ray_tracer_tpu_torch.ops.cuda import render_cuda
from python_ray_tracer_tpu_torch.ops.intersect import BIG, _all_t
from python_ray_tracer_tpu_torch.ops.shade import BIAS, _surface_attributes, reflect

from .test_torch_render import to_torch
from .torch_plain_launch import plain_tables

torch.set_num_threads(1)


def _rows(idx, cnt):
    idx, cnt = np.asarray(idx), np.asarray(cnt)
    k = idx.size // max(cnt.size, 1)
    idx = idx.reshape(cnt.size, k)
    return [None if c < 0 else idx[r, :c].tolist() for r, c in enumerate(cnt)]


def test_two_level_rows_and_lists_match_jax():
    """22 spheres, 16x8, 8x8 tiles, no AA, compat, two levels: the plain hit
    extents against the JAX hit-extent kernel in interpret mode (levels
    fastest, brought into the port's tile numbering with bridge.py), then the
    lists over those rows against the JAX package's _shadow_visibility_lists,
    integer for integer."""
    scene_j = jrt.random_scene(jax.random.key(11), n_spheres=22)
    cam_j = jrt.Camera.build((16, 8), [-7, 0, 3], [0, 10, 0])
    cam, scene = to_torch(cam_j, scene_j)
    ns, npl = scene_j.spheres.count, scene_j.planes.count
    swap = jp._resolve_swap(16, 8)
    n_tx, n_ty, tile = 2, 1, 8
    n_u, n_v = (n_ty, n_tx) if swap else (n_tx, n_ty)
    params = jp._pack_params(cam_j, scene_j, True, 0.0)
    sph = jnp.concatenate([scene_j.spheres.center.T, scene_j.spheres.radius[None],
                           scene_j.spheres.albedo.T], axis=0)
    pln = jnp.concatenate([scene_j.planes.origin.T, scene_j.planes.normal.T,
                           scene_j.planes.albedo.T], axis=0)
    idx_j, cnt_j = jp._tile_visibility(cam_j, scene_j, n_u=n_u, n_v=n_v, TW=tile, TH=tile,
                                       swap_xy=swap, x_offset=0.0, compat=True)
    ext_j = np.asarray(jp._hit_extents_pallas(
        params, sph, pln, W=16, H=8, n_u=n_u, n_v=n_v, TW=tile, TH=tile, ns=ns, npl=npl,
        compat=True, swap_xy=swap, aliasing=False, culled=True,
        vis_tabs=(idx_j, cnt_j), vis_k=ns, interpret=True, n_levels=2))
    ext_j = bridge.tile_rows_from_jax(ext_j, n_tx, n_ty, swap, levels=2)
    vis, _ = bridge.tables_from_arrays(vis=(
        bridge.tile_rows_from_jax(np.asarray(idx_j).reshape(-1, ns), n_tx, n_ty, swap),
        bridge.tile_rows_from_jax(np.asarray(cnt_j), n_tx, n_ty, swap), ns), device="cpu")
    ext = hx.hit_extents_plain(cam, scene, aliasing=False, compat=True, tile=tile, vis=vis,
                               n_levels=2).numpy()
    assert ext.shape == ext_j.shape == (4, 8)
    np.testing.assert_array_equal(ext[:, 6:], ext_j[:, 6:])
    assert ext[1::2, 6].sum() > 0                       # bounce hits in the rows
    np.testing.assert_allclose(ext[0::2, :6], ext_j[0::2, :6], rtol=0, atol=1e-5)
    rule = hx.extent_rule(torch.tensor(ext[1::2]), torch.tensor(ext_j[1::2]))
    assert rule["ok"], rule
    # the lists over the port's rows, both packages' functions
    lights = scene.lights.position
    C, R = scene.spheres.center, scene.spheres.radius
    for K in (ns, 4):
        idx, cnt = ct.shadow_visibility_lists(torch.as_tensor(ext), lights, C, R, K=K,
                                              compat=True)
        idx_w, cnt_w = jp._shadow_visibility_lists(
            jnp.asarray(ext), jnp.asarray(lights.numpy()), jnp.asarray(C.numpy()),
            jnp.asarray(R.numpy()), nl=3, K=K, compat=True)
        assert cnt.shape == (4 * 3,)
        np.testing.assert_array_equal(cnt.numpy(), np.asarray(cnt_w))
        assert _rows(idx, cnt) == _rows(idx_w, cnt_w)
        if K == 4:
            assert bool((cnt == -1).any())


@pytest.mark.parametrize("depth", [0, 1, 2, 4])
def test_level_count_clamp(monkeypatch, depth):
    """render_pallas._render_image_pallas's rule: None is level 0 alone, else
    max(1, min(depth + 1, L)); the tables carry it."""
    assert render_cuda.list_levels(depth) == 1
    for L in (-3, 0, 1, 2, 3, 5, 9):
        assert render_cuda.list_levels(depth, L) == max(1, min(depth + 1, L))
    cam = trt.Camera.build((32, 16), [-7.0, 0.0, 3.0], [0.0, -20.0, 0.0], device="cpu")
    scene = trt.random_scene(20, generator=torch.Generator().manual_seed(2), device="cpu")
    plain_tables(monkeypatch.setattr)
    vis, shadow, tree, cells = render_cuda.large_scene_tables(
        cam, scene, depth=depth, aliasing=False, compat=True, shadow_list_levels=9)
    levels = min(depth + 1, 9)
    assert shadow[2] == ct.list_capacity(20) and shadow[3] == levels
    assert shadow[1].shape == (2 * 1 * levels * 3,)
    assert cells is None                     # every level is listed: no light cells
    hx.check_tables(vis, shadow, tree, n_tiles=2, ns=20, nl=3, dev=torch.device("cpu"))
    with pytest.raises(ValueError):
        hx.check_tables(vis, (*shadow[:3], levels + 1), tree, n_tiles=2, ns=20, nl=3,
                        dev=torch.device("cpu"))
    args = hx.table_args(vis, shadow, tree)
    assert args[1][2:] == [shadow[2], levels] and args[1] == args[1][:2] + [shadow[2], levels]
    assert hx.table_args(None, None, None)[1] == [None, None, 0, 1]


@pytest.mark.parametrize("levels", [2, 3])
@pytest.mark.parametrize("aliasing", [False, True])
def test_row_layout(monkeypatch, levels, aliasing):
    """The tables' shadow rows are (tile * L + level) * nl + light: the list
    function on the plain hit-extent rows of L levels (levels fastest), whose
    scale is taken over every level's rows; and the rows of level 0 keep at
    least the one-level tables' spheres."""
    cam = trt.Camera.build((32, 32), [-7.0, 0.0, 3.0], [0.0, -20.0, 0.0], device="cpu")
    scene = trt.random_scene(20, generator=torch.Generator().manual_seed(5), device="cpu")
    kw = dict(depth=2, aliasing=aliasing, compat=True)
    plain_tables(monkeypatch.setattr)
    vis, shadow, _, cells = render_cuda.large_scene_tables(cam, scene, **kw,
                                                           shadow_list_levels=levels)
    assert (cells is not None) == (levels <= 2)
    ext = hx.hit_extents_plain(cam, scene, aliasing=aliasing, compat=True, n_levels=levels,
                               vis=vis)
    want = ct.shadow_visibility_lists(ext, scene.lights.position, scene.spheres.center,
                                      scene.spheres.radius, K=shadow[2], compat=True)
    assert torch.equal(shadow[0], want[0]) and torch.equal(shadow[1], want[1])
    one = render_cuda.large_scene_tables(cam, scene, **kw)[1]
    rows, rows1 = _rows(shadow[0], shadow[1]), _rows(one[0], one[1])
    for t in range(4):
        for light in range(3):
            r, r1 = rows[(t * levels) * 3 + light], rows1[t * 3 + light]
            assert r is None or (r1 is not None and set(r1) <= set(r))


def _chain_points(cam, scene, levels, compat, tile=16):
    """Per tile and level: the used sample positions' biased hit points,
    traced as hit_extents_plain traces them (pixel centers, no AA)."""
    W, H = cam.resolution
    n_tx, n_ty = ct.tile_grid(W, H, tile)
    px, py = hx._positions(n_tx, n_ty, tile, False, cam.device)
    d = cam.ray_directions(torch.stack([px, py], dim=-1), compat=compat)
    o = cam.ray_origin().expand(d.shape)
    used = (px >= 0) & (px <= W - 1) & (py >= 0) & (py <= H - 1)
    ns = scene.spheres.count
    out = []
    for _ in range(levels):
        t_all, _ = _all_t(o, d, scene, compat)
        t = torch.amin(t_all, dim=-1)
        obj = torch.argmin(t_all, dim=-1)
        alive = t < BIG
        P = o + torch.where(alive, t, torch.zeros_like(t))[..., None] * d
        _, N = _surface_attributes(P, dict(obj=obj, is_plane=obj >= ns), scene)
        Pb = P + BIAS * N
        used = used & alive
        out.append((used.clone(), Pb))
        d = reflect(d, N)
        o = Pb + BIAS * d
    return out


@pytest.mark.parametrize("levels", [2, 3])
@pytest.mark.parametrize("compat", [True, False])
def test_every_listed_level_covers_its_occluders(monkeypatch, levels, compat):
    """At every listed level, every sphere that blocks a shadow ray of the
    plain bounce chain (sphere_occludes_plain, both forms of the test, beyond
    the light too) is in its (tile, level, light) row, or the row is -1."""
    scene = trt.random_scene(20, generator=torch.Generator().manual_seed(7), device="cpu")
    cam = trt.Camera.build((32, 32), [-7.0, 0.0, 3.0], [0.0, 10.0, 0.0], device="cpu")
    plain_tables(monkeypatch.setattr)
    _, shadow, _, _ = render_cuda.large_scene_tables(cam, scene, depth=2, aliasing=False,
                                                     compat=compat, shadow_list_levels=levels)
    rows = _rows(shadow[0], shadow[1])
    C, R = scene.spheres.center, scene.spheres.radius
    n_occ = 0
    for level, (used, Pb) in enumerate(_chain_points(cam, scene, levels, compat)):
        for t in range(used.shape[0]):
            P = Pb[t][used[t]]
            for light in range(3):
                row = rows[(t * levels + level) * 3 + light]
                if P.shape[0] == 0:
                    assert row == []
                    continue
                Ld = scene.lights.position[light] - P
                Ld = Ld / Ld.norm(dim=-1, keepdim=True)
                for cheap in (True, False):
                    occ = ct.sphere_occludes_plain(P, Ld, C, R, compat=compat, cheap=cheap)
                    blockers = set(torch.nonzero(occ.any(dim=0)).flatten().tolist())
                    n_occ += len(blockers)
                    assert row is None or blockers <= set(row), (level, t, light)
    assert n_occ > 0


@pytest.mark.parametrize("tree", [False, True])
def test_listed_levels_move_the_staged_bands(tree):
    """Each listed level adds nl (k + 1) words to a block's lists: the render
    kernel's largest staged scene at 1 plane and 3 lights falls from 7753
    (5600 with the bounce tree) at L = 1, and the backward's table words
    count the levels."""
    def edge(levels):
        lo, hi = 17, 20000
        while lo < hi:       # the largest ns the staged form takes
            mid = (lo + hi + 1) // 2
            if render_cuda.scene_form(mid, 1, 3, tree, levels=levels) == 0:
                lo = mid
            else:
                hi = mid - 1
        return lo
    edges = [edge(L) for L in (1, 2, 3)]
    assert edges[0] == (5600 if tree else 7753)
    assert edges == sorted(edges, reverse=True) and edges[2] < edges[1] < edges[0]
    for L, e in zip((1, 2, 3), edges):
        assert render_cuda._smem_bytes(e, 1, 3, tree, L) <= render_cuda._SMEM_LIMIT
        assert render_cuda._smem_bytes(e + 1, 1, 3, tree, L) > render_cuda._SMEM_LIMIT
        # the levels add 3 (k + 1) words each, k = 128 past 2048 spheres
        assert render_cuda._smem_bytes(e, 1, 3, tree, L) - \
            render_cuda._smem_bytes(e, 1, 3, tree, 1) == 4 * (L - 1) * 3 * 129
    k = 32
    shadow = (torch.zeros(5 * 2 * 3 * k, dtype=torch.int32),
              torch.zeros(5 * 2 * 3, dtype=torch.int32), k, 2)
    vis = (torch.zeros(5 * k, dtype=torch.int32), torch.zeros(5, dtype=torch.int32), k)
    assert rb.table_words((vis, shadow, None, None), 3) == (k + 2 * 3 * (k + 1), 0)
    assert rb.table_words((vis, (*shadow[:3], 1), None, None), 3) == (k + 3 * (k + 1), 0)


def test_cpu_path_takes_the_plain_render():
    """On CPU tensors render_image_cuda raises whatever the new keywords say,
    before any table or launch; the plain render is render_image, by name."""
    cam = trt.Camera.build((24, 16), [-7.0, 0.0, 3.0], [0.0, -20.0, 0.0], device="cpu")
    scene = trt.random_scene(20, generator=torch.Generator().manual_seed(3), device="cpu")
    before = (dict(render_cuda.LAUNCHES), dict(hx.LAUNCHES))
    for kw in (dict(shadow_list_levels=3), dict(shadow_cull=True),
               dict(cheap_shadow=False), dict(shadow_list_levels=2, shadow_cull=True)):
        with pytest.raises(ValueError, match="render_image_cuda takes CUDA tensors, got cpu"):
            trt.render_image_cuda(cam, scene, depth=2, **kw)
    assert (dict(render_cuda.LAUNCHES), dict(hx.LAUNCHES)) == before
    ref = trt.render_image(cam, scene, depth=2, aliasing=True)
    assert ref.shape == (24, 16, 3) and bool(torch.isfinite(ref).all())


@pytest.mark.parametrize("levels", [1, 2, 3])
@pytest.mark.parametrize("ns", [100, 1000])
def test_backward_plans_count_the_levels(ns, levels):
    """The hard backward's planner on tables of L listed levels (the render's
    tables, which the backward reads): its plan's shared memory holds L nl
    (k + 1) list words and fits a block, in every mode."""
    nl, npl = 3, 1
    k = ct.list_capacity(ns)
    scene = trt.random_scene(ns, generator=torch.Generator().manual_seed(0), device="cpu")
    tree = ct.bounce_tree(scene.spheres.center, scene.spheres.radius)
    shadow = (torch.zeros(8 * levels * nl * k, dtype=torch.int32),
              torch.zeros(8 * levels * nl, dtype=torch.int32), k, levels)
    vis = (torch.zeros(8 * k, dtype=torch.int32), torch.zeros(8, dtype=torch.int32), k)
    lists, tree_w = rb.table_words((vis, shadow, tree, None), nl)
    assert lists == k + levels * nl * (k + 1)
    for aa, fused, one in ((False, True, False), (True, False, False), (True, True, True)):
        p = rb.plan(ns, npl, nl, 64, 32, aa=aa, fused=fused, large=True, lists=lists,
                    tree=tree_w, one_launch=one)
        assert p.smem <= rb.SMEM_LIMIT
        assert p.smem == rb.smem_bytes(ns, npl, nl, fused, aa, p.nt, False, p.staged,
                                       p.device_rows, lists + tree_w * p.tree_smem, one)
