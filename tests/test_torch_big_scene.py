"""A scene past every staged form, on the CPU, against the JAX package.

At 10000 spheres the render kernel's staged form (7753 spheres at 1 plane and
3 lights), its tree's (5600) and the list kernel's (9685) no longer fit a
block, so the card takes their global and chunked forms; the CPU takes the
plain versions, which have no size limit. Here they are held to the JAX
package's at that size through bridge.py: the render (ops/render.py against
the JAX render_image, tests/test_pallas.py::_compare's outlier rule, 1e-4),
the hit extents (the plain version against the JAX hit-extent kernel in
interpret mode on the same cone-cull tables, by hit_extents_cuda.extent_rule,
the port's kernel rule: counts equal, boxes within 1e-3 + 1e-6 m^2; the
kernel's hoisted quadratic puts grazing hits 2.8e-5 off the plain root form
here, past the 1e-5 that 22 spheres kept in tests/test_torch_large_scene.py) and the level-0 lists (integers: equal). The JAX
calls take about 11 s together. The forms themselves are chosen by
render_cuda.scene_form (tests/test_torch_scene_limits.py).
"""
import jax
import jax.numpy as jnp
import numpy as np
import torch

import python_ray_tracer_tpu as jrt
import python_ray_tracer_tpu_torch as trt
from python_ray_tracer_tpu.ops.pallas import render_pallas as jp
from python_ray_tracer_tpu_torch import bridge
from python_ray_tracer_tpu_torch.ops.cuda import cull_tables as ct
from python_ray_tracer_tpu_torch.ops.cuda import hit_extents_cuda as hx
from python_ray_tracer_tpu_torch.ops.cuda import render_cuda
from python_ray_tracer_tpu_torch.ops.cuda import shadow_lists_cuda as sl

from .test_torch_render import compare_images, to_torch

torch.set_num_threads(1)
NS = 10000
RES = (16, 16)
POSE = ([-12.0, 0.0, 4.0], [0.0, -15.0, 0.0])   # outside the cloud (chip_smoke.BENCH_POSE)
TILE = 8


def _rows(idx, cnt):
    """Per row: the kept entries (a list) or None for the -1 sentinel."""
    idx, cnt = np.asarray(idx), np.asarray(cnt)
    k = idx.size // max(cnt.size, 1)
    idx = idx.reshape(cnt.size, k)
    return [None if c < 0 else idx[r, :c].tolist() for r, c in enumerate(cnt)]


def _inputs():
    scene_j = jrt.random_scene(jax.random.key(5), n_spheres=NS)
    cam_j = jrt.Camera.build(RES, *POSE)
    return cam_j, scene_j, *to_torch(cam_j, scene_j)


def test_the_scene_is_past_every_staged_form():
    assert render_cuda.scene_form(NS, 1, 3) == 1
    assert render_cuda.scene_form(NS, 1, 3, True) == 1
    assert sl.chunk_spheres(NS) > 0


def test_plain_render_at_10000_spheres_matches_jax():
    cam_j, scene_j, cam, scene = _inputs()
    for depth in (0, 1):
        ref = np.asarray(jrt.render_image(cam_j, scene_j, depth=depth, aliasing=False))
        out = trt.render_image(cam, scene, depth=depth, aliasing=False).numpy()
        assert float(np.abs(ref).max()) > 0.0
        compare_images(out, ref)


def test_hit_extents_and_lists_at_10000_spheres_match_jax():
    """The JAX hit-extent kernel (interpret mode) on its cone-cull tables and
    the JAX lists on its rows, against the port's plain functions on the
    same tables and rows."""
    cam_j, scene_j, cam, scene = _inputs()
    swap = jp._resolve_swap(*RES)
    n_tx, n_ty = RES[0] // TILE, RES[1] // TILE
    n_u, n_v = (n_ty, n_tx) if swap else (n_tx, n_ty)
    params = jp._pack_params(cam_j, scene_j, True, 0.0)
    sph = jnp.concatenate([scene_j.spheres.center.T, scene_j.spheres.radius[None],
                           scene_j.spheres.albedo.T], axis=0)
    pln = jnp.concatenate([scene_j.planes.origin.T, scene_j.planes.normal.T,
                           scene_j.planes.albedo.T], axis=0)
    idx_j, cnt_j = jp._tile_visibility(cam_j, scene_j, n_u=n_u, n_v=n_v, TW=TILE, TH=TILE,
                                       swap_xy=swap, x_offset=0.0, compat=True)
    ext_j = np.asarray(jp._hit_extents_pallas(
        params, sph, pln, W=RES[0], H=RES[1], n_u=n_u, n_v=n_v, TW=TILE, TH=TILE, ns=NS,
        npl=1, compat=True, swap_xy=swap, aliasing=False, culled=True,
        vis_tabs=(idx_j, cnt_j), vis_k=NS, interpret=True, n_levels=1))
    ext_j = np.array(bridge.tile_rows_from_jax(ext_j, n_tx, n_ty, swap))
    vis, _ = bridge.tables_from_arrays(vis=(
        bridge.tile_rows_from_jax(np.asarray(idx_j).reshape(-1, NS), n_tx, n_ty, swap),
        bridge.tile_rows_from_jax(np.asarray(cnt_j), n_tx, n_ty, swap), NS), device="cpu")
    idx, cnt = ct.tile_visibility(cam, scene, compat=True, tile=TILE)
    assert _rows(idx, cnt) == _rows(vis[0], vis[1])
    ext = hx.hit_extents_plain(cam, scene, aliasing=False, compat=True, tile=TILE, vis=vis)
    assert ext[:, 6].sum() > 0
    rule = hx.extent_rule(ext, torch.from_numpy(ext_j))
    assert rule["ok"], rule
    k = ct.list_capacity(NS)
    li_j, lc_j = jp._shadow_visibility_lists(jnp.asarray(ext_j), scene_j.lights.position,
                                             scene_j.spheres.center, scene_j.spheres.radius,
                                             nl=3, K=k, compat=True)
    scale = ct.extent_scale(torch.from_numpy(ext_j)).reshape(1)
    li, lc = ct.shadow_visibility_lists(torch.from_numpy(ext_j), scene.lights.position,
                                        scene.spheres.center, scene.spheres.radius, K=k,
                                        compat=True, scale=scale)
    np.testing.assert_array_equal(lc.numpy(), np.asarray(lc_j))
    assert _rows(li, lc) == _rows(li_j, lc_j)
    assert int((lc == -1).sum()) > 0 and int((lc >= 0).sum()) > 0
