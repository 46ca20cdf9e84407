"""The port's large-scene render path on the CPU: the three table functions
(ops/cuda/cull_tables.py) and the hit-extent kernel's plain version
(ops/cuda/hit_extents_cuda.py) against the JAX package's functions and its
hit-extent Pallas kernel in interpret mode, on the same seeded scenes, and the
coverage properties that make the culls exact.

Tolerances. Lists and counts are integers and must be equal. Group bounds:
1e-6 relative (sums of 16 centers in another order). Hit boxes against the
Pallas kernel: 1e-5 absolute (its hoisted quadratic against the plain root
form, at scene scale ~10). Morton codes that collide keep ascending sphere
index on both sides (both argsorts are stable).
"""
import inspect

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import python_ray_tracer_tpu as jrt
import python_ray_tracer_tpu_torch as trt
from python_ray_tracer_tpu.ops.pallas import render_pallas as jp
from python_ray_tracer_tpu_torch import bridge
from python_ray_tracer_tpu_torch.ops import intersect
from python_ray_tracer_tpu_torch.ops.cuda import cull_tables as ct
from python_ray_tracer_tpu_torch.ops.cuda import hit_extents_cuda as hx
from python_ray_tracer_tpu_torch.ops.cuda import render_cuda
from python_ray_tracer_tpu_torch.ops.shade import BIAS, _surface_attributes
from python_ray_tracer_tpu_torch.utils import timing

from .test_torch_render import to_torch
from .torch_plain_launch import plain_tables

torch.set_num_threads(1)


def _scene(seed, n):
    return jrt.random_scene(jax.random.key(seed), n_spheres=n)


def _rows(idx, cnt):
    """Per row: the kept entries (a list) or None for the -1 sentinel."""
    idx, cnt = np.asarray(idx), np.asarray(cnt)
    k = idx.size // max(cnt.size, 1)
    idx = idx.reshape(cnt.size, k)
    return [None if c < 0 else idx[r, :c].tolist() for r, c in enumerate(cnt)]


# --- sphere_groups ---------------------------------------------------------------

@pytest.mark.parametrize("n", [24, 100, 300])
@pytest.mark.parametrize("ordered", [False, True])
def test_sphere_groups_match_jax(n, ordered):
    scene_j = _scene(5, n)
    cam_j = jrt.Camera.build((16, 8), [-7, 0, 3], [0, -15, 0])
    cam, scene = to_torch(cam_j, scene_j)
    perm_j, bnd_j = jp._sphere_groups(scene_j.spheres.center, scene_j.spheres.radius,
                                      order_from=cam_j.position if ordered else None)
    perm, bnd = ct.sphere_groups(scene.spheres.center, scene.spheres.radius,
                                 order_from=cam.position if ordered else None)
    assert perm.dtype == torch.int32 and bnd.dtype == torch.float32
    G = -(-n // ct.GROUP_SIZE)
    assert perm.shape == (G * ct.GROUP_SIZE,) and bnd.shape == (G * 4,)
    # a permutation plus pad, the same groups in the same order
    np.testing.assert_array_equal(perm.numpy(), np.asarray(perm_j))
    pad = G * ct.GROUP_SIZE - n
    assert sorted(perm.tolist()) == sorted(list(range(n)) + [0] * pad)
    np.testing.assert_allclose(bnd.numpy(), np.asarray(bnd_j), rtol=1e-6)
    # every member ball inside its group's ball (tests/test_pallas.py's check);
    # the group that holds the pad slots is the Morton order's last, wherever
    # the front-to-back order put it
    last = ct.sphere_groups(scene.spheres.center, scene.spheres.radius)[0][
        (G - 1) * ct.GROUP_SIZE].item()
    groups = perm.numpy().reshape(G, ct.GROUP_SIZE)
    b = bnd.numpy().reshape(G, 4)
    cen, rad = scene.spheres.center.numpy(), scene.spheres.radius.numpy()
    for g in range(G):
        m = groups[g][:ct.GROUP_SIZE - pad] if groups[g][0] == last else groups[g]
        assert (np.linalg.norm(cen[m] - b[g, :3], axis=-1) + rad[m] <= b[g, 3]).all()


def test_morton_code_matches_jax():
    rng = np.random.default_rng(0)
    q = rng.integers(0, 1024, size=(64, 3))
    want = np.asarray(jp._morton30(*(jnp.asarray(q[:, i], jnp.uint32) for i in range(3))))
    got = ct._morton30(*(torch.from_numpy(q[:, i]) for i in range(3))).numpy()
    np.testing.assert_array_equal(got, want.astype(np.int64))


# --- tile_visibility -------------------------------------------------------------

@pytest.mark.parametrize("seed,n,res,pos,euler,tile,K", [
    (7, 24, (16, 8), [-7, 0, 3], [0, -20, 0], 8, None),    # test_pallas_cone_cull_exact
    (7, 24, (48, 32), [-7, 0, 3], [0, -20, 0], 16, 8),
    (3, 40, (16, 16), [-60, 0, 3], [0, -5, 0], 8, 8),      # every tile overflows
    (3, 40, (40, 24), [-7, 0, 3], [0, -15, 0], 16, 32),    # ragged edge tiles
])
def test_tile_visibility_matches_jax(seed, n, res, pos, euler, tile, K):
    scene_j = _scene(seed, n)
    cam_j = jrt.Camera.build(res, pos, euler)
    cam, scene = to_torch(cam_j, scene_j)
    n_tx, n_ty = ct.tile_grid(*res, tile)
    idx_j, cnt_j = jp._tile_visibility(cam_j, scene_j, n_u=n_tx, n_v=n_ty, TW=tile,
                                       TH=tile, swap_xy=False, x_offset=0.0,
                                       compat=True, K=K)
    idx, cnt = ct.tile_visibility(cam, scene, compat=True, tile=tile, K=K)
    assert idx.dtype == torch.int32 and cnt.dtype == torch.int32
    assert idx.shape == tuple(np.asarray(idx_j).shape) and cnt.shape == (n_tx * n_ty,)
    np.testing.assert_array_equal(cnt.numpy(), np.asarray(cnt_j))
    assert _rows(idx, cnt) == _rows(idx_j, cnt_j)
    if pos[0] == -60:
        assert int(cnt.max()) == -1 and int(cnt.min()) == -1
    else:
        assert 0 <= int(cnt[cnt >= 0].min()) < n          # some tile culls something
    for row in _rows(idx, cnt):
        assert row is None or row == sorted(row)   # ascending sphere index


# --- shadow_visibility_lists ------------------------------------------------------

def test_shadow_visibility_lists_unit_arrays():
    """The arrays of tests/test_pallas.py::test_shadow_visibility_lists_unit."""
    ext = np.array([[-1.0, -1.0, 0.0, 1.0, 1.0, 0.5, 64.0, 0.0],
                    [1e30, 1e30, 1e30, -1e30, -1e30, -1e30, 0.0, 0.0]], np.float32)
    lights = np.array([[0.0, 0.0, 10.0]], np.float32)
    centers = np.array([[0.0, 0.0, 5.0], [0.0, 0.0, 14.0], [50.0, 0.0, 1.0]], np.float32)
    radii = np.array([0.1, 3.0, 0.5], np.float32)
    args = [torch.from_numpy(a) for a in (ext, lights, centers, radii)]
    idx, cnt = ct.shadow_visibility_lists(*args, K=2, compat=True)
    assert cnt.tolist() == [2, 0]
    assert idx.reshape(2, 2)[0].tolist() == [1, 0]      # biggest apparent occluder first
    idx2, _ = ct.shadow_visibility_lists(*args, K=2, compat=True,
                                         to_sorted=torch.tensor([2, 0, 1]))
    assert idx2.reshape(2, 2)[0].tolist() == [0, 2]
    _, cnt3 = ct.shadow_visibility_lists(*args, K=1, compat=True)
    assert cnt3.tolist() == [-1, 0]
    for K, to_sorted in ((2, None), (2, [2, 0, 1]), (1, None)):
        ts_j = None if to_sorted is None else jnp.asarray(to_sorted, jnp.int32)
        ts = None if to_sorted is None else torch.tensor(to_sorted)
        idx_j, cnt_j = jp._shadow_visibility_lists(
            *(jnp.asarray(a) for a in (ext, lights, centers, radii)), nl=1, K=K,
            compat=True, to_sorted=ts_j)
        idx_t, cnt_t = ct.shadow_visibility_lists(*args, K=K, compat=True, to_sorted=ts)
        assert _rows(idx_t, cnt_t) == _rows(idx_j, cnt_j)


@pytest.mark.parametrize("n,K,compat", [(24, 8, True), (24, 24, False), (100, 32, True),
                                        (100, 4, True)])
def test_shadow_visibility_lists_match_jax(n, K, compat):
    """Seeded extents (the plain hit extents of an n-sphere scene; the sky
    tiles above the horizon have no hits) through both packages' functions."""
    scene_j = _scene(11, n)
    cam_j = jrt.Camera.build((64, 48), [-7, 0, 3], [0, 10, 0])
    cam, scene = to_torch(cam_j, scene_j)
    ext = hx.hit_extents_plain(cam, scene, aliasing=False, compat=compat)
    assert int((ext[:, 6] == 0).sum()) > 0 and int((ext[:, 6] > 0).sum()) > 0
    rng = np.random.default_rng(n)
    to_sorted = rng.permutation(n).astype(np.int32)
    for ts in (None, to_sorted):
        idx_j, cnt_j = jp._shadow_visibility_lists(
            jnp.asarray(ext.numpy()), scene_j.lights.position, scene_j.spheres.center,
            scene_j.spheres.radius, nl=3, K=K, compat=compat,
            to_sorted=None if ts is None else jnp.asarray(ts))
        idx, cnt = ct.shadow_visibility_lists(
            ext, scene.lights.position, scene.spheres.center, scene.spheres.radius, K=K,
            compat=compat, to_sorted=None if ts is None else torch.from_numpy(ts))
        assert idx.shape == (ext.shape[0] * 3 * K,) and cnt.shape == (ext.shape[0] * 3,)
        np.testing.assert_array_equal(cnt.numpy(), np.asarray(cnt_j))
        assert _rows(idx, cnt) == _rows(idx_j, cnt_j)
        sky = np.repeat(ext[:, 6].numpy() == 0, 3)
        assert (cnt.numpy()[sky] == 0).all()
    if K == 4:
        assert int((cnt == -1).sum()) > 0


# --- hit extents -----------------------------------------------------------------

def test_hit_extents_plain_matches_pallas_interpret():
    """22 spheres, 16x8, 8x8 tiles, no AA, compat, one level, through the JAX
    kernel in interpret mode with its own cone-cull tables, in the layout its
    wrapper picks at this size (swap_xy: y tiles outermost), against the
    plain version on the same tables brought across by bridge.py."""
    scene_j = _scene(11, 22)
    cam_j = jrt.Camera.build((16, 8), [-7, 0, 3], [0, 10, 0])
    cam, scene = to_torch(cam_j, scene_j)
    ns, npl = scene_j.spheres.count, scene_j.planes.count
    swap = jp._resolve_swap(16, 8)
    assert swap
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
        vis_tabs=(idx_j, cnt_j), vis_k=ns, interpret=True, n_levels=1))
    ext_j = bridge.tile_rows_from_jax(ext_j, n_tx, n_ty, swap)
    vis, _ = bridge.tables_from_arrays(vis=(
        bridge.tile_rows_from_jax(np.asarray(idx_j).reshape(-1, ns), n_tx, n_ty, swap),
        bridge.tile_rows_from_jax(np.asarray(cnt_j), n_tx, n_ty, swap), ns), device="cpu")
    # the port's own function gives those tables
    idx, cnt = ct.tile_visibility(cam, scene, compat=True, tile=tile)
    assert _rows(idx, cnt) == _rows(vis[0], vis[1])
    ext = hx.hit_extents_plain(cam, scene, aliasing=False, compat=True, tile=tile,
                               vis=vis).numpy()
    assert ext.shape == ext_j.shape == (2, 8)
    np.testing.assert_array_equal(ext[:, 6:], ext_j[:, 6:])
    assert ext[:, 6].sum() > 0
    np.testing.assert_allclose(ext[:, :6], ext_j[:, :6], rtol=0, atol=1e-5)
    # the cull changes no box: the listed sweep's hits are the full sweep's
    full = hx.hit_extents_plain(cam, scene, aliasing=False, compat=True, tile=tile).numpy()
    np.testing.assert_array_equal(ext, full)


def test_hit_extents_plain_levels_and_empty_scene():
    cam = trt.Camera.build((24, 16), [-7.0, 0.0, 3.0], [0.0, -20.0, 0.0], device="cpu")
    scene = trt.random_scene(30, generator=torch.Generator().manual_seed(2), device="cpu")
    one = hx.hit_extents_plain(cam, scene, aliasing=True, compat=True, tile=8)
    two = hx.hit_extents_plain(cam, scene, aliasing=True, compat=True, tile=8, n_levels=2)
    assert one.shape == (6, 8) and two.shape == (12, 8)
    torch.testing.assert_close(two[0::2], one, rtol=0, atol=0)     # levels fastest
    assert bool((two[1::2, 6] <= two[0::2, 6]).all())              # alive is cumulative
    # the wrapper refuses CPU tensors (the plain version is hit_extents_plain)
    with pytest.raises(ValueError, match="hit_extents_cuda takes CUDA tensors, got cpu"):
        hx.hit_extents_cuda(cam, scene, aliasing=True, compat=True)
    assert hx.LAUNCHES["hit_extents"] == 0
    empty = trt.Scene(trt.Spheres.build([], device="cpu"), trt.Planes.build([], device="cpu"),
                      trt.Lights.build([], device="cpu"), trt.Materials.build(device="cpu"))
    e = hx.hit_extents_plain(cam, empty, aliasing=False, compat=True)
    assert e.shape == (2, 8)
    assert e[:, :3].min() == 1e30 and e[:, 3:6].max() == -1e30 and e[:, 6:].abs().max() == 0


# --- coverage: what makes the culls exact -----------------------------------------

def _tile_hits(cam, scene, aliasing, compat, tile=16):
    """Per tile: sample positions' used mask, closest-hit object and biased
    hit point, by brute force with ops/intersect.py."""
    W, H = cam.resolution
    n_tx, n_ty = ct.tile_grid(W, H, tile)
    px, py = hx._positions(n_tx, n_ty, tile, aliasing, cam.device)
    d = cam.ray_directions(torch.stack([px, py], dim=-1), compat=compat)
    o = cam.ray_origin().expand(d.shape)
    hits = intersect.closest_hit(o, d, scene, compat=compat)
    P = o + torch.where(hits["hit"], hits["t"], torch.zeros_like(hits["t"]))[..., None] * d
    _, N = _surface_attributes(P, hits, scene)
    used = (px >= 0) & (px <= W - 1) & (py >= 0) & (py <= H - 1) & hits["hit"]
    return used, hits["obj"], P + BIAS * N


def _planted(n=100):
    """n seeded spheres plus one beyond light 0, as seen from the scene
    (tests/test_pallas.py::test_pallas_shadow_lists_exact's occluder)."""
    base = trt.random_scene(n, generator=torch.Generator().manual_seed(11), device="cpu")
    L0 = base.lights.position[0]
    u = L0 - torch.tensor([0.0, 0.0, 2.0])
    beyond = L0 + 4.0 * u / u.norm()
    sph = trt.Spheres(torch.cat([base.spheres.center, beyond[None]]),
                      torch.cat([base.spheres.radius, torch.tensor([1.5])]),
                      torch.cat([base.spheres.albedo, torch.tensor([[1.0, 0.0, 0.0]])]))
    return trt.Scene(sph, base.planes, base.lights, base.materials)


@pytest.mark.parametrize("aliasing", [False, True])
@pytest.mark.parametrize("compat", [True, False])
def test_lists_cover_every_used_hit_and_occluder(monkeypatch, aliasing, compat):
    scene = _planted()
    ns = scene.spheres.count
    cam = trt.Camera.build((64, 48), [-7.0, 0.0, 3.0], [0.0, 10.0, 0.0], device="cpu")
    plain_tables(monkeypatch.setattr)
    vis, shadow, tree, cells = render_cuda.large_scene_tables(
        cam, scene, depth=2, aliasing=aliasing, compat=compat)
    assert tree is None and vis[2] == shadow[2] == 32 and cells is not None
    used, obj, Pb = _tile_hits(cam, scene, aliasing, compat)
    vis_rows, sh_rows = _rows(vis[0], vis[1]), _rows(shadow[0], shadow[1])
    assert any(r is not None and len(r) < ns for r in vis_rows)
    # every used sample's closest-hit sphere is in its tile's primary list
    for t, row in enumerate(vis_rows):
        hit = set(obj[t][used[t] & (obj[t] < ns)].tolist())
        assert row is None or hit <= set(row), (t, hit - set(row))
    # every sphere that blocks a used hit point's shadow ray toward light l, at
    # any distance (beyond the light too), is in row (tile, l)
    planted_kept = 0
    for t in range(used.shape[0]):
        P = Pb[t][used[t]]
        for l in range(3):
            row = sh_rows[t * 3 + l]
            if P.shape[0] == 0:
                assert row == []          # a sky tile sweeps no sphere
                continue
            L = scene.lights.position[l] - P
            L = L / L.norm(dim=-1, keepdim=True)
            ts, valid = intersect.intersect_spheres(P, L, scene.spheres.center,
                                                    scene.spheres.radius, compat=compat)
            if compat:
                valid = valid & (ts < intersect.FAR)
            blockers = set(torch.nonzero(valid.any(dim=0)).reshape(-1).tolist())
            assert row is None or blockers <= set(row), (t, l, blockers - set(row))
            if l == 0 and ns - 1 in blockers:
                planted_kept += 1
    assert planted_kept > 0     # the occluder beyond the light does shadow, and is kept
    assert any(r == [] for r in sh_rows) and any(r for r in sh_rows)


def test_large_scene_tables_thresholds(monkeypatch):
    """Auto: nothing for <= 16 spheres, cull and lists above, groups from 256
    spheres and only with bounces; lists need a light, and the light cells
    the lists and bounces."""
    cam = trt.Camera.build((32, 32), [-7.0, 0.0, 3.0], [0.0, -20.0, 0.0], device="cpu")
    kw = dict(depth=2, aliasing=False, compat=True)
    g = torch.Generator().manual_seed(0)
    plain_tables(monkeypatch.setattr)
    assert render_cuda.large_scene_tables(cam, trt.default_scene(device="cpu"), **kw) == (None,) * 4
    assert render_cuda.large_scene_tables(cam, trt.random_scene(16, generator=g, device="cpu"),
                                          **kw, shadow_lists=True,
                                          group_cull=True) == (None,) * 4
    vis, shadow, groups, cells = render_cuda.large_scene_tables(
        cam, trt.random_scene(17, generator=g, device="cpu"), **kw)
    assert vis is not None and shadow is not None and groups is None and cells is not None
    assert vis[2] == 17 and vis[0].shape == (4 * 17,) and shadow[0].shape == (4 * 3 * 17,)
    big = trt.random_scene(256, generator=g, device="cpu")
    vis, shadow, tree, cells = render_cuda.large_scene_tables(cam, big, **kw)
    assert tree is not None and tree.n_leaves == 256 // ct.LEAF and vis[2] == 32
    assert cells is not None
    assert render_cuda.large_scene_tables(cam, big, depth=0, aliasing=False,
                                          compat=True)[2:] == (None, None)
    assert render_cuda.large_scene_tables(cam, big, **kw, cull=False, shadow_lists=False,
                                          group_cull=False) == (None,) * 4
    dark = trt.Scene(big.spheres, big.planes, trt.Lights.build([], device="cpu"), big.materials)
    assert render_cuda.large_scene_tables(cam, dark, **kw)[1::2] == (None, None)
    assert render_cuda.CULL_MIN_SPHERES == jp._UNROLL_LIMIT
    assert render_cuda.GROUP_MIN_SPHERES == jp._GROUP_MIN_NS
    assert [ct.list_capacity(n) for n in (6, 100, 1000, 4000)] == [6, 32, 64, 128]


def _groups_smem_bytes(ns, npl, nl):
    """The render wrapper's shared-memory charge before the bounce tree: the
    scene, both lists at their largest capacity and, above 16 spheres, the
    16-sphere Morton groups (4 bound floats and 16 indices each) whatever the
    depth."""
    words = 41 + 7 * ns + 9 * npl + 3 * nl
    if ns > 16:
        k = ct.list_capacity(ns)
        words += -(-ns // 16) * 20 + k + nl * (k + 1)
    return 4 * words


@pytest.mark.parametrize("npl,nl", [(1, 3), (0, 0), (1, 20), (4, 1)])
def test_smem_check_counts_the_tree_only_where_it_is_built(npl, nl):
    """The render wrapper charges the bounce tree's shared memory only where
    large_scene_tables builds it (render_cuda.uses_tree): at depth 0 or with
    group_cull off, the largest scene the groups' charge took, and one less,
    keep the staged form; with the tree, the largest staged scene is pinned
    (5600 spheres with 1 plane and 3 lights, where the groups' charge took
    6576), and past it the scene takes the global form instead of a refusal."""
    limit = render_cuda._SMEM_LIMIT
    ns_old = max(n for n in range(9000) if _groups_smem_bytes(n, npl, nl) <= limit)
    for ns in (ns_old - 1, ns_old):
        for depth, group_cull in ((0, None), (0, True), (2, False)):
            assert not render_cuda.uses_tree(ns, depth, group_cull)
        assert render_cuda._smem_bytes(ns, npl, nl, tree=False) <= limit
    assert render_cuda.uses_tree(256, 1) and render_cuda.uses_tree(17, 1, True)
    assert not render_cuda.uses_tree(255, 2) and not render_cuda.uses_tree(16, 2, True)
    ns_tree = max(n for n in range(9000) if render_cuda._smem_bytes(n, npl, nl, tree=True)
                  <= limit)
    assert ns_tree == {(1, 3): 5600, (0, 0): 5643, (1, 20): 5369, (4, 1): 5625}[(npl, nl)]
    if (npl, nl) == (1, 3):
        assert ns_old == 6576
        cam = trt.Camera.build((16, 16), [-7.0, 0.0, 3.0], [0.0, -20.0, 0.0], device="cpu")
        scene = trt.random_scene(ns_old, generator=torch.Generator().manual_seed(0), device="cpu")
        dev = torch.device("cpu")
        render_cuda._check_inputs(cam, scene, dev)
        for depth, group_cull, form in ((0, None, 0), (2, False, 0), (2, None, 1)):
            tree = render_cuda.uses_tree(ns_old, depth, group_cull)
            assert render_cuda.scene_form(ns_old, npl, nl, tree) == form


@pytest.mark.parametrize("kw", [dict(), dict(cull=False, shadow_lists=False,
                                             group_cull=False),
                                dict(shadow_lists=True, group_cull=True)])
def test_wrapper_on_cpu_tensors_is_the_plain_render(monkeypatch, kw):
    """Both render wrappers refuse CPU tensors whatever the cull keywords,
    before any table or launch; large_scene_tables builds the same keywords'
    tables from CPU tensors with its table launches standing in by their
    plain versions (tests/torch_plain_launch.py), launching nothing."""
    from python_ray_tracer_tpu_torch.ops.cuda import light_cells_cuda as lc
    from python_ray_tracer_tpu_torch.ops.cuda import shadow_lists_cuda as sl
    scene = trt.random_scene(24, generator=torch.Generator().manual_seed(3), device="cpu")
    cam = trt.Camera.build((20, 12), [-7.0, 0.0, 3.0], [0.0, -20.0, 0.0], device="cpu")
    before = (dict(render_cuda.LAUNCHES), dict(hx.LAUNCHES), dict(sl.LAUNCHES),
              dict(lc.LAUNCHES))
    for fn in (trt.render_image_cuda, render_cuda.render_image_fast):
        with pytest.raises(ValueError, match="takes CUDA tensors, got cpu"):
            fn(cam, scene, depth=1, aliasing=True, **kw)
    plain_tables(monkeypatch.setattr)
    vis, shadow, tree, cells = render_cuda.large_scene_tables(cam, scene, depth=1,
                                                              aliasing=True, compat=True,
                                                              **kw)
    assert (dict(render_cuda.LAUNCHES), dict(hx.LAUNCHES), dict(sl.LAUNCHES),
            dict(lc.LAUNCHES)) == before
    assert (vis is None) == (kw.get("cull") is False)
    assert (shadow is None) == (kw.get("shadow_lists") is False)
    assert (tree is None) == (not kw.get("group_cull"))
    assert all(t.device.type == "cpu" for t in (vis or shadow or (torch.zeros(0),))[:2])


def test_cull_keywords_match_the_jax_wrapper():
    want = inspect.signature(jp.render_image_pallas).parameters
    for fn in (render_cuda.render_image_cuda, render_cuda.render_image_fast):
        got = inspect.signature(fn).parameters
        for name in ("cull", "shadow_lists", "group_cull"):
            assert got[name].default == want[name].default, (fn.__name__, name)


def test_bridge_tables_and_tile_rows():
    rows = np.arange(6 * 2).reshape(6, 2)              # n_ty=2 outermost, n_tx=3
    got = bridge.tile_rows_from_jax(rows, 3, 2, True)
    want = np.array([rows[ty * 3 + tx] for tx in range(3) for ty in range(2)])
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(bridge.tile_rows_from_jax(rows, 3, 2, False), rows)
    vis, shadow = bridge.tables_from_arrays(vis=(rows, np.full(6, 2), 2), device="cpu")
    assert shadow is None and vis[2] == 2
    assert vis[0].dtype == vis[1].dtype == torch.int32 and vis[0].shape == (12,)
    tree = ct.bounce_tree(torch.rand(32, 3), torch.full((32,), 0.1))
    hx.check_tables(vis, None, tree, n_tiles=6, ns=32, nl=0, dev=torch.device("cpu"))
    with pytest.raises(ValueError, match="primary list indices"):
        hx.check_tables(vis, None, None, n_tiles=5, ns=32, nl=0, dev=torch.device("cpu"))
    with pytest.raises(ValueError, match="bounce tree"):
        hx.check_tables(None, None, tree, n_tiles=6, ns=40, nl=0, dev=torch.device("cpu"))


def test_large_scene_bound_counts_listed_work(monkeypatch):
    """utils/timing.py's large-scene bound: a tile's samples times its listed
    spheres, not ns; less work than the unculled bound, and bytes that count
    the tables in and 32 bytes a tile out."""
    scene = _planted()
    cam = trt.Camera.build((64, 48), [-7.0, 0.0, 3.0], [0.0, 10.0, 0.0], device="cpu")
    plain_tables(monkeypatch.setattr)
    vis, shadow, _, _ = render_cuda.large_scene_tables(cam, scene, depth=2,
                                                       aliasing=False, compat=True)
    ext = hx.hit_extents_plain(cam, scene, aliasing=False, compat=True, vis=vis)
    ns, npl, nl = 101, 1, 3
    ops_k3, bytes_k3 = timing.hit_extents_work(64, 48, ns, npl, False, vis, ext)
    full_ops, _ = timing.hit_extents_work(64, 48, ns, npl, False, None, ext)
    assert 0 < ops_k3 < full_ops
    # only positions inside the image count, and the surface only where a sample hit
    assert timing.tile_positions(40, 24, False).tolist() == [256.0, 128.0, 256.0, 128.0,
                                                             128.0, 64.0]
    # half positions: a tile's 17 reach both neighbours' edges, less the -0.5 one
    assert float(timing.tile_positions(40, 24, True).sum()) == (40 + 41) * (24 + 24)
    sky = ext.clone()
    sky[:, 6] = 0
    assert ops_k3 - timing.hit_extents_work(64, 48, ns, npl, False, vis, sky)[0] == \
        float(ext[:, 6].sum()) * (timing.SURFACE + timing.SPHERE_NORMAL)
    assert bytes_k3 == 4 * (41 + 7 * ns + 9 * npl) + 4 * (12 * 32 + 12) + 32 * 12
    ops, nbytes = timing.large_scene_work(64, 48, ns, npl, nl, "aa_none", vis, shadow, ext)
    ops_full, nbytes_full = timing.hard_work(64, 48, ns, npl, nl, "aa_none")
    assert ops < ops_full + 64 * 48 * nl * ns * timing.SHADOW_SPHERE
    assert nbytes > nbytes_full
    none = timing.large_scene_work(64, 48, ns, npl, nl, "aa_none", None, None, ext)
    assert none[0] > ops


def test_large_scene_bound_counts_bounce_levels():
    """Hit-extent rows of levels 0..2 (levels fastest) add the bounce floor
    to the level-0 bound: a traced bounce ray (set-up, planes, one sphere)
    from each hit alive at the level before, and each hit alive past level 0
    shaded (point, normal, and per light its direction, shadow set-up and
    planes); the level-0 rows alone give the level-0 bound."""
    W, H, ns, npl, nl = 40, 24, 30, 1, 3                   # 3 x 2 tiles
    live = torch.tensor([[256, 200, 50], [128, 128, 0], [256, 0, 0], [128, 64, 64],
                         [128, 100, 90], [64, 64, 64]], dtype=torch.float32)
    ext = torch.zeros((6, 3, 8))
    ext[:, :, 6] = live
    lv0 = ext[:, 0].clone()
    ops, nbytes = timing.large_scene_work(W, H, ns, npl, nl, "aa_none", None, None,
                                          ext.reshape(18, 8))
    ops0, nbytes0 = timing.large_scene_work(W, H, ns, npl, nl, "aa_none", None, None, lv0)
    assert nbytes == nbytes0
    traced = float(live[:, 0].sum() + live[:, 1].sum())
    hits = float(live[:, 1].sum() + live[:, 2].sum())
    assert ops - ops0 == traced * (timing.HIT_SETUP + npl * timing.HIT_PLANE +
                                   timing.HIT_SPHERE) + \
        hits * (timing.SURFACE + timing.SPHERE_NORMAL +
                nl * (timing.LIGHT + timing.SHADOW_SETUP + npl * timing.HIT_PLANE))
    assert timing.bounce_floor(live, npl, nl) == ops - ops0
