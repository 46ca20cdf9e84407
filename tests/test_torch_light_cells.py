"""The light cells of the bounce shadow rays (ops/cuda/light_cells_cuda.py,
csrc/light_cells.cu) on the CPU: the plain build against its definition, and
the plain lookup traversal (``occluded_cells_plain``, which mirrors
csrc/rt_common.cuh ``occluded_cells``) against the full any-hit of the same
sphere tests and against the JAX package's ``render_pallas._any_hit``.

Tolerances. None: the lookup's any-hit must be the full sweep's on every ray,
because the rows keep every sphere within the margin of a line through the
light whose direction the kernel files under the cell (rt_common.cuh derives
the margin m and the test's slack tau). The rays include the bounce shadow rays
of real 100- and 1000-sphere frames, directions on cell edges, cell corners
and face seams, exact-zero and subnormal direction components, spheres near
and around a light, an occluder beyond a light, and origins past ``s_max``
(which must take the fallback). With the margin and the slack both at 0 the
lookup misses occluders that the float32 sphere tests report (a sphere placed
just past a cell's widest corner, rays from 5-28 units out); with the margin
alone at 0 it misses the hits that those tests report off a small sphere's
silhouette from origins out near ``s_max``.
"""
import functools
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import python_ray_tracer_tpu_torch as trt
from python_ray_tracer_tpu.ops.pallas import render_pallas as jp
from python_ray_tracer_tpu_torch.ops import intersect
from python_ray_tracer_tpu_torch.ops.cuda import cull_tables as ct
from python_ray_tracer_tpu_torch.ops.cuda import light_cells_cuda as lc
from python_ray_tracer_tpu_torch.ops.cuda import render_cuda
from python_ray_tracer_tpu_torch.ops.shade import BIAS, _surface_attributes, reflect
from python_ray_tracer_tpu_torch.utils.config import RenderConfig
from .torch_plain_launch import plain_tables

torch.set_num_threads(1)


def _scene(n, seed=0):
    return trt.random_scene(n, generator=torch.Generator().manual_seed(seed), device="cpu")


def _planted(n=40, seed=3):
    """n seeded spheres, light 0 moved to the origin (shadow directions with
    exact-zero and subnormal components), a sphere holding light 1, one just
    off light 2, and one beyond light 0 (it shadows from behind the light)."""
    s = _scene(n, seed)
    L = s.lights.position.clone()
    L[0] = 0.0
    extra_c = torch.stack([L[1] + torch.tensor([0.1, 0.0, 0.0]),
                           L[2] + torch.tensor([0.0, 0.9, 0.0]),
                           L[0] + torch.tensor([1.0, 2.0, 4.0])])
    extra_r = torch.tensor([0.3, 0.8, 1.2])
    return (torch.cat([s.spheres.center, extra_c]), torch.cat([s.spheres.radius, extra_r]),
            L)


@functools.lru_cache(maxsize=None)
def _frame(n):
    """The bounce shadow rays (levels 1 and 2) of a 96x54 frame of
    ``random_scene(n)`` from the CLI's camera, one ``(o, d, light)`` a light
    and level, with the scene and its light cells (and tree from 256
    spheres)."""
    cfg = RenderConfig()
    scene = _scene(n)
    cam = trt.Camera.build((96, 54), cfg.camera_position, cfg.camera_euler, cfg.fov, device="cpu")
    c, r, L = scene.spheres.center, scene.spheres.radius, scene.lights.position
    xs, ys = torch.meshgrid(torch.arange(96.0), torch.arange(54.0), indexing="ij")
    d = cam.ray_directions(torch.stack([xs, ys], -1).reshape(-1, 2), compat=True)
    o = cam.ray_origin().expand(d.shape)
    rays = []
    for level in range(3):
        h = intersect.closest_hit(o, d, scene, compat=True)
        alive = h["hit"]
        P = o + torch.where(alive, h["t"], torch.zeros_like(h["t"]))[..., None] * d
        _, N = _surface_attributes(P, h, scene)
        Pb = (P + BIAS * N)[alive]
        if level:
            for li in range(L.shape[0]):
                v = L[li] - Pb
                rays.append((Pb, v / torch.sqrt(intersect._dot(v, v))[:, None], li))
        d2 = reflect(d, N)
        o, d = (P + BIAS * N + BIAS * d2)[alive], d2[alive]
    tree = ct.bounce_tree(c, r) if n >= render_cuda.GROUP_MIN_SPHERES else None
    return c, r, L, lc.light_cells_plain(c, r, L), tree, rays


def _unit(v):
    return v / np.linalg.norm(v, axis=-1, keepdims=True)


def _face_dirs(uv, face):
    """Directions ``(n, 3)`` float64 with face coordinates ``uv (n, 2)`` on
    axial face ``face`` (the other two axes in ascending order)."""
    d = np.empty((uv.shape[0], 3))
    others = [a for a in range(3) if a != face]
    d[:, face] = 1.0
    d[:, others[0]], d[:, others[1]] = uv[:, 0], uv[:, 1]
    return _unit(d)


def _rows(cells, k=lc.K):
    idx = cells.idx.reshape(-1, k)
    return [idx[i, :n].tolist() if n >= 0 else None for i, n in enumerate(cells.cnt.tolist())]


def test_rows_hold_their_definition():
    """At R = 8: rows ascend and pad with 0; every sphere within rho = r + m of
    a line through the light along a direction filed under a cell (dense
    samples, cell edges and corners included, in float64) is in that cell's
    row; every listed sphere passes the float64 cone test with twice the
    slack; a small K turns exactly the longer rows into -1 and keeps their
    first entries."""
    r_cells = 8
    c, rad, L = _planted()
    cells = lc.light_cells_plain(c, rad, L, r=r_cells)
    rows = _rows(cells)
    assert all(row is not None for row in rows)
    for row in rows:
        assert row == sorted(set(row))
    idx = cells.idx.reshape(-1, lc.K)
    for i, n in enumerate(cells.cnt.tolist()):
        assert not idx[i, n:].any()
    reach, s_max = (float(v) for v in cells.hdr)
    m = float(np.float32(lc.MARGIN) * np.float32(s_max))
    tau = float(np.float32(lc.TAU) * np.float32(s_max))
    assert reach >= float((torch.sqrt(intersect._dot(c, c)) + rad).max())
    assert reach >= float(torch.sqrt(intersect._dot(L, L)).max())
    # superset: samples at 4 a cell side, edges and corners included
    g = np.linspace(-1.0, 1.0, 4 * r_cells + 1)
    uv = np.stack(np.meshgrid(g, g, indexing="ij"), -1).reshape(-1, 2)
    cd, rd, Ld = c.double().numpy(), rad.double().numpy(), L.double().numpy()
    per = 3 * r_cells * r_cells
    for face in range(3):
        u = _face_dirs(uv, face)
        cell = lc.light_cell_of(torch.tensor(u, dtype=torch.float32), r_cells).numpy()
        assert (cell >= 0).all()
        for li in range(3):
            w = cd - Ld[li]
            dist = np.linalg.norm(np.cross(w[None], u[:, None]), axis=-1)   # (n, ns)
            near = dist <= rd[None] + m
            for q in np.nonzero(near.any(1))[0]:
                row = set(rows[li * per + cell[q]])
                assert set(np.nonzero(near[q])[0].tolist()) <= row, (face, li, q)
    # no sphere is listed that cannot reach its cell (the cone test in float64)
    cones = lc.cell_cones(r_cells).double().numpy()
    step = 2.0 / r_cells
    for i, row in enumerate(rows):
        li, cell = divmod(i, per)
        face, iu, iv = cell // (r_cells ** 2), (cell // r_cells) % r_cells, cell % r_cells
        lo = np.array([iu, iv]) * step - 1.0 - lc.GROW
        corners = _face_dirs(np.array([[lo[0] + a, lo[1] + b] for a in (0, step + 2 * lc.GROW)
                                       for b in (0, step + 2 * lc.GROW)]), face)
        ch = _unit(cones[cell, :3])
        cb = float((corners @ ch).min())
        sb = math.sqrt(max(0.0, 1.0 - cb * cb))
        for j in row:
            w = cd[j] - Ld[li]
            ww, rho = float(w @ w), rd[j] + m
            assert rho * rho >= ww * lc.HOLDS * (1 - 1e-6) or \
                abs(float(ch @ w)) + 2 * tau >= cb * math.sqrt(ww - rho * rho) - sb * rho - 1e-6
    # overflow: K = 2
    small = lc.light_cells_plain(c, rad, L, r=r_cells, k=2)
    full_cnt = cells.cnt
    assert torch.equal(small.cnt < 0, full_cnt > 2) and bool((full_cnt > 2).any())
    ok = small.cnt >= 0
    assert torch.equal(small.cnt[ok], full_cnt[ok])
    assert torch.equal(small.idx.reshape(-1, 2), idx[:, :2])


@pytest.mark.parametrize("n", [100, 1000])
@pytest.mark.parametrize("compat,cheap", [(True, True), (True, False), (False, True),
                                          (False, False)])
def test_lookup_is_the_full_any_hit_on_frame_bounces(n, compat, cheap):
    c, r, L, cells, tree, rays = _frame(n)
    listed = total = 0
    for o, d, li in rays:
        occ, fb, _ = lc.occluded_cells_plain(cells, o, d, li, c, r, compat=compat,
                                             cheap=cheap, tree=tree)
        full = ct.sphere_occludes_plain(o, d, c, r, compat=compat, cheap=cheap).any(dim=1)
        assert torch.equal(occ, full), (li, int((occ != full).sum()))
        listed += int((~fb).sum())
        total += o.shape[0]
    assert listed > 0.9 * total       # the rows, not the fallback, answer most rays


def _special_rays(L, s_max, r_cells=lc.R):
    """``[(o, d, light, must_fall_back)]`` float32: directions on cell edges
    and corners and on face seams (both signs), exact-zero and subnormal
    components (light 0 sits at the origin), and origins past ``s_max``."""
    out = []
    g = np.arange(0, r_cells + 1, 3) * (2.0 / r_cells) - 1.0     # cell edges
    uv = np.stack(np.meshgrid(g, g, indexing="ij"), -1).reshape(-1, 2)
    seams = np.array([[1.0, t] for t in np.linspace(-1, 1, 9)] +
                     [[-1.0, t] for t in np.linspace(-1, 1, 9)] + [[1.0, 1.0], [-1.0, 1.0]])
    Ln = L.double().numpy()
    for li in range(L.shape[0]):
        for face in range(3):
            u = np.concatenate([_face_dirs(uv, face), _face_dirs(seams, face)])
            u = np.concatenate([u, -u])
            for t in (0.7, 4.0, 15.0):
                o = Ln[li][None] - t * u
                out.append((torch.tensor(o, dtype=torch.float32), li, False))
        far = Ln[li][None] - (1.05 * s_max) * _unit(np.array([[1.0, 0.3, 0.2], [-0.2, 1, -0.4],
                                                               [0.1, 0.1, -1.0]]))
        out.append((torch.tensor(far, dtype=torch.float32), li, True))
    # light 0 at the origin: o = -t e gives a shadow direction with exact zeros,
    # and a subnormal offset a subnormal component
    e = np.array([[1, 0, 0], [0, 1, 0], [0, 0, 1], [1, 1, 0], [0, 1, 1], [1, 0, 1],
                  [1, 1, 1]], dtype=np.float64)
    e = _unit(np.concatenate([e, -e]))
    zero = [-t * e for t in (0.5, 3.0, 9.0)]
    sub = np.array([[-3.0, -1e-39, 0.0], [-2.0, 3e-41, -1e-40], [1e-42, -4.0, 0.0],
                    [0.0, -2e-39, -5.0]])
    out.append((torch.tensor(np.concatenate(zero), dtype=torch.float32), 0, False))
    out.append((torch.tensor(sub, dtype=torch.float32), 0, False))
    assert float(L[0].abs().max()) == 0.0
    return [(o, (L[li] - o) / torch.sqrt(intersect._dot(L[li] - o, L[li] - o))[:, None], li,
             fall) for o, li, fall in out]


@pytest.mark.parametrize("compat,cheap", [(True, True), (True, False), (False, True),
                                          (False, False)])
def test_lookup_is_the_full_any_hit_on_edges_seams_and_odd_directions(compat, cheap):
    c, r, L = _planted()
    cells = lc.light_cells_plain(c, r, L)
    s_max = float(cells.hdr[1])
    n_listed = 0
    for o, d, li, must_fall in _special_rays(L, s_max):
        occ, fb, _ = lc.occluded_cells_plain(cells, o, d, li, c, r, compat=compat, cheap=cheap)
        full = ct.sphere_occludes_plain(o, d, c, r, compat=compat, cheap=cheap).any(dim=1)
        assert torch.equal(occ, full), (li, int((occ != full).sum()))
        if must_fall:
            assert bool(fb.all())
        n_listed += int((~fb).sum())
    assert n_listed > 1000
    # the subnormal and zero components do reach the cells
    d = _special_rays(L, s_max)[-1][1]
    assert bool((d == 0).any()) and bool(((d != 0) & (d.abs() < 1.2e-38)).any())
    assert bool((lc.light_cell_of(d) >= 0).all())
    # the sphere around light 1 is in every row of light 1, and the one beyond
    # light 0 shadows rays that reach it
    per = 3 * lc.R ** 2
    rows = cells.idx.reshape(-1, lc.K)
    holder = c.shape[0] - 3
    assert bool((cells.cnt[per:2 * per] >= 0).all())
    assert bool((rows[per:2 * per] == holder).any(dim=1).all())


def test_lookup_matches_the_jax_any_hit():
    """The lookup traversal against render_pallas._any_hit (jnp, the JAX
    package's shadow sweep) on the same numpy rays: the frame's bounce shadow
    rays at 100 spheres, both forms, compat and clean."""
    c, r, L, cells, tree, rays = _frame(100)
    sph = jnp.asarray(np.concatenate([c.numpy().T, r.numpy()[None]]))
    pln = jnp.zeros((9, 0), jnp.float32)
    for compat in (True, False):
        for cheap in (True, False):
            for o, d, li in rays[:3]:
                occ, _, _ = lc.occluded_cells_plain(cells, o, d, li, c, r, compat=compat,
                                                    cheap=cheap)
                on, dn = o.numpy(), d.numpy()
                ref = jp._any_hit(sph, c.shape[0], pln, 0, *(jnp.asarray(on[:, i])
                                                             for i in range(3)),
                                  *(jnp.asarray(dn[:, i]) for i in range(3)),
                                  compat=compat, shape=(on.shape[0],), cheap=cheap)
                np.testing.assert_array_equal(occ.numpy(), np.asarray(ref) > 0.5)


def _corner_case():
    """A sphere placed just past the widest corner of one cell of light 0 (its
    cone from the light touches the cell's bounding cone 3e-6 rad out), and
    shadow rays toward light 0 from 5-28 units out whose directions lie in
    that cell within 2e-5 rad of the corner: their lines pass 2e-5-1.4e-4
    outside the sphere, which the float32 sphere tests report as hits for
    about a quarter of them."""
    base = _scene(30, 5)
    L = base.lights.position
    lv = L[0].double().numpy()
    cones = lc.cell_cones(lc.R).double().numpy()
    face, iu, iv = 2, 40, 45
    cell = (face * lc.R + iu) * lc.R + iv
    ch = _unit(cones[cell, :3])
    step = 2.0 / lc.R
    corners = _face_dirs(np.array([[iu * step - 1 + a, iv * step - 1 + b]
                                   for a in (0, step) for b in (0, step)]), face)
    ang = np.arccos(np.clip(corners @ ch, -1, 1))
    uc, beta = corners[int(ang.argmax())], float(ang.max())
    e = _unit(uc - (uc @ ch) * ch)

    def along(theta):
        return math.cos(theta) * ch + math.sin(theta) * e
    wn, rad = 6.0, 0.5
    cen = lv + wn * along(beta + math.asin(rad / wn) + 3e-6)
    c = torch.cat([base.spheres.center, torch.tensor(cen, dtype=torch.float32)[None]])
    r = torch.cat([base.spheres.radius, torch.tensor([rad])])
    g = np.random.default_rng(0)
    u = np.stack([along(beta - t) for t in g.uniform(0.0, 2e-5, 2000)])
    o = torch.tensor(lv[None] - g.uniform(5.0, 28.0, 2000)[:, None] * u, dtype=torch.float32)
    v = L[0] - o
    return c, r, L, o, v / torch.sqrt(intersect._dot(v, v))[:, None], cell


@pytest.mark.parametrize("cheap", [True, False])
def test_margin_and_slack_at_zero_miss_occluders(cheap):
    """The corner case: with the default margin and slack (and with either
    one alone) the lookup is the full any-hit; with both at 0 the cell's row
    drops the sphere and the lookup misses the hits that the float32 tests
    report past its exact silhouette."""
    c, r, L, o, d, cell = _corner_case()
    assert float((lc.light_cell_of(d) == cell).float().mean()) > 0.99
    full = ct.sphere_occludes_plain(o, d, c, r, compat=True, cheap=cheap).any(dim=1)
    assert int(full.sum()) > 100
    for margin, tau, exact in ((lc.MARGIN, lc.TAU, True), (0.0, lc.TAU, True),
                               (lc.MARGIN, 0.0, True), (0.0, 0.0, False)):
        cells = lc.light_cells_plain(c, r, L, margin=margin, tau=tau)
        occ, fb, _ = lc.occluded_cells_plain(cells, o, d, 0, c, r, compat=True, cheap=cheap)
        assert not bool(fb.any())
        assert torch.equal(occ, full) == exact, (margin, tau, int((full & ~occ).sum()))


def _far_origin_case():
    """A small sphere (r 0.005) 0.012 from light 0, placed so that a line
    through the light along a direction in one cell's widest corner passes
    0.005 outside it, and 4000 shadow rays toward light 0 along such lines
    from origins beyond the sphere, with S = |o| + reach from 0.73 to 0.97 of ``s_max``: the
    hoisted quadratics of the float32 sphere tests report about a quarter of
    them as hits, 1.1e-4 - 1.4e-4 S off the silhouette."""
    base = _scene(30, 5)
    L = base.lights.position
    lv = L[0].double().numpy()
    cones = lc.cell_cones(lc.R).double().numpy()
    face, iu, iv = 2, 40, 45
    cell = (face * lc.R + iu) * lc.R + iv
    ch = _unit(cones[cell, :3])
    step = 2.0 / lc.R
    corners = _face_dirs(np.array([[iu * step - 1 + a, iv * step - 1 + b]
                                   for a in (0, step) for b in (0, step)]), face)
    ang = np.arccos(np.clip(corners @ ch, -1, 1))
    uc, beta = corners[int(ang.argmax())], float(ang.max())
    e = _unit(uc - (uc @ ch) * ch)

    def along(theta):
        return math.cos(theta) * ch + math.sin(theta) * e
    wn, rad, off = 0.012, 0.005, 0.005
    cen = lv + wn * along(beta + math.asin((rad + off) / wn))
    c = torch.cat([base.spheres.center, torch.tensor(cen, dtype=torch.float32)[None]])
    r = torch.cat([base.spheres.radius, torch.tensor([rad])])
    reach, s_max = (float(v) for v in lc.light_cells_plain(c, r, L).hdr)
    g = np.random.default_rng(0)
    u = np.stack([along(beta - t) for t in g.uniform(0.0, 2e-5, 4000)])
    dist = g.uniform(0.6, 0.99, 4000) * (s_max - reach - float(np.linalg.norm(lv)))
    o = torch.tensor(lv[None] + dist[:, None] * u, dtype=torch.float32)
    v = L[0] - o
    return c, r, L, o, v / torch.sqrt(intersect._dot(v, v))[:, None], cell


@pytest.mark.parametrize("cheap", [True, False])
def test_margin_at_zero_misses_far_origin_occluders(cheap):
    """The case the margin m = LC_MARGIN S_max is derived for (rt_common.cuh,
    steps 1-3): from far origins the float32 sphere tests report hits on lines
    that pass outside the sphere by more than the test's slack covers. With
    the margin at 0 and the slack at its default, the cell's row drops the
    sphere and the lookup misses those hits; with the default margin it is
    the full any-hit."""
    c, r, L, o, d, cell = _far_origin_case()
    assert float((lc.light_cell_of(d) == cell).float().mean()) > 0.99
    full = ct.sphere_occludes_plain(o, d, c, r, compat=True, cheap=cheap).any(dim=1)
    assert int(full.sum()) > 500
    cells = lc.light_cells_plain(c, r, L)
    s = torch.sqrt(intersect._dot(o, o)) + cells.hdr[0]
    assert float(s.max()) > 0.95 * float(cells.hdr[1])
    occ, fb, _ = lc.occluded_cells_plain(cells, o, d, 0, c, r, compat=True, cheap=cheap)
    assert not bool(fb.any())
    assert torch.equal(occ, full)
    cells0 = lc.light_cells_plain(c, r, L, margin=0.0)
    occ0, fb0, _ = lc.occluded_cells_plain(cells0, o, d, 0, c, r, compat=True, cheap=cheap)
    assert not bool(fb0.any())
    assert int((full & ~occ0).sum()) > 500


def test_large_scene_tables_build_the_cells_with_the_shadow_lists(monkeypatch):
    """large_scene_tables: the light cells where the shadow lists are on and
    the frame has bounces (100 spheres as well as 1000), none at depth 0,
    without lights, with shadow_lists=False or light_cells=False; on CPU
    tensors they are the plain build's."""
    cam = trt.Camera.build((32, 32), [-7.0, 0.0, 3.0], [0.0, -20.0, 0.0], device="cpu")
    kw = dict(aliasing=False, compat=True)
    scene = _scene(100)
    plain_tables(monkeypatch.setattr)
    cells = render_cuda.large_scene_tables(cam, scene, depth=2, **kw)[3]
    want = lc.light_cells_plain(scene.spheres.center, scene.spheres.radius,
                                scene.lights.position)
    assert all(torch.equal(a, b) for a, b in zip(cells, want))
    assert cells.cnt.shape == (lc.n_rows(3),) and cells.idx.shape == (lc.n_rows(3) * lc.K,)
    assert render_cuda.large_scene_tables(cam, scene, depth=0, **kw)[3] is None
    assert render_cuda.large_scene_tables(cam, scene, depth=2, shadow_lists=False,
                                          **kw)[3] is None
    assert render_cuda.large_scene_tables(cam, scene, depth=2, light_cells=False,
                                          **kw)[3] is None
    dark = trt.Scene(scene.spheres, scene.planes, trt.Lights.build([], device="cpu"),
                     scene.materials)
    assert render_cuda.large_scene_tables(cam, dark, depth=2, **kw)[3] is None
    assert render_cuda.large_scene_tables(cam, _scene(16), depth=2, **kw)[3] is None
    with pytest.raises(ValueError, match="light cells indices"):
        lc.check_cells(lc.LightCells(cells.idx[:-1], cells.cnt, cells.hdr), 3,
                       torch.device("cpu"))
    with pytest.raises(ValueError, match="need a light"):
        lc.check_cells(cells, 0, torch.device("cpu"))


def test_light_cell_of_files_directions_by_face_and_square():
    """Faces by the largest |component| (ties to the lower axis), squares by
    floor((a + 1) R / 2) with a = 1 in the last cell, -1 for directions that
    are not finite or far from unit length."""
    R = lc.R
    d = torch.tensor([[1.0, 0.0, 0.0], [-1.0, 0.0, 0.0], [0.0, 1.0, 0.0], [0.0, 0.0, -1.0],
                      [0.6, 0.6, 0.5291503], [0.0, 0.6, -0.6], [0.8, -0.6, 0.0],
                      [0.0, 0.0, 0.0], [float("nan"), 0.0, 1.0], [float("inf"), 0.0, 0.0],
                      [0.3, 0.2, 0.1]])
    got = lc.light_cell_of(d).tolist()
    mid = R // 2
    assert got[0] == got[1] == (0 * R + mid) * R + mid
    assert got[2] == (1 * R + mid) * R + mid and got[3] == (2 * R + mid) * R + mid
    assert got[4] == (0 * R + R - 1) * R + int((0.5291503 / 0.6 + 1) * R / 2)
    assert got[5] == (1 * R + mid) * R + 0
    assert got[6] == (0 * R + int((-0.75 + 1) * R / 2)) * R + mid
    assert got[7:] == [-1, -1, -1, -1]
