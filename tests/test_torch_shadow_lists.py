"""The level-0 shadow lists on the CPU: the list kernel's entry point
(ops/cuda/shadow_lists_cuda.py, which takes the plain
cull_tables.shadow_visibility_lists for CPU tensors), the hit-extent
wrapper's scale, and the lists' bound (utils/timing.shadow_lists_work).

The rows are held to the JAX package's _shadow_visibility_lists on the same
seeded hit-extent rows, made with numpy (boxes over the scene, sky rows with
the +-1e30 sentinels, boxes that hold a light): integers, so they must be
equal. The scale is a max, so it must be equal bit for bit. The bound's count
of capsule-and-cone tests is held to a brute-force count in numpy float32,
operation for operation like the plain function (IEEE float32 on both
sides, so the decisions are the same).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import python_ray_tracer_tpu_torch as trt
from python_ray_tracer_tpu.ops.pallas import render_pallas as jp
from python_ray_tracer_tpu_torch.ops.cuda import cull_tables as ct
from python_ray_tracer_tpu_torch.ops.cuda import hit_extents_cuda as hx
from python_ray_tracer_tpu_torch.ops.cuda import render_cuda
from python_ray_tracer_tpu_torch.ops.cuda import shadow_lists_cuda as sl
from python_ray_tracer_tpu_torch.utils import timing
from .torch_plain_launch import plain_tables

torch.set_num_threads(1)
f32 = np.float32


def _seeded(n: int, seed: int, n_tiles: int = 40, nl: int = 3):
    """numpy scene and hit-extent rows: ``n`` spheres on a 16 x 16 floor,
    ``nl`` lights above it, and ``n_tiles`` rows: a quarter without hits
    (the sentinels, count 0), one box around each light (its cone is not
    defined: the row keeps every sphere), the rest boxes over the floor."""
    rng = np.random.default_rng(seed)
    centers = np.concatenate([rng.uniform(-8, 8, (n, 2)), rng.uniform(0.2, 3.0, (n, 1))],
                             axis=1).astype(f32)
    radii = rng.uniform(0.1, 0.7, n).astype(f32)
    lights = np.concatenate([rng.uniform(-10, 10, (nl, 2)), rng.uniform(5, 12, (nl, 1))],
                            axis=1).astype(f32)
    ext = np.zeros((n_tiles, 8), f32)
    lo = np.concatenate([rng.uniform(-8, 6, (n_tiles, 2)), rng.uniform(0, 1, (n_tiles, 1))],
                        axis=1)
    ext[:, 0:3] = lo
    ext[:, 3:6] = lo + rng.uniform(0.05, 3.0, (n_tiles, 3))
    ext[:, 6] = rng.integers(1, 257, n_tiles)
    ext[:nl, 0:3] = lights - 1.0
    ext[:nl, 3:6] = lights + 1.0
    sky = rng.permutation(np.arange(nl, n_tiles))[:n_tiles // 4]
    ext[sky, 0:3], ext[sky, 3:6], ext[sky, 6] = 1e30, -1e30, 0.0
    return ext, lights, centers, radii


def _torch(*arrays):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]


def _rows(idx, cnt):
    """Per row: the kept entries (a list) or None for the -1 sentinel."""
    idx, cnt = np.asarray(idx), np.asarray(cnt)
    k = idx.size // max(cnt.size, 1)
    idx = idx.reshape(cnt.size, k)
    return [None if c < 0 else idx[r, :c].tolist() for r, c in enumerate(cnt)]


@pytest.mark.parametrize("n", [24, 100])
@pytest.mark.parametrize("cap", [True, False])
@pytest.mark.parametrize("compat", [True, False])
def test_entry_point_rows_match_jax(n, cap, compat):
    """The list kernel's plain function (cull_tables.shadow_visibility_lists)
    with the scale hit_extents_cuda would write (cull_tables.extent_scale),
    against the JAX function on the same rows; K at the scene's list
    capacity, or 4 so that rows overflow. The wrapper refuses the CPU
    tensors, launching nothing."""
    ext, lights, centers, radii = _seeded(n, seed=n + 7)
    K = ct.list_capacity(n) if cap else 4
    e, L, C, R = _torch(ext, lights, centers, radii)
    scale = ct.extent_scale(e).reshape(1)
    sl.reset_launch_counts()
    with pytest.raises(ValueError, match="shadow_lists_cuda takes CUDA tensors, got cpu"):
        sl.shadow_lists_cuda(e, scale, L, C, R, K=K, compat=compat)
    idx, cnt = ct.shadow_visibility_lists(e, L, C, R, K=K, compat=compat, scale=scale)
    assert sl.LAUNCHES["shadow_lists"] == 0
    k = min(K, n)
    assert idx.dtype == cnt.dtype == torch.int32
    assert idx.shape == (40 * 3 * k,) and cnt.shape == (40 * 3,)
    idx_j, cnt_j = jp._shadow_visibility_lists(*(jnp.asarray(a) for a in
                                                 (ext, lights, centers, radii)),
                                               nl=3, K=K, compat=compat)
    np.testing.assert_array_equal(cnt.numpy(), np.asarray(cnt_j))
    assert _rows(idx, cnt) == _rows(idx_j, cnt_j)
    # slots past a count hold 0; sky rows keep nothing; the rows around a
    # light keep every sphere (-1 where that is more than k)
    slots = idx.reshape(-1, k)
    for r, c in enumerate(cnt.tolist()):
        assert (slots[r, c if c >= 0 else k:] == 0).all()
    sky = np.repeat(ext[:, 6] == 0, 3)
    assert (cnt.numpy()[sky] == 0).all() and sky.any()
    rows = ct.shadow_rows(e, L, C, R, compat=compat)
    assert not bool(rows.cull_ok.all())
    whole = (~rows.cull_ok & rows.has[:, None]).reshape(-1).numpy()
    assert (cnt.numpy()[whole] == (n if n <= k else -1)).all()
    if not cap:
        assert int((cnt == -1).sum()) > int(whole.sum())     # tested rows overflow too


def test_entry_point_takes_the_scale_it_is_given():
    """The plain rows with the scale passed equal those with the scale the
    function derives from the rows; a larger scale widens the slack and can
    only keep more."""
    ext, lights, centers, radii = _seeded(100, seed=3)
    e, L, C, R = _torch(ext, lights, centers, radii)
    base = ct.shadow_visibility_lists(e, L, C, R, K=100, compat=True)
    given = ct.shadow_visibility_lists(e, L, C, R, K=100, compat=True,
                                       scale=ct.extent_scale(e).reshape(1))
    assert all(torch.equal(a, b) for a, b in zip(base, given))
    wide = ct.shadow_visibility_lists(e, L, C, R, K=100, compat=True,
                                      scale=torch.tensor([1e5]))
    assert bool((wide[1] >= base[1]).all())
    for a, b in zip(_rows(*base), _rows(*wide)):
        assert set(a) <= set(b)


def test_extent_scale_ignores_rows_without_hits():
    """The scale is the largest |coordinate| of the rows with hits, as
    shadow_visibility_lists takes it inside (cull_tables.py: the sentinel
    rows must not feed it); 0 where no row has hits."""
    ext = _seeded(24, seed=5)[0]
    has = ext[:, 6] > 0.5
    want = np.maximum(np.abs(ext[has, 0:3]), np.abs(ext[has, 3:6])).max()
    got = ct.extent_scale(torch.from_numpy(ext))
    assert got.dtype == torch.float32 and got.shape == () and float(got) == float(want)
    assert float(want) < 1e29
    sky = ext.copy()
    sky[:, 6] = 0
    assert float(ct.extent_scale(torch.from_numpy(sky))) == 0.0
    assert float(ct.extent_scale(torch.zeros((0, 8)))) == 0.0


def test_hit_extents_wrapper_writes_the_plain_scale(monkeypatch):
    """hit_extents_cuda refuses CPU tensors and leaves the scale buffer it is
    given as it was; large_scene_tables, its table launches standing in by
    their plain versions (tests/torch_plain_launch.py), writes extent_scale of
    the plain rows (the plain hit_extents_plain's) into its lists' slack; the
    buffer check refuses other shapes and types."""
    cam = trt.Camera.build((40, 24), [-7.0, 0.0, 3.0], [0.0, 10.0, 0.0], device="cpu")
    scene = trt.random_scene(30, generator=torch.Generator().manual_seed(4), device="cpu")
    scale = torch.full((1,), float("nan"))
    with pytest.raises(ValueError, match="hit_extents_cuda takes CUDA tensors, got cpu"):
        hx.hit_extents_cuda(cam, scene, aliasing=True, compat=True, scale=scale)
    assert bool(torch.isnan(scale).all()) and hx.LAUNCHES["hit_extents"] == 0
    ext = hx.hit_extents_plain(cam, scene, aliasing=True, compat=True)
    assert int((ext[:, 6] == 0).sum()) > 0 and float(ct.extent_scale(ext)) < 1e29
    plain_tables(monkeypatch.setattr)
    _, shadow, _, _ = render_cuda.large_scene_tables(cam, scene, depth=0, aliasing=True,
                                                     compat=True)
    want = ct.shadow_visibility_lists(ext, scene.lights.position, scene.spheres.center,
                                      scene.spheres.radius, K=shadow[2], compat=True,
                                      scale=ct.extent_scale(ext).reshape(1))
    assert torch.equal(shadow[0], want[0]) and torch.equal(shadow[1], want[1])
    with pytest.raises(ValueError, match="scale"):
        hx.check_scale(torch.zeros(2), torch.device("cpu"))
    with pytest.raises(ValueError, match="scale"):
        hx.check_scale(torch.zeros(1, dtype=torch.float64), torch.device("cpu"))


@pytest.mark.parametrize("aliasing", [False, True])
def test_large_scene_tables_on_the_cpu_are_unchanged(monkeypatch, aliasing):
    """The render path's lists on CPU tensors, its table launches standing
    in by their plain versions (tests/torch_plain_launch.py): the plain hit
    extents, then the plain lists with the scale they derive themselves."""
    cam = trt.Camera.build((64, 48), [-7.0, 0.0, 3.0], [0.0, 10.0, 0.0], device="cpu")
    scene = trt.random_scene(60, generator=torch.Generator().manual_seed(9), device="cpu")
    plain_tables(monkeypatch.setattr)
    vis, shadow, _, _ = render_cuda.large_scene_tables(cam, scene, depth=2,
                                                       aliasing=aliasing, compat=True)
    ext = hx.hit_extents_plain(cam, scene, aliasing=aliasing, compat=True, vis=vis)
    k = ct.list_capacity(60)
    want = ct.shadow_visibility_lists(ext, scene.lights.position, scene.spheres.center,
                                      scene.spheres.radius, K=k, compat=True)
    assert shadow[2] == k
    assert torch.equal(shadow[0], want[0]) and torch.equal(shadow[1], want[1])


def test_launch_checks_its_inputs():
    """The kernel's launch raises on what the kernel does not take, before it
    loads the library."""
    ext, lights, centers, radii = _seeded(24, seed=1, n_tiles=8)
    e, L, C, R = _torch(ext, lights, centers, radii)
    order = ct.light_order(L, C, R).to(torch.int32)
    scale = ct.extent_scale(e).reshape(1)

    def run(**kw):
        args = dict(idx=torch.zeros(8 * 3 * 4, dtype=torch.int32),
                    cnt=torch.zeros(8 * 3, dtype=torch.int32), ext=e, scale=scale,
                    lights=L, centers=C, radii=R, order=order)
        args.update(kw)
        sl.launch(*args.values(), k=4, compat=True)
    for bad, match in ((dict(order=order.long()), "order"),
                       (dict(ext=e[:, :7].contiguous()), "hit-extent rows"),
                       (dict(cnt=torch.zeros(8 * 3 - 1, dtype=torch.int32)), "counts"),
                       (dict(idx=torch.zeros(8 * 3 * 5, dtype=torch.int32)), "indices"),
                       (dict(centers=C.double()), "centers"),
                       (dict(scale=scale.reshape(())), "scale")):
        with pytest.raises(ValueError, match=match):
            run(**bad)
    with pytest.raises(ValueError, match="k=30"):
        sl.launch(torch.zeros(8 * 3 * 30, dtype=torch.int32),
                  torch.zeros(8 * 3, dtype=torch.int32), e, scale, L, C, R, order, k=30,
                  compat=True)


def _brute_tests(ext, lights, centers, radii, K, compat):
    """Per (tile, light) row, in numpy float32 operation for operation like
    cull_tables.shadow_rows: the capsule-and-cone tests the row needs before
    it is decided (0 for a row without hits or whose cone is not defined, all
    spheres for a row that keeps at most k, up to the (k + 1)-th kept one for
    a row that overflows), whether it overflowed there, and whether its tile
    has hits."""
    T, nl, ns = ext.shape[0], lights.shape[0], centers.shape[0]
    k = min(K, ns)

    def dot(a, b):
        return (a[0] * b[0] + a[1] * b[1]) + a[2] * b[2]
    has = ext[:, 6] > f32(0.5)
    coord = max([f32(0.0)] + [max(abs(v) for v in ext[t, :6]) for t in range(T) if has[t]])
    slack = max(f32(2e-6) * max(coord, np.abs(lights).max()), f32(1e-3))
    extent = f32(999.0) if compat else f32(1e9)
    tests = np.zeros((T, nl), np.int64)
    over = np.zeros((T, nl), bool)
    for li in range(nl):
        Lp = lights[li]
        ang = [radii[j] / max(np.sqrt(dot(centers[j] - Lp, centers[j] - Lp)), f32(1e-6))
               for j in range(ns)]
        order = np.argsort(-np.array(ang, f32), kind="stable")
        for t in range(T):
            if not has[t]:
                continue
            lo, hi = ext[t, 0:3], ext[t, 3:6]
            b, e = f32(0.5) * (lo + hi), f32(0.5) * (hi - lo)
            hdiag = np.sqrt(dot(e, e))
            s = Lp - b
            ss = max(dot(s, s), f32(1e-12))
            dlb = np.sqrt(ss)
            if not dlb > f32(2.0) * hdiag:
                continue
            u = s / dlb
            slope = hdiag / max(dlb - hdiag, f32(1e-6))
            rmink = np.sqrt(f32(1.0) + slope * slope)
            kept = 0
            for pos, j in enumerate(order):
                c, r = centers[j], radii[j]
                w = c - b
                ws = dot(w, s)
                tt = min(max(ws / ss, f32(0.0)), f32(1.0))
                d2 = (dot(w, w) - (f32(2.0) * tt) * ws) + (tt * tt) * ss
                reach = (r + hdiag) + slack
                v = c - Lp
                proj = dot(v, u)
                lat2 = max(dot(v, v) - proj * proj, f32(0.0))
                allow = proj * slope + (r + slack) * rmink
                keep = bool(d2 <= reach * reach) or bool(
                    proj > -r and proj < extent + r and lat2 <= allow * allow and
                    allow > f32(0.0))
                kept += keep
                if kept > k:
                    tests[t, li], over[t, li] = pos + 1, True
                    break
            else:
                tests[t, li] = ns
    return tests, over, has


@pytest.mark.parametrize("compat", [True, False])
def test_shadow_lists_work_counts_the_decided_tests(compat):
    """timing.shadow_lists_work against a brute-force count on rows with sky
    rows, overflowed rows and rows whose cone is not defined."""
    ext, lights, centers, radii = _seeded(20, seed=13, n_tiles=16, nl=2)
    K = 1       # the tested rows keep 0-3 spheres
    tests, over, has = _brute_tests(ext, lights, centers, radii, K, compat)
    cnt = ct.shadow_visibility_lists(*_torch(ext, lights, centers, radii), K=K,
                                     compat=compat)[1].reshape(16, 2).numpy()
    tested = tests > 0
    assert (~has).any() and (over & (tests < 20)).any() and (tested & ~over).any()
    assert (has[:, None] & ~tested & (cnt == -1)).any()        # a row around a light
    # the brute force decides as the plain function does
    np.testing.assert_array_equal(over, tested & (cnt == -1))
    assert (tests[tested & ~over] == 20).all()
    ops, nbytes = timing.shadow_lists_work(*_torch(ext, lights, centers, radii), K=K,
                                           compat=compat)
    want_ops = (int(has.sum()) * 2 * timing.SL_ROW + 2 * 20 * timing.SL_SPHERE +
                int(tests.sum()) * timing.SL_TEST)
    assert ops == want_ops
    assert nbytes == 32 * 16 + 4 + 16 * 20 + 12 * 2 + 4 * 2 * 20 + 4 * 16 * 2 * (K + 1)
