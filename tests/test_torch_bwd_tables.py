"""The hard backward through the render's large-scene tables, on the CPU: the
port's plain version against the JAX package's culled backward kernel (the
cone cull and the level-0 shadow lists, in interpret mode), the planner's
shared memory with the tables' words against a mirror of the kernel's
``bwd_smem_words``, the cull keywords against the JAX wrappers', the CPU
path that ignores them, the launch's argument checks, and the culled bound
(``utils/timing.hard_bwd_work_culled``). The kernels themselves, tables on
against off and the one-launch fused AA step against the two-launch one, run
on a card (tests/test_torch_card.py, chip_smoke.py phase 24)."""
import inspect

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import python_ray_tracer_tpu as jrt
from python_ray_tracer_tpu.ops.pallas import render_bwd as jb
import python_ray_tracer_tpu_torch as trt
from python_ray_tracer_tpu_torch.ops.cuda import cull_tables as ct
from python_ray_tracer_tpu_torch.ops.cuda import render_bwd_cuda as rb
from python_ray_tracer_tpu_torch.ops.cuda import render_cuda
from python_ray_tracer_tpu_torch.utils import timing

from .test_torch_grads import leaf_groups, noise, port_groups
from .test_torch_render import to_torch
from .torch_plain_launch import plain_launches, plain_tables

torch.set_num_threads(1)

CULLS = ("cull", "shadow_lists", "group_cull")


# Share of a leaf group's largest element below which an element is held to
# the group's scale and to the float64 witness instead of element by element:
# at seed 0 the one element off the rule is spheres.albedo[0, 2], 2.0e-5, 0.8%
# of its group's largest.
CANCEL = 1e-2


def test_plain_matches_the_jax_culled_backward():
    """32 random spheres 32x16, depth 1, no AA: the port's plain fused step
    against the JAX backward kernel with its cone cull and level-0 shadow
    lists on (interpret mode; its grouped fold stays off: ROADMAP Queue 3),
    under the JAX package's kernel rule (render_bwd_cuda.grad_rule): the
    geometry groups to max|d| / max|g| < 5e-2, the loss to rel 1e-5, and
    every other element at least CANCEL of its group's largest to rtol 1e-3 /
    atol 1e-7. An element below that is held to 1e-3 of its group's largest,
    and the plain version's float32 to its float64 witness (the same inputs,
    the arithmetic in float64) under the element rule: there the JAX
    kernel's float32 sits off both (albedo[0, 2]: JAX 2.0115e-5, plain
    2.0307e-5, float64 2.0285e-5)."""
    scene_j = jrt.random_scene(jax.random.key(0), n_spheres=32)
    cam_j = jrt.Camera.build((32, 16), [-12.0, 0.0, 4.0], [0.0, -15.0, 0.0])
    target = noise((32, 16), seed=5)
    loss_k, gs_k, gc_k = jb.loss_and_scene_grads_pallas(
        cam_j, scene_j, jnp.asarray(target), depth=1, compat=True, interpret=True,
        tile_w=8, tile_h=16, return_camera=True, cull=True, shadow_lists=True,
        group_cull=False)
    cam, scene = to_torch(cam_j, scene_j)
    flat = rb.loss_and_scene_grads_plain(cam, scene, torch.from_numpy(target), depth=1)
    got, loss = port_groups(flat, scene)
    cam64 = trt.Camera(cam.position.double(), cam.rotation.double(), cam.fov.double(),
                       cam.resolution)
    scene64 = trt.Scene.from_leaves([t.double() for t in scene.leaves()])
    witness, _ = port_groups(rb.loss_and_scene_grads_plain(
        cam64, scene64, torch.from_numpy(target).double(), depth=1), scene)
    assert float(loss) == pytest.approx(float(loss_k), rel=1e-5)
    want = leaf_groups(gs_k, gc_k)
    for path in want:
        if not want[path].size:
            continue
        g, w = got[path], want[path]
        scale = np.abs(w).max()
        if path in rb.GEOMETRY_GROUPS:
            assert np.abs(g - w).max() <= 5e-2 * scale, path
            continue
        big = np.abs(w) >= CANCEL * scale
        np.testing.assert_allclose(g[big], w[big], rtol=1e-3, atol=1e-7, err_msg=path)
        assert np.abs(g - w)[~big].max(initial=0.0) <= 1e-3 * scale, path
        np.testing.assert_allclose(g[~big], witness[path][~big], rtol=1e-3, atol=1e-7,
                                   err_msg=path)


def _smem_mirror(ns, npl, nl, fused, aa, nt, cols, staged, rows, tab, one):
    """render_bwd_kernel.cuh bwd_smem_words, in bytes."""
    mat = 7 * ns + 9 * npl + 3 * nl
    n = mat + 18 + int(fused)
    words = 41 + mat - (0 if staged else 7 * ns) + tab + (3 * 1089 if one else 0) + \
        (6 * 256 if aa else 0)
    words += n * nt if cols else (nt // 32 * mat if rows else 0) + (n - mat) * nt
    return 4 * words


@pytest.mark.parametrize("ns", [100, 1000, 5000, 16384])
def test_smem_counts_the_tables(ns):
    """The planner's shared memory with the tables' words (a tile's lists in
    every form; the bounce tree only where the staged form copies it) is the
    kernel's, in every form it takes at this scene, with and without the
    one-launch AA step's colors."""
    npl, nl = 1, 3
    cam = trt.Camera.build((64, 32), [-12.0, 0.0, 4.0], [0.0, -15.0, 0.0], device="cpu")
    scene = trt.random_scene(ns, generator=torch.Generator().manual_seed(0), device="cpu")
    k = ct.list_capacity(ns)
    n_leaves = -(-ns // ct.LEAF)
    tree = ct.bounce_tree(scene.spheres.center, scene.spheres.radius)
    tabs = ((torch.zeros(8 * k, dtype=torch.int32), torch.zeros(8, dtype=torch.int32), k),
            (torch.zeros(8 * nl * k, dtype=torch.int32), torch.zeros(8 * nl, dtype=torch.int32),
             k, 1), tree, None)
    lists = k + nl * (k + 1)
    tree_w = ct.tree_box_words(n_leaves) + n_leaves * ct.LEAF
    assert rb.table_words(tabs, nl) == (lists, tree_w)
    assert rb.table_words((*tabs[:2], None, None), nl) == (lists, 0)
    for aa, fused, one in ((False, True, False), (True, False, False), (True, True, False),
                           (True, True, True)):
        for nt in (32, 64, 128):
            for staged, rows in ((True, True), (False, True), (False, False)):
                tab = lists + (tree_w if staged else 0)
                assert rb.smem_bytes(ns, npl, nl, fused, aa, nt, False, staged, not rows, tab,
                                     one) == _smem_mirror(ns, npl, nl, fused, aa, nt, False,
                                                          staged, rows, tab, one)
        p = rb.plan(ns, npl, nl, *cam.resolution, aa=aa, fused=fused, large=True,
                    lists=lists, tree=tree_w, one_launch=one)
        assert p.smem == _smem_mirror(ns, npl, nl, fused, aa, p.nt, False, p.staged,
                                      not p.device_rows, lists + tree_w * p.tree_smem,
                                      one) <= rb.SMEM_LIMIT
        assert not p.tree_smem or p.staged
        # the tree staged only where that keeps the plan without it
        q = rb.plan(ns, npl, nl, *cam.resolution, aa=aa, fused=fused, large=True,
                    lists=lists, tree=tree_w, one_launch=one, tree_smem=False)
        assert (q.nt, q.staged, q.device_rows, q.blocks) == (p.nt, p.staged, p.device_rows,
                                                             p.blocks)
        assert p.tree_smem == (p.staged and rb.SM_SMEM // (q.smem + 4 * tree_w + 1024)
                               >= min(rb.BLOCKS_PER_SM, rb.SM_SMEM // (q.smem + 1024))
                               and q.smem + 4 * tree_w <= rb.SMEM_LIMIT)


def test_cull_keywords_match_the_jax_wrappers():
    pairs = ((rb.scene_grads_cuda, jb.scene_grads_pallas),
             (rb.loss_and_scene_grads_cuda, jb.loss_and_scene_grads_pallas))
    for fn, jfn in pairs:
        got, want = inspect.signature(fn).parameters, inspect.signature(jfn).parameters
        for name in CULLS:
            assert got[name].default == want[name].default, (fn.__name__, name)


@pytest.mark.parametrize("culls", [dict(cull=False), dict(shadow_lists=False),
                                   dict(group_cull=True), dict(cull=False, shadow_lists=False,
                                                               group_cull=False)])
@pytest.mark.parametrize("aliasing", [False, True])
def test_cpu_tensors_with_cull_keywords_take_the_plain_version(culls, aliasing, monkeypatch):
    """A 20-sphere scene (the large-scene path on a card) on CPU tensors: both
    wrappers refuse them whatever the cull keywords, launching and computing
    nothing; the plain versions are reached by name. With the launches
    standing in for the card (tests/torch_plain_launch.py), the wrappers'
    glue takes every cull keyword and returns the plain version's numbers in
    both return forms."""
    cam = trt.Camera.build((12, 8), [-12.0, 0.0, 4.0], [0.0, -15.0, 0.0], device="cpu")
    scene = trt.random_scene(20, generator=torch.Generator().manual_seed(3), device="cpu")
    target = torch.from_numpy(noise((12, 8), seed=6))
    kw = dict(depth=1, aliasing=aliasing, **culls)
    rb.reset_launch_counts()
    with pytest.raises(ValueError, match="loss_and_scene_grads_cuda takes CUDA tensors, got cpu"):
        rb.loss_and_scene_grads_cuda(cam, scene, target, return_camera=True, **kw)
    with pytest.raises(ValueError, match="scene_grads_cuda takes CUDA tensors, got cpu"):
        rb.scene_grads_cuda(cam, scene, target, **kw)
    assert rb.PLAIN_CALLS == {"scene_grads": 0, "loss_and_scene_grads": 0}
    assert not any(rb.LAUNCHES.values()) and not any(rb.TABLE_LAUNCHES.values())
    flat = rb.loss_and_scene_grads_plain(cam, scene, target, depth=1, aliasing=aliasing)
    plain = rb.scene_grads_plain(cam, scene, target, depth=1, aliasing=aliasing)
    plain_launches(monkeypatch.setattr)
    loss, sg, cg = rb.loss_and_scene_grads_cuda(cam, scene, target, return_camera=True, **kw)
    torch.testing.assert_close(rb.flatten_grads(sg, cg, loss), flat, rtol=0, atol=0)
    g = rb.scene_grads_cuda(cam, scene, target, **kw)
    torch.testing.assert_close(rb.flatten_grads(g)[:-13], plain[:-13], rtol=0, atol=0)
    assert rb.PLAIN_CALLS == {"scene_grads": 2, "loss_and_scene_grads": 2}
    assert not any(rb.LAUNCHES.values()) and not any(rb.TABLE_LAUNCHES.values())
    with pytest.raises(ValueError, match="aa_form"):
        rb.loss_and_scene_grads_cuda(cam, scene, target, aa_form="three")


def test_launch_refuses_what_the_kernel_does_not_take(monkeypatch):
    """Checked before any library is loaded: the one-launch form outside
    fused_aa, tables on a small scene, the tree staged without a tree or in
    the global form."""
    cam = trt.Camera.build((32, 16), [-12.0, 0.0, 4.0], [0.0, -15.0, 0.0], device="cpu")
    small = trt.random_scene(8, generator=torch.Generator().manual_seed(1), device="cpu")
    large = trt.random_scene(40, generator=torch.Generator().manual_seed(1), device="cpu")

    def go(scene, mode, **kw):
        counts = (scene.spheres.count, scene.planes.count, scene.lights.count)
        shape = rb.plan(*counts, 32, 16, aa=mode.endswith("_aa"), fused=True,
                        large=counts[0] > 16, staged=kw.pop("staged", None))
        shape = shape._replace(tree_smem=kw.pop("tree", False))
        n = rb.n_grads(*counts, True)
        return rb.launch(torch.empty(n), torch.empty(n * shape.blocks),
                         render_cuda.pack_params(cam, scene, True),
                         render_cuda.scene_tables(scene), counts, image=None,
                         target=torch.zeros((32, 16, 3)), W=32, H=16, depth=1, mode=mode,
                         compat=True, cheap_shadow=True, shape=shape, **kw)
    with pytest.raises(ValueError, match="one-launch"):
        go(small, "fused_noaa", one_launch=True)
    plain_tables(monkeypatch.setattr)
    tabs = render_cuda.large_scene_tables(cam, large, depth=1, aliasing=True, compat=True,
                                          group_cull=True)
    with pytest.raises(ValueError, match="takes no large-scene table"):
        go(small, "fused_aa", tabs=tabs)
    with pytest.raises(ValueError, match="tree_smem"):
        go(large, "fused_aa", tabs=(*tabs[:2], None, tabs[3]), tree=True)
    with pytest.raises(ValueError, match="tree_smem"):
        go(large, "fused_aa", tabs=tabs, tree=True, staged=False)


@pytest.mark.parametrize("mode", ["cot_noaa", "fused_aa"])
def test_culled_bound_is_at_most_the_unculled(monkeypatch, mode):
    """40 spheres 48x32, depth 2: the culled bound of this frame's tables is
    at most hard_bwd_work's, below it where a list is short, and equal to it
    (operations) with every list row full and no tree."""
    W, H = 48, 32
    aa = mode.endswith("_aa")
    cam = trt.Camera.build((W, H), [-12.0, 0.0, 4.0], [0.0, -15.0, 0.0], device="cpu")
    scene = trt.random_scene(40, generator=torch.Generator().manual_seed(2), device="cpu")
    counts = (scene.spheres.count, scene.planes.count, scene.lights.count)
    pos = timing.bwd_positions(W, H, aa)
    live = timing.hard_chain_counts(cam, scene, pos, depth=2)
    hits0 = timing.level0_hits_by_tile(cam, scene, pos)
    assert float(hits0.sum()) == float(live[0, 1] + live[0, 2])
    plain_tables(monkeypatch.setattr)
    vis, shadow, tree, _ = render_cuda.large_scene_tables(cam, scene, depth=2, aliasing=aa,
                                                          compat=True, group_cull=True)
    full_ops, full_bytes = timing.hard_bwd_work(W, H, *counts, mode, live)
    ops, nbytes = timing.hard_bwd_work_culled(W, H, *counts, mode, live, pos, hits0, vis,
                                              shadow, tree)
    assert ops < full_ops and nbytes > full_bytes
    assert timing.bound_ms(ops, nbytes)[0] < timing.bound_ms(full_ops, full_bytes)[0]
    n_tiles = vis[1].numel()
    full_rows = [(torch.arange(40, dtype=torch.int32).repeat(rows), torch.full(
        (rows,), 40, dtype=torch.int32), 40) for rows in (n_tiles, n_tiles * 3)]
    same, _ = timing.hard_bwd_work_culled(W, H, *counts, mode, live, pos, hits0, *full_rows)
    assert same == full_ops
    overflow = [(r[0], torch.full_like(r[1], -1), r[2]) for r in full_rows]
    assert timing.hard_bwd_work_culled(W, H, *counts, mode, live, pos, hits0,
                                       *overflow)[0] == full_ops
    assert timing.position_tiles(pos, H).max() < n_tiles
