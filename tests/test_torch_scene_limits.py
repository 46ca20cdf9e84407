"""Every kernel takes a scene of any size, on the CPU: the forms and plans.

Each kernel that stages the scene in one block's shared memory keeps its
staged form wherever the scene fits (the render kernel: 7753 spheres at 1
plane and 3 lights without the bounce tree, 5600 with it) and takes a global
form past it (``render_cuda.scene_form``: the sphere table and the bounce
tree read where they lie); the light-cell and list
kernels take their chunked form past 11620 and 9685 spheres. The backward
planners' staged form reaches 4104 / 4101 / 3994 / 3992 spheres hard and 3388
soft; the global form, which leaves the sphere table in device memory,
reaches 8208 / 8203 / 7989 / 7984 hard and 8228 soft; past those the third
form keeps the warps' rows in device memory and takes any scene. The limits
are the planners' own ``smem_bytes`` formulas, pinned here, and every plan
fits a block and agrees with its formula. The soft planner stages while the
scene fits; the hard planner takes the most threads a block either form
fits, staged where both do; neither takes the third form where another fits.
"""
import pytest

from python_ray_tracer_tpu_torch.ops.cuda import hit_extents_cuda as hx
from python_ray_tracer_tpu_torch.ops.cuda import light_cells_cuda as lc
from python_ray_tracer_tpu_torch.ops.cuda import render_bwd_cuda as rb
from python_ray_tracer_tpu_torch.ops.cuda import render_cuda
from python_ray_tracer_tpu_torch.ops.cuda import shadow_lists_cuda as sl
from python_ray_tracer_tpu_torch.ops.cuda import soft_bwd_cuda as sb
from python_ray_tracer_tpu_torch.ops.cuda import soft_cuda
from python_ray_tracer_tpu_torch.ops.cuda.cull_tables import LEAF, list_capacity, tree_box_words

MODES = ("cot_noaa", "cot_aa", "fused_noaa", "fused_aa")
NPL, NL = 1, 3
# Every band edge of every rule below, each side of it, up to 2^20 spheres.
BAND_EDGES = sorted({n + d for n in (16, 255, 1587, 1983, 2704, 3388, 3992, 3994, 4057,
                                     4101, 4104, 5600, 7753, 7984, 7989, 8203, 8208,
                                     8220, 8228, 9685, 11620)
                     for d in (0, 1)} | {1, 65535, 65536, 1 << 20})


def _largest(fits, start=1):
    n = start
    while fits(n + 1):
        n += 1
    return n


def _render_max(tree=False):
    return _largest(lambda n: render_cuda._smem_bytes(n, NPL, NL, tree)
                    <= render_cuda._SMEM_LIMIT)


def _hard_max(mode, staged):
    aa, fused = mode.endswith("_aa"), mode.startswith("fused")
    return _largest(lambda n: any(rb.smem_bytes(n, NPL, NL, fused, aa, nt, False, staged)
                                  <= rb.SMEM_LIMIT for nt in (128, 64, 32)), 17)


def _soft_max(fused, staged):
    return _largest(lambda n: sb.smem_bytes(n, NPL, NL, fused, 32, 1, 1, False, staged)
                    <= sb.SMEM_LIMIT)


def test_render_limits():
    assert (_render_max(), _render_max(tree=True)) == (7753, 5600)


@pytest.mark.parametrize("mode,staged,glob", [("cot_noaa", 4104, 8208),
                                              ("fused_noaa", 4101, 8203),
                                              ("cot_aa", 3994, 7989),
                                              ("fused_aa", 3992, 7984)])
def test_hard_planner_limits(mode, staged, glob):
    assert (_hard_max(mode, True), _hard_max(mode, False)) == (staged, glob)
    assert glob > _render_max()


@pytest.mark.parametrize("fused", [True, False])
def test_soft_planner_limits(fused):
    assert (_soft_max(fused, True), _soft_max(fused, False)) == (3388, 8228)
    assert _soft_max(fused, False) > _render_max()


@pytest.mark.parametrize("mode", MODES)
def test_every_rendered_scene_has_a_hard_plan(mode):
    """Every ns the render accepts without the tree, at 1000x1000 and at a
    slice of it; a large scene's plan has the most threads either form fits,
    staged where both do."""
    aa, fused = mode.endswith("_aa"), mode.startswith("fused")

    def fits(ns, nt, staged):
        return rb.smem_bytes(ns, NPL, NL, fused, aa, nt, False, staged) <= rb.SMEM_LIMIT
    for ns in range(1, _render_max() + 1):
        if render_cuda._smem_bytes(ns, NPL, NL) > render_cuda._SMEM_LIMIT:
            continue
        large = ns > render_cuda.CULL_MIN_SPHERES
        for W in (1000, 125):
            p = rb.plan(ns, NPL, NL, W, 1000, aa=aa, fused=fused, large=large)
            if large:
                assert p.nt == max(nt for nt in (128, 64, 32)
                                   if fits(ns, nt, True) or fits(ns, nt, False))
                assert p.staged == fits(ns, p.nt, True)
            else:
                assert p.staged
            assert p.smem == rb.smem_bytes(ns, NPL, NL, fused, aa, p.nt, p.cols, p.staged)
            assert p.smem <= rb.SMEM_LIMIT
            assert not (p.cols and not p.staged)


@pytest.mark.parametrize("ns,nt,staged", [(1000, 128, True), (1587, 128, True),
                                          (1588, 128, False), (1983, 128, False),
                                          (1984, 64, True), (2704, 64, True),
                                          (2705, 64, False), (3000, 64, False),
                                          (4057, 64, False), (4058, 32, True),
                                          (4101, 32, True), (4102, 32, False),
                                          (7753, 32, False)])
def test_hard_plan_form_bands(ns, nt, staged):
    """The fused no-AA step's plans at 1 plane and 3 lights, band by band
    (render_bwd_kernel.cuh's head)."""
    p = rb.plan(ns, NPL, NL, 256, 256, aa=False, fused=True, large=True)
    assert (p.nt, p.staged) == (nt, staged)


@pytest.mark.parametrize("fused", [True, False])
def test_every_rendered_scene_has_a_soft_plan(fused):
    for ns in range(1, _render_max() + 1):
        p = sb.plan(ns, NPL, NL, fused)
        assert p.staged == (ns <= 3388)
        assert p.smem == sb.smem_bytes(ns, NPL, NL, fused, p.nt, p.cap, p.cj, p.store_vis,
                                       p.staged)
        assert p.smem <= sb.SMEM_LIMIT


def test_planners_refuse_past_the_global_form():
    """Where the global form stops fitting a block (8208 spheres hard, 8228
    soft, at 1 plane and 3 lights), the third form, rows in device memory,
    starts: exactly there, in both planners, and not a sphere earlier."""
    for ns, rows in ((8208, False), (8209, True)):
        p = rb.plan(ns, NPL, NL, 64, 64, aa=False, fused=False, large=True)
        assert (p.staged, p.device_rows) == (False, rows)
        assert p.smem == rb.smem_bytes(ns, NPL, NL, False, False, p.nt, False, False, rows)
    for ns, rows in ((8228, False), (8229, True)):
        p = sb.plan(ns, NPL, NL, True)
        assert (p.staged, p.device_rows) == (False, rows)
        assert p.smem == sb.smem_bytes(ns, NPL, NL, True, p.nt, p.cap, p.cj, p.store_vis,
                                       False, rows)
    with pytest.raises(ValueError, match="backward kernel"):
        rb.plan(8209, NPL, NL, 64, 64, aa=False, fused=False, large=True, device_rows=False)
    with pytest.raises(ValueError, match="soft backward"):
        sb.plan(8229, NPL, NL, True, device_rows=False)


def test_small_scenes_are_always_staged():
    """The contracted (small-scene) kernels have no global form: a scene of
    at most 16 spheres always fits staged, many lights and planes or not."""
    for npl, nl in ((1, 3), (4, 34), (16, 64)):
        for mode in MODES:
            p = rb.plan(16, npl, nl, 64, 64, aa=mode.endswith("_aa"),
                        fused=mode.startswith("fused"), large=False)
            assert p.staged


def test_global_form_leaves_out_only_the_sphere_table():
    for ns in (17, 1000, 7753):
        for mode in MODES:
            aa, fused = mode.endswith("_aa"), mode.startswith("fused")
            for nt in (32, 64, 128):
                a = rb.smem_bytes(ns, NPL, NL, fused, aa, nt, False, True)
                b = rb.smem_bytes(ns, NPL, NL, fused, aa, nt, False, False)
                assert a - b == 4 * 7 * ns
        for nt in (32, 128):
            a = sb.smem_bytes(ns, NPL, NL, True, nt, 4, 4, True, True)
            b = sb.smem_bytes(ns, NPL, NL, True, nt, 4, 4, True, False)
            assert a - b == 4 * 10 * ns



def test_planners_give_one_form_on_request():
    """``staged`` True or False: that form's plan alone; a small scene has no
    global form."""
    for mode in MODES:
        aa, fused = mode.endswith("_aa"), mode.startswith("fused")
        for staged in (True, False):
            p = rb.plan(1000, NPL, NL, 256, 256, aa=aa, fused=fused, large=True, staged=staged)
            assert p.staged == staged and p.nt == 128
        with pytest.raises(ValueError):
            rb.plan(4200, NPL, NL, 256, 256, aa=aa, fused=fused, large=True, staged=True)
        with pytest.raises(ValueError):
            rb.plan(16, NPL, NL, 256, 256, aa=aa, fused=fused, large=False, staged=False)
    for fused in (True, False):
        assert not sb.plan(100, NPL, NL, fused, staged=False).staged
        assert sb.plan(100, NPL, NL, fused) == sb.plan(100, NPL, NL, fused, staged=True)
        with pytest.raises(ValueError):
            sb.plan(3389, NPL, NL, fused, staged=True)


def test_forward_form_limits():
    """The staged forms' limits stay where they were (1 plane, 3 lights); the
    forward forms are staged and global, nothing between."""
    def largest(fits):
        return max(n for n in range(1, 30000) if fits(n))
    assert largest(lambda n: render_cuda.scene_form(n, NPL, NL) == 0) == 7753
    assert largest(lambda n: render_cuda.scene_form(n, NPL, NL, True) == 0) == 5600
    assert {render_cuda.scene_form(n, NPL, NL, t) for n in (1, 7753, 7754, 1 << 20)
            for t in (False, True)} == {0, 1}
    assert largest(lambda n: soft_cuda.form(n, NPL, NL) == 0) == 8220
    assert largest(lambda n: lc.chunk_spheres(n) == 0) == 11620
    assert largest(lambda n: sl.chunk_spheres(n) == 0) == 9685


@pytest.mark.parametrize("ns", BAND_EDGES)
def test_every_scene_size_has_a_form_and_a_plan(ns):
    """At every band edge up to 2^20 spheres each kernel has a form that fits
    a block (the staged form wherever it fits), and both backward planners a
    plan, in every mode; no scene is refused for its size."""
    limit = render_cuda.SMEM_BLOCK
    for tree in (False, True):
        f = render_cuda.scene_form(ns, NPL, NL, tree)
        staged = render_cuda._smem_bytes(ns, NPL, NL, tree)
        assert (f == 0) == (staged <= render_cuda._SMEM_LIMIT)
        left = staged
        if f and ns > 16:
            left -= 28 * ns
            if tree:
                n_leaves = -(-ns // LEAF)
                left -= 4 * (tree_box_words(n_leaves) + n_leaves * LEAF)
        assert left <= render_cuda._SMEM_LIMIT
        k = list_capacity(ns) if ns > 16 else 0
        hb = hx.staged_bytes(ns, NPL, True, k, None)
        assert render_cuda.scene_form(ns, NPL, NL, False, hb, limit) in (0, 1)
    assert soft_cuda.form(ns, NPL, NL) == (0 if soft_cuda.staged_bytes(ns, NPL, NL) <= limit
                                           else 1)
    for chunk, words in ((lc.chunk_spheres(ns), 5), (sl.chunk_spheres(ns), 6)):
        assert 4 * words * (chunk or ns) <= limit
    for mode in MODES:
        aa, fused = mode.endswith("_aa"), mode.startswith("fused")
        p = rb.plan(ns, NPL, NL, 1000, 1000, aa=aa, fused=fused, large=ns > 16)
        assert p.smem <= rb.SMEM_LIMIT
        assert p.smem == rb.smem_bytes(ns, NPL, NL, fused, aa, p.nt, p.cols, p.staged,
                                       p.device_rows)
        assert p.device_rows == (ns > {"cot_noaa": 8208, "fused_noaa": 8203,
                                       "cot_aa": 7989, "fused_aa": 7984}[mode])
        assert rb.scratch_floats(ns, NPL, NL, p) == (
            p.blocks * p.nt // 32 * (7 * ns + 9 * NPL + 3 * NL) if p.device_rows else 0)
    for fused in (True, False):
        p = sb.plan(ns, NPL, NL, fused)
        assert p.smem <= sb.SMEM_LIMIT and p.device_rows == (ns > 8228)
        assert p.staged == (ns <= 3388)


@pytest.mark.parametrize("ns", [8229, 16384, 65536])
def test_soft_device_rows_grid_is_the_cards(ns):
    """The soft third form's grid is the card's size whatever the frame:
    its scratch and partials at fit_scene_soft's 1000x1000 equal those at
    1080p, and the other forms keep one block a pixel group."""
    p = sb.plan(ns, NPL, NL, True)
    assert p.device_rows
    groups = {res: sb.n_blocks(*res, p._replace(device_rows=False))
              for res in ((64, 64), (1000, 1000), (1920, 1080))}
    for res, g in groups.items():
        want = min(g, sb.H100_SMS * max(1, min(sb.BLOCKS_PER_SM,
                                                sb.SM_SMEM // (p.smem + 1024))))
        assert sb.n_blocks(*res, p) == want
    assert groups[(64, 64)] == 32 and sb.n_blocks(64, 64, p) == 32
    big = [sb.scratch_floats(ns, NPL, NL, True, *res, p) for res in ((1000, 1000),
                                                                     (1920, 1080))]
    assert big[0] == big[1] == sb.n_blocks(1000, 1000, p) * (p.nt // 32) * \
        sb.n_grads(ns, NPL, NL, True)
    assert 4 * big[0] <= 1.0e9 * ns / 65536


def test_soft_planner_objects():
    """The soft backward indexes objects in 21 bits (csrc/soft_bwd.cu
    GI_BITS): its planner refuses 2^21 objects and more, and only that."""
    sb.plan((1 << 21) - 2, NPL, NL, True)
    with pytest.raises(ValueError, match="objects"):
        sb.plan((1 << 21) - 1, NPL, NL, True)
