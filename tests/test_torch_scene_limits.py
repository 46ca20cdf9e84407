"""The backward kernels take every scene the render kernel takes, on the CPU.

The render stages a scene in one block's shared memory and refuses a larger
one (``render_cuda._check_inputs``: 7753 spheres at 1 plane and 3 lights
without the bounce tree, 5600 with it). Both backward planners must then
return a plan for every such scene, AA or not, fused or cotangent. The staged
form reaches 4104 / 4101 / 3994 / 3992 spheres hard and 3388 soft; the global
form, which leaves the sphere table in device memory, reaches 8208 / 8203 /
7989 / 7984 hard and 8228 soft, all past 7753. The limits are the planners'
own ``smem_bytes`` formulas, pinned here against the render's, and every plan
fits a block and agrees with its formula. The soft planner stages while the
scene fits; the hard planner takes the most threads a block either form
fits, staged where both do.
"""
import pytest

from python_ray_tracer_tpu_torch.ops.cuda import render_bwd_cuda as rb
from python_ray_tracer_tpu_torch.ops.cuda import render_cuda
from python_ray_tracer_tpu_torch.ops.cuda import soft_bwd_cuda as sb

MODES = ("cot_noaa", "cot_aa", "fused_noaa", "fused_aa")
NPL, NL = 1, 3


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
    with pytest.raises(ValueError, match="backward kernel"):
        rb.plan(8209, NPL, NL, 64, 64, aa=False, fused=False, large=True)
    with pytest.raises(ValueError, match="soft backward"):
        sb.plan(8229, NPL, NL, True)


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
