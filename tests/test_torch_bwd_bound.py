"""The backward kernel's bound (utils/timing.hard_bwd_work) and its launch
planner (render_bwd_cuda.plan), on the CPU.

The bound counts the work the hard render's gradient needs for this run's
inputs: the forward chain's traces from the plain trace's live counts
(timing.hard_chain_counts at timing.bwd_positions), the reverse sweep's
adjoints of each live hit and each chain, one add a chain into each slot it
touches. It is held to a hand count, to the old lower bound (timing.hard_work,
which counts the primary sweep and the slot sums only) and to depth. The
planner's plans fit a block's 227 KB of shared memory and deal every tile to
one block.
"""
import math

import pytest
import torch

import python_ray_tracer_tpu_torch as trt
from python_ray_tracer_tpu_torch import cli
from python_ray_tracer_tpu_torch.ops.cuda import render_bwd_cuda as rb
from python_ray_tracer_tpu_torch.utils import timing
from python_ray_tracer_tpu_torch.utils.config import RenderConfig

torch.set_num_threads(1)

MODES = ("cot_noaa", "cot_aa", "fused_noaa", "fused_aa")


def test_hard_bwd_work_is_the_hand_count():
    """One sphere filling a 4x4 view, one light, no plane, depth 0, fused
    without AA: 16 chains, each a live sphere hit."""
    scene = trt.Scene(trt.Spheres.build([([60.0, 0.0, 0.0], 50.0, trt.RED)], device="cpu"),
                      trt.Planes.build([], device="cpu"),
                      trt.Lights.build([[-2.0, 0.0, 30.0]], device="cpu"),
                      trt.Materials.build(device="cpu"))
    cam = trt.default_camera((4, 4), device="cpu")
    live = timing.hard_chain_counts(cam, scene, timing.bwd_positions(4, 4, False), depth=0)
    assert live.tolist() == [[16.0, 16.0, 0.0]]
    ops, nbytes = timing.hard_bwd_work(4, 4, 1, 0, 1, "fused_noaa", live)
    per_chain = (30          # ray generation
                 + 17 + 29   # closest-hit set-up, the one sphere's test
                 + 6 + 13    # the hit point and the sphere's normal
                 + 17 + 18 + 26   # the light: direction and Lambert, shadow set-up, one sphere test
                 + 95 + 32   # the trace's adjoint, the light's
                 + 104       # the sphere's quadratic root and normal adjoints
                 + 23        # the camera's adjoint
                 + 19 + 3 + 7    # adds: material, camera and loss; light; sphere slots
                 + 12)       # the loss
    assert ops == 16 * per_chain
    assert nbytes == 4 * (41 + 7 + 3) + 12 * 16 + 4 * (7 + 3 + 19)


def _scene(name):
    if name == "two":
        return cli.fit_scene_two_spheres(RenderConfig(), "cpu")
    return trt.default_scene(device="cpu")


@pytest.mark.parametrize("name", ["two", "demo"])
@pytest.mark.parametrize("mode", MODES)
def test_hard_bwd_work_is_above_the_lower_bound_and_grows_with_depth(name, mode):
    scene, (W, H) = _scene(name), (18, 12)
    cam = trt.default_camera((W, H), device="cpu")
    counts = (scene.spheres.count, scene.planes.count, scene.lights.count)
    pos = timing.bwd_positions(W, H, mode.endswith("_aa"))
    low = timing.hard_work(W, H, *counts, mode)
    prev = 0.0
    for depth in range(4):
        live = timing.hard_chain_counts(cam, scene, pos, depth=depth)
        ops, nbytes = timing.hard_bwd_work(W, H, *counts, mode, live)
        assert ops >= low[0]
        # hard_work gave the cotangent modes a loss slot too
        assert nbytes == low[1] - (0 if mode.startswith("fused") else 4)
        assert ops > prev
        prev = ops


@pytest.mark.parametrize("size", [(18, 12), (1, 7), (2, 2)])
def test_bwd_positions_are_the_distinct_aa_samples(size):
    """With AA: every interior pixel's 9 samples and every border pixel's
    centre, each position once; a zero cotangent drops its pixel's."""
    W, H = size
    pos = timing.bwd_positions(W, H, True)
    want = set()
    for x in range(W):
        for y in range(H):
            inner = 1 <= x <= W - 2 and 1 <= y <= H - 2
            for sx in ((-0.5, 0.0, 0.5) if inner else (0.0,)):
                for sy in ((-0.5, 0.0, 0.5) if inner else (0.0,)):
                    want.add((x + sx, y + sy))
    assert len(pos) == len(want) and {tuple(p) for p in pos.tolist()} == want
    g = torch.zeros((W, H, 3))
    g[0, 0, 1] = 1.0
    assert timing.bwd_positions(W, H, True, g).tolist() == [[0.0, 0.0]]
    assert len(timing.bwd_positions(W, H, False)) == W * H


@pytest.mark.parametrize("ns", [1, 2, 6, 16, 24])
def test_plan_fits_a_block(ns):
    for npl, nl in ((1, 1), (1, 3), (4, 34)):
        for mode in MODES:
            aa, fused = mode.endswith("_aa"), mode.startswith("fused")
            for W, H in ((1000, 1000), (37, 29), (1, 1), (1920, 1080)):
                p = rb.plan(ns, npl, nl, W, H, aa=aa, fused=fused, large=ns > 16)
                assert p.smem == rb.smem_bytes(ns, npl, nl, fused, aa, p.nt, p.cols)
                assert p.smem <= 227 * 1024 and p.nt in (32, 64, 128)
                assert p.cols == (ns <= 16)          # 24 spheres: the per-warp rows
                n = rb.n_tiles(W, H)
                assert 1 <= p.blocks <= min(n, rb.BLOCKS_PER_SM * rb.H100_SMS)
                assert (p.blocks - 1) * p.tiles < n <= p.blocks * p.tiles


def test_plan_of_the_fit_scene():
    """The fit CLI's scene at 1000x1000: 128 threads with the slot columns
    (48 slots, 24.6 KB), 4 blocks a multiprocessor, 8 tiles a block."""
    p = rb.plan(2, 1, 2, 1000, 1000, aa=False, fused=True, large=False)
    assert (p.nt, p.cols, p.tiles, p.blocks) == (128, True, 8, math.ceil(3969 / 8))
    assert p.smem == 4 * (41 + 14 + 9 + 6 + 48 * 128)


def test_plan_takes_rows_where_the_columns_do_not_fit():
    """16 spheres and 600 lights: no column layout fits 227 KB, the rows do."""
    p = rb.plan(16, 1, 600, 256, 256, aa=True, fused=True, large=False)
    assert not p.cols and p.smem <= 227 * 1024
    with pytest.raises(ValueError, match="shared memory"):
        rb.plan(16, 1, 100_000, 256, 256, aa=True, fused=True, large=False)
