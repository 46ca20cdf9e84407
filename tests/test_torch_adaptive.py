"""The port's adaptive AA on the CPU (ops/adaptive.py, the wrapper's CPU path
and the CLI flags) against the JAX package's render_adaptive module, on the
same seeded images, scenes and cameras.

Tolerances. Flags and worklists are booleans and integers: equal. The tent
image repeats the JAX operations in the same order: within 1e-6 (both sides
are float32 elementwise ops; on these inputs they agree bit for bit). The whole
pipeline against the JAX function (its Pallas worklist kernel in interpret
mode): pixels more than 3e-5 apart (the JAX package's own kernel-against-kernel
bound, tests/test_adaptive.py) are near-tie flips of the centers or the
samples, and at most 0.1% of the pixels may be such flips or off by more than 1
uint8 level. The all-flagged identity against the port's plain 9-sample render
sums the same samples in another association and multiplies by float32(1/9)
where that render divides by 9: within 3e-5; against the JAX package's plain
render, tests/test_torch_render.py's port-against-JAX rule (the two plain ray
codes flip isolated near ties).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import python_ray_tracer_tpu as jrt
import python_ray_tracer_tpu_torch as trt
from python_ray_tracer_tpu.ops.pallas import render_adaptive as ja
from python_ray_tracer_tpu_torch import cli
from python_ray_tracer_tpu_torch.ops import adaptive as A
from python_ray_tracer_tpu_torch.utils import timing

from .test_torch_render import compare_images, to_torch

torch.set_num_threads(1)
FLIP_FRAC = 1e-3
ATOL = 3e-5


def _centers(seed, w=32, h=24):
    """A seeded (r, g, b) image with smooth and rough regions: cumulative sums
    of uniform noise along x, so second differences vary pixel to pixel."""
    rng = np.random.default_rng(seed)
    return (np.cumsum(rng.random((w, h, 3), dtype=np.float32), axis=0) * 0.01
            ).astype(np.float32)


def _q(img):
    return np.asarray(trt.to_framebuffer(torch.tensor(np.asarray(img))), np.int32)


# --- curvature flags -----------------------------------------------------------------

@pytest.mark.parametrize("eps", [-1.0, 0.0, 0.5 / 255, 0.01, 0.05])
@pytest.mark.parametrize("shape", [(32, 24), (17, 9)])
def test_curvature_flags_match_jax(eps, shape):
    C = _centers(1, *shape)
    want = np.asarray(ja._curvature_flags(jnp.asarray(C), *shape, eps))
    got = A.curvature_flags(torch.from_numpy(C), eps)
    assert got.dtype == torch.bool and got.shape == shape
    np.testing.assert_array_equal(got.numpy(), want)


def test_curvature_flags_ramp_vs_edge():
    """tests/test_adaptive.py's case: a steep linear ramp never flags away from
    the wrap-around ring; a step edge flags with its dilation ring; the
    border never flags."""
    w, h = 32, 24
    x = torch.arange(w, dtype=torch.float32)[:, None] * torch.ones((1, h))
    ramp = torch.stack([x * 0.1] * 3, dim=-1)
    assert not bool(A.curvature_flags(ramp, 0.5 / 255)[2:-2].any())
    step = torch.stack([(x >= 16).float()] * 3, dim=-1)
    f = A.curvature_flags(step, 0.5 / 255).numpy()
    np.testing.assert_array_equal(
        f, np.asarray(ja._curvature_flags(jnp.asarray(step.numpy()), w, h, 0.5 / 255)))
    assert f[15:18, 2:h - 2].all()
    assert not f[3:13].any() and not f[20:-3].any()
    assert not f[:, 0].any() and not f[:, -1].any()


# --- tent image ----------------------------------------------------------------------

@pytest.mark.parametrize("compat", [True, False])
@pytest.mark.parametrize("seed", [0, 1])
def test_tent_image_matches_jax(compat, seed):
    C = _centers(seed, 24, 20)
    want = np.asarray(ja._tent_image(jnp.asarray(C), 24, 20, compat))
    got = A.tent_image(torch.from_numpy(C), compat).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)


def test_tent_exact_on_linear_field():
    """On a linear field of small integers every weight, product and sum is
    exact, so the interior of the clean tent image IS the field, and under
    compat its (r, g, b) read back as (r, (b + 8 g) / 9, (g + 8 b) / 9), the
    compat 9-sample average of a linear field."""
    w, h = 16, 12
    x = torch.arange(w, dtype=torch.float32)[:, None] * torch.ones((1, h))
    y = torch.ones((w, 1)) * torch.arange(h, dtype=torch.float32)[None, :]
    lin = torch.stack([3 * x + y, 2 * x, 5 * y], dim=-1)
    t = A.tent_image(lin, compat=False)
    assert torch.equal(t[1:-1, 1:-1], lin[1:-1, 1:-1])
    assert torch.equal(t[0], lin[0]) and torch.equal(t[:, -1], lin[:, -1])
    tc = A.tent_image(lin, compat=True)
    r, g, b = lin[1:-1, 1:-1].unbind(-1)
    assert torch.equal(tc[1:-1, 1:-1, 0], r)
    assert torch.equal(tc[1:-1, 1:-1, 1], (b + 9.0 * g - g) / 9.0)
    assert torch.equal(tc[1:-1, 1:-1, 2], (g + 9.0 * b - b) / 9.0)


# --- compaction ----------------------------------------------------------------------

@pytest.mark.parametrize("frac,budget", [(0.3, 1.0), (0.3, 0.25), (0.3, 0.05), (0.0, 0.25),
                                         (1.0, 0.5)])
def test_compact_matches_jax_nonzero(frac, budget):
    w, h = 20, 14
    flags = np.random.default_rng(3).random((w, h)) < frac
    K = A.budget_slots(w, h, budget)
    assert K == max(1, min(int(budget * w * h), w * h))
    (want,) = jnp.nonzero(jnp.asarray(flags.reshape(-1)), size=K, fill_value=w * h)
    idx, flagged, dropped = A.compact(torch.from_numpy(flags), K)
    assert idx.dtype == flagged.dtype == dropped.dtype == torch.int32
    assert idx.shape == (K,) and flagged.dim() == 0 and dropped.dim() == 0
    np.testing.assert_array_equal(idx.numpy(), np.asarray(want))
    assert int(flagged) == int(flags.sum())
    assert int(dropped) == max(int(flags.sum()) - K, 0)


# --- the whole pipeline ----------------------------------------------------------------

def test_adaptive_plain_matches_jax_kernel():
    """One call of the JAX function (the Pallas worklist kernel in interpret
    mode) at 64x48 against the plain pipeline: the same flags and stats, and
    the frames within the flip rule."""
    W, H = 64, 48
    cam_j = jrt.Camera.build((W, H), position=[-2.0, 0.0, 2.0], euler=[0.0, -30.0, 0.0])
    scene_j = jrt.default_scene()
    want, sj = ja.render_image_adaptive(cam_j, scene_j, depth=2, compat=True,
                                        eps=0.5 / 255, budget_frac=1.0, with_stats=True,
                                        tile_w=8, tile_h=32, interpret=True)
    cam, scene = to_torch(cam_j, scene_j)
    got, st = A.render_image_adaptive_plain(cam, scene, depth=2, compat=True,
                                            eps=0.5 / 255, budget_frac=1.0,
                                            with_stats=True)
    assert int(st["flagged"]) == int(sj["flagged"]) and int(st["dropped"]) == 0
    assert 0 < int(st["flagged"]) < W * H
    want = np.asarray(want)
    far = np.abs(got.numpy() - want).max(axis=-1) > ATOL
    flipped = np.abs(_q(got) - _q(want)).max(axis=0) > 1
    assert far.sum() <= FLIP_FRAC * W * H, f"{far.sum()} pixels off by > {ATOL}"
    assert flipped.sum() <= FLIP_FRAC * W * H


@pytest.mark.parametrize("compat", [True, False])
def test_all_flagged_identity_24_spheres(compat):
    """eps < 0 with a covering budget: every interior pixel is traced, so the
    frame is the port's plain 9-sample AA render of a 24-sphere JAX scene
    (within 3e-5), and so the JAX package's (under the port-against-JAX rule
    of tests/test_torch_render.py: its plain ray math flips near ties
    there)."""
    cam_j = jrt.Camera.build((32, 24), [-7.0, 0.0, 3.0], [0.0, -15.0, 0.0])
    scene_j = jrt.random_scene(jax.random.key(2), n_spheres=24)
    cam, scene = to_torch(cam_j, scene_j)
    want = np.asarray(jrt.render_image(cam_j, scene_j, depth=2, aliasing=True,
                                       compat=compat))
    got, st = A.render_image_adaptive_plain(cam, scene, depth=2, compat=compat, eps=-1.0,
                                            budget_frac=1.0, with_stats=True)
    assert int(st["flagged"]) == 30 * 22 and int(st["dropped"]) == 0
    plain = trt.render_image(cam, scene, depth=2, aliasing=True, compat=compat)
    assert float((got - plain).abs().max()) <= ATOL
    compare_images(got.numpy(), want)


def test_budget_overflow_keeps_tent_and_reports():
    """Pixels flagged past the budget keep the tent value, in pixel-index
    order; the first K listed pixels are those of the covering budget."""
    cam, scene = trt.default_camera((40, 30), device="cpu"), trt.default_scene(device="cpu")
    full, sf = A.render_image_adaptive_plain(cam, scene, eps=0.5 / 255, budget_frac=1.0,
                                             with_stats=True)
    part, sp = A.render_image_adaptive_plain(cam, scene, eps=0.5 / 255, budget_frac=0.1,
                                             with_stats=True)
    K = A.budget_slots(40, 30, 0.1)
    assert int(sp["flagged"]) == int(sf["flagged"]) > K
    assert int(sp["dropped"]) == int(sf["flagged"]) - K and int(sf["dropped"]) == 0
    C = A.stored_to_rgb(trt.render_image(cam, scene, aliasing=False), True)
    tent = A.tent_image(C, True).reshape(-1, 3)
    order = torch.nonzero(A.curvature_flags(C, 0.5 / 255).reshape(-1))[:, 0]
    kept, dropped = order[:K], order[K:]
    assert torch.equal(part.reshape(-1, 3)[kept], full.reshape(-1, 3)[kept])
    assert torch.equal(part.reshape(-1, 3)[dropped], tent[dropped])


def test_trace_worklist_chunks_and_count():
    """The chunked trace equals the one-block trace; slots at or past the
    count leave the image as it is."""
    cam, scene = trt.default_camera((24, 16), device="cpu"), trt.default_scene(device="cpu")
    img = torch.rand((24, 16, 3), generator=torch.Generator().manual_seed(0))
    idx = torch.tensor([30, 31, 100, 250, 24 * 16], dtype=torch.int32)
    one = A.trace_worklist_plain(cam, scene, idx, 4, img, depth=2, compat=True)
    chunked = A.trace_worklist_plain(cam, scene, idx, 4, img, depth=2, compat=True,
                                     chunk=3)
    assert torch.equal(one, chunked)
    changed = (one != img).any(dim=-1).reshape(-1)
    assert set(torch.nonzero(changed)[:, 0].tolist()) <= {30, 31, 100, 250}
    two = A.trace_worklist_plain(cam, scene, idx, torch.tensor(2, dtype=torch.int32), img,
                                 depth=2, compat=True)
    assert torch.equal(two.reshape(-1, 3)[:100], one.reshape(-1, 3)[:100])
    assert torch.equal(two.reshape(-1, 3)[100:], img.reshape(-1, 3)[100:])


def test_wrapper_cpu_path_is_the_plain_version():
    """The wrapper takes CUDA tensors only: on CPU tensors it raises, naming
    the device, and launches nothing. The plain version, by its own name,
    gives the same frame and stats each call."""
    from python_ray_tracer_tpu_torch.ops.cuda import adaptive_cuda, render_cuda
    cam, scene = trt.default_camera((20, 16), device="cpu"), trt.default_scene(device="cpu")
    kw = dict(depth=1, compat=False, eps=0.002, budget_frac=0.3)
    before = (dict(adaptive_cuda.LAUNCHES), dict(render_cuda.LAUNCHES))
    with pytest.raises(ValueError, match="render_image_adaptive_cuda takes CUDA tensors, got cpu"):
        trt.render_image_adaptive_cuda(cam, scene, **kw, with_stats=True)
    assert (dict(adaptive_cuda.LAUNCHES), dict(render_cuda.LAUNCHES)) == before
    a, sa = trt.render_image_adaptive_plain(cam, scene, **kw, with_stats=True)
    b, sb = trt.render_image_adaptive_plain(cam, scene, **kw, with_stats=True)
    assert torch.equal(a, b) and sa == sb
    assert torch.equal(trt.render_image_adaptive_plain(cam, scene, **kw), a)


def test_adaptive_work_counts_listed_chains():
    idx = torch.arange(1200, dtype=torch.int32)
    ops, nbytes = timing.adaptive_work(idx, 1000, 40, 6, 1, 3)
    assert ops == 9 * 1000 * (timing.RAYGEN + timing.HIT_SETUP + 6 * timing.HIT_SPHERE
                              + timing.HIT_PLANE)
    assert nbytes == 4 * (41 + 42 + 9 + 9) + 4 + 16 * 1000
    assert timing.bound_ms(ops, nbytes)[1] == "operations"


def test_adaptive_work_sweeps_each_listed_pixel_tile_list():
    """With the cone-cull table each listed pixel's 9 chains sweep its 16x16
    tile's list (x tiles outermost; all ns where the row overflowed), and the
    table's bytes count; the unlisted slots past n_listed count nothing."""
    W, H, ns, k = 40, 20, 50, 8
    cnt = torch.tensor([3, -1, 0, 5, 2, 7], dtype=torch.int32)          # 3 x 2 tiles
    vis = (torch.zeros((6, k), dtype=torch.int32), cnt, k)
    px = [(0, 0), (17, 3), (5, 19), (39, 19), (20, 16), (33, 2)]       # tiles 0 2 1 5 3 4
    idx = torch.tensor([x * H + y for x, y in px] + [0, 0], dtype=torch.int32)
    ops, nbytes = timing.adaptive_work(idx, len(px), H, ns, 1, 3, vis)
    per_px = timing.RAYGEN + timing.HIT_SETUP + timing.HIT_PLANE
    swept = 3 + 0 + ns + 7 + 5 + 2
    assert ops == 9 * (len(px) * per_px + swept * timing.HIT_SPHERE)
    assert nbytes == timing.adaptive_work(idx, len(px), H, ns, 1, 3)[1] + 4 * (6 * k + 6)
    assert ops < timing.adaptive_work(idx, len(px), H, ns, 1, 3)[0]



def test_adaptive_work_counts_bounce_levels_of_live_chains():
    """With the hit-extent rows of the AA lattice (levels 0..2), each tile's
    listed chains that must be alive (9 m - 4 dead positions, at least 0)
    add the level-0 shadow rays over the tile's occluder lists and the
    bounce floor: a traced bounce ray from each live chain of the level
    before, a shaded hit for each live chain past level 0."""
    W, H, ns, npl, nl, k = 40, 20, 50, 1, 3, 8
    cnt = torch.tensor([3, -1, 0, 5, 2, 7], dtype=torch.int32)          # 3 x 2 tiles
    vis = (torch.zeros((6 * k,), dtype=torch.int32), cnt, k)
    sh_cnt = torch.tensor([1, 2, 0, 0, 0, 0, -1, 4, 1] + [0] * 9, dtype=torch.int32)
    shadow = (torch.zeros((18 * k,), dtype=torch.int32), sh_cnt, k, 1)
    px = [(0, 0), (1, 1), (17, 3), (20, 16), (33, 2)]                   # tiles 0 0 2 3 4
    idx = torch.tensor([x * H + y for x, y in px], dtype=torch.int32)
    P = timing.tile_positions(W, H, True)
    ext = torch.zeros((6, 3, 8))
    ext[:, :, 6] = P[:, None]                 # every position live at every level ...
    ext[2, :, 6] = P[2] - torch.tensor([0.0, 2.0, 100.0])   # ... but tile 2's
    ext[3, 2, 6] = P[3] - 1.0
    ext = ext.reshape(18, 8)
    base, b0 = timing.adaptive_work(idx, len(px), H, ns, npl, nl, vis, shadow)
    ops, nbytes = timing.adaptive_work(idx, len(px), H, ns, npl, nl, vis, shadow, ext, W)
    assert nbytes == b0 == timing.adaptive_work(idx, len(px), H, ns, npl, nl)[1] + \
        4 * (6 * (k + 1) + 18 * (k + 1))
    chains = {0: (18, 18, 18), 2: (9, 1, 0), 3: (9, 9, 5), 4: (9, 9, 9)}   # tile: levels 0-2
    occ = {0: 1 + 2 + 0, 2: ns + 4 + 1, 3: 0, 4: 0}
    shade = timing.LIGHT + timing.SHADOW_SETUP + npl * timing.HIT_PLANE
    want = sum(c[0] * (nl * shade + occ[t] * timing.SHADOW_SPHERE) for t, c in chains.items())
    traced = sum(c[0] + c[1] for c in chains.values())
    hits = sum(c[1] + c[2] for c in chains.values())
    want += traced * (timing.HIT_SETUP + npl * timing.HIT_PLANE + timing.HIT_SPHERE)
    want += hits * (timing.SURFACE + timing.SPHERE_NORMAL + nl * shade)
    assert ops - base == want

# --- the CLI ---------------------------------------------------------------------------

@pytest.mark.parametrize("extra,why", [(["--soft", "0.05"], "--soft renders use the soft"),
                                       (["--no-aliasing"], "requires aliasing on"),
                                       ([], "cuda backend only")])
def test_cli_adaptive_ignored_messages(tmp_path, capsys, extra, why):
    out = tmp_path / "r.png"
    assert cli.main(["render", "--backend", "torch", "--width", "12", "--height", "10",
                     "--adaptive-aa", "0.002", "--out", str(out), *extra]) == 0
    captured = capsys.readouterr()
    assert f"[adaptive-aa] ignored: {why}" in captured.err
    assert "[adaptive-aa] flagged" not in captured.out and out.exists()


def test_cli_adaptive_without_card_raises(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    with pytest.raises(RuntimeError, match="CUDA device"):
        cli.main(["render", "--adaptive-aa", "0.002", "--width", "8", "--height", "8",
                  "--out", str(tmp_path / "x.png")])
