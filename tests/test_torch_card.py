"""The CUDA render and backward kernels on a card, against the plain PyTorch
version.

Every test here needs a CUDA card and skips without one. The file imports no
JAX, so it also runs on a host without it:

    python -m pytest tests/test_torch_card.py --noconftest -o addopts="" -q

Against the plain version (tests/test_pallas.py::_compare's rule, at the
uint8 frame): float32 reassociation (FMA contraction, the hoisted quadratic)
flips isolated near-tie hit or shadow tests, so at most 0.1% of pixels may be
off by more than 1 level. Against the JAX package's frozen framebuffers (read
with numpy): max diff <= 1 level and < 1% changed, except at the one near tie
named in tests/torch_goldens.py, as tests/test_goldens.py holds the Pallas
kernel. The backward kernel against autograd of the plain version follows
the JAX package's kernel rule (render_bwd_cuda.GEOMETRY_GROUPS): geometry,
light and camera leaves max|d| / max|g| < 5e-2, the other leaves rtol 1e-3 /
atol 1e-7, the loss rel 1e-5, with the 0.1% of pixels where the kernel's and
the plain render disagree most held out of both sides
(render_bwd_cuda.held_out: at 64x64 one near-tie or near-tangent sample can
carry most of a leaf group's gradient).
"""
import math

import numpy as np
import pytest
import torch

import python_ray_tracer_tpu_torch as trt
from python_ray_tracer_tpu_torch import cli, train
from python_ray_tracer_tpu_torch.ops.cuda import render_bwd_cuda as rb
from python_ray_tracer_tpu_torch.ops.cuda import render_cuda
from python_ray_tracer_tpu_torch.utils.config import RenderConfig

from .torch_goldens import GOLDEN_CONFIGS, compare_frames, load_golden

pytestmark = pytest.mark.cuda

MODES = ("aa_none", "aa_per_sample", "aa_shared")


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (torch.cuda.is_available() is False)")
    return torch.device("cuda", 0)


def _kernel(cam, scene, mode, depth, compat):
    return trt.render_image_cuda(cam, scene, depth=depth, compat=compat,
                                 aliasing=mode != "aa_none",
                                 aa_share=mode == "aa_shared")


def _flipped(a, b):
    d = (trt.to_framebuffer(a).int() - trt.to_framebuffer(b).int()).abs().amax(0)
    return int((d > 1).sum())


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("compat", [True, False])
@pytest.mark.parametrize("res,depth", [((67, 45), 2), ((128, 128), 4)])
def test_kernel_matches_plain(cuda_device, mode, compat, res, depth):
    mats = trt.Materials.build(0.05, 0.6, 0.3, 0.5, 16.0, device=cuda_device)
    scene = trt.default_scene(mats, device=cuda_device)
    cam = trt.default_camera(res, device=cuda_device)
    before = render_cuda.LAUNCHES[mode]
    out = _kernel(cam, scene, mode, depth, compat)
    torch.cuda.synchronize()
    assert render_cuda.LAUNCHES[mode] == before + 1
    ref = trt.render_image(cam, scene, depth=depth, aliasing=mode != "aa_none",
                           compat=compat)
    assert out.shape == (res[0], res[1], 3) and bool(torch.isfinite(out).all())
    assert _flipped(out, ref) <= 1e-3 * res[0] * res[1]


@pytest.mark.parametrize("name", sorted(GOLDEN_CONFIGS))
def test_kernel_golden_framebuffers(cuda_device, name):
    """The kernel against the JAX package's goldens directly, so a drift shared
    by the kernel and the plain version (pack_params, the scene tables) fails."""
    (w, h), depth, aa, compat = GOLDEN_CONFIGS[name]
    img = trt.render_image_cuda(trt.default_camera((w, h), device=cuda_device),
                                trt.default_scene(device=cuda_device),
                                depth=depth, aliasing=aa, compat=compat)
    compare_frames(trt.to_framebuffer(img).cpu().numpy(), load_golden(name), name)


@pytest.mark.parametrize("compat", [True, False])
def test_kernel_random_scene_root_and_cheap_shadows(cuda_device, compat):
    """40 spheres (no unroll limit on the card) through both shadow tests."""
    g = torch.Generator().manual_seed(4)
    scene = trt.random_scene(40, generator=g, device=cuda_device)
    cam = trt.Camera.build((96, 64), [-7.0, 0.0, 3.0], [0.0, -20.0, 0.0],
                           device=cuda_device)
    out = _kernel(cam, scene, "aa_shared", 2, compat)
    ref = trt.render_image(cam, scene, depth=2, aliasing=True, compat=compat)
    assert _flipped(out, ref) <= 1e-3 * 96 * 64
    big = trt.Scene(trt.Spheres.build([([3.0, 0.0, 0.5], 600.0, (200, 10, 10))],
                                      device=cuda_device),
                    scene.planes, scene.lights, scene.materials)
    assert not render_cuda.shadow_cheap_ok(big, True)
    out = _kernel(cam, big, "aa_none", 1, compat)
    ref = trt.render_image(cam, big, depth=1, aliasing=False, compat=compat)
    assert _flipped(out, ref) <= 1e-3 * 96 * 64


def test_kernel_is_deterministic(cuda_device):
    scene = trt.default_scene(device=cuda_device)
    cam = trt.default_camera((200, 120), device=cuda_device)
    a = _kernel(cam, scene, "aa_shared", 2, True)
    b = _kernel(cam, scene, "aa_shared", 2, True)
    assert torch.equal(a, b)


def test_wrapper_rejects_mixed_devices_and_dtypes(cuda_device):
    cam = trt.default_camera((32, 32), device=cuda_device)
    with pytest.raises(ValueError, match="is on cpu"):
        trt.render_image_cuda(cam, trt.default_scene(device="cpu"))
    scene = trt.default_scene(device=cuda_device)
    scene.spheres.radius = scene.spheres.radius.double()
    with pytest.raises(TypeError, match="float32"):
        trt.render_image_cuda(cam, scene)


def test_empty_scene_renders_black(cuda_device):
    scene = trt.Scene(trt.Spheres.build([], cuda_device), trt.Planes.build([], cuda_device),
                      trt.Lights.build([], cuda_device), trt.Materials.build(device=cuda_device))
    out = trt.render_image_cuda(trt.default_camera((20, 20), device=cuda_device), scene)
    assert float(out.abs().max()) == 0.0
    np.testing.assert_array_equal(out.cpu().numpy(), np.zeros((20, 20, 3), np.float32))


# --- the backward kernel ---------------------------------------------------------

BWD_MODES = ("cot_noaa", "cot_aa", "fused_noaa", "fused_aa")


def _bwd_scene(name, compat, dev):
    if name == "two":
        return cli.fit_scene_two_spheres(RenderConfig(), dev)
    mats = trt.Materials.build(0.05, 0.6, 0.3, 0.0 if compat else 0.6, 8.0, device=dev)
    return trt.default_scene(mats, device=dev)


def _target(res, dev, seed=0):
    g = torch.Generator().manual_seed(seed)
    return torch.rand((*res, 3), generator=g).to(dev)


def _bwd_input(mode, cam, scene, target, compat, depth=2):
    """The target (fused modes) or the MSE cotangent of the plain render."""
    if mode.startswith("fused"):
        return target
    img = trt.render_image(cam, scene, depth=depth, aliasing=mode.endswith("_aa"),
                           compat=compat)
    return (2.0 * (img - target) / img.numel()).contiguous()


def _kernel_flat(mode, cam, scene, x, compat):
    """The kernel wrapper's flat gradient, camera slots included."""
    kw = dict(depth=2, compat=compat, aliasing=mode.endswith("_aa"), return_camera=True)
    if mode.startswith("fused"):
        loss, scene_g, cam_g = rb.loss_and_scene_grads_cuda(cam, scene, x, **kw)
        return rb.flatten_grads(scene_g, cam_g, loss)
    return rb.flatten_grads(*rb.scene_grads_cuda(cam, scene, x, **kw))


def _assert_rule(flat, ref, scene, scale_ref=None):
    counts = (scene.spheres.count, scene.planes.count, scene.lights.count)
    bad = {k: v for k, (v, ok) in rb.grad_rule(flat, ref, *counts, scale_ref).items()
           if not ok}
    assert not bad, bad


def _assert_matches_plain(mode, cam, scene, target, compat, depth=2):
    """Kernel against plain version under the rule, the held-out pixels
    (render_bwd_cuda.held_out) taken out of both."""
    x = _bwd_input(mode, cam, scene, target, compat, depth)
    flat, ref, ref_all, held = rb.kernel_and_plain(mode, cam, scene, x, depth=depth,
                                                   compat=compat)
    assert int(held.sum()) == math.ceil(rb.HELD_OUT_FRAC * held.numel())
    assert bool(torch.isfinite(flat).all())
    _assert_rule(flat, ref, scene, ref_all)


def _counter(mode):
    """The launch counter that a wrapper call of ``mode`` adds to: the
    wrappers' fused AA step is the one-launch form, counted as ``fused_aa1``."""
    return "fused_aa1" if mode == "fused_aa" else mode


@pytest.mark.parametrize("mode", BWD_MODES)
@pytest.mark.parametrize("name", ["demo", "two"])
@pytest.mark.parametrize("compat", [True, False])
def test_bwd_kernel_matches_plain(cuda_device, mode, name, compat):
    scene = _bwd_scene(name, compat, cuda_device)
    cam = trt.default_camera((64, 64), device=cuda_device)
    target = _target((64, 64), cuda_device)
    before = rb.LAUNCHES[_counter(mode)]
    flat = _kernel_flat(mode, cam, scene, _bwd_input(mode, cam, scene, target, compat),
                        compat)
    torch.cuda.synchronize()
    assert rb.LAUNCHES[_counter(mode)] == before + 1
    assert bool(torch.isfinite(flat).all())
    _assert_matches_plain(mode, cam, scene, target, compat)


@pytest.mark.parametrize("mode", BWD_MODES)
def test_bwd_kernel_is_deterministic(cuda_device, mode):
    scene = _bwd_scene("demo", True, cuda_device)
    cam = trt.default_camera((96, 72), device=cuda_device)
    x = _bwd_input(mode, cam, scene, _target((96, 72), cuda_device, seed=1), True)
    assert torch.equal(_kernel_flat(mode, cam, scene, x, True),
                       _kernel_flat(mode, cam, scene, x, True))


@pytest.mark.parametrize("aliasing", [False, True])
def test_render_image_fast_grads_match_plain_autograd(cuda_device, aliasing):
    """render_image_fast: the render kernel forward, the backward kernel
    backward, for scene and camera leaves, against autograd of the plain path."""
    scene = _bwd_scene("demo", True, cuda_device)
    cam = trt.default_camera((48, 40), device=cuda_device)
    g = _target((48, 40), cuda_device, seed=2) - 0.5
    mode = "cot_aa" if aliasing else "cot_noaa"
    before = rb.LAUNCHES[mode]
    grads = []
    for fn in (render_cuda.render_image_fast, trt.render_image):
        leaves = [t.detach().clone().requires_grad_(True)
                  for t in scene.leaves() + [cam.position, cam.rotation, cam.fov]]
        c = trt.Camera(*leaves[12:], cam.resolution)
        (fn(c, trt.Scene.from_leaves(leaves[:12]), depth=2, aliasing=aliasing) * g).sum()\
            .backward()
        grads.append(rb.flatten_grads(
            trt.Scene.from_leaves([t.grad if t.grad is not None else torch.zeros_like(t)
                                   for t in leaves[:12]]),
            trt.Camera(*(t.grad for t in leaves[12:]), cam.resolution)))
    assert rb.LAUNCHES[mode] == before + 1
    _assert_rule(grads[0], grads[1], scene)


@pytest.mark.parametrize("mode", ["fused_noaa", "fused_aa"])
def test_bwd_kernel_24_spheres(cuda_device, mode):
    """24 spheres at 32x32 (past the JAX kernel's 16-sphere unroll limit; the
    port's loop has no such limit), seen from a corner of the field. The view
    is one where float32 says something about every geometry group: the plain
    version in float32 and in float64 agree under the rule. (From a camera
    beside a sphere, the two plain versions put the AA fov gradient 3x apart,
    and no float32 kernel can be held to either.)"""
    g = torch.Generator().manual_seed(4)
    scene = trt.random_scene(24, generator=g, device=cuda_device)
    cam = trt.Camera.build((32, 32), [-10.0, -10.0, 8.0], [0.0, -30.0, 45.0],
                           device=cuda_device)
    target = _target((32, 32), cuda_device)
    aa = mode == "fused_aa"
    cam64 = trt.Camera(cam.position.double(), cam.rotation.double(), cam.fov.double(),
                       cam.resolution)
    scene64 = trt.Scene.from_leaves([t.double() for t in scene.leaves()])
    rule = rb.grad_rule(
        rb.loss_and_scene_grads_plain(cam, scene, target, depth=2, aliasing=aa),
        rb.loss_and_scene_grads_plain(cam64, scene64, target.double(), depth=2,
                                      aliasing=aa), 24, 1, 3)
    assert all(ok for k, (_, ok) in rule.items() if k in rb.GEOMETRY_GROUPS), rule
    _assert_matches_plain(mode, cam, scene, target, True)


@pytest.mark.parametrize("mode", ["fused_noaa", "cot_aa"])
@pytest.mark.parametrize("compat", [True, False])
def test_bwd_kernel_past_32_lights(cuda_device, mode, compat):
    """34 lights: the reverse sweep re-tests the shadow rays of lights past the
    kernel's 32-bit occlusion mask."""
    two = _bwd_scene("two", compat, cuda_device)
    lights = trt.Lights(torch.tensor([[2.5 + 0.1 * i, -2.0 + 0.12 * i, 3.0 + 0.05 * i]
                                      for i in range(34)], device=cuda_device))
    mats = trt.Materials.build(0.1, 0.05, 0.3, 0.0 if compat else 0.5, 8.0,
                               device=cuda_device)
    scene = trt.Scene(two.spheres, two.planes, lights, mats)
    cam = trt.default_camera((24, 16), device=cuda_device)
    _assert_matches_plain(mode, cam, scene, _target((24, 16), cuda_device), compat)


def test_bwd_kernel_at_max_depth(cuda_device):
    scene = _bwd_scene("two", True, cuda_device)
    cam = trt.default_camera((32, 32), device=cuda_device)
    _assert_matches_plain("fused_noaa", cam, scene, _target((32, 32), cuda_device), True,
                          depth=rb.MAX_DEPTH)


@pytest.mark.parametrize("aliasing", [False, True])
def test_bwd_kernel_empty_scene(cuda_device, aliasing):
    """No objects and no lights: every gradient slot 0, the loss mean(target^2)."""
    dev = cuda_device
    scene = trt.Scene(trt.Spheres.build([], dev), trt.Planes.build([], dev),
                      trt.Lights.build([], dev), trt.Materials.build(device=dev))
    cam = trt.default_camera((20, 12), device=dev)
    target = _target((20, 12), dev)
    loss, scene_g, cam_g = rb.loss_and_scene_grads_cuda(cam, scene, target,
                                                        aliasing=aliasing,
                                                        return_camera=True)
    assert bool((rb.flatten_grads(scene_g, cam_g) == 0).all())
    assert float(loss) == pytest.approx(float((target ** 2).mean()), rel=1e-5)


def _bwd_case_scene(name, compat, dev):
    """The fit scene, the demo scene, or 24 seeded spheres (the large-scene
    instantiation), with the camera each is held under."""
    if name == "r24":
        scene = trt.random_scene(24, generator=torch.Generator().manual_seed(4), device=dev)
        return scene, trt.Camera.build((32, 32), [-10.0, -10.0, 8.0], [0.0, -30.0, 45.0],
                                       device=dev)
    return _bwd_scene(name, compat, dev), trt.default_camera((37, 29), device=dev)


# (mode, scene, depth, compat) of test_bwd_kernel_every_depth_instantiation:
# the fit scene at every depth; the demo scene at depths 0-3 and, clean, 5;
# the 24-sphere view of test_bwd_kernel_24_spheres in compat at depths 0-3
# (and 5 in the cotangent and AA modes), clean with AA at every depth and
# without AA at depths 0-1. Left out are the combinations where that view or
# the demo scene's depth-5 AA frame is one float32 cannot decide (the plain
# version in float32 and in float64 already differ there by more than the
# rule), and the 24-sphere clean no-AA fused step at depths 0-1, where a
# sphere's near-zero albedo gradient misses rtol 1e-3 by the same margin in
# the kernel before and after the slot columns.
BWD_DEPTH_CASES = (
    [(m, "two", d, c) for m in BWD_MODES for d in (0, 1, 2, 3, 5) for c in (True, False)]
    + [(m, "demo", d, c) for m in BWD_MODES for d in (0, 1, 2, 3) for c in (True, False)]
    + [(m, "demo", 5, False) for m in BWD_MODES]
    + [(m, "r24", d, True) for m in BWD_MODES for d in (0, 1, 2, 3)]
    + [(m, "r24", 5, True) for m in ("cot_noaa", "cot_aa", "fused_aa")]
    + [(m, "r24", d, False) for m in ("cot_aa", "fused_aa") for d in (0, 1, 2, 3, 5)]
    + [("cot_noaa", "r24", d, False) for d in (0, 1)])


@pytest.mark.parametrize("mode,name,depth,compat", BWD_DEPTH_CASES)
def test_bwd_kernel_every_depth_instantiation(cuda_device, mode, depth, name, compat):
    """Depths 0-3 take their own instantiation (residuals in registers), 5
    the general one; the fit and demo scenes the slot columns at 37x29 (W and
    H not multiples of 16), 24 spheres the pinned per-warp rows. Under the
    rule against the plain version, two runs bit-identical, one launch."""
    scene, cam = _bwd_case_scene(name, compat, cuda_device)
    target = _target(cam.resolution, cuda_device)
    x = _bwd_input(mode, cam, scene, target, compat, depth)
    kw = dict(depth=depth, compat=compat, aliasing=mode.endswith("_aa"), return_camera=True)

    def flat():
        if mode.startswith("fused"):
            loss, scene_g, cam_g = rb.loss_and_scene_grads_cuda(cam, scene, x, **kw)
            return rb.flatten_grads(scene_g, cam_g, loss)
        return rb.flatten_grads(*rb.scene_grads_cuda(cam, scene, x, **kw))
    before = rb.LAUNCHES[_counter(mode)]
    a = flat()
    torch.cuda.synchronize()
    assert rb.LAUNCHES[_counter(mode)] == before + 1
    assert torch.equal(a, flat())
    assert rb.launch_plan(cam, scene, mode).cols == (name != "r24")
    _assert_matches_plain(mode, cam, scene, target, compat, depth)


@pytest.mark.parametrize("compat", [True, False])
@pytest.mark.parametrize("name", ["two", "demo"])
def test_cot_aa_lattice_matches_the_9_sample_vjp(cuda_device, compat, name):
    """cot_aa traces the AA lattice: the kernel, the plain lattice form
    (render_bwd_cuda.scene_grads_lattice_plain) and the plain 9-sample VJP.
    The two plain forms differ only in float rounding; the kernel is held to
    the 9-sample VJP under the rule, its held-out pixels out of both."""
    scene = _bwd_scene(name, compat, cuda_device)
    cam = trt.default_camera((45, 38), device=cuda_device)
    x = _bwd_input("cot_aa", cam, scene, _target((45, 38), cuda_device, seed=3), compat)
    lattice = rb.scene_grads_lattice_plain(cam, scene, x, depth=2, compat=compat)
    per_sample = rb.scene_grads_plain(cam, scene, x, depth=2, compat=compat, aliasing=True)
    counts = (scene.spheres.count, scene.planes.count, scene.lights.count)
    rule = rb.grad_rule(lattice, per_sample, *counts)
    assert all(r < 1e-3 for r, _ in rule.values()), rule
    _assert_matches_plain("cot_aa", cam, scene, _target((45, 38), cuda_device, seed=3), compat)


def test_bwd_plan_sizes_the_grid_to_the_card(cuda_device):
    """The planner's grid: a few blocks on every multiprocessor, each walking
    several tiles, the partial columns as many as the blocks."""
    scene = _bwd_scene("two", True, cuda_device)
    cam = trt.default_camera((1000, 1000), device=cuda_device)
    n_sm = torch.cuda.get_device_properties(cuda_device).multi_processor_count
    for mode in BWD_MODES:
        p = rb.launch_plan(cam, scene, mode)
        assert p.cols and p.nt == 128 and p.tiles > 1
        assert n_sm <= p.blocks <= rb.BLOCKS_PER_SM * n_sm
        assert (p.blocks - 1) * p.tiles < rb.n_tiles(1000, 1000) <= p.blocks * p.tiles


def test_bwd_wrapper_rejects_bad_inputs(cuda_device):
    scene = _bwd_scene("two", True, cuda_device)
    cam = trt.default_camera((16, 16), device=cuda_device)
    target = _target((16, 16), cuda_device)
    with pytest.raises(ValueError, match="depth"):
        rb.loss_and_scene_grads_cuda(cam, scene, target, depth=rb.MAX_DEPTH + 1)
    with pytest.raises(ValueError, match="shape"):
        rb.loss_and_scene_grads_cuda(cam, scene, target[:8])
    with pytest.raises(ValueError, match="is on cpu"):
        rb.scene_grads_cuda(cam, trt.default_scene(device="cpu"), target)


def test_fit_scene_cuda_backend_on_card(cuda_device):
    """fit_scene(backend="cuda"): one fused launch a step, the plain version
    never called, the loss falls."""
    scene = _bwd_scene("two", True, cuda_device)
    cam = trt.default_camera((128, 128), device=cuda_device)
    target = trt.render_image_cuda(cam, scene, depth=2, aliasing=False)
    init = trt.Scene.from_leaves(scene.leaves())
    init.spheres = trt.Spheres(scene.spheres.center + torch.tensor(
        [0.2, -0.15, 0.1], device=cuda_device), scene.spheres.radius, scene.spheres.albedo)
    rb.reset_launch_counts()
    _, losses = train.fit_scene(init, cam, target, steps=20, lr=1e-2, depth=2,
                                trainable=("spheres.center",), backend="cuda")
    assert rb.LAUNCHES["fused_noaa"] == 20 and sum(rb.PLAIN_CALLS.values()) == 0
    assert losses[-1] < 0.75 * losses[0]


def test_fit_camera_cuda_backend_on_card(cuda_device):
    scene = _bwd_scene("two", True, cuda_device)
    true_cam = trt.Camera.build((64, 64), [-2.0, 0.0, 2.0], [0.0, -30.0, 0.0],
                                device=cuda_device)
    target = trt.render_image_cuda(true_cam, scene, depth=1, aliasing=False)
    init = trt.Camera.build((64, 64), [-2.1, 0.08, 1.92], [1.5, -27.5, 2.0],
                            device=cuda_device)
    rb.reset_launch_counts()
    fitted, losses = train.fit_camera(init, scene, target, steps=60, depth=1,
                                      backend="cuda")
    assert rb.LAUNCHES["fused_noaa"] == 60 and sum(rb.PLAIN_CALLS.values()) == 0
    assert losses[-1] < 0.6 * losses[0]
    err0 = float((init.position - true_cam.position).abs().max())
    assert float((fitted.position - true_cam.position).abs().max()) < err0


# --- the soft-visibility kernels ---------------------------------------------------
#
# Forward against the plain version: soft_cuda.image_rule (every element
# within 2e-4 of the plain version in float32 or in float64; <= 0.1% of uint8
# pixels off by more than 1 level). Backward against autograd of the plain
# version: soft_bwd_cuda.soft_grad_rule, the JAX package's rule for its soft
# backward kernel (tests/test_soft_bwd.py:30-70), on the MSE cotangent of a
# seeded target, each element within its allowance of the float32 or the
# float64 plain gradient.

SOFT_TAUS = (0.15, 0.05, 0.02)


def _soft_scene(name, dev):
    if name == "demo":
        return trt.default_scene(trt.Materials.build(0.1, 0.6, device=dev), device=dev)
    if name == "random40":
        return trt.random_scene(40, generator=torch.Generator().manual_seed(4), device=dev)
    if name == "ties":      # the camera inside two spheres: both clamp to t = 1e-4
        return trt.Scene(
            trt.Spheres.build([([-1.9, 0.0, 2.0], 0.5, trt.RED),
                               ([-1.95, 0.1, 2.0], 0.6, trt.GREEN),
                               ([3.0, 0.0, 1.0], 1.0, trt.BLUE),
                               ([-6.0, 0.0, 2.0], 1.0, trt.YELLOW)], dev),
            trt.Planes.build([([0.0, 0.0, -1.0], [0.0, 0.0, 1.0], trt.GREY)], dev),
            trt.Lights.build([[0.0, 2.0, 6.0]], dev), trt.Materials.build(0.3, 0.6, device=dev))
    if name == "degenerate":  # saturated cover behind a sphere; a plane in front
        return trt.Scene(
            trt.Spheres.build([([3.0, 0.0, 0.0], 1.4, trt.RED),
                               ([8.0, 0.0, 0.0], 1.0, trt.GREEN)], dev),
            trt.Planes.build([([1.0, 0.0, 0.0], [-1.0, 0.0, 0.0], trt.GREY)], dev),
            trt.Lights.build([[0.0, 0.0, 8.0]], dev),
            trt.Materials.build(ambient=0.2, lambert=0.6, device=dev))
    # "lights20": no light-count limit in either soft kernel
    two = _bwd_scene("two", False, dev)
    lights = trt.Lights(torch.tensor([[2.5 + 0.2 * i, -2.0 + 0.2 * i, 3.0 + 0.1 * i]
                                      for i in range(20)], device=dev))
    return trt.Scene(two.spheres, two.planes, lights, trt.Materials.build(0.1, 0.05,
                                                                          device=dev))


def _assert_soft_image(out, cam, scene, tau, label):
    from python_ray_tracer_tpu_torch.ops.cuda import soft_cuda
    rule = soft_cuda.image_rule(out, trt.render_image_soft(cam, scene, tau=tau),
                                trt.render_image_soft(*soft_cuda.as_double(cam, scene),
                                                      tau=tau))
    print(f"[soft-fwd] {label} tau={tau}: max|k-plain| {rule['max_abs_err']:.4e}, "
          f"ratio {rule['ratio']:.4f}, worst {rule['worst']}, worst64 {rule['worst64']}")
    assert rule["ok"], rule


@pytest.mark.parametrize("tau", SOFT_TAUS)
@pytest.mark.parametrize("name", ["demo", "random40", "ties", "lights20"])
def test_soft_fwd_matches_plain(cuda_device, name, tau):
    from python_ray_tracer_tpu_torch.ops.cuda import soft_cuda
    scene = _soft_scene(name, cuda_device)
    cam = trt.default_camera((96, 64), device=cuda_device)
    before = soft_cuda.LAUNCHES["soft_fwd"]
    out = trt.render_image_soft_cuda(cam, scene, tau=tau)
    torch.cuda.synchronize()
    assert soft_cuda.LAUNCHES["soft_fwd"] == before + 1
    _assert_soft_image(out, cam, scene, tau, f"{name} 96x64")
    assert torch.equal(out, trt.render_image_soft_cuda(cam, scene, tau=tau))


@pytest.mark.parametrize("tau", SOFT_TAUS)
def test_soft_fwd_100_spheres(cuda_device, tau):
    """100 seeded spheres (up to ~40 live objects a pixel at tau 0.15: more
    than one chunk of the forward's table where it overflows its 32)."""
    from python_ray_tracer_tpu_torch.ops.cuda import soft_cuda
    scene = trt.random_scene(100, generator=torch.Generator().manual_seed(0), device=cuda_device)
    cam = trt.default_camera((96, 64), device=cuda_device)
    before = soft_cuda.LAUNCHES["soft_fwd"]
    out = trt.render_image_soft_cuda(cam, scene, tau=tau)
    torch.cuda.synchronize()
    assert soft_cuda.LAUNCHES["soft_fwd"] == before + 1
    _assert_soft_image(out, cam, scene, tau, "random100 96x64")
    assert torch.equal(out, trt.render_image_soft_cuda(cam, scene, tau=tau))


def _soft_flat(mode, cam, scene, x, tau):
    from python_ray_tracer_tpu_torch.ops.cuda import soft_bwd_cuda as sb
    if mode == "fused":
        loss, scene_g, cam_g = sb.soft_loss_and_grads_cuda(cam, scene, x, tau=tau,
                                                           return_camera=True)
        return rb.flatten_grads(scene_g, cam_g, loss)
    return rb.flatten_grads(*sb.soft_scene_grads_cuda(cam, scene, x, tau=tau,
                                                      return_camera=True))


def _soft_input(mode, cam, scene, target, tau):
    if mode == "fused":
        return target
    img = trt.render_image_soft(cam, scene, tau=tau)
    return (2.0 * (img - target) / img.numel()).contiguous()


@pytest.mark.parametrize("mode", ["cot", "fused"])
@pytest.mark.parametrize("name,tau", [("demo", 0.15), ("demo", 0.02), ("random40", 0.05),
                                      ("ties", 0.05), ("degenerate", 0.02),
                                      ("lights20", 0.05)])
def test_soft_bwd_matches_plain(cuda_device, mode, name, tau):
    from python_ray_tracer_tpu_torch.ops.cuda import soft_bwd_cuda as sb, soft_cuda
    scene = _soft_scene(name, cuda_device)
    cam = trt.default_camera((64, 48), device=cuda_device)
    x = _soft_input(mode, cam, scene, _target((64, 48), cuda_device), tau)
    before = sb.LAUNCHES[mode]
    flat = _soft_flat(mode, cam, scene, x, tau)
    torch.cuda.synchronize()
    assert sb.LAUNCHES[mode] == before + 1
    assert bool(torch.isfinite(flat).all())
    assert torch.equal(flat, _soft_flat(mode, cam, scene, x, tau))
    plain = sb.soft_loss_and_grads_plain if mode == "fused" else sb.soft_scene_grads_plain
    ref = plain(cam, scene, x, tau=tau)
    ref64 = plain(*soft_cuda.as_double(cam, scene), x.double(), tau=tau)
    counts = (scene.spheres.count, scene.planes.count, scene.lights.count)
    rule = sb.soft_grad_rule(flat, ref, *counts, ref64=ref64)
    assert all(ok for _, ok in rule.values()), rule
    groups = rb.grad_groups(flat.cpu(), *counts)
    for leaf in ("materials.reflection", "materials.specular", "materials.shininess"):
        assert float(groups[leaf]) == 0.0


def _skip_scene(name, dev):
    """Scenes that reach each of the soft backward kernel's exact skips (and
    the planner's chunks): see test_soft_bwd_skips_match_plain."""
    S = trt.Spheres.build
    if name in ("dead", "backlit"):
        # dead: spheres 2 (wholly off-frame) and 3 (behind the camera) have
        # alpha 0 on every primary and shadow ray; backlit: light 1 lies under
        # the plane, the only surface in view
        seen = [([2.2, 0.3, 1.0], 1.0, trt.RED), ([0.6, -0.8, 0.5], 0.5, trt.GREEN)]
        gone = [([2.0, 40.0, 1.0], 0.3, trt.BLUE), ([-8.0, 0.0, -3.0], 0.5, trt.YELLOW)]
        lights = [[2.5, -2.0, 3.0], [5.0, 0.1, 6.0]] if name == "dead" else \
            [[2.5, -2.0, 3.0], [3.0, 0.0, -4.0]]
        return trt.Scene(S((seen if name == "dead" else []) + gone, dev),
                         trt.Planes.build([([5, 0, 0], [0, 0, 1], trt.GREY)], dev),
                         trt.Lights.build(lights, dev), trt.Materials.build(device=dev))
    if name == "eclipsed":  # at tau 0.02 the big sphere's a == 1.0f hides the small one
        return trt.Scene(S([([2.0, 0.0, 1.0], 1.0, trt.RED), ([6.0, 0.0, -1.0], 0.1, trt.GREEN)],
                           dev),
                         trt.Planes.build([([5, 0, 0], [0, 0, 1], trt.GREY)], dev),
                         trt.Lights.build([[2.5, -2.0, 3.0]], dev), trt.Materials.build(device=dev))
    if name in ("nolights", "lights20"):
        # lights20: past the 14 lights whose Lambert signs the kernel's table
        # keeps as bits; every other light under the plane
        demo = _soft_scene("demo", dev)
        lights = [] if name == "nolights" else [
            [3.0 + 4.0 * math.cos(0.3 * i), 4.0 * math.sin(0.3 * i), 5.0 if i % 2 else -3.0]
            for i in range(20)]
        return trt.Scene(demo.spheres, demo.planes, trt.Lights.build(lights, dev),
                         demo.materials)
    if name == "random256":
        return trt.random_scene(256, generator=torch.Generator().manual_seed(5), device=dev)
    # "largest": the most spheres (1 plane, 3 lights) the first port's kernel took
    return trt.random_scene(1654, generator=torch.Generator().manual_seed(6), device=dev)


# name -> (tau, resolution, slots that are exactly 0: (group, rows))
SKIP_CASES = {
    "dead": (0.05, (64, 48), (("spheres.center", [2, 3]), ("spheres.radius", [2, 3]),
                              ("spheres.albedo", [2, 3]))),
    "eclipsed": (0.02, (64, 48), (("spheres.center", [1]), ("spheres.radius", [1]),
                                  ("spheres.albedo", [1]))),
    "backlit": (0.15, (64, 48), (("lights.position", [1]),)),
    "nolights": (0.05, (64, 48), ()),
    "lights20": (0.05, (64, 48), ()),
    "random256": (0.05, (64, 48), ()),
    "largest": (0.05, (16, 16), ()),
}


@pytest.mark.parametrize("mode", ["cot", "fused"])
@pytest.mark.parametrize("name", sorted(SKIP_CASES))
def test_soft_bwd_skips_match_plain(cuda_device, mode, name):
    """Scenes that reach each exact skip of the soft backward kernel (dead
    objects and occluders, an eclipsed sphere, an unlit light, no lights, 20
    lights: past the table's Lambert sign bits) and
    its chunked paths (256 spheres; the largest scene the first port took):
    the rule against the plain version in float32 or float64, two runs
    bit-identical, and exact zeros where the function has them."""
    from python_ray_tracer_tpu_torch.ops.cuda import soft_bwd_cuda as sb, soft_cuda
    from python_ray_tracer_tpu_torch.ops.soft import row_chunk_for
    tau, res, zeros = SKIP_CASES[name]
    scene = _skip_scene(name, cuda_device)
    cam = trt.default_camera(res, device=cuda_device)
    x = _soft_input(mode, cam, scene, _target(res, cuda_device), tau)
    before = sb.LAUNCHES[mode]
    flat = _soft_flat(mode, cam, scene, x, tau)
    torch.cuda.synchronize()
    assert sb.LAUNCHES[mode] == before + 1
    assert bool(torch.isfinite(flat).all())
    assert torch.equal(flat, _soft_flat(mode, cam, scene, x, tau))
    plain = sb.soft_loss_and_grads_plain if mode == "fused" else sb.soft_scene_grads_plain
    chunk = row_chunk_for(res, scene, 1 << 28)
    ref = plain(cam, scene, x, tau=tau, row_chunk=chunk)
    ref64 = plain(*soft_cuda.as_double(cam, scene), x.double(), tau=tau,
                  row_chunk=None if chunk is None else max(1, chunk // 2))
    counts = (scene.spheres.count, scene.planes.count, scene.lights.count)
    rule = sb.soft_grad_rule(flat, ref, *counts, ref64=ref64)
    assert all(ok for _, ok in rule.values()), rule
    groups = rb.grad_groups(flat.cpu(), *counts)
    for leaf, rows in zeros:
        assert bool((groups[leaf][rows] == 0).all()), (leaf, groups[leaf][rows])
        assert bool((rb.grad_groups(ref.cpu(), *counts)[leaf][rows] == 0).all())


@pytest.mark.parametrize("mode", ["cot", "fused"])
@pytest.mark.parametrize("name,shape", [("demo", (32, 1, 1, False)), ("demo", (64, 2, 3, True)),
                                        ("demo", (128, 3, 2, False)),
                                        ("lights20", (128, 7, 6, False))])
def test_soft_bwd_any_plan_matches_plain(cuda_device, mode, name, shape):
    """Launch plans the planner picks only for very large scenes: one live
    object a chunk (weights from fresh covers, FUSED's transmissions swept
    again), windows smaller than the scene, transmissions not stored (with
    20 lights, past the 14 Lambert sign bits the kernel decides each sign and
    sweeps each transmission again). Each is held to the rule, two runs
    bit-identical."""
    from python_ray_tracer_tpu_torch.ops.cuda import soft_bwd_cuda as sb, soft_cuda
    scene = _soft_scene("demo", cuda_device) if name == "demo" else \
        _skip_scene(name, cuda_device)
    cam = trt.default_camera((48, 40), device=cuda_device)
    x = _soft_input(mode, cam, scene, _target((48, 40), cuda_device), 0.05)
    counts = (scene.spheres.count, scene.planes.count, scene.lights.count)
    plan = sb.Plan(*shape, sb.smem_bytes(*counts, mode == "fused", *shape))
    flat = sb._run(cam, scene, x, tau=0.05, mode=mode, shape=plan)
    assert torch.equal(flat, sb._run(cam, scene, x, tau=0.05, mode=mode, shape=plan))
    plain = sb.soft_loss_and_grads_plain if mode == "fused" else sb.soft_scene_grads_plain
    rule = sb.soft_grad_rule(flat, plain(cam, scene, x, tau=0.05), *counts,
                             ref64=plain(*soft_cuda.as_double(cam, scene), x.double(),
                                         tau=0.05))
    assert all(ok for _, ok in rule.values()), rule


def test_render_image_soft_fast_grads_match_plain_autograd(cuda_device):
    """render_image_soft_fast: the soft forward kernel forward, the soft backward
    kernel (one cotangent launch) backward, for scene and camera leaves."""
    from python_ray_tracer_tpu_torch.ops.cuda import soft_bwd_cuda as sb
    scene = _soft_scene("demo", cuda_device)
    cam = trt.default_camera((48, 40), device=cuda_device)
    g = (_target((48, 40), cuda_device, seed=2) - 0.5) / (48 * 40)
    before = sb.LAUNCHES["cot"]
    grads = []
    for fn in (trt.render_image_soft_fast, trt.render_image_soft):
        leaves = [t.detach().clone().requires_grad_(True)
                  for t in scene.leaves() + [cam.position, cam.rotation, cam.fov]]
        c = trt.Camera(*leaves[12:], cam.resolution)
        (fn(c, trt.Scene.from_leaves(leaves[:12]), tau=0.05) * g).sum().backward()
        grads.append(rb.flatten_grads(
            trt.Scene.from_leaves([t.grad if t.grad is not None else torch.zeros_like(t)
                                   for t in leaves[:12]]),
            trt.Camera(*(t.grad for t in leaves[12:]), cam.resolution)))
    assert sb.LAUNCHES["cot"] == before + 1
    rule = sb.soft_grad_rule(grads[0], grads[1], 6, 1, 3)
    assert all(ok for _, ok in rule.values()), rule


def test_soft_empty_scene(cuda_device):
    from python_ray_tracer_tpu_torch.ops.cuda import soft_bwd_cuda as sb
    dev = cuda_device
    scene = trt.Scene(trt.Spheres.build([], dev), trt.Planes.build([], dev),
                      trt.Lights.build([], dev), trt.Materials.build(device=dev))
    cam = trt.default_camera((20, 12), device=dev)
    assert float(trt.render_image_soft_cuda(cam, scene).abs().max()) == 0.0
    target = _target((20, 12), dev)
    loss, scene_g, cam_g = sb.soft_loss_and_grads_cuda(cam, scene, target,
                                                       return_camera=True)
    assert bool((rb.flatten_grads(scene_g, cam_g) == 0).all())
    assert float(loss) == pytest.approx(float((target ** 2).mean()), rel=1e-5)


def test_soft_wrappers_reject_bad_inputs(cuda_device):
    from python_ray_tracer_tpu_torch.ops.cuda import soft_bwd_cuda as sb
    scene = _soft_scene("demo", cuda_device)
    cam = trt.default_camera((16, 16), device=cuda_device)
    with pytest.raises(ValueError, match="tau"):
        trt.render_image_soft_cuda(cam, scene, tau=0.0)
    with pytest.raises(ValueError, match="shape"):
        sb.soft_loss_and_grads_cuda(cam, scene, _target((16, 16), cuda_device)[:8])
    with pytest.raises(ValueError, match="is on cpu"):
        sb.soft_scene_grads_cuda(cam, trt.default_scene(device="cpu"),
                                 _target((16, 16), cuda_device))


def test_fit_scene_soft_cuda_backend_on_card(cuda_device):
    """fit_scene_soft(backend="cuda"): one soft forward launch per stage (the
    target), one fused soft backward launch per step, the plain version never
    called, and the loss falls within each stage."""
    from python_ray_tracer_tpu_torch.ops.cuda import soft_bwd_cuda as sb, soft_cuda
    scene = _soft_scene("demo", cuda_device)
    cam = trt.default_camera((96, 96), device=cuda_device)
    init = trt.Scene.from_leaves(scene.leaves())
    init.spheres = trt.Spheres(scene.spheres.center + torch.tensor(
        [0.05, -0.04, 0.03], device=cuda_device), scene.spheres.radius,
        scene.spheres.albedo)
    sb.reset_launch_counts()
    soft_cuda.reset_launch_counts()
    _, losses = train.fit_scene_soft(init, cam, scene, steps=30, lr=1e-2, backend="cuda")
    assert sb.LAUNCHES == {"cot": 0, "fused": 30} and soft_cuda.LAUNCHES["soft_fwd"] == 3
    assert not any(sb.PLAIN_CALLS.values()) and not any(soft_cuda.PLAIN_CALLS.values())
    for k in range(3):
        assert losses[10 * k + 9] < losses[10 * k]


# --- the large-scene path: hit-extent kernel, cone cull, shadow lists, bounce tree --
#
# Every cull is exact, so a render with any of them on must equal the render
# with all of them off bit for bit (torch.equal on the float image). The
# hit-extent kernel against its plain version: hit_extents_cuda.extent_rule
# (counts equal, rows of tiles without hits equal to the sentinels, boxes
# within 1e-3 + 1e-6 m^2, m the row's largest coordinate).

from python_ray_tracer_tpu_torch.ops.cuda import cull_tables as ct  # noqa: E402
from python_ray_tracer_tpu_torch.ops.cuda import hit_extents_cuda as hx  # noqa: E402


def _planted_scene(n, dev, seed=11, lights=3, planes=True):
    """n seeded spheres plus one large sphere beyond light 0: shadow rays have
    no maximum distance, so it shadows the scene from behind the light."""
    base = trt.random_scene(n, generator=torch.Generator().manual_seed(seed), device=dev)
    L0 = base.lights.position[0]
    u = L0 - torch.tensor([0.0, 0.0, 2.0], device=dev)
    beyond = L0 + 4.0 * u / u.norm()
    sph = trt.Spheres(torch.cat([base.spheres.center, beyond[None]]),
                      torch.cat([base.spheres.radius, torch.tensor([1.5], device=dev)]),
                      torch.cat([base.spheres.albedo,
                                 torch.tensor([[1.0, 0.0, 0.0]], device=dev)]))
    return trt.Scene(sph, base.planes if planes else trt.Planes.build([], dev),
                     trt.Lights(base.lights.position[:lights]), base.materials)


# 100 and "1000 far": the horizon and sky tiles in view, so bounce rays start
# up to the far clip out on the ground plane, where the sphere tests' hoisted
# quadratic is noisiest. A ground-plane hit near the horizon is
# ill-conditioned (t = h / (d . n) with d . n near 0; no far clip in clean
# mode), so the 100-sphere pose is held against the plain version in compat
# mode only; at 1000 spheres so many bounce rays start far out that the full
# sweep's hoisted quadratic parts from the plain version's root form at more
# pixels than the flip rule allows in both modes, and "1000 far" is there for
# the culls' bit identity alone. 1000: the CLI's camera (RenderConfig).
# "1000 axis", at 129 x 65: the center column's primary rays have direction y
# exactly 0 and so have their ground bounces, from origins at y = 3 (a slab
# slope clamped at FLT_MAX once made the tree drop every box for them); there
# for the culls' bit identity alone.
LARGE_POSES = {24: ([-7.0, 0.0, 3.0], [0.0, -20.0, 0.0]),
               40: ([-7.0, 0.0, 3.0], [0.0, -15.0, 0.0]),
               100: ([-7.0, 0.0, 3.0], [0.0, 10.0, 0.0]),
               300: ([-2.0, 0.0, 2.0], [0.0, -30.0, 0.0]),
               1000: (list(RenderConfig.camera_position), list(RenderConfig.camera_euler)),
               "1000 far": ([-7.0, 0.0, 3.0], [0.0, 10.0, 0.0]),
               "1000 axis": ([-12.0, 3.0, 3.0], [0.0, -15.0, 0.0])}
HORIZON_POSES = (100, "1000 far")
POSE_RES = {"1000 axis": (129, 65)}     # every other pose renders 104 x 72


@pytest.mark.parametrize("n", [24, 100, 300])
@pytest.mark.parametrize("aliasing", [False, True])
@pytest.mark.parametrize("compat", [True, False])
def test_hit_extents_kernel_matches_plain(cuda_device, n, aliasing, compat):
    scene = _planted_scene(n, cuda_device)
    cam = trt.Camera.build((120, 72), *LARGE_POSES[n if compat else 24], device=cuda_device)
    k = ct.list_capacity(n + 1)
    vis = (*ct.tile_visibility(cam, scene, compat=compat, K=k), k)
    for v in (None, vis):
        hx.reset_launch_counts()
        a = hx.hit_extents_cuda(cam, scene, aliasing=aliasing, compat=compat, vis=v)
        b = hx.hit_extents_cuda(cam, scene, aliasing=aliasing, compat=compat, vis=v)
        torch.cuda.synchronize()
        assert hx.LAUNCHES["hit_extents"] == 2 and torch.equal(a, b)
        ref = hx.hit_extents_plain(cam, scene, aliasing=aliasing, compat=compat, vis=v)
        assert a.shape == ref.shape == (8 * 5, 8)
        rule = hx.extent_rule(a, ref)
        assert rule["ok"], rule


def _render_tabs(cam, scene, mode, depth, compat, tabs):
    W, H = cam.resolution
    dev = cam.device
    out = torch.empty((W, H, 3), device=dev)
    cnt = (scene.spheres.count, scene.planes.count, scene.lights.count)
    vis, shadow, tree, cells = tabs
    return render_cuda.launch(
        out, render_cuda.pack_params(cam, scene, compat).to(dev),
        render_cuda.scene_tables(scene), cnt, depth=depth, mode=mode, compat=compat,
        cheap_shadow=render_cuda.shadow_cheap_ok(scene, compat), vis=vis, shadow=shadow,
        tree=tree, cells=cells)


CULLS = {"cull": dict(cull=True, shadow_lists=False, group_cull=False),
         "lists": dict(cull=False, shadow_lists=True, group_cull=False),
         "groups": dict(cull=False, shadow_lists=False, group_cull=True),
         "all": dict(cull=True, shadow_lists=True, group_cull=True),
         "auto": dict()}
ALL_OFF = dict(cull=False, shadow_lists=False, group_cull=False)


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("compat", [True, False])
@pytest.mark.parametrize("n", [24, 40, 100, 300, 1000, "1000 far", "1000 axis"])
def test_culls_are_bit_identical_to_the_full_sweep(cuda_device, mode, compat, n):
    """Each cull alone, all together, the automatic choice, and lists forced
    to K=2 so that every row overflows, against all culls off; then all on
    against the plain version under the flip rule."""
    mats = trt.Materials.build(0.05, 0.6, 0.3, 0.5, 16.0, device=cuda_device)
    pose, res = LARGE_POSES[n], POSE_RES.get(n, (104, 72))
    n = int(str(n).split()[0])
    scene = _planted_scene(n, cuda_device)
    scene.materials = mats
    cam = trt.Camera.build(res, *pose, device=cuda_device)
    aa = mode != "aa_none"
    kw = dict(depth=2, compat=compat, aliasing=aa, aa_share=mode == "aa_shared")
    hx.reset_launch_counts()
    off = trt.render_image_cuda(cam, scene, **kw, **ALL_OFF)
    assert hx.LAUNCHES["hit_extents"] == 0
    for name, culls in CULLS.items():
        hx.reset_launch_counts()
        img = trt.render_image_cuda(cam, scene, **kw, **culls)
        torch.cuda.synchronize()
        assert hx.LAUNCHES["hit_extents"] == int(name in ("lists", "all", "auto")), name
        assert torch.equal(img, off), (name, int((img != off).any(-1).sum()))
    tabs = render_cuda.large_scene_tables(cam, scene, depth=2, aliasing=aa, compat=compat,
                                          group_cull=True, K=2)
    assert int((tabs[0][1] >= 0).sum()) < tabs[0][1].numel()      # rows overflow
    assert torch.equal(_render_tabs(cam, scene, mode, 2, compat, tabs), off)
    if res == (104, 72) and ((compat and n < 1000) or
                             pose not in [LARGE_POSES[k] for k in HORIZON_POSES]):
        ref = trt.render_image(cam, scene, depth=2, aliasing=aa, compat=compat)
        assert _flipped(off, ref) <= 1e-3 * 104 * 72


@pytest.mark.parametrize("lights,planes", [(0, True), (3, False), (1, True)])
def test_culls_without_lights_or_planes(cuda_device, lights, planes):
    scene = _planted_scene(40, cuda_device, lights=lights, planes=planes)
    cam = trt.Camera.build((96, 64), *LARGE_POSES[40], device=cuda_device)
    for aa in (False, True):
        off = trt.render_image_cuda(cam, scene, depth=2, aliasing=aa, **ALL_OFF)
        hx.reset_launch_counts()
        on = trt.render_image_cuda(cam, scene, depth=2, aliasing=aa, group_cull=True)
        assert hx.LAUNCHES["hit_extents"] == int(lights > 0)
        assert torch.equal(on, off)
        ref = trt.render_image(cam, scene, depth=2, aliasing=aa)
        assert _flipped(on, ref) <= 1e-3 * 96 * 64


def test_planted_occluder_beyond_the_light_still_shadows(cuda_device):
    """The lists keep a sphere beyond a light: with it the image differs from
    the scene without it, and lists on equals lists off."""
    scene = _planted_scene(22, cuda_device)
    base = trt.Scene(trt.Spheres(scene.spheres.center[:-1], scene.spheres.radius[:-1],
                                 scene.spheres.albedo[:-1]),
                     scene.planes, scene.lights, scene.materials)
    cam = trt.Camera.build((96, 64), [-7.0, 0.0, 3.0], [0.0, 10.0, 0.0], device=cuda_device)
    on = trt.render_image_cuda(cam, scene, depth=1, aliasing=False, shadow_lists=True)
    off = trt.render_image_cuda(cam, scene, depth=1, aliasing=False, **ALL_OFF)
    without = trt.render_image_cuda(cam, base, depth=1, aliasing=False, shadow_lists=True)
    assert torch.equal(on, off)
    assert float((on - without).abs().max()) > 1e-3


def test_render_image_fast_on_a_large_scene(cuda_device):
    """Forward on the large-scene path, backward through the unculled backward
    kernel: the same gradient as with every cull off."""
    scene = _planted_scene(40, cuda_device)
    cam = trt.Camera.build((64, 48), *LARGE_POSES[40], device=cuda_device)
    target = _target((64, 48), cuda_device)
    grads = []
    for culls in (dict(), ALL_OFF):
        leaves = [t.detach().clone().requires_grad_(True) for t in scene.leaves()]
        hx.reset_launch_counts()
        img = render_cuda.render_image_fast(cam, trt.Scene.from_leaves(leaves), depth=2,
                                            aliasing=False, **culls)
        assert hx.LAUNCHES["hit_extents"] == int(not culls)
        torch.mean((img - target) ** 2).backward()
        grads.append(leaves[0].grad)
    assert torch.equal(grads[0], grads[1]) and bool(grads[0].abs().max() > 0)


def test_large_scene_wrappers_reject_bad_tables(cuda_device):
    scene = _planted_scene(24, cuda_device)
    cam = trt.Camera.build((32, 32), *LARGE_POSES[24], device=cuda_device)
    with pytest.raises(ValueError, match="n_levels"):
        hx.hit_extents_cuda(cam, scene, aliasing=False, n_levels=0)
    vis, shadow, tree, cells = render_cuda.large_scene_tables(cam, scene, depth=2,
                                                              aliasing=False, compat=True,
                                                              group_cull=True)
    with pytest.raises(ValueError, match="primary list"):
        _render_tabs(cam, scene, "aa_none", 2, True, ((vis[0][:-1], vis[1], vis[2]), None,
                                                      None, None))
    with pytest.raises(ValueError, match="shadow list"):
        _render_tabs(cam, scene, "aa_none", 2, True, (None, (shadow[0].cpu(), *shadow[1:]),
                                                      None, None))
    with pytest.raises(ValueError, match="tree sweep order"):
        _render_tabs(cam, scene, "aa_none", 2, True, (None, None, tree._replace(
            perm=tree.perm[:-1]), None))
    with pytest.raises(ValueError, match="bounce tree"):
        _render_tabs(cam, scene, "aa_none", 2, True, (None, None, tree._replace(
            n_leaves=tree.n_leaves + 1), None))
    with pytest.raises(ValueError, match="light cells counts"):
        _render_tabs(cam, scene, "aa_none", 2, True, (None, None, None, cells._replace(
            cnt=cells.cnt[:-1])))
    two = hx.hit_extents_cuda(cam, scene, aliasing=True, n_levels=2, vis=vis)
    one = hx.hit_extents_cuda(cam, scene, aliasing=True, n_levels=1, vis=vis)
    assert two.shape == (8, 8) and torch.equal(two[0::2], one)
    # past level 0 the tree's hit points are the full sweep's
    three = hx.hit_extents_cuda(cam, scene, aliasing=True, n_levels=3, vis=vis, tree=tree)
    assert torch.equal(three, hx.hit_extents_cuda(cam, scene, aliasing=True, n_levels=3,
                                                  vis=vis))


# --- adaptive AA: the worklist kernel -------------------------------------------------
#
# The kernel against the plain trace of the same worklist into the same tent
# image: at most 0.1% of the listed pixels off by more than 1 level (the flip
# rule), two runs bit-identical. With every interior pixel listed the frame is
# the per-sample AA render: above 16 spheres both run the pinned arithmetic of
# render_fwd.cu, so torch.equal; on the demo scene (render_fwd_small.cu, the
# compiler's contraction in two kernels) tests/test_adaptive.py's JAX rule,
# max |d| <= 3e-5 and uint8 off by at most 1 on at most 0.2% of the pixels.

from python_ray_tracer_tpu_torch.ops import adaptive as adp  # noqa: E402
from python_ray_tracer_tpu_torch.ops.cuda import adaptive_cuda as ac  # noqa: E402

ADAPTIVE_RES = (160, 120)
INTERIOR = (ADAPTIVE_RES[0] - 2) * (ADAPTIVE_RES[1] - 2)


def _adaptive_scene(n, dev, compat):
    """The demo scene (n = 0) or n planted spheres, seen from the default
    camera at 160x120 (no horizon in view: ground hits there are
    ill-conditioned, LARGE_POSES)."""
    mats = trt.Materials.build(0.05, 0.6, 0.3, 0.0 if compat else 0.5, 16.0, device=dev)
    cam = trt.default_camera(ADAPTIVE_RES, device=dev)
    if n == 0:
        return trt.default_scene(mats, device=dev), cam
    scene = _planted_scene(n, dev)
    scene.materials = mats
    return scene, cam


def _worklist(cam, scene, compat, eps, budget):
    """``(packed, tables, tent, idx, flagged, dropped)``; ``tables`` as
    launch_list's keywords."""
    packed, (vis, shadow, tree, cells), *rest = ac.worklist_inputs(
        cam, scene, depth=2, compat=compat, eps=eps, budget_frac=budget)
    return (packed, dict(vis=vis, shadow=shadow, tree=tree, cells=cells), *rest)


@pytest.mark.parametrize("n", [0, 24, 100])
@pytest.mark.parametrize("compat", [True, False])
def test_list_kernel_matches_plain(cuda_device, n, compat):
    scene, cam = _adaptive_scene(n, cuda_device, compat)
    packed, tabs, tent, idx, flagged, dropped = _worklist(cam, scene, compat, 0.5 / 255, 1.0)
    cheap = render_cuda.shadow_cheap_ok(scene, compat)
    ac.reset_launch_counts()
    a = ac.launch_list(tent.clone(), *packed, idx, flagged, depth=2, compat=compat,
                       cheap_shadow=cheap, **tabs)
    b = ac.launch_list(tent.clone(), *packed, idx, flagged, depth=2, compat=compat,
                       cheap_shadow=cheap, **tabs)
    torch.cuda.synchronize()
    assert ac.LAUNCHES["render_list"] == 2 and torch.equal(a, b)
    n_listed = int(flagged)
    assert 0 < n_listed <= INTERIOR and int(dropped) == 0
    ref = adp.trace_worklist_plain(cam, scene, idx, flagged, tent, depth=2, compat=compat)
    listed = torch.zeros(ADAPTIVE_RES[0] * ADAPTIVE_RES[1], dtype=torch.bool,
                         device=cuda_device)
    listed[idx[:n_listed].long()] = True
    assert torch.equal(a.reshape(-1, 3)[~listed], tent.reshape(-1, 3)[~listed])
    d = (trt.to_framebuffer(a).int() - trt.to_framebuffer(ref).int()).abs().amax(0)
    assert int((d.reshape(-1)[listed] > 1).sum()) <= 1e-3 * n_listed


@pytest.mark.parametrize("n", [24, 100, 1000])
@pytest.mark.parametrize("compat", [True, False])
def test_list_kernel_with_tables_is_the_list_kernel_without(cuda_device, n, compat):
    """The worklist kernel reading its pixels' tile lists, the bounce tree and
    the light cells against the same launch with every table off, bit for bit
    (listed pixels everywhere, the budget dropping none)."""
    scene, cam = _adaptive_scene(n, cuda_device, compat)
    packed, tabs, tent, idx, flagged, dropped = _worklist(cam, scene, compat, 0.5 / 255, 1.0)
    assert tabs["vis"] is not None and tabs["shadow"] is not None
    assert tabs["cells"] is not None
    assert (tabs["tree"] is not None) == (n >= render_cuda.GROUP_MIN_SPHERES)
    if tabs["tree"] is None:
        tabs["tree"] = ct.bounce_tree(scene.spheres.center, scene.spheres.radius)
    cheap = render_cuda.shadow_cheap_ok(scene, compat)
    kw = dict(depth=2, compat=compat, cheap_shadow=cheap)
    off = ac.launch_list(tent.clone(), *packed, idx, flagged, **kw)
    on = ac.launch_list(tent.clone(), *packed, idx, flagged, **kw, **tabs)
    torch.cuda.synchronize()
    assert int(flagged) > 0 and int(dropped) == 0
    assert torch.equal(on, off), int((on != off).any(-1).sum())
    for only in ("vis", "shadow", "tree", "cells"):
        one = ac.launch_list(tent.clone(), *packed, idx, flagged, **kw, **{only: tabs[only]})
        assert torch.equal(one, off), only


@pytest.mark.parametrize("n", [24, 100, 1000])
@pytest.mark.parametrize("compat", [True, False])
def test_adaptive_all_flagged_is_the_per_sample_render(cuda_device, n, compat):
    scene, cam = _adaptive_scene(n, cuda_device, compat)
    out, st = trt.render_image_adaptive_cuda(cam, scene, compat=compat, eps=-1.0,
                                             budget_frac=1.0, with_stats=True)
    ref = trt.render_image_cuda(cam, scene, compat=compat, aliasing=True, aa_share=False)
    assert int(st["flagged"]) == INTERIOR and int(st["dropped"]) == 0
    assert torch.equal(out, ref), int((out != ref).any(-1).sum())


@pytest.mark.parametrize("compat", [True, False])
def test_adaptive_all_flagged_demo_scene(cuda_device, compat):
    scene, cam = _adaptive_scene(0, cuda_device, compat)
    out = trt.render_image_adaptive_cuda(cam, scene, compat=compat, eps=-1.0,
                                         budget_frac=1.0)
    ref = trt.render_image_cuda(cam, scene, compat=compat, aliasing=True, aa_share=False)
    assert float((out - ref).abs().max()) <= 3e-5
    d = (trt.to_framebuffer(out).int() - trt.to_framebuffer(ref).int()).abs()
    assert int(d.max()) <= 1 and float((d.amax(0) > 0).float().mean()) <= 0.002


def test_adaptive_wrapper_launches_and_budget(cuda_device):
    """One centers pass and one worklist launch a frame, no AA render; pixels
    flagged past the budget keep the tent value and are reported."""
    scene, cam = _adaptive_scene(0, cuda_device, True)
    render_cuda.reset_launch_counts()
    ac.reset_launch_counts()
    full, sf = trt.render_image_adaptive_cuda(cam, scene, eps=0.5 / 255, budget_frac=1.0,
                                              with_stats=True)
    torch.cuda.synchronize()
    assert ac.LAUNCHES["render_list"] == 1
    assert dict(render_cuda.LAUNCHES) == {"aa_none": 1, "aa_per_sample": 0, "aa_shared": 0}
    K = adp.budget_slots(*ADAPTIVE_RES, 0.05)
    part, sp = trt.render_image_adaptive_cuda(cam, scene, eps=0.5 / 255, budget_frac=0.05,
                                              with_stats=True)
    assert int(sp["flagged"]) == int(sf["flagged"]) > K
    assert int(sp["dropped"]) == int(sf["flagged"]) - K
    _, _, tent, idx, _, _ = _worklist(cam, scene, True, 0.5 / 255, 1.0)
    kept, cut = idx[:K].long(), idx[K:int(sf["flagged"])].long()
    assert torch.equal(part.reshape(-1, 3)[kept], full.reshape(-1, 3)[kept])
    assert torch.equal(part.reshape(-1, 3)[cut], tent.reshape(-1, 3)[cut])
    cpu = trt.render_image_adaptive_plain(cam.to("cpu"), trt.Scene.from_leaves(
        [t.cpu() for t in scene.leaves()]), eps=0.5 / 255, budget_frac=1.0)
    assert _flipped(full.cpu(), cpu) <= 1e-3 * ADAPTIVE_RES[0] * ADAPTIVE_RES[1]


def test_list_kernel_rejects_bad_inputs(cuda_device):
    scene, cam = _adaptive_scene(0, cuda_device, True)
    packed, _, tent, idx, flagged, _ = _worklist(cam, scene, True, 0.5 / 255, 0.25)
    kw = dict(depth=2, compat=True, cheap_shadow=True)
    with pytest.raises(ValueError, match="idx"):
        ac.launch_list(tent, *packed, idx.long(), flagged, **kw)
    with pytest.raises(ValueError, match="flagged"):
        ac.launch_list(tent, *packed, idx, flagged.cpu(), **kw)
    with pytest.raises(ValueError, match="out"):
        ac.launch_list(tent.double(), *packed, idx, flagged, **kw)
    # the small-scene instantiation takes no table
    with pytest.raises(RuntimeError, match="worklist kernel failed"):
        ac.launch_list(tent, *packed, idx, flagged, **kw,
                       tree=ct.bounce_tree(scene.spheres.center, scene.spheres.radius))
    mixed = trt.Scene.from_leaves([t.cpu() if i == 0 else t
                                   for i, t in enumerate(scene.leaves())])
    with pytest.raises(ValueError, match="expected cuda"):
        trt.render_image_adaptive_cuda(cam, mixed)


# --- the light cells of the bounce shadow rays ---------------------------------------
#
# The build kernel (csrc/light_cells.cu) against its plain version integer for
# integer; frames with the cells on against the same kernel instantiation with
# them off (large_scene_tables(light_cells=False): the tile lists and the tree
# as before), bit for bit, for aa_none, aa_shared and the worklist kernel; a
# library built with LC_K = 2, where most rows overflow to the sweep of before,
# gives the same frames; the build makes no host sync.

from python_ray_tracer_tpu_torch.ops.cuda import _build  # noqa: E402
from python_ray_tracer_tpu_torch.ops.cuda import light_cells_cuda as lc  # noqa: E402

# 100: the horizon in view (bounce shadow rays from far out on the ground take
# the fallback past s_max); 1000: the CLI's camera.
CELL_POSES = {100: LARGE_POSES[100], 1000: LARGE_POSES[1000]}


def _cells_scene(n, dev, compat, lights=3):
    mats = trt.Materials.build(0.05, 0.6, 0.3, 0.0 if compat else 0.5, 16.0, device=dev)
    scene = _planted_scene(n, dev, lights=lights)
    scene.materials = mats
    return scene, trt.Camera.build((104, 72), *CELL_POSES[n], device=dev)


@pytest.mark.parametrize("n", [100, 1000])
@pytest.mark.parametrize("lights", [1, 3])
def test_light_cell_kernel_is_its_plain_version(cuda_device, n, lights):
    scene, _ = _cells_scene(n, cuda_device, True, lights)
    ns, nl = scene.spheres.count, scene.lights.count
    sph, _, lts = render_cuda.scene_tables(scene)
    lc.reset_launch_counts()
    a = lc.light_cells_cuda(sph, lts, ns, nl)
    b = lc.light_cells_cuda(sph, lts, ns, nl)
    torch.cuda.synchronize()
    assert lc.LAUNCHES["light_cells"] == 2
    ref = lc.light_cells_plain(scene.spheres.center, scene.spheres.radius,
                               scene.lights.position)
    with pytest.raises(ValueError, match="light_cells_cuda takes CUDA tensors, got cpu"):
        lc.light_cells_cuda(sph.cpu(), lts.cpu(), ns, nl)
    cpu = lc.light_cells_plain(sph[0:3, :ns].T.cpu(), sph[3, :ns].cpu(), lts[:, :nl].T.cpu())
    assert lc.LAUNCHES["light_cells"] == 2
    for x, y, z, w in zip(a, b, ref, cpu):
        assert torch.equal(x, y) and torch.equal(x, z) and torch.equal(x.cpu(), w)
    assert bool((a.cnt > 0).any())


def _frame_pair(cam, scene, mode, compat, depth=2):
    """The frame of ``mode`` (or of the worklist kernel, every interior pixel
    listed) with the light cells on and with them off, the other tables
    the same."""
    aa = mode != "aa_none"
    tabs = render_cuda.large_scene_tables(cam, scene, depth=depth, aliasing=aa,
                                          compat=compat)
    assert tabs[3] is not None
    off = (*tabs[:3], None)
    if mode != "worklist":
        return (_render_tabs(cam, scene, mode, depth, compat, tabs),
                _render_tabs(cam, scene, mode, depth, compat, off),
                _render_tabs(cam, scene, mode, depth, compat, (None,) * 4))
    packed, _, tent, idx, flagged, _ = ac.worklist_inputs(
        cam, scene, depth=depth, compat=compat, eps=-1.0, budget_frac=1.0)
    kw = dict(depth=depth, compat=compat,
              cheap_shadow=render_cuda.shadow_cheap_ok(scene, compat))
    return tuple(ac.launch_list(tent.clone(), *packed, idx, flagged, **kw,
                                **dict(zip(("vis", "shadow", "tree", "cells"), t)))
                 for t in (tabs, off, (None,) * 4))


@pytest.mark.parametrize("mode", ["aa_none", "aa_shared", "worklist"])
@pytest.mark.parametrize("compat", [True, False])
@pytest.mark.parametrize("n", [100, 1000])
def test_frames_with_light_cells_are_the_frames_without(cuda_device, mode, compat, n):
    scene, cam = _cells_scene(n, cuda_device, compat)
    on, off, none = _frame_pair(cam, scene, mode, compat)
    torch.cuda.synchronize()
    assert torch.equal(on, off), int((on != off).any(-1).sum())
    assert torch.equal(on, none), int((on != none).any(-1).sum())


def _launch_with(lib, out, packed, mode, compat, cheap, tabs, depth=2):
    from python_ray_tracer_tpu_torch.ops.cuda.hit_extents_cuda import table_args
    (params, (sph, pln, lts), (ns, npl, nl)) = packed
    W, H = out.shape[0], out.shape[1]
    v, sh, g, c = table_args(*tabs)
    rc = lib.rt_render_fwd(params.data_ptr(), sph.data_ptr(), ns, pln.data_ptr(), npl,
                           lts.data_ptr(), nl, out.data_ptr(), W, H, W, depth,
                           render_cuda.MODES.index(mode), int(compat), int(cheap), 1,
                           *v, *sh, *g, *c, None)
    assert rc == 0, rc
    return out


def test_small_k_overflows_rows_and_keeps_the_frames(cuda_device):
    """A library built with LC_K = 2 (-DRT_LC_K=2): its build kernel equals the
    plain version at k = 2, most rows hold -1, and its frames with those cells
    equal the package's with the cells off."""
    path = _build.build(("render_fwd.cu", "render_fwd_small.cu", "light_cells.cu"),
                        ("-DRT_LC_K=2",))
    lib = _build.declare(__import__("ctypes").CDLL(path))
    assert _build.light_cells_shape(lib) == (lc.R, 2)
    for n in (100, 1000):
        for compat in (True, False):
            scene, cam = _cells_scene(n, cuda_device, compat)
            ns, nl = scene.spheres.count, scene.lights.count
            packed = render_cuda.packed_inputs(cam, scene, depth=2, compat=compat)
            sph, _, lts = packed[1]
            small = lc.launch(lc.empty(nl, cuda_device, k=2), sph, lts, ns, nl, lib=lib)
            torch.cuda.synchronize()
            ref = lc.light_cells_plain(scene.spheres.center, scene.spheres.radius,
                                       scene.lights.position, k=2)
            assert all(torch.equal(x, y) for x, y in zip(small, ref))
            assert bool((small.cnt < 0).any()) and bool((small.cnt >= 0).any())
            cheap = render_cuda.shadow_cheap_ok(scene, compat)
            for mode in ("aa_none", "aa_shared"):
                tabs = render_cuda.large_scene_tables(cam, scene, depth=2,
                                                      aliasing=mode != "aa_none",
                                                      compat=compat, light_cells=False)
                W, H = cam.resolution
                got = _launch_with(lib, torch.empty((W, H, 3), device=cuda_device), packed,
                                   mode, compat, cheap, (*tabs[:3], small))
                want = _render_tabs(cam, scene, mode, 2, compat, tabs)
                torch.cuda.synchronize()
                assert torch.equal(got, want), (n, compat, mode,
                                                int((got != want).any(-1).sum()))


def test_light_cell_build_makes_no_host_sync(cuda_device):
    scene, _ = _cells_scene(1000, cuda_device, True)
    sph, _, lts = render_cuda.scene_tables(scene)
    ns, nl = scene.spheres.count, scene.lights.count
    lc.light_cells_cuda(sph, lts, ns, nl)          # the library is loaded
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        cells = lc.light_cells_cuda(sph, lts, ns, nl)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    assert cells.cnt.shape == (lc.n_rows(nl),)


# --- the level-0 shadow lists on the card: the list kernel -----------------------------
#
# csrc/shadow_lists.cu against cull_tables.shadow_visibility_lists on the same
# hit-extent rows, integer for integer (counts and slots), at list capacity
# and at K = 4 (rows overflow); two runs bit-identical. The hit-extent kernel's
# scale against cull_tables.extent_scale of its own rows, bit for bit; the
# two launches of the render path make no host sync; frames with the kernel's
# lists equal the frames with every cull off.

from python_ray_tracer_tpu_torch.ops.cuda import shadow_lists_cuda as sl  # noqa: E402

# 24 and 100: the horizon in view, sky tiles beside boxes that reach far out on
# the ground; 1000: the CLI's camera.
LIST_POSES = {24: LARGE_POSES[24], 100: LARGE_POSES[100], 1000: LARGE_POSES[1000]}


def _list_inputs(n, dev, aliasing, compat, res=(160, 96), pose=None):
    scene = _planted_scene(n, dev)
    cam = trt.Camera.build(res, *(pose or LIST_POSES[n]), device=dev)
    k = ct.list_capacity(n + 1)
    vis = (*ct.tile_visibility(cam, scene, compat=compat, K=k), k)
    scale = torch.full((1,), float("nan"), device=dev)
    ext = hx.hit_extents_cuda(cam, scene, aliasing=aliasing, compat=compat, vis=vis,
                              scale=scale)
    return scene, cam, vis, ext, scale


@pytest.mark.parametrize("n", [24, 100, 1000])
@pytest.mark.parametrize("aliasing", [False, True])
@pytest.mark.parametrize("compat", [True, False])
def test_shadow_list_kernel_is_its_plain_version(cuda_device, n, aliasing, compat):
    scene, _, vis, ext, scale = _list_inputs(n, cuda_device, aliasing, compat)
    L, C, R = scene.lights.position, scene.spheres.center, scene.spheres.radius
    for K in (vis[2], 4):
        sl.reset_launch_counts()
        a = sl.shadow_lists_cuda(ext, scale, L, C, R, K=K, compat=compat)
        b = sl.shadow_lists_cuda(ext, scale, L, C, R, K=K, compat=compat)
        torch.cuda.synchronize()
        assert sl.LAUNCHES["shadow_lists"] == 2
        assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])
        want = ct.shadow_visibility_lists(ext, L, C, R, K=K, compat=compat)
        assert torch.equal(a[1], want[1]), int((a[1] != want[1]).sum())
        assert torch.equal(a[0], want[0]), int((a[0] != want[0]).sum())
        assert bool((a[1] == 0).any()) or n == 1000          # sky rows keep nothing
        if K == 4:
            assert bool((a[1] == -1).any())


@pytest.mark.parametrize("n", [100, 1000])
@pytest.mark.parametrize("aliasing", [False, True])
@pytest.mark.parametrize("compat", [True, False])
def test_hit_extents_kernel_scale_and_repeats(cuda_device, n, aliasing, compat):
    """The hit-extent kernel (a group of warps a tile) under extent_rule, its rows
    and scale bit-identical over two runs, the scale extent_scale of its rows,
    the rows with and without the scale buffer the same. The 100-sphere pose
    has the horizon in view, so it is held to the rule in compat mode only
    (test_hit_extents_kernel_matches_plain's convention)."""
    pose = None if compat or n == 1000 else LARGE_POSES[24]
    scene, cam, vis, ext, scale = _list_inputs(n, cuda_device, aliasing, compat, pose=pose)
    scale2 = torch.full((1,), float("nan"), device=cuda_device)
    again = hx.hit_extents_cuda(cam, scene, aliasing=aliasing, compat=compat, vis=vis,
                                scale=scale2)
    bare = hx.hit_extents_cuda(cam, scene, aliasing=aliasing, compat=compat, vis=vis)
    torch.cuda.synchronize()
    assert torch.equal(ext, again) and torch.equal(ext, bare) and torch.equal(scale, scale2)
    assert torch.equal(scale, ct.extent_scale(ext).reshape(1))
    rule = hx.extent_rule(ext, hx.hit_extents_plain(cam, scene, aliasing=aliasing,
                                                    compat=compat, vis=vis))
    assert rule["ok"], rule


def test_list_pipeline_makes_no_host_sync(cuda_device):
    """The render path's two launches, hit extents then lists, on packed
    inputs: no host sync."""
    scene, cam, vis, _, _ = _list_inputs(1000, cuda_device, True, True)
    packed = render_cuda.packed_inputs(cam, scene, depth=2, compat=True)
    W, H = cam.resolution
    n_tx, n_ty = ct.tile_grid(W, H)
    L, C, R = scene.lights.position, scene.spheres.center, scene.spheres.radius
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        scale = torch.empty(1, device=cuda_device)
        ext = hx.launch(torch.empty((n_tx * n_ty, 8), device=cuda_device), *packed, W=W, H=H,
                        aliasing=True, compat=True, n_levels=1, vis=vis, scale=scale)
        idx, cnt = sl.shadow_lists_cuda(ext, scale, L, C, R, K=vis[2], compat=True)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    want = ct.shadow_visibility_lists(ext, L, C, R, K=vis[2], compat=True)
    assert torch.equal(idx, want[0]) and torch.equal(cnt, want[1])


@pytest.mark.parametrize("n", [100, 1000])
@pytest.mark.parametrize("mode", MODES)
def test_frames_with_the_list_kernel_equal_culls_off(cuda_device, n, mode):
    """render_image_cuda with every cull on (one hit-extent and one list
    launch a frame) against every cull off, bit for bit, in compat and clean
    mode; the lists forced to K = 4 give the same frame."""
    scene = _planted_scene(n, cuda_device)
    cam = trt.Camera.build((320, 180), *LIST_POSES[n], device=cuda_device)
    aa = mode != "aa_none"
    for compat in (True, False):
        kw = dict(depth=2, compat=compat, aliasing=aa, aa_share=mode == "aa_shared")
        off = trt.render_image_cuda(cam, scene, **kw, **ALL_OFF)
        hx.reset_launch_counts()
        sl.reset_launch_counts()
        on = trt.render_image_cuda(cam, scene, **kw, **CULLS["all"])
        torch.cuda.synchronize()
        assert hx.LAUNCHES["hit_extents"] == 1 and sl.LAUNCHES["shadow_lists"] == 1
        assert torch.equal(on, off), (compat, int((on != off).any(-1).sum()))
        tabs = render_cuda.large_scene_tables(cam, scene, depth=2, aliasing=aa,
                                              compat=compat, K=4)
        assert bool((tabs[1][1] == -1).any())
        assert torch.equal(_render_tabs(cam, scene, mode, 2, compat, tabs), off)


# --- the ray-parallel path: slices, their gradients, the repair, animation ---------

def _sliced(n, fn):
    from python_ray_tracer_tpu_torch.parallel import make_mesh
    return torch.cat([fn(make_mesh(size=n, rank=i)) for i in range(n)])


@pytest.mark.parametrize("n_spheres", [0, 300])
@pytest.mark.parametrize("mode", MODES)
def test_slices_stitch_to_the_whole_frame(cuda_device, n_spheres, mode):
    """Slices of 2, 4 and 8 (widths not a multiple of 16) stitched equal the
    whole frame bit for bit: the demo scene, and 300 spheres with the cone
    cull, the shadow lists, the light cells and the bounce tree on."""
    from python_ray_tracer_tpu_torch.parallel import render_image_sharded
    if n_spheres:
        scene = trt.random_scene(n_spheres, generator=torch.Generator().manual_seed(3),
                                 device=cuda_device)
    else:
        scene = trt.default_scene(device=cuda_device)
    cam = trt.default_camera((360, 200), device=cuda_device)
    kw = dict(aliasing=mode != "aa_none", aa_share=mode == "aa_shared")
    whole = trt.render_image_cuda(cam, scene, **kw)
    for n in (2, 4, 8):
        st = _sliced(n, lambda m: render_image_sharded(cam, scene, m, **kw))
        assert torch.equal(st, whole), (n, int((st != whole).any(-1).sum()))


@pytest.mark.parametrize("mode", ["fused_noaa", "fused_aa", "cot_noaa", "cot_aa"])
def test_slice_gradients_sum_to_the_frame(cuda_device, mode):
    """The partials of 4 slices (96 wide) summed against the whole frame's
    under the kernel rule, the fused loss within rel 1e-6."""
    from python_ray_tracer_tpu_torch.parallel.mesh import column_slice
    scene = cli.fit_scene_two_spheres(RenderConfig(), cuda_device)
    cam = trt.default_camera((384, 256), device=cuda_device)
    aa = mode.endswith("_aa")
    init = trt.Scene.from_leaves(scene.leaves())
    init.spheres = trt.Spheres(scene.spheres.center + torch.tensor(cli.FIT_SHIFT,
                                                                   device=cuda_device),
                               scene.spheres.radius, scene.spheres.albedo)
    x = trt.render_image_cuda(cam, scene, aliasing=aa)
    if not mode.startswith("fused"):
        x = torch.rand(x.shape, generator=torch.Generator().manual_seed(4)).to(cuda_device)

    def run(x0, lw):
        xs = x[x0:x0 + lw].contiguous()
        if mode.startswith("fused"):
            lo, g, c = rb.loss_and_scene_grads_cuda(cam, init, xs, aliasing=aa,
                                                    return_camera=True, x_offset=x0,
                                                    local_width=lw)
            return rb.flatten_grads(g, c, lo)
        return rb.flatten_grads(*rb.scene_grads_cuda(cam, init, xs * 1e-2, aliasing=aa,
                                                     return_camera=True, x_offset=x0,
                                                     local_width=lw))
    whole = run(0, 384)
    parts = sum(run(*column_slice(384, i, 4)) for i in range(4))
    res = rb.grad_rule(parts, whole, *_counts(scene))
    assert all(ok for _, ok in res.values()), res
    if mode.startswith("fused"):
        assert abs(float(parts[-1]) - float(whole[-1])) <= 1e-6 * abs(float(whole[-1]))


def test_soft_slice_gradients_sum_to_the_frame(cuda_device):
    from python_ray_tracer_tpu_torch.ops.cuda import soft_bwd_cuda as sb
    from python_ray_tracer_tpu_torch.ops.cuda.soft_cuda import render_image_soft_cuda
    from python_ray_tracer_tpu_torch.parallel.mesh import column_slice
    scene = trt.default_scene(device=cuda_device)
    cam = trt.default_camera((256, 256), device=cuda_device)
    target = render_image_soft_cuda(cam, scene, tau=0.05)
    init = trt.Scene.from_leaves(scene.leaves())
    init.spheres = trt.Spheres(scene.spheres.center + 0.03, scene.spheres.radius,
                               scene.spheres.albedo)

    def run(x0, lw):
        lo, g, c = sb.soft_loss_and_grads_cuda(cam, init, target[x0:x0 + lw].contiguous(),
                                               tau=0.05, return_camera=True, x_offset=x0,
                                               local_width=lw)
        return rb.flatten_grads(g, c, lo)
    whole = run(0, 256)
    parts = sum(run(*column_slice(256, i, 4)) for i in range(4))
    res = sb.soft_grad_rule(parts, whole, *_counts(scene))
    assert all(ok for _, ok in res.values()), res
    assert abs(float(parts[-1]) - float(whole[-1])) <= 1e-6 * abs(float(whole[-1]))


def _counts(scene):
    return scene.spheres.count, scene.planes.count, scene.lights.count


def test_backward_at_the_render_limit(cuda_device):
    """7753 spheres (1 plane, 3 lights: the largest scene the render takes)
    at 48x48, depth 1, no AA, seen from outside the cloud: the hard backward
    (global form) against the plain version computed 8 columns at a time.
    Held out: the 0.1% of pixels and every pixel whose renders differ by more
    than 2e-6 (chip_smoke.REPAIR_TIE: this dense view has more near-tie
    decisions than the 0.1%)."""
    scene = trt.random_scene(7753, generator=torch.Generator().manual_seed(1),
                             device=cuda_device)
    cam = trt.Camera.build((48, 48), [-12.0, 0.0, 4.0], [0.0, -15.0, 0.0], device=cuda_device)
    assert not rb.launch_plan(cam, scene, "cot_noaa").staged
    kw = dict(depth=1, aliasing=False)
    img_k = trt.render_image_cuda(cam, scene, group_cull=False, **kw)
    with torch.no_grad():
        img_p = torch.cat([trt.render_image(cam, scene, x_offset=x0, local_width=8, **kw)
                           for x0 in range(0, 48, 8)])
    held = (rb.held_out(img_k, img_p) | ((img_k - img_p).abs().amax(-1) > 2e-6))[..., None]
    g = torch.rand((48, 48, 3), generator=torch.Generator().manual_seed(5)).to(cuda_device)
    g = (g * 1e-2 * ~held).contiguous()
    k = rb.flatten_grads(*rb.scene_grads_cuda(cam, scene, g, return_camera=True, **kw))
    p = sum(rb.scene_grads_plain(cam, scene, g[x0:x0 + 8], x_offset=x0, local_width=8, **kw)
            for x0 in range(0, 48, 8))
    res = rb.grad_rule(k, p, *_counts(scene))
    assert all(ok for _, ok in res.values()), res


def test_render_frames_equal_single_renders(cuda_device):
    from python_ray_tracer_tpu_torch import animation
    scene = trt.default_scene(device=cuda_device)
    cams = animation.orbit_cameras((96, 64), center=[1.0, 0.0, 1.0], radius=4.0,
                                   height=1.5, n_frames=5, device=cuda_device)
    for aa in (True, False):
        frames = animation.render_frames(cams, scene, aliasing=aa)
        for k in range(5):
            single = trt.render_image_cuda(animation.frame_camera(cams, k), scene,
                                           aliasing=aa)
            assert torch.equal(frames[k], single), (aa, k)


@pytest.mark.parametrize("ns", [300, 3000])
def test_backward_global_form_equals_staged(cuda_device, ns):
    """The backward kernels' global form (the sphere table read from device
    memory) against the staged form at the same launch shape on scenes both
    take: the hard kernel's bits in every mode; the soft kernel's, which nvcc
    contracts differently in the two forms, under soft_grad_rule."""
    from python_ray_tracer_tpu_torch.ops.cuda import render_cuda
    from python_ray_tracer_tpu_torch.ops.cuda import soft_bwd_cuda as sb
    scene = trt.random_scene(ns, generator=torch.Generator().manual_seed(3),
                             device=cuda_device)
    cam = trt.Camera.build((40, 36), [-12.0, 0.0, 4.0], [0.0, -15.0, 0.0], device=cuda_device)
    cnt = _counts(scene)
    tables = render_cuda.scene_tables(scene)
    g = torch.rand((40, 36, 3), generator=torch.Generator().manual_seed(4)).to(cuda_device)
    target = trt.render_image_cuda(cam, scene, aliasing=False, group_cull=False) * 0.9
    img_aa = trt.render_image_cuda(cam, scene, aliasing=True, group_cull=False)
    params = render_cuda.pack_params(cam, scene, True).to(cuda_device)
    for mode in rb.MODES:
        fused = mode.startswith("fused")
        out = []
        sp = rb.launch_plan(cam, scene, mode, staged=True)
        twin = sp._replace(staged=False, smem=rb.smem_bytes(*cnt, fused, mode.endswith("_aa"),
                                                            sp.nt, sp.cols, False))
        for p in (sp, twin):   # the same launch shape in both forms
            n = rb.n_grads(*cnt, fused)
            out.append(rb.launch(
                torch.empty(n, device=cuda_device), torch.empty(n * p.blocks, device=cuda_device),
                params, tables, cnt,
                image=img_aa if mode == "fused_aa" else (None if fused else g),
                target=target if fused else None, W=40, H=36, depth=2, mode=mode, compat=True,
                cheap_shadow=render_cuda.shadow_cheap_ok(scene, True), shape=p))
        assert torch.equal(out[0], out[1]), mode
    if ns > 1000:
        return   # the soft kernels' time grows with the scene's density
    sparams = render_cuda.pack_params(cam, scene, False).to(cuda_device)
    for mode in sb.MODES:
        fused = mode == "fused"
        p = sb.plan(*cnt, fused)
        out = []
        for q in (p, p._replace(staged=False, smem=sb.smem_bytes(
                *cnt, fused, p.nt, p.cap, p.cj, p.store_vis, False))):
            n = rb.n_grads(*cnt, fused)
            out.append(sb.launch(
                torch.empty(n, device=cuda_device),
                torch.empty(n * sb.n_blocks(40, 36, q), device=cuda_device), sparams, tables,
                cnt, image=target if fused else g, W=40, H=36, tau=0.05, mode=mode, shape=q))
        res = sb.soft_grad_rule(out[1], out[0], *cnt)
        assert all(ok for _, ok in res.values()), (mode, res)


def _pose(res, device):
    return trt.Camera.build(res, [-12.0, 0.0, 4.0], [0.0, -15.0, 0.0], device=device)


@pytest.mark.parametrize("ns", [1000, 5000])
def test_forward_global_forms_equal_staged(cuda_device, ns):
    """Past the staged size each forward kernel reads the scene where it
    lies (render_cuda.scene_form) or stages it in chunks: on scenes every
    form takes, each form against the staged one. The pinned sources (the
    render and worklist kernels in every form, the hit extents with bounce
    levels, the light cells and the lists) give the same bits; the soft
    forward, a contracted source, stays within the soft image rule's 2e-4."""
    from python_ray_tracer_tpu_torch.ops.cuda import adaptive_cuda as ac
    from python_ray_tracer_tpu_torch.ops.cuda import cull_tables as ct
    from python_ray_tracer_tpu_torch.ops.cuda import hit_extents_cuda as hx
    from python_ray_tracer_tpu_torch.ops.cuda import light_cells_cuda as lc
    from python_ray_tracer_tpu_torch.ops.cuda import shadow_lists_cuda as sl
    from python_ray_tracer_tpu_torch.ops.cuda import soft_cuda
    scene = trt.random_scene(ns, generator=torch.Generator().manual_seed(3), device=cuda_device)
    W, H = 48, 40
    cam = _pose((W, H), cuda_device)
    cnt = _counts(scene)
    packed = render_cuda.packed_inputs(cam, scene, depth=2, compat=True)
    cheap = render_cuda.shadow_cheap_ok(scene, True)
    for mode in MODES:
        vis, shadow, tree, cells = render_cuda.large_scene_tables(
            cam, scene, depth=2, aliasing=mode != "aa_none", compat=True, packed=packed)
        assert tree is not None
        outs = [render_cuda.launch(torch.empty((W, H, 3), device=cuda_device), *packed, depth=2,
                                   mode=mode, compat=True, cheap_shadow=cheap, vis=vis,
                                   shadow=shadow, tree=tree, cells=cells, form=f)
                for f in (0, 1)]
        assert torch.equal(outs[0], outs[1]), mode
    idx = torch.arange(W * H, dtype=torch.int32, device=cuda_device)
    flagged = torch.tensor([W * H], dtype=torch.int32, device=cuda_device)
    lists = [ac.launch_list(torch.zeros((W, H, 3), device=cuda_device), *packed, idx, flagged,
                            depth=2, compat=True, cheap_shadow=cheap, vis=vis, shadow=shadow,
                            tree=tree, cells=cells, form=f) for f in (0, 1)]
    assert torch.equal(lists[0], lists[1])
    n_tiles = -(-W // 16) * -(-H // 16)
    ext = [hx.launch(torch.empty((n_tiles * 3, 8), device=cuda_device), *packed, W=W, H=H,
                     aliasing=True, compat=True, n_levels=3, vis=vis, tree=tree, form=f)
           for f in (0, 1)]
    assert torch.equal(ext[0], ext[1])
    sph, _, lts = packed[1]
    a, b = (lc.launch(lc.empty(cnt[2], cuda_device), sph, lts, ns, cnt[2], chunk=c)
            for c in (0, 256))
    assert all(torch.equal(u, v) for u, v in zip(a, b))
    scale = torch.empty(1, device=cuda_device)
    e = hx.hit_extents_cuda(cam, scene, aliasing=True, vis=vis, scale=scale)
    order = ct.light_order(scene.lights.position, scene.spheres.center,
                           scene.spheres.radius).to(torch.int32)
    k = ct.list_capacity(ns)
    rows = [sl.launch(torch.empty(n_tiles * cnt[2] * k, dtype=torch.int32, device=cuda_device),
                      torch.empty(n_tiles * cnt[2], dtype=torch.int32, device=cuda_device), e,
                      scale, scene.lights.position.contiguous(),
                      scene.spheres.center.contiguous(), scene.spheres.radius.contiguous(),
                      order, k=k, compat=True, chunk=c) for c in (0, 256)]
    assert all(torch.equal(u, v) for u, v in zip(*rows))
    sp = render_cuda.pack_params(cam, scene, False).to(cuda_device)
    soft = [soft_cuda.launch(torch.empty((W, H, 3), device=cuda_device), sp, packed[1], cnt,
                             tau=0.05, staged=st) for st in (True, False)]
    assert float((soft[0] - soft[1]).abs().max()) <= soft_cuda.IMAGE_ATOL


@pytest.mark.parametrize("ns", [1000, 5000])
def test_backward_device_rows_equal_the_other_forms(cuda_device, ns):
    """The backward kernels' third form (each warp's row in device memory)
    against the staged and global forms at the same launch shape: the hard
    kernel's bits in every mode; the soft kernel's under soft_grad_rule
    against its global form (another instantiation of a contracted source)
    on a frame of more pixel groups than its card-sized grid has blocks."""
    from python_ray_tracer_tpu_torch.ops.cuda import soft_bwd_cuda as sb
    scene = trt.random_scene(ns, generator=torch.Generator().manual_seed(3), device=cuda_device)
    W, H = 40, 36
    cam = _pose((W, H), cuda_device)
    cnt = _counts(scene)
    tables = render_cuda.scene_tables(scene)
    g = torch.rand((W, H, 3), generator=torch.Generator().manual_seed(4)).to(cuda_device)
    target = trt.render_image_cuda(cam, scene, aliasing=False) * 0.9
    img_aa = trt.render_image_cuda(cam, scene, aliasing=True)
    params = render_cuda.pack_params(cam, scene, True).to(cuda_device)
    for mode in rb.MODES:
        fused, aa = mode.startswith("fused"), mode.endswith("_aa")
        for staged in (True, False):
            try:
                p = rb.launch_plan(cam, scene, mode, staged=staged, device_rows=False)
            except ValueError:
                continue   # the staged form does not fit this scene
            twin = p._replace(staged=False, device_rows=True, smem=rb.smem_bytes(
                *cnt, fused, aa, p.nt, False, False, True))
            out = []
            for q in (p, twin):
                n = rb.n_grads(*cnt, fused)
                out.append(rb.launch(
                    torch.empty(n, device=cuda_device),
                    torch.empty(n * q.blocks, device=cuda_device), params, tables, cnt,
                    image=img_aa if mode == "fused_aa" else (None if fused else g),
                    target=target if fused else None, W=W, H=H, depth=2, mode=mode,
                    compat=True, cheap_shadow=render_cuda.shadow_cheap_ok(scene, True),
                    shape=q))
            assert torch.equal(out[0], out[1]), (mode, staged)
    if ns > 1000:
        return   # the soft kernels' time grows with the scene's density
    W, H = 320, 128
    cam = _pose((W, H), cuda_device)
    g = torch.rand((W, H, 3), generator=torch.Generator().manual_seed(4)).to(cuda_device)
    target = trt.render_image_cuda(cam, scene, aliasing=False) * 0.9
    sparams = render_cuda.pack_params(cam, scene, False).to(cuda_device)
    for mode in sb.MODES:
        fused = mode == "fused"
        p = sb.plan(*cnt, fused, staged=False, device_rows=False)
        twin = p._replace(device_rows=True, smem=sb.smem_bytes(
            *cnt, fused, p.nt, p.cap, p.cj, p.store_vis, False, True))
        assert sb.n_blocks(W, H, twin) < sb.n_blocks(W, H, p)   # blocks walk groups
        out = []
        for q in (p, twin):
            n = rb.n_grads(*cnt, fused)
            out.append(sb.launch(
                torch.empty(n, device=cuda_device),
                torch.empty(n * sb.n_blocks(W, H, q), device=cuda_device), sparams, tables,
                cnt, image=target if fused else g, W=W, H=H, tau=0.05, mode=mode, shape=q))
        res = sb.soft_grad_rule(out[1], out[0], *cnt)
        assert all(ok for _, ok in res.values()), (mode, res)


def test_16384_spheres_against_the_plain_version(cuda_device):
    """16384 spheres (past every staged form) at 48x48, depth 1, seen from
    outside the cloud: the render in every mode and the worklist kernel
    against the plain version (column slices) and culls off, the light cells
    and the lists against their plain functions, and the hard backward (its
    third form) against the plain version, held out as
    test_backward_at_the_render_limit holds them."""
    from python_ray_tracer_tpu_torch.ops.cuda import cull_tables as ct
    from python_ray_tracer_tpu_torch.ops.cuda import hit_extents_cuda as hx
    from python_ray_tracer_tpu_torch.ops.cuda import light_cells_cuda as lc
    from python_ray_tracer_tpu_torch.ops.cuda import shadow_lists_cuda as sl
    ns, W = 16384, 48
    scene = trt.random_scene(ns, generator=torch.Generator().manual_seed(3), device=cuda_device)
    cam = _pose((W, W), cuda_device)
    kw = dict(depth=1)
    for mode in MODES:
        aa = mode != "aa_none"
        k = trt.render_image_cuda(cam, scene, aliasing=aa, aa_share=mode == "aa_shared", **kw)
        off = trt.render_image_cuda(cam, scene, aliasing=aa, aa_share=mode == "aa_shared",
                                    cull=False, shadow_lists=False, group_cull=False, **kw)
        with torch.no_grad():
            p = torch.cat([trt.render_image(cam, scene, x_offset=x0, local_width=8, aliasing=aa,
                                            **kw) for x0 in range(0, W, 8)])
        assert torch.equal(k, off) and _flipped(k, p) <= 1e-3 * W * W, mode
        if mode == "aa_per_sample":
            assert torch.equal(trt.render_image_adaptive_cuda(cam, scene, eps=-1.0,
                                                              budget_frac=1.0, **kw), k)
    sph, _, lts = render_cuda.scene_tables(scene)
    cells = lc.light_cells_cuda(sph, lts, ns, 3)
    plain = lc.light_cells_plain(scene.spheres.center, scene.spheres.radius,
                                 scene.lights.position)
    assert all(torch.equal(a, b) for a, b in zip(cells, plain))
    vis = (*ct.tile_visibility(cam, scene, compat=True, K=ct.list_capacity(ns)),
           ct.list_capacity(ns))
    scale = torch.empty(1, device=cuda_device)
    ext = hx.hit_extents_cuda(cam, scene, aliasing=True, vis=vis, scale=scale)
    args = (ext, scale, scene.lights.position, scene.spheres.center, scene.spheres.radius)
    rows = sl.shadow_lists_cuda(*args, K=ct.list_capacity(ns), compat=True)
    plain = ct.shadow_visibility_lists(*args[:1], *args[2:], K=ct.list_capacity(ns),
                                       compat=True, scale=scale)
    assert all(torch.equal(a, b) for a, b in zip(rows, plain))
    assert rb.launch_plan(cam, scene, "cot_noaa").device_rows
    img_k = trt.render_image_cuda(cam, scene, aliasing=False, **kw)
    with torch.no_grad():
        img_p = torch.cat([trt.render_image(cam, scene, x_offset=x0, local_width=8,
                                            aliasing=False, **kw) for x0 in range(0, W, 8)])
    held = (rb.held_out(img_k, img_p) | ((img_k - img_p).abs().amax(-1) > 2e-6))[..., None]
    g = torch.rand((W, W, 3), generator=torch.Generator().manual_seed(5)).to(cuda_device)
    g = (g * 1e-2 * ~held).contiguous()
    k = rb.flatten_grads(*rb.scene_grads_cuda(cam, scene, g, return_camera=True,
                                              aliasing=False, **kw))
    p = sum(rb.scene_grads_plain(cam, scene, g[x0:x0 + 4], x_offset=x0, local_width=4,
                                 aliasing=False, **kw) for x0 in range(0, W, 4))
    res = rb.grad_rule(k, p, *_counts(scene))
    assert all(ok for _, ok in res.values()), res


def test_resilient_fit_equals_an_uninterrupted_run(cuda_device, tmp_path):
    """resilient_fit over the fused no-AA step (kernel 4) on the fit CLI's
    2-sphere scene at 96x96: a NaN at step 4 and an exception at step 7,
    restored from the checkpoints at steps 4 and 6; the backward is
    bit-deterministic, so the losses are the uninterrupted run's, bit for
    bit."""
    from python_ray_tracer_tpu_torch.utils import faults
    cfg = RenderConfig(width=96, height=96)
    scene = cli.fit_scene_two_spheres(cfg, cuda_device)
    cam = trt.Camera.build((96, 96), cfg.camera_position, cfg.camera_euler, cfg.fov,
                           device=cuda_device)
    target = trt.render_image_cuda(cam, scene, depth=2, aliasing=False)

    def make_step():
        init = trt.Scene.from_leaves([t.clone() for t in scene.leaves()])
        init.spheres.center += torch.tensor(cli.FIT_SHIFT, device=cuda_device)
        return train.make_train_step(init, train.cuda_value_and_grad(cam, target, depth=2),
                                     lr=1e-2, trainable=("spheres",))

    step = make_step()
    ref = [float(step()) for _ in range(10)]

    class Both:
        nan = faults.FaultInjector([4], mode="nan")
        exc = faults.FaultInjector([7], mode="exception")

        def maybe_fail(self, i, loss):
            return self.exc.maybe_fail(i, self.nan.maybe_fail(i, loss))

    _, _, losses, events = faults.resilient_fit(make_step(), steps=10, ckpt_dir=str(tmp_path),
                                                ckpt_every=2, injector=Both())
    assert [(e.step, e.restored_step) for e in events] == [(4, 4), (7, 6)]
    assert losses == ref
    assert faults.device_healthcheck() == {"cuda:0": True}


# --- kernel 4 through the large-scene tables; the one-launch fused AA step -------------

BWD_FORMS = {"staged": dict(staged=True, tree_smem=False),
             "staged, tree staged": dict(staged=True, tree_smem=True),
             "global": dict(staged=False, device_rows=False), "rows": dict(device_rows=True)}


def _bwd_once(cam, scene, mode, x, *, culls=None, form=None, shape=None, depth=2):
    """(flat gradient, the two-launch step's aa_shared frame or None, plan) of
    one launch of ``mode`` (``fused_aa1``: the one-launch AA step) through the
    frame's tables (``culls``: render_cuda.large_scene_tables' keywords), in
    ``form`` (a BWD_FORMS key) or at ``shape``."""
    one = mode == "fused_aa1"
    m = "fused_aa" if one else mode
    aa, fused = m.endswith("_aa"), m.startswith("fused")
    W, H = cam.resolution
    packed = render_cuda.packed_inputs(cam, scene, depth=depth, compat=True)
    params, tables, cnt = packed
    tabs = render_cuda.large_scene_tables(cam, scene, depth=depth, aliasing=aa, compat=True,
                                          packed=packed, **(culls or {}))
    if shape is None:
        shape = rb.launch_plan(cam, scene, m, tabs=tabs, one_launch=one, **BWD_FORMS[form])
    elif tabs[2] is None:   # another launch's shape, for the launch without the tree
        shape = shape._replace(tree_smem=False)
    cheap = render_cuda.shadow_cheap_ok(scene, True)
    frame = None
    if m == "fused_aa" and not one:
        frame = render_cuda.launch(torch.empty((W, H, 3), device=cam.device), params, tables,
                                   cnt, depth=depth, mode="aa_shared", compat=True,
                                   cheap_shadow=cheap, vis=tabs[0], shadow=tabs[1],
                                   tree=tabs[2], cells=tabs[3])
    n = rb.n_grads(*cnt, fused)
    out = rb.launch(torch.empty(n, device=cam.device),
                    torch.empty(n * shape.blocks, device=cam.device), params, tables, cnt,
                    image=frame if frame is not None else (None if fused else x),
                    target=x if fused else None, W=W, H=H, depth=depth, mode=m, compat=True,
                    cheap_shadow=cheap, shape=shape, tabs=tabs, one_launch=one)
    return out, frame, shape


@pytest.mark.parametrize("form", sorted(BWD_FORMS))
@pytest.mark.parametrize("mode", rb.MODES + ("fused_aa1",))
def test_bwd_tables_equal_every_table_off(cuda_device, mode, form):
    """300 spheres 48x32 depth 2, the bounce tree, light cells and both lists
    on: every backward mode (and the one-launch AA step) in every form equals
    the same launch with every table off, bit for bit (the culls are exact
    in the pinned arithmetic), the two-launch step's aa_shared frame too."""
    scene = trt.random_scene(300, generator=torch.Generator().manual_seed(3),
                             device=cuda_device)
    cam = _pose((48, 32), cuda_device)
    fused = mode.startswith("fused")
    aa = mode.endswith(("_aa", "_aa1"))
    target = trt.render_image_cuda(cam, scene, aliasing=aa) * 0.9
    g = torch.rand((48, 32, 3), generator=torch.Generator().manual_seed(4)).to(cuda_device)
    x = target.contiguous() if fused else (g * 1e-2).contiguous()
    on, f_on, shape = _bwd_once(cam, scene, mode, x, form=form)
    off, f_off, _ = _bwd_once(cam, scene, mode, x, culls=ALL_OFF, shape=shape)
    torch.cuda.synchronize()
    assert bool(torch.isfinite(on).all()) and bool(on.abs().max() > 0)
    assert torch.equal(on, off)
    assert f_on is None or torch.equal(f_on, f_off)


@pytest.mark.parametrize("mode", rb.MODES)
def test_bwd_slice_partials_with_tables_equal_without(cuda_device, mode):
    """A slice [20, 52) of a 300-sphere 64x32 frame through the wrappers: its
    partials with the slice's own tables equal those with every table off, at
    the planner's one launch shape either way."""
    scene = trt.random_scene(300, generator=torch.Generator().manual_seed(3),
                             device=cuda_device)
    cam = _pose((64, 32), cuda_device)
    aa = mode.endswith("_aa")
    kw = dict(depth=2, aliasing=aa, return_camera=True, x_offset=20, local_width=32)
    target = (trt.render_image_cuda(cam, scene, aliasing=aa) * 0.9)[20:52].contiguous()
    g = (torch.rand((32, 32, 3), generator=torch.Generator().manual_seed(6)) * 1e-2).to(
        cuda_device)
    out = []
    for culls in ({}, ALL_OFF):
        if mode.startswith("fused"):
            loss, sg, cg = rb.loss_and_scene_grads_cuda(cam, scene, target, **kw, **culls)
            out.append(rb.flatten_grads(sg, cg, loss))
        else:
            out.append(rb.flatten_grads(*rb.scene_grads_cuda(cam, scene, g, **kw, **culls)))
    torch.cuda.synchronize()
    assert torch.equal(out[0], out[1])


@pytest.mark.parametrize("depth", [0, 2, 4])
@pytest.mark.parametrize("name", ["fit", "demo", "100 spheres"])
def test_one_launch_aa_step_equals_the_two_launch_step(cuda_device, name, depth):
    """The one-launch fused AA step (FUSED_AA1) against the aa_shared render
    plus the backward, from shifted centers: the same bits where the scene
    takes the pinned arithmetic (100 spheres); on the small scenes, whose
    kernels the compiler contracts per instantiation, the loss's bits (the
    same colors, combined in aa_shared's order) and the gradient within
    grad_rule (the reverse sweep rebuilds each trace's ray from its record,
    which nvcc may contract otherwise than the retrace)."""
    cfg = RenderConfig()
    if name == "fit":
        scene = cli.fit_scene_two_spheres(cfg, cuda_device)
        cam = trt.Camera.build((96, 80), cfg.camera_position, cfg.camera_euler, cfg.fov,
                               device=cuda_device)
    elif name == "demo":
        scene, cam = trt.default_scene(device=cuda_device), trt.default_camera(
            (96, 80), device=cuda_device)
    else:
        scene = trt.random_scene(100, generator=torch.Generator().manual_seed(3),
                                 device=cuda_device)
        cam = _pose((96, 80), cuda_device)
    target = trt.render_image_cuda(cam, scene, depth=depth, aliasing=True)
    init = trt.Scene.from_leaves([t.clone() for t in scene.leaves()])
    init.spheres.center += torch.tensor(cli.FIT_SHIFT, device=cuda_device)
    rb.reset_launch_counts()
    out = {}
    for form in ("two", "one"):
        loss, sg, cg = rb.loss_and_scene_grads_cuda(cam, init, target, depth=depth,
                                                    aliasing=True, return_camera=True,
                                                    aa_form=form)
        out[form] = rb.flatten_grads(sg, cg, loss)
    torch.cuda.synchronize()
    assert rb.LAUNCHES["fused_aa"] == 1 and rb.LAUNCHES["fused_aa1"] == 1
    assert bool(out["one"].abs()[:-1].max() > 0)
    assert float(out["one"][-1]) == float(out["two"][-1])
    if init.spheres.count > render_cuda.CULL_MIN_SPHERES:
        assert torch.equal(out["one"], out["two"])
    else:
        res = rb.grad_rule(out["one"], out["two"], *_counts(init))
        assert all(ok for _, ok in res.values()), res


def test_render_image_fast_backward_reads_the_forward_tables(cuda_device):
    """render_image_fast at 300 spheres with AA: its backward takes the
    forward's tables (one hit-extent launch over both) and gives the bits of
    scene_grads_cuda, which builds them again."""
    from python_ray_tracer_tpu_torch.ops.cuda import hit_extents_cuda as hx
    scene = trt.random_scene(300, generator=torch.Generator().manual_seed(3),
                             device=cuda_device)
    cam = _pose((48, 32), cuda_device)
    target = trt.render_image_cuda(cam, scene) * 0.9
    leaves = [t.detach().clone().requires_grad_(True) for t in scene.leaves()]
    hx.reset_launch_counts()
    rb.reset_launch_counts()
    img = render_cuda.render_image_fast(cam, trt.Scene.from_leaves(leaves))
    seen = []
    img.register_hook(seen.append)
    torch.mean((img - target) ** 2).backward()
    torch.cuda.synchronize()
    assert hx.LAUNCHES["hit_extents"] == 1 and rb.TABLE_LAUNCHES["cot_aa"] == 1
    want = rb.scene_grads_cuda(cam, scene, seen[0].float().contiguous(), aliasing=True)
    assert torch.equal(leaves[0].grad, want.spheres.center)


# --- shadow lists at the bounce levels; shadow_cull; an explicit cheap_shadow ---------

def _scaled(scene, s):
    """The scene with every length times s (centers, radii, lights, plane
    origins): the same picture from a camera whose position is scaled too."""
    sp, pl = scene.spheres, scene.planes
    return trt.Scene(trt.Spheres(sp.center * s, sp.radius * s, sp.albedo),
                     trt.Planes(pl.origin * s, pl.normal, pl.albedo),
                     trt.Lights(scene.lights.position * s), scene.materials)


@pytest.mark.parametrize("levels", [2, 3])
@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("compat", [True, False])
@pytest.mark.parametrize("n", [100, 300])
def test_list_levels_frames_equal_every_table_off(cuda_device, n, compat, mode, levels):
    """Shadow lists at the first `levels` trace levels (the render's
    shadow_list_levels; 300 spheres with the bounce tree, 100 without):
    frames torch.equal to every table off, the hit-extent launch writing
    `levels` rows a tile and the list launch its rows; the light cells serve
    the levels past the lists."""
    scene = _planted_scene(n, cuda_device)
    cam = trt.Camera.build((104, 72), *LARGE_POSES[n], device=cuda_device)
    aa = mode != "aa_none"
    kw = dict(depth=2, compat=compat, aliasing=aa, aa_share=mode == "aa_shared")
    off = trt.render_image_cuda(cam, scene, **kw, **ALL_OFF)
    tabs = render_cuda.large_scene_tables(cam, scene, depth=2, aliasing=aa, compat=compat,
                                          shadow_list_levels=levels)
    assert tabs[1][3] == levels and tabs[1][1].numel() == 7 * 5 * levels * 3
    assert (tabs[3] is not None) == (levels <= 2)
    hx.reset_launch_counts()
    on = trt.render_image_cuda(cam, scene, **kw, shadow_list_levels=levels)
    torch.cuda.synchronize()
    assert hx.LAUNCHES["hit_extents"] == 1
    assert torch.equal(on, off), int((on != off).any(-1).sum())
    assert torch.equal(_render_tabs(cam, scene, mode, 2, compat, tabs), off)
    for form in (0, 1):   # the staged and the global form of the same launch
        W, H = cam.resolution
        img = render_cuda.launch(
            torch.empty((W, H, 3), device=cuda_device),
            render_cuda.pack_params(cam, scene, compat).to(cuda_device),
            render_cuda.scene_tables(scene), _counts(scene), depth=2, mode=mode,
            compat=compat, cheap_shadow=render_cuda.shadow_cheap_ok(scene, compat),
            vis=tabs[0], shadow=tabs[1], tree=tabs[2], cells=tabs[3], form=form)
        assert torch.equal(img, off), form


@pytest.mark.parametrize("mode", MODES)
def test_list_levels_at_depth_4(cuda_device, mode):
    """Five listed levels at depth 4 (past the hit-extent kernel's four
    levels a pass), 300 spheres, compat: the frame of every table off."""
    scene = _planted_scene(300, cuda_device)
    cam = trt.Camera.build((96, 64), *LARGE_POSES[300], device=cuda_device)
    aa = mode != "aa_none"
    kw = dict(depth=4, aliasing=aa, aa_share=mode == "aa_shared")
    off = trt.render_image_cuda(cam, scene, **kw, **ALL_OFF)
    on = trt.render_image_cuda(cam, scene, **kw, shadow_list_levels=5)
    over = trt.render_image_cuda(cam, scene, **kw, shadow_list_levels=9)   # clamped to 5
    torch.cuda.synchronize()
    assert torch.equal(on, off) and torch.equal(over, off)


@pytest.mark.parametrize("levels", [1, 2, 3, 5])
@pytest.mark.parametrize("aliasing", [False, True])
def test_list_levels_rows_are_the_plain_rows(cuda_device, levels, aliasing):
    """The hit-extent kernel's rows of `levels` levels (the first four in one
    pass, the fifth in a second) and the list kernel's rows on them: the list
    rows integer for integer the plain function's on the same rows, the
    extent rows two runs bit for bit, level 0 the one-level launch's, and
    every level's rows the launch without the bounce tree's."""
    scene = _planted_scene(300, cuda_device)
    cam = trt.Camera.build((112, 64), *LARGE_POSES[300], device=cuda_device)
    k = ct.list_capacity(301)
    vis = (*ct.tile_visibility(cam, scene, compat=True, K=k), k)
    tree = ct.bounce_tree(scene.spheres.center, scene.spheres.radius)
    scale = torch.empty(1, device=cuda_device)
    kw = dict(aliasing=aliasing, compat=True, vis=vis)
    ext = hx.hit_extents_cuda(cam, scene, n_levels=levels, tree=tree, scale=scale, **kw)
    again = hx.hit_extents_cuda(cam, scene, n_levels=levels, tree=tree, **kw)
    bare = hx.hit_extents_cuda(cam, scene, n_levels=levels, **kw)
    one = hx.hit_extents_cuda(cam, scene, n_levels=1, **kw)
    torch.cuda.synchronize()
    assert ext.shape == (7 * 4 * levels, 8)
    assert torch.equal(ext, again) and torch.equal(ext, bare)
    assert torch.equal(ext.reshape(28, levels, 8)[:, 0], one)
    assert torch.equal(scale, ct.extent_scale(ext).reshape(1))
    if levels > 1:
        assert float(ext.reshape(28, levels, 8)[:, 1:, 6].sum()) > 0
    L, C, R = scene.lights.position, scene.spheres.center, scene.spheres.radius
    for K in (k, 4):
        idx, cnt = sl.shadow_lists_cuda(ext, scale, L, C, R, K=K, compat=True)
        want = ct.shadow_visibility_lists(ext, L, C, R, K=K, compat=True)
        assert torch.equal(cnt, want[1]) and torch.equal(idx, want[0])


def test_list_levels_slice_stitches(cuda_device):
    """A slice [96, 160) of a 256 x 64 frame with three listed levels: the
    frame's columns, and the frame with every table off."""
    scene = _planted_scene(300, cuda_device)
    cam = trt.Camera.build((256, 64), *LARGE_POSES[300], device=cuda_device)
    for mode in MODES:
        kw = dict(depth=2, aliasing=mode != "aa_none", aa_share=mode == "aa_shared")
        whole = trt.render_image_cuda(cam, scene, **kw, **ALL_OFF)
        part = trt.render_image_cuda(cam, scene, **kw, shadow_list_levels=3, x_offset=96,
                                     local_width=64)
        torch.cuda.synchronize()
        assert torch.equal(part, whole[96:160]), mode


def test_list_levels_worklist_and_backward(cuda_device):
    """Tables with two listed levels through the worklist kernel (its pixels'
    rows, read where they lie) and every backward mode: the bits of every
    table off (the backward at one launch shape)."""
    from python_ray_tracer_tpu_torch.ops.cuda import adaptive_cuda as ac
    scene = trt.random_scene(300, generator=torch.Generator().manual_seed(3),
                             device=cuda_device)
    cam = _pose((48, 32), cuda_device)
    packed = render_cuda.packed_inputs(cam, scene, depth=2, compat=True)
    tabs = render_cuda.large_scene_tables(cam, scene, depth=2, aliasing=True, compat=True,
                                          packed=packed, shadow_list_levels=2)
    W, H = cam.resolution
    idx = torch.arange(W * H, dtype=torch.int32, device=cuda_device)
    flagged = torch.tensor([W * H], dtype=torch.int32, device=cuda_device)
    kw = dict(depth=2, compat=True, cheap_shadow=render_cuda.shadow_cheap_ok(scene, True))
    off = ac.launch_list(torch.zeros((W, H, 3), device=cuda_device), *packed, idx, flagged,
                         **kw)
    on = ac.launch_list(torch.zeros((W, H, 3), device=cuda_device), *packed, idx, flagged,
                        **kw, vis=tabs[0], shadow=tabs[1], tree=tabs[2], cells=tabs[3])
    assert torch.equal(on, off)
    g = (torch.rand((48, 32, 3), generator=torch.Generator().manual_seed(4)) * 1e-2).to(
        cuda_device)
    for mode in rb.MODES + ("fused_aa1",):
        fused = mode.startswith("fused")
        aa = mode.endswith(("_aa", "_aa1"))
        t = (trt.render_image_cuda(cam, scene, aliasing=aa) * 0.9) if fused else None
        x = t.contiguous() if fused else g.contiguous()
        for form in ("staged", "global", "rows"):
            a, frame_a, shape = _bwd_once(cam, scene, mode, x, form=form,
                                          culls=dict(shadow_list_levels=2))
            b, frame_b, _ = _bwd_once(cam, scene, mode, x, culls=ALL_OFF, shape=shape)
            torch.cuda.synchronize()
            assert bool(a.abs().max() > 0) and torch.equal(a, b), (mode, form)
            assert frame_a is None or torch.equal(frame_a, frame_b)


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("compat", [True, False])
@pytest.mark.parametrize("n", [100, 1000])
def test_capsule_frames_equal_capsule_off(cuda_device, n, compat, mode):
    """shadow_cull (the JAX wrapper's capsule cull) changes no launch: with
    it on, at the default tables, with the shadow lists off and with every
    table off, the frames and the kernel launches of it off, on the scene
    with an occluder planted beyond a light; each the frame of every table
    off."""
    scene = _planted_scene(n, cuda_device)
    cam = trt.Camera.build((104, 72), *LARGE_POSES[n], device=cuda_device)
    aa = mode != "aa_none"
    kw = dict(depth=2, compat=compat, aliasing=aa, aa_share=mode == "aa_shared")
    off = trt.render_image_cuda(cam, scene, **kw, **ALL_OFF)
    for culls in ({}, dict(shadow_lists=False), ALL_OFF):
        counts = []
        for cull in (False, True):
            render_cuda.reset_launch_counts()
            hx.reset_launch_counts()
            sl.reset_launch_counts()
            img = trt.render_image_cuda(cam, scene, **kw, **culls, shadow_cull=cull)
            torch.cuda.synchronize()
            assert torch.equal(img, off), (culls, cull, int((img != off).any(-1).sum()))
            counts.append((dict(render_cuda.LAUNCHES), dict(render_cuda.GLOBAL_LAUNCHES),
                           dict(hx.LAUNCHES), dict(sl.LAUNCHES)))
        assert counts[0] == counts[1], culls


def test_capsule_beyond_the_light_and_scaled(cuda_device):
    """The shadow lists keep the sphere planted beyond a light (the frame
    differs without it, and equals every table off), at level 0 and with two
    listed levels, shadow_cull on and off, on the scene as it is and scaled
    by 1e4 in clean mode (the lists' scale-aware slack)."""
    scene = _planted_scene(22, cuda_device)
    base = trt.Scene(trt.Spheres(scene.spheres.center[:-1], scene.spheres.radius[:-1],
                                 scene.spheres.albedo[:-1]),
                     scene.planes, scene.lights, scene.materials)
    for s, compat in ((1.0, True), (1.0, False), (1e4, False)):
        pos = [v * s for v in (-7.0, 0.0, 3.0)]
        cam = trt.Camera.build((96, 64), pos, [0.0, 10.0, 0.0], device=cuda_device)
        sc, bs = _scaled(scene, s), _scaled(base, s)
        for aa in (False, True):
            kw = dict(depth=1, aliasing=aa, compat=compat)
            off = trt.render_image_cuda(cam, sc, **kw, **ALL_OFF)
            without = trt.render_image_cuda(cam, bs, **kw)
            for levels in (None, 2):
                for cull in (False, True):
                    on = trt.render_image_cuda(cam, sc, **kw, shadow_list_levels=levels,
                                               shadow_cull=cull)
                    torch.cuda.synchronize()
                    assert torch.equal(on, off), (s, compat, aa, levels, cull)
            assert float((off - without).abs().max()) > 1e-3, (s, compat, aa)


@pytest.mark.parametrize("compat", [True, False])
def test_list_levels_5000_spheres(cuda_device, compat):
    """5000 spheres 128 x 96 (a dense cloud, whose shadow rays graze many
    spheres; the size where a run-time capsule sweep with only the lists'
    slack dropped occluders in clean mode): one, two and three listed levels,
    the staged and the global form of each, every mode, against every table
    off."""
    scene = trt.random_scene(5000, generator=torch.Generator().manual_seed(3),
                             device=cuda_device)
    cam = _pose((128, 96), cuda_device)
    packed = render_cuda.packed_inputs(cam, scene, depth=2, compat=compat)
    cheap = render_cuda.shadow_cheap_ok(scene, compat)
    for mode in MODES:
        aa = mode != "aa_none"
        tabs = {levels: render_cuda.large_scene_tables(
            cam, scene, depth=2, aliasing=aa, compat=compat, packed=packed,
            **(ALL_OFF if levels is None else dict(shadow_list_levels=levels)))
            for levels in (None, 1, 2, 3)}
        outs = {}
        for levels, t in tabs.items():
            for form in (0, 1):
                outs[levels, form] = render_cuda.launch(
                    torch.empty((128, 96, 3), device=cuda_device), *packed, depth=2,
                    mode=mode, compat=compat, cheap_shadow=cheap, vis=t[0], shadow=t[1],
                    tree=t[2], cells=t[3], form=form)
        torch.cuda.synchronize()
        ref = outs[None, 0]
        for key, img in outs.items():
            assert torch.equal(img, ref), (mode, key, int((img != ref).any(-1).sum()))


@pytest.mark.parametrize("compat", [True, False])
def test_explicit_cheap_shadow_picks_the_instantiation(cuda_device, compat):
    """cheap_shadow=True / False force the sqrt-free and the root shadow test
    (the CHEAP instantiations); on a scene where shadow_cheap_ok holds both
    give the frame of the automatic choice, on the demo and a 100-sphere scene:
    the same bits in compat mode on the 100-sphere scene (pinned arithmetic);
    in clean mode, where neither test clips the shadow ray at FAR, the two
    tests' float32 roundings part at grazing shadow rays, and on the
    contracted small-scene kernels, the flip rule."""
    for scene, cam in ((trt.default_scene(device=cuda_device),
                        trt.default_camera((96, 64), device=cuda_device)),
                       (_planted_scene(100, cuda_device),
                        trt.Camera.build((96, 64), *LARGE_POSES[100], device=cuda_device))):
        assert render_cuda.shadow_cheap_ok(scene, compat)
        for mode in MODES:
            kw = dict(depth=2, compat=compat, aliasing=mode != "aa_none",
                      aa_share=mode == "aa_shared")
            auto = trt.render_image_cuda(cam, scene, **kw)
            cheap = trt.render_image_cuda(cam, scene, **kw, cheap_shadow=True)
            root = trt.render_image_cuda(cam, scene, **kw, cheap_shadow=False)
            torch.cuda.synchronize()
            assert torch.equal(cheap, auto)
            if compat and scene.spheres.count > render_cuda.CULL_MIN_SPHERES:
                assert torch.equal(root, auto), mode
            else:
                assert _flipped(root, auto) <= 1e-3 * 96 * 64, mode


# --- the per-sample AA cotangent; default devices ---------------------------

def _ps_cotangent(cam, scene, seed=0):
    """A fit's first cotangent of the per-sample render: the scene with its
    centers moved by the fit CLI's shift against the scene."""
    init = trt.Scene.from_leaves([t.clone() for t in scene.leaves()])
    init.spheres.center += torch.tensor(cli.FIT_SHIFT, device=scene.device)
    tgt = trt.render_image_cuda(cam, scene, aliasing=True, aa_share=False)
    img = trt.render_image_cuda(cam, init, aliasing=True, aa_share=False)
    return init, (2.0 * (img - tgt) / img.numel()).contiguous()


@pytest.mark.parametrize("name", ["demo", "two"])
@pytest.mark.parametrize("compat", [True, False])
def test_per_sample_cotangent_matches_plain(cuda_device, name, compat):
    """scene_grads_cuda(aliasing=True, aa_share=False), the adjoint of the
    aa_per_sample render, against autograd of the plain per-sample render
    under the kernel rule, held-out pixels (of the aa_per_sample frame) out of
    both sides; counted under cot_aa, the lattice, and two runs
    bit-identical."""
    scene = _bwd_scene(name, compat, cuda_device)
    cam = trt.default_camera((64, 64), device=cuda_device)
    target = _target((64, 64), cuda_device)
    x = _bwd_input("cot_aa", cam, scene, target, compat)
    before = rb.LAUNCHES["cot_aa"]
    flat, ref, ref_all, held = rb.kernel_and_plain("cot_aa", cam, scene, x, depth=2,
                                                   compat=compat, aa_share=False)
    assert rb.LAUNCHES["cot_aa"] > before
    assert bool(torch.isfinite(flat).all())
    _assert_rule(flat, ref, scene, ref_all)
    kw = dict(depth=2, compat=compat, aliasing=True, aa_share=False, return_camera=True)
    a = rb.flatten_grads(*rb.scene_grads_cuda(cam, scene, x, **kw))
    b = rb.flatten_grads(*rb.scene_grads_cuda(cam, scene, x, **kw))
    assert torch.equal(a, b)


@pytest.mark.parametrize("compat", [True, False])
def test_per_sample_cotangent_against_the_lattice(cuda_device, compat):
    """aa_share=False launches the lattice as aa_share=True does: the AA
    offsets are 0 and +-0.5, so the per-sample render's rays are the
    lattice's, and the same launch gives the same bits; both within the
    kernel rule of the plain per-sample gradient."""
    scene = _bwd_scene("demo", compat, cuda_device)
    cam = trt.default_camera((96, 64), device=cuda_device)
    x = _bwd_input("cot_aa", cam, scene, _target((96, 64), cuda_device, seed=2), compat)
    kw = dict(depth=2, compat=compat, aliasing=True, return_camera=True)
    held = rb.held_out(trt.render_image_cuda(cam, scene, depth=2, compat=compat,
                                             aliasing=True, aa_share=False),
                       trt.render_image(cam, scene, depth=2, compat=compat, aliasing=True))
    keep = (x * ~held[..., None]).contiguous()
    ps = rb.flatten_grads(*rb.scene_grads_cuda(cam, scene, keep, aa_share=False, **kw))
    lat = rb.flatten_grads(*rb.scene_grads_cuda(cam, scene, keep, **kw))
    assert torch.equal(ps, lat)
    _assert_rule(ps, rb.scene_grads_plain(cam, scene, keep, depth=2, compat=compat,
                                          aliasing=True),
                 scene, rb.scene_grads_plain(cam, scene, x, depth=2, compat=compat,
                                             aliasing=True))


@pytest.mark.parametrize("form", sorted(BWD_FORMS))
def test_per_sample_cotangent_forms_match_plain(cuda_device, form):
    """300 spheres 48x32 depth 2 with the large-scene tables: the lattice
    (cot_aa) on the per-sample render's cotangent in every
    form (staged, the tree staged, global, device rows) against autograd of
    the plain per-sample render, held-out pixels out of both sides. The
    default camera: there the plain float32 gradient is within the rule of
    its float64 witness (0.5% at most); from the _pose camera it is 45-62%
    off in the geometry groups, a view float32 cannot decide."""
    scene = trt.random_scene(300, generator=torch.Generator().manual_seed(3),
                             device=cuda_device)
    cam = trt.default_camera((48, 32), device=cuda_device)
    init, x = _ps_cotangent(cam, scene)
    held = rb.held_out(trt.render_image_cuda(cam, init, aliasing=True, aa_share=False),
                       trt.render_image(cam, init, aliasing=True))
    keep = (x * ~held[..., None]).contiguous()
    before = rb.TABLE_LAUNCHES["cot_aa"]
    flat, _, shape = _bwd_once(cam, init, "cot_aa", keep, form=form)
    assert rb.TABLE_LAUNCHES["cot_aa"] == before + 1
    assert shape.device_rows == (form == "rows") and shape.staged == form.startswith("staged")
    ref = rb.scene_grads_plain(cam, init, keep, depth=2, aliasing=True)
    _assert_rule(flat, ref, init, rb.scene_grads_plain(cam, init, x, depth=2, aliasing=True))


def test_per_sample_slice_partials_sum_to_the_frame(cuda_device):
    """The slice form: the partials of 4 slices (96 wide) of the fit scene's
    384x256 frame summed against the whole frame's under the kernel rule; a
    slice of a 300-sphere frame with its own tables equals the same slice
    with every table off, bit for bit."""
    from python_ray_tracer_tpu_torch.parallel.mesh import column_slice
    scene = cli.fit_scene_two_spheres(RenderConfig(), cuda_device)
    cam = trt.default_camera((384, 256), device=cuda_device)
    init, x = _ps_cotangent(cam, scene)
    kw = dict(aliasing=True, aa_share=False, return_camera=True)

    def run(x0, lw):
        return rb.flatten_grads(*rb.scene_grads_cuda(cam, init, x[x0:x0 + lw].contiguous(),
                                                     x_offset=x0, local_width=lw, **kw))
    whole = run(0, 384)
    parts = sum(run(*column_slice(384, i, 4)) for i in range(4))
    res = rb.grad_rule(parts, whole, *_counts(scene))
    assert all(ok for _, ok in res.values()), res
    big = trt.random_scene(300, generator=torch.Generator().manual_seed(3), device=cuda_device)
    cam = _pose((64, 32), cuda_device)
    g = (torch.rand((32, 32, 3), generator=torch.Generator().manual_seed(6)) * 1e-2).to(
        cuda_device)
    out = [rb.flatten_grads(*rb.scene_grads_cuda(cam, big, g, depth=2, x_offset=20,
                                                 local_width=32, **kw, **culls))
           for culls in ({}, ALL_OFF)]
    torch.cuda.synchronize()
    assert torch.equal(out[0], out[1])


@pytest.mark.parametrize("compat", [True, False])
def test_backward_cheap_shadow_keyword(cuda_device, compat):
    """cheap_shadow on the backward wrappers, on the demo and a 100-sphere
    scene, where shadow_cheap_ok holds: None gives the bits of True (the
    sqrt-free test); False runs the root test, the bits of a launch of the
    root-test instantiation at the same shape. On the demo scene it is held
    against the plain gradient under the kernel rule, held-out pixels out of
    both; on the 100-sphere scene (a view where the plain float32 gradient
    is too far off its float64 witness to judge a kernel, as in
    test_per_sample_cotangent_forms_match_plain) against the sqrt-free test:
    the same bits in compat mode (pinned arithmetic, as in the render), the
    kernel rule in clean mode, where on the whole cotangent the two tests'
    bits differ (4.3e-6 at most on an H100), so False did reach the launch.
    The fused step and train.cuda_value_and_grad pass the keyword the same
    way."""
    for scene, cam in ((_bwd_scene("demo", compat, cuda_device),
                        trt.default_camera((96, 64), device=cuda_device)),
                       (_planted_scene(100, cuda_device),
                        trt.Camera.build((96, 64), *LARGE_POSES[100], device=cuda_device))):
        assert render_cuda.shadow_cheap_ok(scene, compat)
        x = _bwd_input("cot_aa", cam, scene, _target((96, 64), cuda_device), compat)
        held = rb.held_out(trt.render_image_cuda(cam, scene, compat=compat),
                           trt.render_image(cam, scene, compat=compat))
        keep = (x * ~held[..., None]).contiguous()
        kw = dict(depth=2, compat=compat, aliasing=True, return_camera=True)
        auto = rb.flatten_grads(*rb.scene_grads_cuda(cam, scene, keep, **kw))
        cheap = rb.flatten_grads(*rb.scene_grads_cuda(cam, scene, keep, cheap_shadow=True,
                                                      **kw))
        root = rb.flatten_grads(*rb.scene_grads_cuda(cam, scene, keep, cheap_shadow=False,
                                                     **kw))
        assert torch.equal(auto, cheap)
        plain_all = rb.scene_grads_plain(cam, scene, x, depth=2, compat=compat, aliasing=True)
        packed = render_cuda.packed_inputs(cam, scene, depth=2, compat=compat)
        tabs = render_cuda.large_scene_tables(cam, scene, depth=2, aliasing=True,
                                              compat=compat, packed=packed)
        shape = rb.launch_plan(cam, scene, "cot_aa", tabs=tabs)
        n = rb.n_grads(*packed[2])
        direct = rb.launch(torch.empty(n, device=cuda_device),
                           torch.empty(n * shape.blocks, device=cuda_device), *packed,
                           image=keep, target=None, W=96, H=64, depth=2, mode="cot_aa",
                           compat=compat, cheap_shadow=False, shape=shape, tabs=tabs)
        assert torch.equal(root, direct)
        if scene.spheres.count <= render_cuda.CULL_MIN_SPHERES:
            _assert_rule(root, rb.scene_grads_plain(cam, scene, keep, depth=2, compat=compat,
                                                    aliasing=True), scene, plain_all)
        elif compat:
            assert torch.equal(root, cheap)
        else:
            _assert_rule(root, cheap, scene, plain_all)
            assert not torch.equal(*(rb.flatten_grads(*rb.scene_grads_cuda(
                cam, scene, x, cheap_shadow=c, **kw)) for c in (True, False)))
    tgt = trt.render_image_cuda(cam, scene, aliasing=False, compat=compat)
    init = trt.Scene.from_leaves([t.clone() for t in scene.leaves()])
    init.spheres.center += 0.05
    steps = [rb.loss_and_scene_grads_cuda(cam, init, tgt, compat=compat, return_camera=True,
                                          **c) for c in ({}, dict(cheap_shadow=True))]
    fused = [rb.flatten_grads(sg, cg, loss) for loss, sg, cg in steps]
    assert torch.equal(*fused)
    loss, grads = train.cuda_value_and_grad(cam, tgt, compat=compat, cheap_shadow=False)(init)
    root = rb.loss_and_scene_grads_cuda(cam, init, tgt, compat=compat, cheap_shadow=False)
    assert torch.equal(loss, root[0])
    assert torch.equal(rb.flatten_grads(grads, None, loss), rb.flatten_grads(root[1], None,
                                                                             root[0]))


def test_default_device_is_the_card(cuda_device):
    """Objects made with no device argument lie on the card, and the entry
    points launch their kernels on them with no plain call."""
    from python_ray_tracer_tpu_torch import animation
    scene, cam = trt.default_scene(), trt.default_camera((32, 32))
    big = trt.random_scene(40, generator=torch.Generator().manual_seed(1))
    cams = animation.orbit_cameras((16, 16), center=[1.0, 0.0, 1.0], radius=4.0,
                                   height=1.5, n_frames=2)
    for t in scene.leaves() + big.leaves() + [cam.position, cam.rotation, cams.position]:
        assert t.device.type == "cuda"
    rb.reset_launch_counts()
    render_cuda.reset_launch_counts()
    trt.render_image_cuda(cam, big)
    animation.render_frames(cams, scene)
    train.fit_scene(scene, cam, trt.render_image_cuda(cam, scene, aliasing=False), steps=1)
    torch.cuda.synchronize()
    assert render_cuda.LAUNCHES["aa_shared"] >= 3 and rb.LAUNCHES["fused_noaa"] == 1
    assert not any(rb.PLAIN_CALLS.values())
