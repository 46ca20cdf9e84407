"""The port's default device and its refusal of CPU tensors, on a host
without a card; and the plain per-sample AA cotangent against the JAX kernel.

Every port function that makes tensors takes ``device=None``, and None is
the card (``utils.config.resolve_device``): without one it raises the
``RuntimeError`` of ``resolve_backend``. Every wrapper named for a kernel
raises ``ValueError`` on CPU tensors before any launch or plain call, and
every ``backend="cuda"`` entry point needs a card. The plain versions run on
the CPU by their own names and through ``backend="torch"``.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import python_ray_tracer_tpu as jrt
import python_ray_tracer_tpu_torch as trt
from python_ray_tracer_tpu.ops.pallas.render_bwd import scene_grads_pallas
from python_ray_tracer_tpu_torch import animation, bridge, cli, train
from python_ray_tracer_tpu_torch.ops.cuda import (adaptive_cuda, hit_extents_cuda,
                                                  light_cells_cuda, render_bwd_cuda,
                                                  render_cuda, shadow_lists_cuda,
                                                  soft_bwd_cuda, soft_cuda)
from python_ray_tracer_tpu_torch.parallel import make_mesh, render_image_sharded
from python_ray_tracer_tpu_torch.utils.config import resolve_device

from .test_torch_grads import assert_kernel_rule, leaf_groups, noise, port_groups
from .test_torch_render import to_torch
from .torch_plain_launch import plain_launches

torch.set_num_threads(1)

SPHERE = ([0.0, 0.0, 1.0], 0.5, trt.RED)
SOA = trt.default_scene(device="cpu").to_soa()
LEAVES = [t.numpy() for t in trt.default_scene(device="cpu").leaves()]
CONSTRUCTORS = {
    "default_scene": lambda **kw: trt.default_scene(**kw),
    "default_camera": lambda **kw: trt.default_camera((8, 8), **kw),
    "random_scene": lambda **kw: trt.random_scene(
        10, generator=torch.Generator().manual_seed(0), **kw),
    "Camera.build": lambda **kw: trt.Camera.build((8, 8), [0.0, 0.0, 1.0], [0.0, 0.0, 0.0],
                                                  **kw),
    "euler_rotation": lambda **kw: trt.euler_rotation(0.0, -30.0, 0.0, **kw),
    "Spheres.build": lambda **kw: trt.Spheres.build([SPHERE], **kw),
    "Planes.build": lambda **kw: trt.Planes.build([([5, 0, 0], [0, 0, 1], trt.GREY)], **kw),
    "Lights.build": lambda **kw: trt.Lights.build([[1.0, 2.0, 3.0]], **kw),
    "Materials.build": lambda **kw: trt.Materials.build(**kw),
    "Scene.from_soa": lambda **kw: trt.Scene.from_soa(*SOA, **kw),
    "orbit_cameras": lambda **kw: animation.orbit_cameras(
        (8, 8), center=[1.0, 0.0, 1.0], radius=4.0, height=1.5, n_frames=2, **kw),
    "bridge.scene_from_leaves": lambda **kw: bridge.scene_from_leaves(LEAVES, **kw),
    "bridge.scene_from_soa": lambda **kw: bridge.scene_from_soa(*SOA, **kw),
    "bridge.camera_from_arrays": lambda **kw: bridge.camera_from_arrays(
        np.zeros(3), np.eye(3), 45.0, (8, 8), **kw),
    "bridge.tables_from_arrays": lambda **kw: bridge.tables_from_arrays(
        vis=(np.zeros(4), np.zeros(4), 1), **kw),
}


def _devices(obj):
    """The device types of every tensor an object holds."""
    if isinstance(obj, torch.Tensor):
        return {obj.device.type}
    if isinstance(obj, (tuple, list)):
        return set().union(*(_devices(o) for o in obj if o is not None))
    if hasattr(obj, "leaves"):
        return {t.device.type for t in obj.leaves()}
    if hasattr(obj, "__dict__"):
        return {t.device.type for t in vars(obj).values() if isinstance(t, torch.Tensor)}
    return set()


@pytest.mark.parametrize("name", sorted(CONSTRUCTORS))
def test_constructor_default_device_is_the_card(name):
    """With no device argument a constructor puts its tensors on the card,
    and without one raises resolve_backend's RuntimeError; device="cpu" is
    the CPU."""
    make = CONSTRUCTORS[name]
    if torch.cuda.is_available():
        assert _devices(make()) == {"cuda"}
    else:
        with pytest.raises(RuntimeError, match="needs a CUDA device, and "
                                               "torch.cuda.is_available\\(\\) is False"):
            make()
    assert _devices(make(device="cpu")) == {"cpu"}


def test_resolve_device():
    assert resolve_device("cpu") == torch.device("cpu")
    assert resolve_device(torch.device("cpu")) == torch.device("cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="needs a CUDA device"):
            resolve_device()


def _counts():
    mods = (render_cuda, render_bwd_cuda, soft_cuda, soft_bwd_cuda, adaptive_cuda,
            hit_extents_cuda, light_cells_cuda, shadow_lists_cuda)
    return [dict(getattr(m, k)) for m in mods for k in
            ("LAUNCHES", "TABLE_LAUNCHES", "PLAIN_CALLS") if hasattr(m, k)]


def _inputs():
    cam = trt.default_camera((16, 16), device="cpu")
    big = trt.random_scene(20, generator=torch.Generator().manual_seed(2), device="cpu")
    return cam, trt.default_scene(device="cpu"), big, torch.zeros((16, 16, 3))


WRAPPERS = {
    "render_image_cuda": lambda c, s, b, g: trt.render_image_cuda(c, s),
    "render_image_fast": lambda c, s, b, g: trt.render_image_fast(c, s),
    "scene_grads_cuda": lambda c, s, b, g: trt.scene_grads_cuda(c, s, g, aliasing=True),
    "scene_grads_cuda per-sample": lambda c, s, b, g: trt.scene_grads_cuda(
        c, s, g, aliasing=True, aa_share=False),
    "loss_and_scene_grads_cuda": lambda c, s, b, g: trt.loss_and_scene_grads_cuda(c, s, g),
    "render_image_soft_cuda": lambda c, s, b, g: trt.render_image_soft_cuda(c, s),
    "render_image_soft_fast": lambda c, s, b, g: trt.render_image_soft_fast(c, s),
    "soft_scene_grads_cuda": lambda c, s, b, g: trt.soft_scene_grads_cuda(c, s, g),
    "soft_loss_and_grads_cuda": lambda c, s, b, g: trt.soft_loss_and_grads_cuda(c, s, g),
    "render_image_adaptive_cuda": lambda c, s, b, g: trt.render_image_adaptive_cuda(c, b),
    "hit_extents_cuda": lambda c, s, b, g: hit_extents_cuda.hit_extents_cuda(
        c, b, aliasing=True),
    "light_cells_cuda": lambda c, s, b, g: light_cells_cuda.light_cells_cuda(
        *render_cuda.scene_tables(b)[::2], 20, 3),
    "shadow_lists_cuda": lambda c, s, b, g: shadow_lists_cuda.shadow_lists_cuda(
        torch.zeros((4, 8)), torch.ones(1), b.lights.position, b.spheres.center,
        b.spheres.radius, K=8, compat=True),
}


@pytest.mark.parametrize("name", sorted(WRAPPERS))
def test_kernel_wrapper_refuses_cpu_tensors(name):
    """Each wrapper named for a kernel raises ValueError naming the device on
    CPU tensors (cull keywords or not), and no launch, table launch or plain
    call is counted."""
    args = _inputs()
    before = _counts()
    with pytest.raises(ValueError, match=r"takes CUDA tensors, got cpu"):
        WRAPPERS[name](*args)
    assert _counts() == before


ENTRY_POINTS = {
    "fit_scene": lambda c, s, g: train.fit_scene(s, c, g, steps=1, backend="cuda"),
    "fit_scene_soft": lambda c, s, g: train.fit_scene_soft(s, c, s, steps=1, backend="cuda"),
    "fit_camera": lambda c, s, g: train.fit_camera(c, s, g, steps=1, backend="cuda"),
    "render_frames": lambda c, s, g: animation.render_frames(
        animation.orbit_cameras((16, 16), center=[1.0, 0.0, 1.0], radius=4.0, height=1.5,
                                n_frames=2, device="cpu"), s, backend="cuda"),
    "render_image_sharded": lambda c, s, g: render_image_sharded(
        c, s, make_mesh(size=2, rank=0), backend="cuda"),
}


@pytest.mark.parametrize("name", sorted(ENTRY_POINTS))
def test_cuda_backend_needs_the_card(name):
    """backend="cuda" means the card: without one it raises resolve_backend's
    RuntimeError; on one, CPU tensors raise ValueError. Nothing runs."""
    cam, scene, _, g = _inputs()
    before = _counts()
    err = ValueError if torch.cuda.is_available() else RuntimeError
    with pytest.raises(err, match="CUDA"):
        ENTRY_POINTS[name](cam, scene, g)
    assert _counts() == before


def test_cli_render_torch_backend_writes_a_png(tmp_path, capsys):
    """`cli render --backend torch` still runs on the CPU at 16x16."""
    out = tmp_path / "r.png"
    assert cli.main(["render", "--backend", "torch", "--width", "16", "--height", "16",
                     "--out", str(out)]) == 0
    assert out.read_bytes()[:8] == b"\x89PNG\r\n\x1a\n"
    assert "device=cpu" in capsys.readouterr().out


def test_plain_per_sample_cotangent_matches_pallas_kernel():
    """The demo scene 16x16, depth 0, AA: scene_grads_plain(aliasing=True), the
    plain version of the per-sample AA cotangent, against the JAX kernel's
    per-sample mode (scene_grads_pallas(aa_share=False), interpret mode),
    camera slots included, under the JAX package's kernel rule: geometry,
    light and camera leaves max|d| / max|g| < 5e-2, the albedo, plane and
    material leaves rtol 1e-3 / atol 1e-7. Depth 0 keeps the one interpret
    trace near 20 s (depth 1 doubles it); the rule still refuses the no-AA
    adjoint and the clean-mode one at this size."""
    scene_j, cam_j = jrt.default_scene(), jrt.default_camera((16, 16))
    g = (noise((16, 16), seed=7) - 0.5) * np.float32(1e-2)
    gs_k, gc_k = scene_grads_pallas(cam_j, scene_j, jnp.asarray(g), depth=0, compat=True,
                                    aliasing=True, aa_share=False, interpret=True,
                                    tile_w=16, tile_h=16, return_camera=True)
    cam, scene = to_torch(cam_j, scene_j)
    flat = render_bwd_cuda.scene_grads_plain(cam, scene, torch.from_numpy(g), depth=0,
                                             aliasing=True)
    got, loss = port_groups(flat, scene)
    assert loss is None
    assert_kernel_rule(got, leaf_groups(gs_k, gc_k))


def _pose_params():
    return {"position": torch.tensor([-2.1, 0.08, 1.92]),
            "euler": torch.deg2rad(torch.tensor([1.5, -27.5, 2.0])),
            "fov": torch.tensor(45.0)}


BWD_CALLS = {
    "scene_grads_cuda": lambda c, s, g, kw: trt.scene_grads_cuda(c, s, g, aliasing=True,
                                                                 **kw),
    "scene_grads_cuda per-sample": lambda c, s, g, kw: trt.scene_grads_cuda(
        c, s, g, aliasing=True, aa_share=False, **kw),
    "loss_and_scene_grads_cuda": lambda c, s, g, kw: trt.loss_and_scene_grads_cuda(
        c, s, g, **kw),
    "cuda_value_and_grad": lambda c, s, g, kw: train.cuda_value_and_grad(c, g, **kw)(s),
    "cuda_value_and_grad unfused": lambda c, s, g, kw: train.cuda_value_and_grad(
        c, g, fused=False, aliasing=True, **kw)(s),
    "cuda_value_and_grad_sharded": lambda c, s, g, kw: train.cuda_value_and_grad_sharded(
        c, make_mesh(size=1, rank=0), **kw)(s, g),
    "camera_value_and_grad": lambda c, s, g, kw: train.camera_value_and_grad(
        s, g, c.resolution, **kw)(_pose_params()),
}


@pytest.mark.parametrize("cheap_shadow", [None, False])
@pytest.mark.parametrize("name", sorted(BWD_CALLS))
def test_backward_keywords_reach_the_launch(monkeypatch, name, cheap_shadow):
    """The backward's cheap_shadow reaches the launch (render_bwd_cuda._run)
    from every wrapper and value_and_grad that takes it, as given (None is
    resolved there, to shadow_cheap_ok); aa_share=False launches cot_aa, the
    lattice, which is also the aa_per_sample render's adjoint. The launch is
    its plain version (tests/torch_plain_launch.py)."""
    plain_launches(monkeypatch.setattr)
    seen, plain_run = [], render_bwd_cuda._run

    def run(*args, **kw):
        seen.append((kw["mode"], kw.get("cheap_shadow")))
        return plain_run(*args, **kw)
    monkeypatch.setattr(render_bwd_cuda, "_run", run)
    cam, scene = trt.default_camera((8, 8), device="cpu"), trt.default_scene(device="cpu")
    g = torch.full((8, 8, 3), 1e-3)
    kw = {} if cheap_shadow is None else dict(cheap_shadow=cheap_shadow)
    BWD_CALLS[name](cam, scene, g, kw)
    assert [c for _, c in seen] == [cheap_shadow]
    if name.startswith("scene_grads_cuda"):
        assert seen[0][0] == "cot_aa"
