"""The CUDA kernel module (ops/cuda/render_cuda.py) on the CPU.

On CPU tensors render_image_cuda runs the plain PyTorch version; here it is held
against the JAX package's fused kernel in interpret mode and against that
kernel's frozen framebuffers (kernel_frames.npz, which also pin the shared-AA
kernel without a slow interpret trace). The host-side pieces the CUDA launch
uses (parameter packing, SoA tables, the shadow-test guard, the build) are
checked here too; the kernel itself runs in tests/test_torch_card.py on a card.
"""
import os
import stat

import jax
import numpy as np
import pytest
import torch

import python_ray_tracer_tpu as jrt
import python_ray_tracer_tpu_torch as trt
from python_ray_tracer_tpu.ops.pallas.render_pallas import (
    _pack_params, _shadow_cheap_ok, render_image_pallas)
from python_ray_tracer_tpu_torch.ops.cuda import _build, render_cuda

from .test_torch_render import compare_images, to_torch
from .torch_goldens import GOLDEN_CONFIGS, compare_frames, load_golden

torch.set_num_threads(1)


@pytest.mark.parametrize("depth,aliasing", [(2, False), (1, True)])
def test_cpu_tensors_match_pallas_interpret(demo_scene, depth, aliasing):
    cam_j = jrt.default_camera((24, 24))
    ref = np.asarray(render_image_pallas(
        cam_j, demo_scene, depth=depth, aliasing=aliasing, compat=True,
        interpret=True, tile_w=8, tile_h=32, aa_share=False))
    cam, scene = to_torch(cam_j, demo_scene)
    before = dict(render_cuda.LAUNCHES)
    with pytest.raises(ValueError, match="render_image_cuda takes CUDA tensors, got cpu"):
        trt.render_image_cuda(cam, scene, depth=depth, aliasing=aliasing, compat=True)
    assert render_cuda.LAUNCHES == before      # refused before any launch
    out = trt.render_image(cam, scene, depth=depth, aliasing=aliasing, compat=True)
    compare_images(out.numpy(), ref)


@pytest.mark.parametrize("name", sorted(n for n in GOLDEN_CONFIGS if n.startswith("kernel_")))
def test_kernel_golden_framebuffers(name):
    (w, h), depth, aa, compat = GOLDEN_CONFIGS[name]
    img = trt.render_image(trt.default_camera((w, h), device="cpu"),
                           trt.default_scene(device="cpu"), depth=depth, aliasing=aa,
                           compat=compat)
    compare_frames(trt.to_framebuffer(img).numpy(), load_golden(name), name)


@pytest.mark.parametrize("res", [(1920, 1080), (40, 24)])
@pytest.mark.parametrize("compat", [True, False])
def test_pack_params_matches_jax(res, compat):
    mats = dict(ambient=0.1, lambert=0.7, reflection=0.25, specular=0.4,
                shininess=20.0)
    cam_j = jrt.Camera.build(res, [-2.0, 0.3, 2.0], [2.0, -30.0, 5.0])
    scene_j = jrt.default_scene(jrt.Materials.build(**mats))
    want = np.asarray(_pack_params(cam_j, scene_j, compat))
    cam, scene = to_torch(cam_j, scene_j)
    got = render_cuda.pack_params(cam, scene, compat).numpy()
    assert got.shape == (render_cuda.N_PARAMS,) == want.shape
    np.testing.assert_allclose(got, want, atol=1e-6, rtol=0)


def test_scene_tables_match_soa_layout():
    scene_j = jrt.random_scene(jax.random.key(2), n_spheres=24)
    _, scene = to_torch(jrt.default_camera((8, 8)), scene_j)
    sph, pln, lts = render_cuda.scene_tables(scene)
    sp, li, pl = scene_j.to_soa()
    np.testing.assert_array_equal(sph[:4].numpy(), sp[:4])
    np.testing.assert_allclose(sph[4:].numpy() * 255.0, sp[4:], rtol=1e-6)
    np.testing.assert_array_equal(lts.numpy(), li)
    np.testing.assert_array_equal(pln[:6].numpy(), pl[:6])
    assert sph.is_contiguous() and pln.is_contiguous() and lts.is_contiguous()
    empty = trt.Scene(trt.Spheres.build([], device="cpu"), trt.Planes.build([], device="cpu"),
                      trt.Lights.build([], device="cpu"), trt.Materials.build(device="cpu"))
    assert [t.shape for t in render_cuda.scene_tables(empty)] == [(7, 1), (9, 1), (3, 1)]


def test_shadow_cheap_ok_matches_jax(demo_scene):
    _, scene = to_torch(jrt.default_camera((8, 8)), demo_scene)
    huge_j = jrt.Scene(jrt.Spheres.build([([0, 0, 0], 600.0, (1, 2, 3))]),
                       demo_scene.planes, demo_scene.lights, demo_scene.materials)
    _, huge = to_torch(jrt.default_camera((8, 8)), huge_j)
    for compat in (True, False):
        assert render_cuda.shadow_cheap_ok(scene, compat) == _shadow_cheap_ok(
            demo_scene, compat)
        assert render_cuda.shadow_cheap_ok(huge, compat) == _shadow_cheap_ok(
            huge_j, compat)
    assert not render_cuda.shadow_cheap_ok(huge, True)


def test_wrapper_rejects_other_devices():
    cam = trt.default_camera((8, 8), device="cpu").to("meta")
    scene = trt.default_scene(device="cpu")
    with pytest.raises(ValueError, match="takes CUDA tensors, got meta"):
        trt.render_image_cuda(cam, scene)


def test_build_raises_with_compiler_stderr(tmp_path, monkeypatch):
    """A failed nvcc run raises with the compiler's stderr; nothing falls back."""
    fake = tmp_path / "cuda" / "bin" / "nvcc"
    fake.parent.mkdir(parents=True)
    fake.write_text("#!/bin/sh\necho 'render_fwd.cu(1): error: deliberate' >&2\nexit 2\n")
    fake.chmod(fake.stat().st_mode | stat.S_IEXEC)
    monkeypatch.setenv("CUDA_HOME", str(tmp_path / "cuda"))
    monkeypatch.setattr(_build, "BUILD_DIR", str(tmp_path / "build"))
    assert _build.find_nvcc() == str(fake)
    with pytest.raises(RuntimeError, match="deliberate"):
        _build.build()
    assert not any(p.suffix == ".so" for p in (tmp_path / "build").iterdir())


def test_library_path_tracks_sources(tmp_path, monkeypatch):
    """The library name hashes the sources: an edit means a rebuild."""
    for name in ("render_fwd.cu", "rt_common.cuh"):
        (tmp_path / name).write_text("// v1\n")
    monkeypatch.setattr(_build, "CSRC_DIR", str(tmp_path))
    a = _build.library_path()
    (tmp_path / "rt_common.cuh").write_text("// v2\n")
    assert _build.library_path() != a
    assert os.path.dirname(a) == _build.BUILD_DIR
