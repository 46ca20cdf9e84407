"""PyTorch port's plain renderer (ops/render.py) against the JAX package's
render_image and its frozen framebuffers.

Float images follow tests/test_pallas.py::_compare's rule: float32
reassociation flips isolated near-tie hit or shadow tests, so the COUNT of
outliers is bounded at two magnitudes instead of the worst case. Framebuffers
against the goldens follow tests/test_goldens.py's rule (max diff <= 1 level,
< 1% changed), except at the one near tie named in tests/torch_goldens.py:
pixel (8, 33) of the 64x64 frame, where the plain port, like the JAX jnp path
run without jit, reads 4 levels off demo_64_d2_aa_compat.
"""
import jax
import numpy as np
import pytest
import torch

import python_ray_tracer_tpu as jrt
import python_ray_tracer_tpu_torch as trt
from python_ray_tracer_tpu_torch import bridge

from .torch_goldens import GOLDEN_CONFIGS, compare_frames, load_golden

torch.set_num_threads(1)


def to_torch(cam_j, scene_j):
    cam = bridge.camera_from_arrays(cam_j.position, cam_j.rotation, cam_j.fov,
                                    cam_j.resolution, device="cpu")
    return cam, bridge.scene_from_leaves(
        [np.asarray(x) for x in jax.tree_util.tree_leaves(scene_j)], device="cpu")


def compare_images(out, ref, atol=1e-4):
    """tests/test_pallas.py::_compare's outlier rule."""
    diff = np.abs(np.asarray(out) - np.asarray(ref))
    assert out.shape == ref.shape
    frac_bad = (diff > atol).mean()
    assert frac_bad <= 0.005, f"{frac_bad:.2%} of values exceed atol={atol}"
    assert (diff > 0.05).mean() <= 0.002, (
        f"{(diff > 0.05).mean():.2%} hit-flip outliers (max {diff.max()})")


@pytest.mark.parametrize("size", [48, 64])
@pytest.mark.parametrize("depth,aliasing,compat", [
    (0, False, True), (2, False, True), (2, True, True), (2, False, False),
    (4, False, True)])
def test_render_matches_jax(demo_scene, size, depth, aliasing, compat):
    cam_j = jrt.default_camera((size, size))
    ref = np.asarray(jrt.render_image(cam_j, demo_scene, depth=depth,
                                      aliasing=aliasing, compat=compat))
    cam, scene = to_torch(cam_j, demo_scene)
    out = trt.render_image(cam, scene, depth=depth, aliasing=aliasing, compat=compat)
    compare_images(out.numpy(), ref)


@pytest.mark.parametrize("name", sorted(n for n in GOLDEN_CONFIGS if n.startswith("demo_")))
def test_demo_golden_framebuffers(name):
    (w, h), depth, aa, compat = GOLDEN_CONFIGS[name]
    img = trt.render_image(trt.default_camera((w, h), device="cpu"),
                           trt.default_scene(device="cpu"),
                           depth=depth, aliasing=aa, compat=compat)
    fb = trt.to_framebuffer(img)
    assert fb.dtype == torch.uint8 and fb.shape == (3, w, h)
    compare_frames(fb.numpy(), load_golden(name), name)


def test_nonsquare_frame_matches_jax(demo_scene):
    """40x24: compat int(w/h) aspect ratio and a ragged border ring."""
    cam_j = jrt.Camera.build((40, 24), [-2, 0, 2], [0, -30, 0])
    ref = np.asarray(jrt.render_image(cam_j, demo_scene, depth=1, aliasing=True))
    cam, scene = to_torch(cam_j, demo_scene)
    compare_images(trt.render_image(cam, scene, depth=1, aliasing=True).numpy(), ref)


def test_row_chunk_equals_full_frame():
    cam, scene = trt.default_camera((40, 24), device="cpu"), trt.default_scene(device="cpu")
    full = trt.render_image(cam, scene, depth=1, aliasing=True)
    chunked = trt.render_image(cam, scene, depth=1, aliasing=True, row_chunk=16)
    torch.testing.assert_close(chunked, full, rtol=0, atol=0)


def test_to_framebuffer_rounds_half_to_even_like_jax():
    vals = np.array([0.0, 0.5, 1.5, 2.5, 254.5, 255.5, 300.0, -3.0, 127.49999],
                    np.float32) / np.float32(255.0)
    img = np.stack([vals, vals[::-1], vals], axis=-1)[:, None, :]      # (9, 1, 3)
    want = np.asarray(jrt.to_framebuffer(jax.numpy.asarray(img)))
    got = trt.to_framebuffer(torch.from_numpy(img)).numpy()
    np.testing.assert_array_equal(got, want)
    assert got.shape == (3, 9, 1)
