"""The port's animation module and ``cli animate`` on the CPU, against the JAX
package's (tests/test_animation.py:11, :23, :42).

Orbit cameras equal the JAX ``orbit_cameras``' (both compute the poses in
float32 from the same float64 angles); frames of the plain backend match the
JAX ``render_frames(backend="jnp")`` under the port's image rule (uint8
framebuffers at most 1 level apart on at most 0.1% of the pixels) and equal
single renders; the GIF writer's frames decode to the JAX writer's.
"""
import io

import numpy as np
import pytest
import torch
from PIL import Image

import python_ray_tracer_tpu_torch as trt
from python_ray_tracer_tpu_torch import animation, cli
from python_ray_tracer_tpu_torch.utils.image import encode_gif

torch.set_num_threads(1)

ORBIT = dict(center=[1.0, 0.0, 1.0], radius=4.0, height=1.5)


def test_orbit_cameras_look_at_center_and_match_jax():
    from python_ray_tracer_tpu import animation as janim
    cams = animation.orbit_cameras((16, 16), n_frames=6, **ORBIT, device="cpu")
    assert cams.position.shape == (6, 3) and cams.rotation.shape == (6, 3, 3)
    fwd = cams.rotation.numpy() @ np.array([1.0, 0.0, 0.0])
    to_c = np.array([1.0, 0.0, 1.0]) - cams.position.numpy()
    to_c /= np.linalg.norm(to_c, axis=1, keepdims=True)
    np.testing.assert_allclose(fwd, to_c, atol=1e-5)
    ref = janim.orbit_cameras((16, 16), n_frames=6, **ORBIT)
    np.testing.assert_allclose(cams.position.numpy(), np.asarray(ref.position), atol=1e-6)
    np.testing.assert_allclose(cams.rotation.numpy(), np.asarray(ref.rotation), atol=1e-6)
    assert cams.resolution == (16, 16)


def test_render_frames_match_jax_and_single_renders():
    from python_ray_tracer_tpu import animation as janim
    import python_ray_tracer_tpu as jrt
    cams = animation.orbit_cameras((24, 16), n_frames=3, **ORBIT, device="cpu")
    scene = trt.default_scene(device="cpu")
    frames = animation.render_frames(cams, scene, depth=1, aliasing=False, backend="torch")
    assert frames.shape == (3, 24, 16, 3)
    ref = np.asarray(janim.render_frames(janim.orbit_cameras((24, 16), n_frames=3, **ORBIT),
                                         jrt.default_scene(), depth=1, aliasing=False,
                                         backend="jnp"))
    for k in range(3):
        cam = animation.frame_camera(cams, k)
        single = trt.render_image(cam, scene, depth=1, aliasing=False)
        assert torch.equal(frames[k], single)
        a = trt.to_framebuffer(frames[k]).int()
        b = trt.to_framebuffer(torch.from_numpy(np.array(ref[k]))).int()
        off = (a - b).abs().amax(dim=0)
        assert int((off > 1).sum()) <= 1e-3 * off.numel(), int(off.max())
    assert float((frames[0] - frames[1]).abs().max()) > 1e-3


def test_render_frames_cuda_backend_takes_cuda_tensors(monkeypatch):
    """"cuda" needs a card (resolve_backend raises without one) and CUDA
    tensors: on a host with a card (resolve_backend passing, patched here)
    CPU tensors raise ValueError before any launch."""
    cams = animation.orbit_cameras((8, 8), n_frames=2, **ORBIT, device="cpu")
    scene = trt.default_scene(device="cpu")
    with pytest.raises(ValueError, match="unknown backend"):
        animation.render_frames(cams, scene, backend="jnp")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="needs a CUDA device"):
            animation.render_frames(cams, scene, backend="cuda")
    monkeypatch.setattr(animation, "resolve_backend", lambda b: b)
    with pytest.raises(ValueError, match="CUDA tensors, got cpu"):
        animation.render_frames(cams, scene, backend="cuda")


def test_stack_cameras_checks():
    with pytest.raises(ValueError, match="at least one camera"):
        animation.stack_cameras([])
    with pytest.raises(ValueError, match="resolutions"):
        animation.stack_cameras([trt.default_camera((8, 8), device="cpu"),
                                 trt.default_camera((8, 4), device="cpu")])


def test_save_animation_writes_gif(tmp_path):
    cams = animation.orbit_cameras((16, 16), n_frames=2, **ORBIT, device="cpu")
    frames = animation.render_frames(cams, trt.default_scene(device="cpu"), depth=0, aliasing=False,
                                     backend="torch")
    path = tmp_path / "orbit.gif"
    animation.save_animation(frames, str(path), fps=8)
    im = Image.open(path)
    assert im.format == "GIF" and im.n_frames == 2 and im.size == (16, 16)
    assert im.info.get("duration") == 120 and im.info.get("loop") == 0


@pytest.mark.parametrize("shape", [(1, 1, 1), (3, 37, 53), (2, 300, 7)])
def test_gif_frames_decode_to_the_palette_levels(shape, tmp_path):
    """``encode_gif``'s frames decode, with PIL, to the frames of the JAX
    package's Pillow-written GIF of the same pixels (each frame's adaptive
    palette, the literal-code LZW stream), including a frame whose codes
    cross many clear codes."""
    from python_ray_tracer_tpu import animation as janim
    n, h, w = shape
    frames = np.random.default_rng(h).integers(0, 256, (n, h, w, 3), dtype=np.uint8)
    path = tmp_path / "jax.gif"
    janim.save_animation(np.transpose(frames, (0, 2, 1, 3)).astype(np.float32) / 255.0,
                         str(path), fps=20)
    want = Image.open(path)
    im = Image.open(io.BytesIO(encode_gif(frames, duration=50)))
    assert im.n_frames == want.n_frames == n
    for k in range(n):
        im.seek(k)
        want.seek(k)
        assert im.info["duration"] == want.info["duration"] == 50
        np.testing.assert_array_equal(np.asarray(im.convert("RGB")),
                                      np.asarray(want.convert("RGB")))


def test_cli_animate_torch_backend_writes_gif(tmp_path, capsys):
    out = tmp_path / "orbit.gif"
    assert cli.main(["animate", "--backend", "torch", "--width", "16", "--height", "16",
                     "--frames", "3", "--fps", "10", "--depth", "1",
                     "--out", str(out)]) == 0
    text = capsys.readouterr().out
    assert "ms/frame" in text and "backend=torch" in text and f"saved {out}" in text
    im = Image.open(out)
    assert im.format == "GIF" and im.n_frames == 3 and im.size == (16, 16)


def test_cli_animate_cuda_backend_without_card_raises(tmp_path):
    with pytest.raises(RuntimeError, match="needs a CUDA device"):
        cli.main(["animate", "--width", "16", "--height", "16", "--frames", "2",
                  "--out", str(tmp_path / "o.gif")])
