"""The port's slices as a whole: ``cli render`` and ``cli fit`` to PNG, the
PNG writers, backend resolution, timing helpers, and that the port never
imports JAX."""
import argparse
import os
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch
from PIL import Image

import python_ray_tracer_tpu as jrt
import python_ray_tracer_tpu_torch as trt
from python_ray_tracer_tpu import cli as jcli
from python_ray_tracer_tpu.utils.image import framebuffer_to_array as jax_fb_to_array
from python_ray_tracer_tpu.utils.timing import rays_per_image as jax_rays_per_image
from python_ray_tracer_tpu_torch import cli
from python_ray_tracer_tpu_torch.models.scene import LEAF_PATHS
from python_ray_tracer_tpu_torch.utils import image

torch.set_num_threads(1)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_cli_render_torch_backend_matches_jax(tmp_path, capsys):
    out = tmp_path / "r.png"
    assert cli.main(["render", "--backend", "torch", "--width", "48",
                     "--height", "48", "--out", str(out)]) == 0
    printed = capsys.readouterr().out
    assert "backend=torch" in printed and "Mrays/s" in printed
    got = np.asarray(Image.open(out).convert("RGB")).astype(np.int32)
    img = jrt.render_image(jrt.default_camera((48, 48)), jrt.default_scene(),
                           depth=2, aliasing=True, compat=True)
    want = jax_fb_to_array(np.asarray(jrt.to_framebuffer(img))).astype(np.int32)
    assert got.shape == want.shape == (48, 48, 3)
    assert np.abs(got - want).max() <= 1


def test_cli_render_spheres_matches_jax(tmp_path):
    """``render --spheres 24``: the JAX package's scene from jax.random.key(0),
    the frame within 1 level of the JAX package's plain render of it."""
    out = tmp_path / "s.png"
    assert cli.main(["render", "--backend", "torch", "--spheres", "24", "--width", "32",
                     "--height", "24", "--out", str(out)]) == 0
    got = np.asarray(Image.open(out).convert("RGB")).astype(np.int32)
    cfg = jrt.RenderConfig()
    mats = jrt.Materials.build(cfg.ambient, cfg.lambert, cfg.reflection, cfg.specular,
                               cfg.shininess)
    scene = jrt.random_scene(jax.random.key(0), 24, materials=mats)
    cam = jrt.Camera.build((32, 24), cfg.camera_position, cfg.camera_euler, cfg.fov)
    img = jrt.render_image(cam, scene, depth=2, aliasing=True, compat=True)
    want = jax_fb_to_array(np.asarray(jrt.to_framebuffer(img))).astype(np.int32)
    assert got.shape == want.shape == (24, 32, 3)
    assert np.abs(got - want).max() <= 1


def test_cli_build_spheres_is_the_jax_clis_scene():
    """``_build`` for ``--spheres 24``: every leaf of the port CLI's scene the
    JAX CLI's, bit for bit."""
    def parsed(add, argv):
        ap = argparse.ArgumentParser()
        add(ap)
        return ap.parse_args(argv)
    scene = cli._build(parsed(cli._add_render_args, ["--spheres", "24", "--backend", "torch"]))[1]
    scene_j = jcli._build(parsed(jcli._add_render_args,
                                 ["--spheres", "24", "--backend", "jnp"]))[1]
    got = [t.numpy() for t in scene.leaves()]
    want = [np.asarray(x) for x in jax.tree_util.tree_leaves(scene_j)]
    assert len(got) == len(want) == len(LEAF_PATHS)
    for path, a, b in zip(LEAF_PATHS, got, want):
        assert a.dtype == b.dtype and np.array_equal(a, b), path


def test_cli_backend_cuda_without_card_raises(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    with pytest.raises(RuntimeError, match="CUDA device"):
        cli.main(["render", "--backend", "cuda", "--width", "8", "--height", "8",
                  "--out", str(tmp_path / "x.png")])


@pytest.mark.parametrize("mode,summary", [("hard", "center err: 0.200 -> median"),
                                          ("camera", "camera pos err: 0.100 -> ")])
def test_cli_fit_torch_backend(tmp_path, capsys, mode, summary):
    """``fit --mode hard|camera --backend torch`` at 16x16, depth 1, 10 steps:
    the JAX CLI's summary line, a falling loss, and the fitted PNG."""
    out = tmp_path / "fit.png"
    assert cli.main(["fit", "--mode", mode, "--backend", "torch", "--width", "16",
                     "--height", "16", "--depth", "1", "--steps", "10",
                     "--out", str(out)]) == 0
    printed = capsys.readouterr().out
    line = next(ln for ln in printed.splitlines() if ln.startswith("loss: "))
    assert summary in line, printed
    first, last = (float(v) for v in line.split()[1:4:2])
    assert last < first
    assert "[fit] step 0: loss=" in printed and "[fit] step 9: loss=" in printed
    assert np.asarray(Image.open(out).convert("RGB")).shape == (16, 16, 3)


def test_cli_fit_first_loss_matches_jax_cli(tmp_path, capsys):
    """The port's hard fit starts from the JAX CLI's scene, shift and target:
    step 0's loss equals ``python_ray_tracer_tpu.cli fit --mode hard``'s."""
    from python_ray_tracer_tpu import cli as jcli
    args = ["fit", "--mode", "hard", "--width", "16", "--height", "16", "--depth", "1",
            "--steps", "1", "--out", ""]
    assert jcli.main(args + ["--backend", "jnp"]) == 0
    want = capsys.readouterr().out
    assert cli.main(args + ["--backend", "torch"]) == 0
    got = capsys.readouterr().out

    def first_loss(text):
        return float(text.split("[fit] step 0: loss=")[1].split()[0])
    assert first_loss(got) == pytest.approx(first_loss(want), rel=1e-5)


def test_cli_fit_backend_cuda_without_card_raises(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    with pytest.raises(RuntimeError, match="CUDA device"):
        cli.main(["fit", "--backend", "cuda", "--width", "8", "--height", "8",
                  "--steps", "1", "--out", str(tmp_path / "x.png")])


def test_resolve_backend():
    """No backend picks the CPU by itself: ``cuda`` is the default and raises
    without a card, ``torch`` is the explicit CPU request, ``auto`` is gone."""
    assert trt.RenderConfig().backend == "cuda"
    assert trt.resolve_backend("torch") == "torch"
    if torch.cuda.is_available():
        assert trt.resolve_backend("cuda") == "cuda"
    else:
        with pytest.raises(RuntimeError, match="CUDA device"):
            trt.resolve_backend("cuda")
    for bad in ("auto", "pallas"):
        with pytest.raises(ValueError):
            trt.resolve_backend(bad)


@pytest.mark.parametrize("shape", [(1, 1), (37, 53), (64, 5)])
def test_stdlib_png_matches_pil(tmp_path, shape):
    rng = np.random.default_rng(sum(shape))
    arr = rng.integers(0, 256, (*shape, 3), dtype=np.uint8)
    path = tmp_path / "s.png"
    path.write_bytes(image.encode_png(arr))
    np.testing.assert_array_equal(np.asarray(Image.open(path)), arr)


def test_native_png_matches_pil(tmp_path):
    """The JAX package's compiled PNG encoder and the port's ``encode_png``
    write the same bytes, which decode to the pixels."""
    from python_ray_tracer_tpu.utils import native as jax_native
    if not jax_native.available():
        pytest.skip("the JAX package's PNG encoder cannot be built here (no g++ or zlib.h)")
    arr = np.random.default_rng(1).integers(0, 256, (29, 41, 3), dtype=np.uint8)
    jax_native.write_png(str(tmp_path / "n.png"), arr)
    np.testing.assert_array_equal(np.asarray(Image.open(tmp_path / "n.png")), arr)
    assert (tmp_path / "n.png").read_bytes() == image.encode_png(arr)


def test_save_png_orientation_matches_jax(tmp_path):
    fb = np.random.default_rng(2).integers(0, 256, (3, 12, 7), dtype=np.uint8)
    np.testing.assert_array_equal(image.framebuffer_to_array(torch.from_numpy(fb)),
                                  jax_fb_to_array(fb))
    trt.save_png(torch.from_numpy(fb), str(tmp_path / "o.png"))
    np.testing.assert_array_equal(np.asarray(Image.open(tmp_path / "o.png")),
                                  jax_fb_to_array(fb))


def test_port_never_imports_jax():
    code = ("import sys; import python_ray_tracer_tpu_torch, "
            "python_ray_tracer_tpu_torch.cli, "
            "python_ray_tracer_tpu_torch.ops.cuda.render_cuda, "
            "python_ray_tracer_tpu_torch.ops.cuda.render_bwd_cuda, "
            "python_ray_tracer_tpu_torch.ops.cuda.soft_cuda, "
            "python_ray_tracer_tpu_torch.ops.cuda.soft_bwd_cuda, "
            "python_ray_tracer_tpu_torch.ops.soft, "
            "python_ray_tracer_tpu_torch.train, "
            "python_ray_tracer_tpu_torch.bridge, "
            "python_ray_tracer_tpu_torch.animation, "
            "python_ray_tracer_tpu_torch.parallel, "
            "python_ray_tracer_tpu_torch.parallel.mesh, "
            "python_ray_tracer_tpu_torch.parallel.render_sharded, "
            "python_ray_tracer_tpu_torch.parallel.distributed, "
            "python_ray_tracer_tpu_torch.ops.adaptive, "
            "python_ray_tracer_tpu_torch.ops.cuda.adaptive_cuda, "
            "python_ray_tracer_tpu_torch.ops.cuda.light_cells_cuda, "
            "python_ray_tracer_tpu_torch.ops.cuda.shadow_lists_cuda, "
            "python_ray_tracer_tpu_torch.ops.cuda.hit_extents_cuda, "
            "python_ray_tracer_tpu_torch.ops.cuda.cull_tables, "
            "python_ray_tracer_tpu_torch.utils.checkpoint, "
            "python_ray_tracer_tpu_torch.utils.faults, "
            "python_ray_tracer_tpu_torch.utils.profiling; "
            "bad = sorted(m for m in sys.modules if m == 'jax' or m.startswith("
            "('jax.', 'python_ray_tracer_tpu.')) or m == 'python_ray_tracer_tpu'); "
            "print(bad); sys.exit(1 if bad else 0)")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr


@pytest.mark.parametrize("aliasing", [True, False])
def test_rays_per_image_matches_jax(aliasing):
    for w, h in [(1000, 1000), (1920, 1080), (1, 1), (2, 5)]:
        kw = dict(depth=2, aliasing=aliasing, n_lights=3)
        assert trt.rays_per_image(w, h, **kw) == jax_rays_per_image(w, h, **kw)
    assert trt.rays_per_image(7, 3, depth=0, aliasing=aliasing, n_lights=0,
                              primary_only=True) == 21


def test_time_fn_on_cpu_returns_seconds_per_call():
    calls = []

    def fn(x):
        calls.append(x)
        return torch.zeros(2) + x
    secs = trt.time_fn(fn, 1.0, warmup=2, iters=3)
    assert secs >= 0.0 and len(calls) == 2 + 3
