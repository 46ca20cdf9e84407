"""The soft slice as a whole on the CPU: the soft kernel wrappers on CPU
tensors (they take the plain version and launch nothing), the differentiable
soft render, ``train.fit_scene_soft`` against the JAX package's
``fit_scene_soft``, and ``cli fit --mode soft`` / ``cli render --soft``
against the JAX CLI.

Fits are held to the same first loss of every tau stage from the same scene
(the same renderer, targets and inputs, before any Adam difference; see
test_fit_scene_soft_matches_jax_fit for the tolerances) and to the same
convergence, not to equal trajectories (torch and optax Adam round their
updates differently).
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

import python_ray_tracer_tpu as jrt
from python_ray_tracer_tpu import train as jtrain
import python_ray_tracer_tpu_torch as trt
from python_ray_tracer_tpu_torch import cli, train
from python_ray_tracer_tpu_torch.ops.cuda import render_bwd_cuda as rb
from python_ray_tracer_tpu_torch.ops.cuda import soft_bwd_cuda as sb
from python_ray_tracer_tpu_torch.ops.cuda import soft_cuda
from python_ray_tracer_tpu_torch.utils.metrics import MetricsLogger

from .test_torch_render import to_torch
from .test_torch_soft import TAU, noise, small_scene_jax
from .torch_plain_launch import plain_launches

torch.set_num_threads(1)


def test_soft_wrappers_on_cpu_take_the_plain_version(monkeypatch):
    """render_image_soft_cuda, render_image_soft_fast, soft_scene_grads_cuda
    and soft_loss_and_grads_cuda refuse CPU tensors: no launch, no plain call.
    The plain versions, by name, give the plain render's numbers; the two
    backward wrappers' glue, with their launches standing in for the card
    (tests/torch_plain_launch.py), gives the plain version's numbers, counted
    in PLAIN_CALLS, with no kernel launch."""
    cam, scene = to_torch(jrt.default_camera((12, 10)), small_scene_jax())
    g = torch.from_numpy(noise((12, 10), seed=1))
    sb.reset_launch_counts()
    soft_cuda.reset_launch_counts()
    for name, fn in (("render_image_soft_cuda", lambda: trt.render_image_soft_cuda(
                         cam, scene, tau=TAU)),
                     ("render_image_soft_fast", lambda: trt.render_image_soft_fast(
                         cam, scene, tau=TAU)),
                     ("soft_scene_grads_cuda", lambda: trt.soft_scene_grads_cuda(
                         cam, scene, g, tau=TAU)),
                     ("soft_loss_and_grads_cuda", lambda: trt.soft_loss_and_grads_cuda(
                         cam, scene, g.abs(), tau=TAU))):
        with pytest.raises(ValueError, match=f"{name} takes CUDA tensors, got cpu"):
            fn()
    assert soft_cuda.PLAIN_CALLS == {"render_image_soft": 0}
    assert sb.PLAIN_CALLS == {"soft_scene_grads": 0, "soft_loss_and_grads": 0}
    plain_launches(monkeypatch.setattr)
    img = soft_cuda.render_image_soft_plain(cam, scene, tau=TAU)
    torch.testing.assert_close(img, trt.render_image_soft(cam, scene, tau=TAU), rtol=0,
                               atol=0)
    scene_g, cam_g = trt.soft_scene_grads_cuda(cam, scene, g, tau=TAU, return_camera=True)
    torch.testing.assert_close(rb.flatten_grads(scene_g, cam_g),
                               sb.soft_scene_grads_plain(cam, scene, g, tau=TAU),
                               rtol=0, atol=0)
    loss, scene_g = trt.soft_loss_and_grads_cuda(cam, scene, g.abs(), tau=TAU)
    flat = sb.soft_loss_and_grads_plain(cam, scene, g.abs(), tau=TAU)
    torch.testing.assert_close(rb.flatten_grads(scene_g, None, loss)[:-14], flat[:-14],
                               rtol=0, atol=0)
    assert float(loss) == float(flat[-1])
    assert soft_cuda.PLAIN_CALLS == {"render_image_soft": 1}
    assert sb.PLAIN_CALLS == {"soft_scene_grads": 2, "soft_loss_and_grads": 2}
    assert soft_cuda.LAUNCHES == {"soft_fwd": 0} and sb.LAUNCHES == {"cot": 0, "fused": 0}


def test_render_image_soft_fast_on_cpu_is_differentiable():
    """render_image_soft_fast refuses CPU tensors; its plain version, the
    plain soft render differentiated by autograd, gives the gradients of
    soft_scene_grads_plain."""
    cam, scene = to_torch(jrt.default_camera((12, 12)), small_scene_jax())
    g = torch.from_numpy(noise((12, 12), seed=4))
    with pytest.raises(ValueError, match="render_image_soft_fast takes CUDA tensors, got cpu"):
        trt.render_image_soft_fast(cam, scene, tau=TAU)
    center = scene.spheres.center.clone().requires_grad_(True)
    fov = cam.fov.clone().requires_grad_(True)
    scene.spheres.center, cam.fov = center, fov
    (soft_cuda.render_image_soft_plain(cam, scene, tau=TAU) * g).sum().backward()
    flat = sb.soft_scene_grads_plain(cam, scene, g, tau=TAU)
    torch.testing.assert_close(center.grad.reshape(-1),
                               flat[:21].reshape(3, 7)[:, :3].reshape(-1))
    torch.testing.assert_close(fov.grad, flat[-1])


def _one_sphere_jax():
    """tests/test_soft_bwd.py::test_soft_fit_scene_pallas_backend_converges."""
    target = jrt.Scene(
        jrt.Spheres.build([([4.0, 0.0, 0.8], 1.0, jrt.RED)]),
        jrt.Planes.build([([0.0, 0.0, -1.0], [0.0, 0.0, 1.0], jrt.GREY)]),
        jrt.Lights.build([[0.0, 2.0, 6.0]]),
        jrt.Materials.build(ambient=0.3, lambert=0.6))
    init = dataclasses.replace(target, spheres=dataclasses.replace(
        target.spheres, center=target.spheres.center + jnp.asarray([[0.0, 0.9, 0.4]])))
    return target, init


def test_fit_scene_soft_matches_jax_fit():
    """32x32, one sphere, taus (0.15, 0.05), 40 steps at lr 5e-2 on the
    centers. Each stage starts a new Adam, so the JAX fit runs stage by stage
    and the port runs each stage from the JAX scene that starts it: the first
    losses agree at rel 1e-5. Stage 2 starts near the optimum, where the
    residual is ~1% of the image, so float32 rounding of the render (~1e-5 of
    color) moves its MSE: on these inputs the port's float32 step-0 loss reads
    1.6e-5 relative off the port's float64 loss and the JAX loss 8e-7 off it
    (printed by this test). So stage 2 holds the port's float64 loss to the
    JAX loss at rel 1e-5 and the port's float32 loss at rel 1e-4. The port's
    own two-stage fit and the JAX fit both end below 0.35x the initial max
    center error."""
    target_j, init_j = _one_sphere_jax()
    cam_j = jrt.default_camera((32, 32))
    kw = dict(steps=20, lr=5e-2, trainable=("spheres.center",))
    cam, target = to_torch(cam_j, target_j)
    start_j = init_j
    for tau in (0.15, 0.05):
        end_j, losses_j = jtrain.fit_scene_soft(start_j, cam_j, target_j, taus=(tau,),
                                                backend="jnp", **kw)
        _, start = to_torch(cam_j, start_j)
        _, losses = train.fit_scene_soft(start, cam, target, taus=(tau,), backend="torch",
                                         **kw)
        assert len(losses) == len(losses_j) == 20
        cam64, start64 = soft_cuda.as_double(cam, start)
        loss64 = float(torch.mean((trt.render_image_soft(cam64, start64, tau=tau) -
                                   trt.render_image_soft(*soft_cuda.as_double(cam, target),
                                                         tau=tau)) ** 2))
        print(f"tau={tau}: step-0 loss port f32 {losses[0]!r}, port f64 {loss64!r}, "
              f"JAX {losses_j[0]!r}; rel f32-f64 {losses[0] / loss64 - 1:.3e}, "
              f"JAX-f64 {losses_j[0] / loss64 - 1:.3e}")
        assert loss64 == pytest.approx(losses_j[0], rel=1e-5)
        assert losses[0] == pytest.approx(losses_j[0], rel=1e-5 if tau == 0.15 else 1e-4)
        start_j = end_j
    fitted_j = end_j
    _, init = to_torch(cam_j, init_j)
    logger = MetricsLogger("fit", echo=False)
    fitted, losses = train.fit_scene_soft(init, cam, target, backend="torch", logger=logger,
                                          taus=(0.15, 0.05), **dict(kw, steps=40))
    assert len(losses) == 40
    assert [(r["step"], r["tau"]) for r in logger.history] == [(20, 0.15), (40, 0.05)]
    assert [r["first_loss"] for r in logger.history] == [losses[0], losses[20]]
    want = np.asarray(target_j.spheres.center)
    err0 = np.abs(np.asarray(init_j.spheres.center) - want).max()
    for got in (fitted.spheres.center.numpy(), np.asarray(fitted_j.spheres.center)):
        assert np.abs(got - want).max() < 0.35 * err0
    torch.testing.assert_close(fitted.spheres.radius, init.spheres.radius, rtol=0, atol=0)


def test_fit_scene_soft_cuda_backend_on_cpu_matches_torch(monkeypatch):
    """backend="cuda" with its launches standing in for the card
    (tests/torch_plain_launch.py) runs the fused step's and the targets'
    plain versions (no launch, counted) and gives the torch backend's losses;
    without a card it raises, and on CPU tensors it raises ValueError."""
    target_j, init_j = _one_sphere_jax()
    cam, init = to_torch(jrt.default_camera((16, 12)), init_j)
    _, target = to_torch(jrt.default_camera((16, 12)), target_j)
    kw = dict(steps=6, lr=5e-2, taus=(0.15, 0.05))
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="needs a CUDA device"):
            train.fit_scene_soft(init, cam, target, backend="cuda", **kw)
    monkeypatch.setattr(train, "resolve_backend", lambda b: b)
    with pytest.raises(ValueError, match="CUDA tensors, got cpu"):
        train.fit_scene_soft(init, cam, target, backend="cuda", **kw)
    plain_launches(monkeypatch.setattr)
    sb.reset_launch_counts()
    soft_cuda.reset_launch_counts()
    _, losses_c = train.fit_scene_soft(init, cam, target, backend="cuda", **kw)
    assert sb.PLAIN_CALLS["soft_loss_and_grads"] == 6
    assert soft_cuda.PLAIN_CALLS["render_image_soft"] == 2
    assert sb.LAUNCHES == {"cot": 0, "fused": 0} and soft_cuda.LAUNCHES["soft_fwd"] == 0
    _, losses_t = train.fit_scene_soft(init, cam, target, backend="torch", **kw)
    np.testing.assert_allclose(losses_c, losses_t, rtol=1e-5)
    with pytest.raises(ValueError, match="unknown backend"):
        train.fit_scene_soft(init, cam, target, steps=1, backend="jnp")


def test_fit_scene_soft_bounce_recovers_reflection(monkeypatch):
    """bounce_depth=1 (tests/test_soft.py::test_soft_fit_recovers_reflection_coefficient,
    smaller): the plain version on either backend, counted, recovers a
    perturbed reflection coefficient ("cuda" with its checks standing in for
    the card, tests/torch_plain_launch.py: no kernel runs on this path)."""
    plain_launches(monkeypatch.setattr)
    target_j = jrt.Scene(
        jrt.Spheres.build([([3.0, 0.0, 1.0], 1.0, jrt.RED), ([2.0, -1.5, 0.6], 0.6, jrt.BLUE)]),
        jrt.Planes.build([([0.0, 0.0, -0.5], [0.0, 0.0, 1.0], jrt.GREY)]),
        jrt.Lights.build([[0.0, 2.0, 6.0]]),
        jrt.Materials.build(ambient=0.3, lambert=0.5, reflection=0.4))
    cam, target = to_torch(jrt.default_camera((20, 20)), target_j)
    init = trt.Scene.from_leaves(target.leaves())
    init.materials = dataclasses.replace(target.materials, reflection=torch.tensor(0.05))
    soft_cuda.reset_launch_counts()
    fitted, _ = train.fit_scene_soft(init, cam, target, steps=30, lr=2e-2, taus=(0.05,),
                                     trainable=("materials.reflection",),
                                     backend="cuda", bounce_depth=1)
    assert soft_cuda.PLAIN_CALLS["render_image_soft"] == 31
    assert abs(float(fitted.materials.reflection) - 0.4) < 0.25 * 0.35


def _first_losses(monkeypatch, module):
    """Record the losses that ``module.fit_scene_soft`` returns."""
    seen = []
    real = module.fit_scene_soft

    def spy(*args, **kwargs):
        out = real(*args, **kwargs)
        seen.append(out[1])
        return out
    monkeypatch.setattr(module, "fit_scene_soft", spy)
    return seen


def test_cli_fit_soft_matches_jax_cli(tmp_path, capsys, monkeypatch):
    """``fit --mode soft --backend torch`` at 16x16 for 6 steps: the JAX CLI's
    summary line, a PNG, and the first loss of ``python_ray_tracer_tpu.cli fit
    --mode soft --backend jnp`` (rel 1e-5)."""
    from python_ray_tracer_tpu import cli as jcli
    args = ["fit", "--mode", "soft", "--width", "16", "--height", "16", "--steps", "6"]
    seen_j = _first_losses(monkeypatch, jtrain)
    assert jcli.main(args + ["--backend", "jnp", "--out", ""]) == 0
    capsys.readouterr()
    seen = _first_losses(monkeypatch, train)
    out = tmp_path / "fit.png"
    assert cli.main(args + ["--backend", "torch", "--out", str(out)]) == 0
    printed = capsys.readouterr().out
    line = next(ln for ln in printed.splitlines() if ln.startswith("loss: "))
    assert "center err: 0.200 -> median" in line, printed
    assert [ln.split(":")[1].split()[0] for ln in printed.splitlines()
            if ln.startswith("[fit] step")] == ["tau=0.15", "tau=0.05", "tau=0.02"]
    assert len(seen[0]) == len(seen_j[0]) == 6
    assert seen[0][0] == pytest.approx(seen_j[0][0], rel=1e-5)
    assert np.asarray(Image.open(out).convert("RGB")).shape == (16, 16, 3)


def test_cli_fit_default_mode_is_soft(monkeypatch, tmp_path):
    calls = _first_losses(monkeypatch, train)
    assert cli.main(["fit", "--backend", "torch", "--width", "12", "--height", "12",
                     "--steps", "3", "--out", str(tmp_path / "f.png")]) == 0
    assert len(calls) == 1 and len(calls[0]) == 3


def test_cli_fit_soft_bounce_depth_1(tmp_path, capsys):
    assert cli.main(["fit", "--backend", "torch", "--bounce-depth", "1", "--width", "12",
                     "--height", "12", "--steps", "3", "--out", ""]) == 0
    assert "center err: 0.200 -> median" in capsys.readouterr().out


def test_cli_render_soft_matches_jax_cli(tmp_path, capsys):
    """``render --soft 0.05 --backend torch`` at 24x24: the JAX CLI's ``--backend
    jnp`` PNG within 1 level."""
    from python_ray_tracer_tpu import cli as jcli
    args = ["render", "--soft", "0.05", "--width", "24", "--height", "24"]
    assert jcli.main(args + ["--backend", "jnp", "--out", str(tmp_path / "j.png")]) == 0
    assert cli.main(args + ["--backend", "torch", "--out", str(tmp_path / "t.png")]) == 0
    assert "soft tau=0.05" in capsys.readouterr().out
    got, want = (np.asarray(Image.open(tmp_path / f).convert("RGB")).astype(np.int32)
                 for f in ("t.png", "j.png"))
    assert got.shape == want.shape == (24, 24, 3)
    assert np.abs(got - want).max() <= 1


def test_cli_random_scene_spheres(tmp_path, capsys):
    """``--spheres N`` renders the N-sphere scene of ``jax.random.key(0)``,
    the same scene on every call."""
    args = ["render", "--backend", "torch", "--spheres", "12", "--no-aliasing", "--depth",
            "1", "--width", "16", "--height", "12"]
    for name in ("a.png", "b.png"):
        assert cli.main(args + ["--out", str(tmp_path / name)]) == 0
    a, b = (np.asarray(Image.open(tmp_path / n)) for n in ("a.png", "b.png"))
    np.testing.assert_array_equal(a, b)
    scene = cli._build(cli.main.__globals__["argparse"].Namespace(
        width=8, height=8, ambient=0.0, lambert=0.6, reflection=0.3, depth=1,
        no_aliasing=True, fov=45.0, clean=False, backend="torch", spheres=12))[1]
    assert scene.spheres.count == 12 and scene.device.type == "cpu"
