"""The port's training path (python_ray_tracer_tpu_torch/train.py) on the CPU,
against the JAX package's train.fit_scene / fit_camera on the same seeded
inputs.

Fits are held to the same first loss (rel 1e-5: the same renderer on the same
inputs) and the same convergence, not to equal trajectories: torch and optax
Adam round their updates differently. With ``backend="cuda"`` on CPU tensors
the kernel wrappers take their plain versions (the device contract of
render_image_cuda), so the kernel path's host logic runs here too.
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import python_ray_tracer_tpu as jrt
from python_ray_tracer_tpu import train as jtrain
import python_ray_tracer_tpu_torch as trt
from python_ray_tracer_tpu_torch import train
from python_ray_tracer_tpu_torch.utils.config import BACKENDS
from python_ray_tracer_tpu_torch.utils.metrics import MetricsLogger

from .test_torch_grads import two_sphere_scene_jax
from .test_torch_render import to_torch
from .torch_plain_launch import plain_launches

torch.set_num_threads(1)


def _fit_inputs(res=(16, 16), depth=1, shift=0.1):
    scene_j = two_sphere_scene_jax()
    cam_j = jrt.default_camera(res)
    target_j = jrt.render_image(cam_j, scene_j, depth=depth, aliasing=False)
    init_j = dataclasses.replace(scene_j, spheres=dataclasses.replace(
        scene_j.spheres, center=scene_j.spheres.center + shift))
    cam, init = to_torch(cam_j, init_j)
    return scene_j, cam_j, target_j, init_j, cam, init, torch.from_numpy(np.array(target_j))


def test_fit_scene_torch_matches_jax_fit():
    """2-sphere scene 16x16, depth 1, 15 Adam steps at lr 5e-3 on the sphere
    centers (tests/test_pallas_bwd.py's fit): same first loss, both converge."""
    _, cam_j, target_j, init_j, cam, init, target = _fit_inputs()
    _, losses_j = jtrain.fit_scene(init_j, cam_j, target_j, steps=15, lr=5e-3, depth=1,
                                   trainable=("spheres.center",), backend="jnp")
    logger = MetricsLogger("fit", echo=False)
    fitted, losses = train.fit_scene(init, cam, target, steps=15, lr=5e-3, depth=1,
                                     trainable=("spheres.center",), backend="torch",
                                     logger=logger, log_every=5)
    assert losses[0] == pytest.approx(losses_j[0], rel=1e-5)
    assert losses[-1] < 0.75 * losses[0] and losses_j[-1] < 0.75 * losses_j[0]
    assert [r["step"] for r in logger.history] == [0, 5, 10, 14]
    # only the trainable leaf moved, and the initial scene is untouched
    torch.testing.assert_close(fitted.spheres.radius, init.spheres.radius, rtol=0, atol=0)
    np.testing.assert_array_equal(init.spheres.center.numpy(),
                                  np.asarray(init_j.spheres.center))
    assert not torch.equal(fitted.spheres.center, init.spheres.center)


def test_fit_scene_cuda_backend_fused_and_unfused_agree(monkeypatch):
    """backend="cuda", fused=True (the one-launch step) and fused=False (render
    + cotangent backward) give the same losses; with the launches standing in
    for the card (tests/torch_plain_launch.py) both run the plain versions
    and launch nothing. Without a card the backend raises, and on a card it
    refuses CPU tensors."""
    from python_ray_tracer_tpu_torch.ops.cuda import render_bwd_cuda as rb
    *_, cam, init, target = _fit_inputs(res=(12, 10))
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="needs a CUDA device"):
            train.fit_scene(init, cam, target, steps=1, backend="cuda")
    monkeypatch.setattr(train, "resolve_backend", lambda b: b)
    with pytest.raises(ValueError, match="fit_scene.backend='cuda'. takes CUDA tensors"):
        train.fit_scene(init, cam, target, steps=1, backend="cuda")
    plain_launches(monkeypatch.setattr)
    before = dict(rb.LAUNCHES)
    runs = [train.fit_scene(init, cam, target, steps=4, lr=5e-3, depth=1,
                            trainable=("spheres.center",), backend="cuda", fused=fused)
            for fused in (True, False)]
    assert rb.LAUNCHES == before
    np.testing.assert_allclose(runs[0][1], runs[1][1], rtol=1e-5)
    torch.testing.assert_close(runs[0][0].spheres.center, runs[1][0].spheres.center,
                               rtol=1e-5, atol=1e-6)


def test_trainable_selects_leaves():
    assert train.trainable_paths(("spheres",)) == ["spheres.center", "spheres.radius",
                                                   "spheres.albedo"]
    assert train.trainable_paths(("spheres.center", "lights")) == ["spheres.center",
                                                                   "lights.position"]
    assert len(train.trainable_paths(None)) == 12
    with pytest.raises(ValueError, match="unknown trainable"):
        train.trainable_paths(("spheres.colour",))
    with pytest.raises(ValueError, match="unknown backend"):
        train.fit_scene(trt.default_scene(device="cpu"), trt.default_camera((4, 4), device="cpu"),
                        torch.zeros(4, 4, 3), steps=1, backend="pallas")


def test_trainable_mask_freezes_fields():
    """tests/test_train.py::test_trainable_mask_freezes_fields on the port."""
    *_, cam, scene, target = _fit_inputs(shift=0.0)
    fitted, _ = train.fit_scene(scene, cam, target * 0.5, steps=5, lr=5e-2,
                                trainable=("spheres",), depth=1, backend="torch")
    torch.testing.assert_close(fitted.lights.position, scene.lights.position, rtol=0,
                               atol=0)
    torch.testing.assert_close(fitted.materials.lambert, scene.materials.lambert,
                               rtol=0, atol=0)
    assert not torch.equal(fitted.spheres.center, scene.spheres.center)


def test_fit_camera_matches_jax_fit():
    """tests/test_train.py::test_fit_camera_recovers_pose on both packages:
    same first loss, both contract the pose error, rotation stays on SO(3),
    fov frozen."""
    scene_j = two_sphere_scene_jax()
    true_j = jrt.Camera.build((24, 24), [-2.0, 0.0, 2.0], [0.0, -30.0, 0.0])
    target_j = jrt.render_image(true_j, scene_j, depth=1, aliasing=False)
    init_j = jrt.Camera.build((24, 24), [-2.1, 0.08, 1.92], [1.5, -27.5, 2.0])
    fitted_j, losses_j = jtrain.fit_camera(init_j, scene_j, target_j, steps=150, depth=1)
    init, scene = to_torch(init_j, scene_j)
    fitted, losses = train.fit_camera(init, scene, torch.from_numpy(np.array(target_j)),
                                      steps=150, depth=1, backend="torch")
    assert losses[0] == pytest.approx(losses_j[0], rel=1e-5)
    true_pos = np.asarray(true_j.position)
    for fit, ls in ((np.asarray(fitted.position), losses),
                    (np.asarray(fitted_j.position), losses_j)):
        assert ls[-1] < 0.35 * ls[0]
        assert np.abs(fit - true_pos).max() < 0.75 * np.abs(np.asarray(init_j.position)
                                                           - true_pos).max()
    R = fitted.rotation.numpy()
    np.testing.assert_allclose(R @ R.T, np.eye(3), atol=1e-5)
    assert float(fitted.fov) == pytest.approx(float(init.fov))


def test_fit_camera_fit_fov_matches_jax_fit():
    """fit_camera(fit_fov=True) on both packages at 32x32, pose and fov both
    off: the same loss at each of the first 6 steps (rel 1e-5) and the same
    fov after them (1e-5). Later steps part: past the loss minimum (step 2) the
    two Adams' rounding moves the cameras ~1e-5 apart, and silhouette pixels
    of the hard render flip (each package's loss agrees with the other's at the
    same camera)."""
    scene_j = two_sphere_scene_jax()
    true_j = jrt.Camera.build((32, 32), [-2.0, 0.0, 2.0], [0.0, -30.0, 0.0])
    target_j = jrt.render_image(true_j, scene_j, depth=1, aliasing=False)
    init_j = jrt.Camera.build((32, 32), [-2.1, 0.08, 1.92], [1.5, -27.5, 2.0], fov=48.0)
    fitted_j, losses_j = jtrain.fit_camera(init_j, scene_j, target_j, steps=6, depth=1,
                                           fit_fov=True)
    init, scene = to_torch(init_j, scene_j)
    fitted, losses = train.fit_camera(init, scene, torch.from_numpy(np.array(target_j)),
                                      steps=6, depth=1, fit_fov=True, backend="torch")
    np.testing.assert_allclose(np.asarray(losses), np.asarray(losses_j), rtol=1e-5, atol=0)
    assert float(fitted.fov) == pytest.approx(float(fitted_j.fov), abs=1e-5)
    assert abs(float(fitted.fov) - 48.0) > 1e-3      # the fov did move


def test_camera_value_and_grad_cuda_backend_matches_autograd(monkeypatch):
    """The kernel path's camera gradient (camera slots chained to Euler angles
    through autograd of euler_rotation; its launch standing in for the card,
    tests/torch_plain_launch.py) equals autograd of the whole loss, and the
    JAX package's jnp camera gradient."""
    plain_launches(monkeypatch.setattr)
    import jax
    from python_ray_tracer_tpu.models.camera import Camera as JCamera, euler_rotation
    scene_j = two_sphere_scene_jax()
    res = (24, 24)
    target_j = jrt.render_image(jrt.Camera.build(res, [-2.0, 0.0, 2.0], [0.0, -30.0, 0.0]),
                                scene_j, depth=1, aliasing=False)
    p_j = {"position": jnp.asarray([-2.1, 0.08, 1.92], jnp.float32),
           "euler": jnp.deg2rad(jnp.asarray([1.5, -27.5, 2.0], jnp.float32)),
           "fov": jnp.float32(45.0)}

    def loss_j(p):
        cam = JCamera(p["position"], euler_rotation(*p["euler"], is_radians=True),
                      p["fov"], res)
        return jnp.mean((jrt.render_image(cam, scene_j, depth=1, aliasing=False)
                         - target_j) ** 2)
    l_j, g_j = jax.value_and_grad(loss_j)(p_j)
    _, scene = to_torch(jrt.default_camera(res), scene_j)
    target = torch.from_numpy(np.array(target_j))
    p = {k: torch.from_numpy(np.array(v)) for k, v in p_j.items()}
    out = {b: train.camera_value_and_grad(scene, target, res, depth=1, backend=b)(p)
           for b in BACKENDS}
    for loss, grads in out.values():
        assert float(loss) == pytest.approx(float(l_j), rel=1e-5)
        for k in train.CAMERA_KEYS:
            np.testing.assert_allclose(grads[k].numpy(), np.asarray(g_j[k]), rtol=5e-3,
                                       atol=5e-5, err_msg=k)
    for k in train.CAMERA_KEYS:
        torch.testing.assert_close(out["cuda"][1][k], out["torch"][1][k], rtol=1e-4,
                                   atol=1e-7)


def test_entry_points_default_to_the_cuda_backend():
    """The library never picks the CPU: every training entry point that takes a
    backend defaults to the kernels (tests ask for "torch" explicitly)."""
    import inspect
    for fn in (train.fit_scene, train.fit_scene_soft, train.fit_camera,
               train.soft_pixel_loss, train.soft_value_and_grad,
               train.camera_value_and_grad):
        assert inspect.signature(fn).parameters["backend"].default == "cuda", fn.__name__
