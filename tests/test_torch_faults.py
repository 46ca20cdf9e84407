"""Checkpoints, fault recovery and profiling of the port, on the CPU, against
the JAX package (python_ray_tracer_tpu/utils/{checkpoint,faults,profiling}.py).

Mirrors tests/test_faults.py and tests/test_train.py's checkpoint tests with
``backend="torch"`` (autograd of the plain renderer). Losses are held to the
JAX package's run with the same injector within rel 1e-5: both fits are
float32 Adam on the same pixel loss, whose two renderers round apart in the
last bits. A checkpoint crosses the packages in both directions: the same
npz keys (``jax.tree_util.keystr`` paths), and a fit resumed from the other
package's file continues with that package's continuation's losses (rel
1e-5).
"""
import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import python_ray_tracer_tpu as jrt
import python_ray_tracer_tpu_torch as trt
from python_ray_tracer_tpu import train as jtrain
from python_ray_tracer_tpu.utils import faults as jfaults
from python_ray_tracer_tpu_torch import train
from python_ray_tracer_tpu_torch.utils import checkpoint, faults, profiling

from .test_torch_render import to_torch

torch.set_num_threads(1)
RES = (16, 16)
POSE = ([-2.0, 0.0, 2.0], [0.0, -30.0, 0.0])
SHIFT = (0.05, -0.04, 0.03)   # the fit's start: the target's centers shifted
LR = 1e-2
REL = 1e-5


def _jax_fit():
    """The JAX package's step of tests/test_faults.py, from shifted centers."""
    cam = jrt.Camera.build(RES, *POSE)
    scene = jrt.default_scene()
    target = jrt.render_image(cam, scene, depth=0, aliasing=False)
    loss_fn = jtrain.pixel_loss(cam, target, depth=0)
    opt = optax.adam(LR)
    step = jtrain.make_train_step(loss_fn, opt, trainable=("spheres.center",))
    init = dataclasses.replace(scene, spheres=dataclasses.replace(
        scene.spheres, center=scene.spheres.center + jnp.asarray(SHIFT)))
    return init, opt, step


def _torch_step(init=None):
    """The port's step on the same camera, scene and target."""
    cam_j = jrt.Camera.build(RES, *POSE)
    cam, scene = to_torch(cam_j, jrt.default_scene())
    target = trt.render_image(cam, scene, depth=0, aliasing=False)
    if init is None:
        init = trt.Scene.from_leaves([t.clone() for t in scene.leaves()])
        init.spheres.center += torch.tensor(SHIFT)
    vg = train.autograd_value_and_grad(train.pixel_loss(cam, target, depth=0))
    return train.make_train_step(init, vg, lr=LR, trainable=("spheres.center",))


def _close(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    assert a.shape == b.shape and np.all(np.abs(a - b) <= REL * np.abs(b)), (a, b)


def test_device_healthcheck():
    """The CPU when it is asked for; the default probes the card, and raises
    without one."""
    assert faults.device_healthcheck(["cpu"]) == {"cpu": True}
    if torch.cuda.is_available():
        assert all(faults.device_healthcheck().values())
    else:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            faults.device_healthcheck()


def test_make_train_step_exposes_its_state():
    step = _torch_step()
    assert step.trainable == ("spheres.center",)
    assert isinstance(step.optimizer, torch.optim.Adam)
    center = step.scene.spheres.center
    assert step.optimizer.param_groups[0]["params"][0] is center
    before = center.clone()
    step()
    assert not torch.equal(center, before)
    assert int(checkpoint.adam_state(step.optimizer, step.scene, step.trainable)[0].count) == 1


def test_resilient_fit_recovers_from_nan(tmp_path):
    step = _torch_step()
    _, _, losses, events = faults.resilient_fit(
        step, steps=8, ckpt_dir=str(tmp_path), ckpt_every=2,
        injector=faults.FaultInjector(fail_steps=[5], mode="nan"))
    assert len(losses) == 8 and all(np.isfinite(losses))
    assert len(events) == 1
    assert events[0].step == 5 and events[0].restored_step == 4
    assert "non-finite" in events[0].reason
    init, opt, jstep = _jax_fit()
    _, _, jlosses, jevents = jfaults.resilient_fit(
        jstep, init, opt.init(init), steps=8, ckpt_dir=str(tmp_path / "jax"), ckpt_every=2,
        injector=jfaults.FaultInjector(fail_steps=[5], mode="nan"))
    assert [(e.step, e.restored_step) for e in jevents] == [(5, 4)]
    assert losses[0] > 0.0
    _close(losses, jlosses)
    # an uninterrupted run's losses: the restart restored every bit
    plain = _torch_step()
    assert losses == [float(plain()) for _ in range(8)]


def test_resilient_fit_recovers_from_exception(tmp_path):
    step = _torch_step()
    _, _, losses, events = faults.resilient_fit(
        step, steps=6, ckpt_dir=str(tmp_path), ckpt_every=2,
        injector=faults.FaultInjector(fail_steps=[3], mode="exception"))
    assert len(losses) == 6
    assert len(events) == 1 and "InjectedFault" in events[0].reason
    init, opt, jstep = _jax_fit()
    _, _, jlosses, _ = jfaults.resilient_fit(
        jstep, init, opt.init(init), steps=6, ckpt_dir=str(tmp_path / "jax"), ckpt_every=2,
        injector=jfaults.FaultInjector(fail_steps=[3], mode="exception"))
    _close(losses, jlosses)


def test_resilient_fit_deterministic_failure_diagnosed(tmp_path):
    class AlwaysFail(faults.FaultInjector):
        def maybe_fail(self, step, loss):
            if step == 2:
                return float("nan")   # fires on every retry, not once
            return loss

    with pytest.raises(faults.UnrecoverableTraining, match="deterministic"):
        faults.resilient_fit(_torch_step(), steps=5, ckpt_dir=str(tmp_path), ckpt_every=1,
                             max_restarts=2, injector=AlwaysFail(fail_steps=[]))


def test_on_restart_hook_sees_event(tmp_path):
    seen = []

    def hook(s, o, ev):
        seen.append(ev)
        assert isinstance(o, torch.optim.Adam) and isinstance(s, trt.Scene)

    faults.resilient_fit(_torch_step(), steps=4, ckpt_dir=str(tmp_path), ckpt_every=1,
                         injector=faults.FaultInjector(fail_steps=[1]), on_restart=hook)
    assert len(seen) == 1 and seen[0].step == 1


# --- checkpoints (tests/test_train.py's) ------------------------------------------

def _two_sphere_scene(offset=0.0):
    return trt.Scene(trt.Spheres.build([([2.5 + offset, 0.5, 1.0], 0.8, trt.RED),
                                        ([1.5, -0.9 + offset, 0.5], 0.5, trt.BLUE)], device="cpu"),
                     trt.Planes.build([([5, 0, 0], [0, 0, 1], trt.GREY)], device="cpu"),
                     trt.Lights.build([[2.5, -2.0, 3.0], [2.5, 2.0, 3.0]], device="cpu"),
                     trt.Materials.build(device="cpu"))


def test_checkpoint_roundtrip(tmp_path):
    scene = _two_sphere_scene()
    path = os.path.join(tmp_path, "scene.npz")
    trt.save_pytree(path, scene)
    loaded = trt.load_pytree(path, trt.Scene.from_soa(*scene.to_soa(), device="cpu"))
    assert isinstance(loaded, trt.Scene)
    for a, b in zip(loaded.leaves(), scene.leaves()):
        assert torch.equal(a, b)


def test_checkpoint_path_mismatch_raises(tmp_path):
    scene = _two_sphere_scene()
    path = os.path.join(tmp_path, "scene.npz")
    trt.save_pytree(path, scene)
    with pytest.raises(ValueError, match="leaf-path mismatch"):
        trt.load_pytree(path, {"a": np.zeros(3), "b": np.zeros(3)})
    keys = np.load(path).files
    assert not any(k.startswith("leaf_") for k in keys), keys
    assert ".spheres.center" in keys and ".materials.shininess" in keys, keys


def test_checkpoint_legacy_positional_rejected(tmp_path):
    path = os.path.join(tmp_path, "old.npz")
    np.savez(path, leaf_0=np.zeros(3), leaf_1=np.ones(3))
    with pytest.raises(ValueError, match="legacy positional"):
        trt.load_pytree(path, {"x": np.zeros(3), "y": np.zeros(3)})
    big = os.path.join(tmp_path, "old_big.npz")
    np.savez(big, **{f"leaf_{i}": np.zeros(2) for i in range(12)})
    with pytest.raises(ValueError, match="legacy positional"):
        trt.load_pytree(big, {f"k{i}": np.zeros(2) for i in range(12)})


def test_checkpoint_resume_training(tmp_path):
    """Save mid-optimization, reload, and continue: the loss keeps falling."""
    cam = trt.default_camera(RES, device="cpu")
    target = trt.render_image(cam, _two_sphere_scene(), depth=1, aliasing=False)
    init = _two_sphere_scene(offset=0.25)
    mid, losses1 = train.fit_scene(init, cam, target, steps=10, lr=2e-2, depth=1,
                                   backend="torch")
    path = os.path.join(tmp_path, "mid.npz")
    trt.save_pytree(path, mid)
    resumed = trt.load_pytree(path, init)
    _, losses2 = train.fit_scene(resumed, cam, target, steps=10, lr=2e-2, depth=1,
                                 backend="torch")
    assert losses2[-1] < losses1[0]


def test_checkpoint_keys_are_the_jax_packages():
    """A fit's checkpoint tree has the JAX package's keys, dtypes and shapes,
    ``jax.tree_util.keystr`` for ``{"scene", "opt": optax.adam's state,
    "step"}``; nested lists, tuples and a lone leaf too."""
    step = _torch_step()
    step()
    tree = faults._fit_tree(step, 1)
    init, opt, _ = _jax_fit()
    jtree = {"scene": init, "opt": opt.init(init), "step": jnp.asarray(1, jnp.int32)}
    ours = {k: checkpoint._numpy(x) for k, x in checkpoint._flatten(tree)}
    theirs = {jax.tree_util.keystr(p): np.asarray(x)
              for p, x in jax.tree_util.tree_flatten_with_path(jtree)[0]}
    assert ours.keys() == theirs.keys()
    for k in ours:
        assert ours[k].dtype == theirs[k].dtype and ours[k].shape == theirs[k].shape, k
    nested = {"b": [np.zeros(2), (np.ones(1), {"c": np.zeros(())})], "a": np.ones(3)}
    assert [k for k, _ in checkpoint._flatten(nested)] == [
        jax.tree_util.keystr(p) for p, _ in jax.tree_util.tree_flatten_with_path(nested)[0]]
    assert [k for k, _ in checkpoint._flatten(np.zeros(2))] == ["<root>"]


def test_scene_checkpoint_crosses_the_packages(tmp_path):
    scene_j = jrt.random_scene(jax.random.key(3), n_spheres=5)
    _, scene = to_torch(jrt.default_camera(RES), scene_j)
    jpath, tpath = str(tmp_path / "j.npz"), str(tmp_path / "t.npz")
    jrt.save_pytree(jpath, scene_j)
    got = trt.load_pytree(jpath, scene)
    for a, b in zip(got.leaves(), scene.leaves()):
        assert torch.equal(a, b)
    trt.save_pytree(tpath, scene)
    back = jrt.load_pytree(tpath, scene_j)
    for a, b in zip(jax.tree_util.tree_leaves(back), jax.tree_util.tree_leaves(scene_j)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_fit_checkpoint_crosses_the_packages(tmp_path):
    """A JAX ``resilient_fit`` file (6 steps, a checkpoint every 3) resumed by
    the port continues with the JAX continuation's losses, and the port's
    file resumed by the JAX package with the port's continuation's (rel
    1e-5 each)."""
    init, opt, jstep = _jax_fit()
    jdir = str(tmp_path / "jax")
    scene_j, state_j, _, _ = jfaults.resilient_fit(jstep, init, opt.init(init), steps=6,
                                                   ckpt_dir=jdir, ckpt_every=3)
    jcont = []
    for _ in range(4):
        scene_j, state_j, loss = jstep(scene_j, state_j)
        jcont.append(float(loss))
    step = _torch_step()
    assert faults.load_fit_state(os.path.join(jdir, "resilient.npz"), step) == 6
    assert int(checkpoint.adam_state(step.optimizer, step.scene, step.trainable)[0].count) == 6
    _close([float(step()) for _ in range(4)], jcont)

    step = _torch_step()
    tdir = str(tmp_path / "torch")
    faults.resilient_fit(step, steps=6, ckpt_dir=tdir, ckpt_every=3)
    tcont = [float(step()) for _ in range(4)]
    init, opt, jstep = _jax_fit()
    like = {"scene": init, "opt": opt.init(init), "step": jnp.asarray(0, jnp.int32)}
    saved = jrt.load_pytree(os.path.join(tdir, "resilient.npz"), like)
    assert int(saved["step"]) == 6 and int(saved["opt"][0].count) == 6
    scene_j, state_j = saved["scene"], saved["opt"]
    jcont = []
    for _ in range(4):
        scene_j, state_j, loss = jstep(scene_j, state_j)
        jcont.append(float(loss))
    _close(jcont, tcont)


# --- profiling --------------------------------------------------------------------

def test_capture_trace_on_the_cpu(tmp_path):
    cam = trt.default_camera(RES, device="cpu")
    scene = trt.default_scene(device="cpu")
    with profiling.capture_trace(str(tmp_path)) as prof:
        with profiling.annotate("rt:render"):
            trt.render_image(cam, scene, depth=0, aliasing=False)
    assert os.path.dirname(prof.trace_path) == str(tmp_path)
    with open(prof.trace_path) as f:
        text = f.read()
    assert "rt:render" in text
    assert any(e.key == "rt:render" for e in prof.key_averages())
    assert profiling.device_memory_stats(torch.device("cpu")) == {}
    if not torch.cuda.is_available():
        assert profiling.device_memory_stats() == {}
