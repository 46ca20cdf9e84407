"""A run of each cell, the look for a card skipped (the port's plain path on
the CPU, at a small size), and again with the timed path broken underneath:
a sound run is correct, and each fault the cell can have makes it not
correct. One card, so no cell has an exchange between cards to leave out."""
import time

import pytest
import torch

from python_ray_tracer_tpu_torch import animation, train
from python_ray_tracer_tpu_torch.ops.soft import render_image_soft
from port_bench import harness

SMALL = {"demo.render_pan": {"width": 40, "height": 28, "batch": 4, "warmup_batches": 1},
         "spheres1000.render_pan": {"width": 24, "height": 16, "batch": 2,
                                    "warmup_batches": 1},
         "demo.fit_soft": {"width": 24, "height": 24, "steps": 9}}
# the window's checked steps among its first two fits, so that a slow CPU run reaches them
CELL = {"demo.fit_soft": {"sampled_fits": 2}}


def run(cell, seed=2 ** 31 + 7):
    return harness.run_cell(cell, seed, 1.0, False, t_start=time.perf_counter(),
                            backend="torch", overrides=SMALL[cell],
                            cell_overrides=CELL.get(cell))


def _frames_fault(monkeypatch, alter):
    orig = animation.render_frames

    def broken(*a, **k):
        return alter(orig(*a, **k))
    monkeypatch.setattr(animation, "render_frames", broken)


def _neighbour(frames):      # an answer altered where it is made: a frame is its neighbour's
    frames[1] = frames[0]
    return frames


def _half(frames):           # half of the batch left out
    frames[frames.shape[0] // 2:] = 0.0
    return frames


def _unchanged(monkeypatch):  # a step that returns its state unchanged
    orig = train.make_train_step

    def broken(scene, vg, *, lr, trainable=None):
        step = orig(scene, vg, lr=lr, trainable=trainable)

        def s():
            return vg(scene)[0]
        s.scene, s.optimizer, s.trainable = step.scene, step.optimizer, step.trainable
        return s
    monkeypatch.setattr(train, "make_train_step", broken)


def _half_loss(monkeypatch):  # half of the image left out of the loss, the mean over the rest
    def broken(camera, target, *, tau, backend="cuda", bounce_depth=0):
        h = camera.resolution[0] // 2

        def loss(scene):
            return torch.mean((render_image_soft(camera, scene, tau=tau)[:h] - target[:h]) ** 2)
        return train.autograd_value_and_grad(loss)
    monkeypatch.setattr(train, "soft_value_and_grad", broken)


def _first_tau(monkeypatch):  # every stage's step at the first stage's tau
    orig = train.soft_value_and_grad

    def broken(camera, target, *, tau, **k):
        return orig(camera, target, tau=0.15, **k)
    monkeypatch.setattr(train, "soft_value_and_grad", broken)


@pytest.mark.parametrize("cell", sorted(SMALL))
def test_sound_run_is_correct(cell):
    out = run(cell)
    assert out["correct"], out["checks"]
    assert list(out)[-1] == "checks" and out["attempted"] > 0


@pytest.mark.parametrize("cell", ["demo.render_pan", "spheres1000.render_pan"])
@pytest.mark.parametrize("fault", [_neighbour, _half])
def test_render_faults_are_not_correct(monkeypatch, cell, fault):
    _frames_fault(monkeypatch, fault)
    assert not run(cell)["correct"]


@pytest.mark.parametrize("fault", [_unchanged, _half_loss, _first_tau])
def test_fit_faults_are_not_correct(monkeypatch, fault):
    fault(monkeypatch)
    out = run("demo.fit_soft")
    assert not out["correct"], out["checks"]
    if fault is _first_tau:      # only the window's later stages can show it
        assert all(out["checks"][k]["value"] <= out["checks"][k]["limit"]
                   for k in ("loss_gap", "grad_gap", "change_gap")), out["checks"]
