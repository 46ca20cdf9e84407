"""Failure detection, fault injection and elastic resume for training loops.

PyTorch counterpart of ``python_ray_tracer_tpu/utils/faults.py``:

1. **Device health probe**: every CUDA device computes ``sum(x * arange(64))``
   for ``x`` of ones, whose answer (2016) is known; a device that raises or
   answers wrong is reported unhealthy before a long job starts on it.
2. **Non-finite-loss detection with elastic resume**: :func:`resilient_fit`
   checkpoints the scene and the Adam state every ``ckpt_every`` steps
   (``utils.checkpoint``, optax's layout, so the JAX package reads the file
   and the reverse) and, on a NaN or Inf loss or a raised error, restores the
   last good state in place and runs on, up to ``max_restarts`` failures of
   the same step. The backward kernels are deterministic, so a step that
   fails again in the same way will fail every time: the loop then says so
   instead of spinning.
3. **Deterministic fault injection** (:class:`FaultInjector`), so that 1 and
   2 are testable without real hardware faults.

What an in-process restart cannot recover from: a sticky CUDA error (an
illegal address, a device-side assert) poisons the process's CUDA context,
and every later call on it fails too. :func:`resilient_fit` then exhausts its
restarts on the same step and raises :class:`UnrecoverableTraining`; such a
fit resumes in a new process from the last checkpoint file.
"""
from __future__ import annotations

import dataclasses
import math
import os
from typing import Callable, List, Optional, Sequence, Tuple

import torch

from .checkpoint import adam_state, load_adam_state, load_pytree, save_pytree


class InjectedFault(RuntimeError):
    """Raised by :class:`FaultInjector` in ``mode="exception"``."""


class UnrecoverableTraining(RuntimeError):
    """Raised when elastic resume exhausts ``max_restarts`` at one step."""


def device_healthcheck(devices: Optional[Sequence] = None) -> dict:
    """Probe each device with a tiny computation whose answer is known.

    Returns ``{device_str: ok_bool}``: a device is healthy when it computes
    ``sum(ones(64) * arange(64)) == 2016``; an exception or a wrong answer
    marks it unhealthy. ``devices`` None probes every CUDA device and raises
    ``RuntimeError`` where there is none (the CPU is probed only when the
    caller names it, ``["cpu"]``)."""
    if devices is None:
        if not torch.cuda.is_available():
            raise RuntimeError("device_healthcheck: no CUDA device to probe "
                               "(torch.cuda.is_available() is False)")
        devices = [f"cuda:{i}" for i in range(torch.cuda.device_count())]
    status = {}
    for d in devices:
        dev = torch.device(d)
        try:
            x = torch.ones(64, dtype=torch.float32, device=dev)
            got = float(torch.sum(x * torch.arange(64, dtype=torch.float32, device=dev)))
            status[str(dev)] = got == 2016.0
        except RuntimeError:
            status[str(dev)] = False
    return status


@dataclasses.dataclass
class FaultInjector:
    """Deterministically corrupt chosen steps of a training loop.

    ``fail_steps`` are global step indices; each fires once (a restarted
    loop that runs the same step again does not fail again), as a transient
    hardware fault would. ``mode``: ``"nan"`` makes the step's loss NaN
    (silent corruption); ``"exception"`` raises :class:`InjectedFault`
    (a lost device)."""
    fail_steps: Sequence[int]
    mode: str = "nan"
    _fired: set = dataclasses.field(default_factory=set)

    def maybe_fail(self, step: int, loss: float) -> float:
        if step in self.fail_steps and step not in self._fired:
            self._fired.add(step)
            if self.mode == "exception":
                raise InjectedFault(f"injected device fault at step {step}")
            return float("nan")
        return loss


@dataclasses.dataclass
class RestartEvent:
    step: int            # the step that failed
    reason: str
    restored_step: int   # the last checkpointed step the loop resumed from


def _fit_tree(step_fn: Callable, step: int) -> dict:
    return {"scene": step_fn.scene,
            "opt": adam_state(step_fn.optimizer, step_fn.scene, step_fn.trainable),
            "step": torch.tensor(step, dtype=torch.int32)}


def save_fit_state(path: str, step_fn: Callable, step: int) -> None:
    """Checkpoint a fit (``train.make_train_step``'s step) after ``step``
    steps: ``{"scene", "opt", "step"}``, the tree the JAX package's
    ``resilient_fit`` writes (the Adam state in optax's layout)."""
    save_pytree(path, _fit_tree(step_fn, step))


def load_fit_state(path: str, step_fn: Callable) -> int:
    """Restore a fit from :func:`save_fit_state`'s file (or the JAX package's
    ``resilient_fit``'s) into ``step_fn``'s scene and optimizer, in place;
    returns the step it was saved at."""
    saved = load_pytree(path, _fit_tree(step_fn, 0))
    with torch.no_grad():
        for leaf, value in zip(step_fn.scene.leaves(), saved["scene"].leaves()):
            leaf.copy_(value)
    load_adam_state(step_fn.optimizer, saved["opt"], step_fn.trainable)
    return int(saved["step"])


def resilient_fit(step_fn: Callable, *, steps: int, ckpt_dir: str, ckpt_every: int = 20,
                  max_restarts: int = 3, injector: Optional[FaultInjector] = None,
                  on_restart: Optional[Callable] = None,
                  ) -> Tuple[object, object, List[float], List[RestartEvent]]:
    """Run ``step_fn() -> loss`` (``train.make_train_step``'s step, which
    updates ``step_fn.scene`` in place with ``step_fn.optimizer``) for
    ``steps`` steps with checkpointed elastic resume.

    The scene and the Adam state (:func:`save_fit_state`) go to
    ``ckpt_dir/resilient.npz`` before the first step and after every
    ``ckpt_every`` steps. On a non-finite loss, an :class:`InjectedFault` or a
    ``RuntimeError`` the loop restores both from the file in place and runs
    again from the step saved there; after ``max_restarts`` failures at the
    same step it raises :class:`UnrecoverableTraining` (the failure is
    deterministic: restarts cannot help). ``on_restart(scene, optimizer,
    event)`` runs after each restore and may change both in place (a lower
    learning rate in ``optimizer.param_groups``, say).

    Returns ``(scene, optimizer, losses, restart_events)``; ``losses`` has
    one entry per successful step.
    """
    scene, opt = step_fn.scene, step_fn.optimizer
    os.makedirs(ckpt_dir, exist_ok=True)
    path = os.path.join(ckpt_dir, "resilient.npz")
    save_fit_state(path, step_fn, 0)
    losses: List[float] = []
    events: List[RestartEvent] = []
    i = 0
    while i < steps:
        try:
            loss = float(step_fn())
            if injector is not None:
                loss = injector.maybe_fail(i, loss)
            if not math.isfinite(loss):
                raise FloatingPointError(f"non-finite loss at step {i}: {loss}")
        except (FloatingPointError, InjectedFault, RuntimeError) as e:
            same_step_failures = sum(1 for ev in events if ev.step == i)
            if same_step_failures + 1 > max_restarts:
                raise UnrecoverableTraining(
                    f"step {i} failed {same_step_failures + 1}x (deterministic failure, "
                    f"restarts cannot help): {e}") from e
            restored = load_fit_state(path, step_fn)
            ev = RestartEvent(step=i, reason=f"{type(e).__name__}: {e}",
                              restored_step=restored)
            events.append(ev)
            del losses[restored:]
            i = restored
            if on_restart is not None:
                on_restart(scene, opt, ev)
            continue
        losses.append(loss)
        i += 1
        if i % ckpt_every == 0:
            save_fit_state(path, step_fn, i)
    return scene, opt, losses, events
