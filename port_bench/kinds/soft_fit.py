"""Traffic kind ``soft_fit``: inverse rendering with the soft renderer, fit
after fit, each from the configuration's scene with every sphere centre
shifted by one vector of a fixed length in a direction drawn from the seed,
tau annealed in stages as ``cli fit`` does. Each stage's target is
``render_image_soft_cuda`` of the true scene, each step
``train.make_train_step(scene, train.soft_value_and_grad(...))``, as
``train.fit_scene_soft`` composes them, and the loss is read on the host
after every step. A step's latency runs from the end of the step before it to
its loss read on the host, so a stage's target and optimizer count in its
first step.

The check, against the plain reference (soft render, autograd, Adam written
out), in two parts:

* the start: set-up drives the window's step object through its first
  ``checked_steps`` steps; the reference follows them from the same shifted
  scene (each step's loss, the first gradient, the change after the steps);
* the window: steps drawn from the seed among the first ``sampled_fits``
  fits of the window, in every stage, a stage's first step (its new target
  and optimizer) among them. For each the program's scene and Adam state
  before the step are kept, and the reference works out the step's loss, its
  gradient (against its own target at the step's tau) and Adam's change from
  that state. It follows the program from the program's own state there; the
  start's check is what covers the state's first steps by themselves.
"""
from __future__ import annotations

import statistics
from typing import Dict, List

import numpy as np
import torch

import python_ray_tracer_tpu_torch as rt
from port_bench import bounds, core, drive, scenes
from port_bench.reference import camera as ref_camera
from port_bench.reference import fit as ref_fit
from python_ray_tracer_tpu_torch import train
from python_ray_tracer_tpu_torch.ops.soft import render_image_soft

# Seconds past the window's close that a sampled step may take to come.
WAIT_S = 60.0


class Traffic(drive.Kind):
    KEYS = frozenset({"width", "height", "taus", "steps", "lr", "trainable", "shift_length",
                      "warmup_steps_per_stage", "traced_steps"})
    UNIT = "step"

    def __init__(self, *a):
        super().__init__(*a)
        t = self.traffic
        self.W, self.H = int(t["width"]), int(t["height"])
        self.taus = [float(x) for x in t["taus"]]
        self.steps = int(t["steps"])
        self.per_stage = max(1, self.steps // len(self.taus))
        self.lr = float(t["lr"])
        self.trainable = list(t["trainable"])
        c = self.config["camera"]
        self.cam_arrays = (np.asarray(c["position"], np.float32),
                           scenes.euler_rotation(*c["euler"]), np.float32(c["fov"]))
        self.plan = self._plan()
        self.sampled: List[dict] = []

    def _plan(self) -> set:
        """The window's steps to check, ``(fit, stage, step)``: for every
        stage its first step and ``sampled_steps_per_stage`` more, each in a
        fit drawn from the window's fits 1 to ``sampled_fits`` (fit 0 began in
        set-up)."""
        rng = scenes.rng(self.seed, 5)
        fits = int(self.params["sampled_fits"])
        plan = set()
        for s in range(len(self.taus)):
            plan.add((int(rng.integers(1, fits + 1)), s, 0))
            for _ in range(int(self.params["sampled_steps_per_stage"])):
                plan.add((int(rng.integers(1, fits + 1)), s,
                          int(rng.integers(1, self.per_stage)) if self.per_stage > 1 else 0))
        return plan

    def _shifted(self, rng: np.random.Generator) -> dict:
        u = rng.standard_normal(3)
        shift = (float(self.traffic["shift_length"]) * u / np.linalg.norm(u)).astype(np.float32)
        return dict(self.arrays, **{"spheres.center": self.arrays["spheres.center"] + shift})

    def _start_fit(self, rng) -> None:
        self.init = self._shifted(rng)
        self.scene = self.port.scene(self.init)
        self.stage, self.k, self.step = -1, self.per_stage, None
        self.fit_no += 1

    def _prepare(self) -> None:
        """Open the next stage (and a new fit after the last stage) once the
        current stage has had its steps: its target and its optimizer."""
        if self.k == self.per_stage:
            if self.stage == len(self.taus) - 1:
                self._start_fit(self.fit_rng)
            self.stage += 1
            tau = self.taus[self.stage]
            with torch.no_grad():
                if self.cuda:
                    target = rt.render_image_soft_cuda(self.cam, self.true_scene, tau=tau)
                else:
                    target = render_image_soft(self.cam, self.true_scene, tau=tau)
            vg = train.soft_value_and_grad(self.cam, target, tau=tau, backend=self.port.backend)
            self.step = train.make_train_step(self.scene, vg, lr=self.lr,
                                              trainable=tuple(self.trainable))
            self.k = 0

    def _step(self) -> float:
        t0 = drive.now()
        loss = self.step()
        self.spans.append(drive.now() - t0)
        self.k += 1
        return float(loss)

    def _params(self):
        return list(zip(self.step.trainable, self.step.optimizer.param_groups[0]["params"]))

    def _advance(self) -> float:
        """One step of the current fit (a new stage or a new fit first, where
        the last is done); the loss read on the host. A planned step keeps the
        program's leaves and Adam state before it and its gradient and leaves
        after it (device copies, read once the window has closed)."""
        self._prepare()
        key = (self.fit_no, self.stage, self.k)
        if key not in self.plan:
            return self._step()
        opt = self.step.optimizer
        rec = {"key": key, "init": self.init, "tau": self.taus[self.stage],
               "before": {p: x.detach().clone() for p, x in self._params()},
               "state": {p: {k: v.clone() for k, v in opt.state.get(x, {}).items()}
                         for p, x in self._params()}}
        rec["loss"] = self._step()
        rec["grad"] = {p: (x.grad if x.grad is not None else torch.zeros_like(x)).clone()
                       for p, x in self._params()}
        rec["after"] = {p: x.detach().clone() for p, x in self._params()}
        self.sampled.append(rec)
        self.plan.discard(key)
        return rec["loss"]

    def setup(self, seconds: float) -> None:
        dev = self.port.device
        self.cam = self.port.cameras(*(torch.as_tensor(np.asarray(x)).to(dev)
                                       for x in self.cam_arrays), (self.W, self.H))
        self.true_scene = self.port.scene(self.arrays)
        self.mark("inputs")
        # warm-up: a fit of its own, a few steps of every stage
        self.fit_no = -10 ** 9
        self._start_fit(scenes.rng(self.seed, 0))
        for _ in self.taus:
            self.k = self.per_stage
            for _ in range(int(self.traffic["warmup_steps_per_stage"])):
                self._prepare()
                self._step()
            self.mark(f"warm-up stage {self.stage}")
        # the window's fit (fit 0): its first steps are the ones the reference follows
        self.fit_rng = scenes.rng(self.seed, 3)
        self.fit_no = -1
        self._start_fit(self.fit_rng)
        self.checked_init = self.init
        self.checked_losses: List[float] = []
        for i in range(int(self.params["checked_steps"])):
            self._prepare()
            self.checked_losses.append(self._step())
            if i == 0:
                self.first_moments = self._moments()
        self.checked_change = {p: x.detach().cpu().numpy() - self.checked_init[p]
                               for p, x in self._params()}
        self.mark("checked steps")

    def _moments(self) -> Dict[str, np.ndarray]:
        """Each trainable leaf's first gradient as Adam holds it after one
        step: its first moment over (1 - beta1)."""
        opt = self.step.optimizer
        beta1 = opt.param_groups[0]["betas"][0]
        out = {}
        for path, p in self._params():
            m = opt.state.get(p, {}).get("exp_avg")
            out[path] = (np.zeros(tuple(p.shape), np.float32) if m is None
                         else (m / (1.0 - beta1)).detach().cpu().numpy())
        return out

    def window(self, seconds: float) -> core.Window:
        """The measured window; then, outside it, the steps that reach every
        planned step not yet come (for at most :data:`WAIT_S`)."""
        lat: List[float] = []
        self.spans = []
        t0 = t = drive.now()
        while t - t0 < seconds:
            self._advance()
            t1 = drive.now()
            lat.append(t1 - t)
            t = t1
        spans, self.spans = self.spans, []
        while self.plan and drive.now() - t < WAIT_S:
            self._advance()
        self.spans = spans
        return core.Window(t0, t, lat)

    def stretch(self) -> list:
        """The traced stretch: ``traced_steps`` more steps; returns for each
        its fit's starting arrays, its trainable leaves before it and its tau."""
        out = []
        for _ in range(int(self.traffic["traced_steps"])):
            self._prepare()
            # only the trainable leaves move: one device copy of each a step
            before = {p: x.detach().clone() for p, x in self._params()}
            with torch.profiler.record_function("port_bench.step"):
                self._step()
            out.append((self.init, before, self.taus[self.stage]))
        return out

    def release(self) -> None:
        del self.scene, self.step, self.true_scene, self.cam

    # the reference -------------------------------------------------------------
    def _ref_camera(self, dtype):
        pos, rot, fov = (torch.as_tensor(np.asarray(x)) for x in self.cam_arrays)
        return ref_camera.Camera(pos, rot, fov, (self.W, self.H)).to(self.ref_device(), dtype)

    def _program(self) -> dict:
        return {"losses": self.checked_losses, "grad": self.first_moments,
                "change": self.checked_change,
                "steps": [{"loss": r["loss"],
                           "grad": {p: g.cpu().numpy() for p, g in r["grad"].items()},
                           "change": {p: (r["after"][p] - r["before"][p]).cpu().numpy()
                                      for p in r["before"]}} for r in self.sampled],
                "missing": len(self.plan)}

    def _reference(self, dtype=torch.float32, columns=None) -> dict:
        """The reference's numbers, in ``dtype``; ``columns`` (a slice) keeps
        only those columns in every loss."""
        def host(d):
            return {k: v.float().cpu().numpy() for k, v in d.items()}
        cam = self._ref_camera(dtype)
        true = self.ref_scene(dtype)
        start = ref_fit.follow_soft_fit(cam, true, self.ref_scene(dtype, self.checked_init),
                                        self.taus[0], self.lr, self.trainable,
                                        steps=int(self.params["checked_steps"]),
                                        columns=columns)
        targets: Dict[float, torch.Tensor] = {}
        steps = []
        for r in self.sampled:
            tau = r["tau"]
            if tau not in targets:
                with torch.no_grad():
                    targets[tau] = ref_fit.soft_image(cam, true, tau)
            before = {p: x.to(self.ref_device(), dtype) for p, x in r["before"].items()}
            scene = self.ref_scene(dtype, dict(r["init"], **{p: x.cpu().numpy() for p, x in
                                                             r["before"].items()}))
            loss, grads = ref_fit.soft_value_and_grad(cam, scene, targets[tau], tau,
                                                      self.trainable, columns)
            change = {}
            for p, x in before.items():
                st = r["state"][p]
                zero = torch.zeros_like(x)
                m = st["exp_avg"].to(x.device, dtype) if st else zero
                v = st["exp_avg_sq"].to(x.device, dtype) if st else zero
                t = int(st["step"]) if st else 0
                new, _, _ = ref_fit.adam_step(x, grads[p].detach(), m, v, t + 1, self.lr)
                change[p] = new - x
            steps.append({"loss": float(loss), "grad": host({p: g.detach() for p, g in
                                                             grads.items()}),
                          "change": host(change)})
        return {"losses": start["losses"], "grad": host(start["grad"]),
                "change": host(start["change"]), "steps": steps, "missing": 0}

    @staticmethod
    def norm_gap(a: dict, b: dict) -> float:
        """Over the leaves of ``b``, the largest gap between ``a``'s and
        ``b``'s norm of a leaf, against ``b``'s norm of that leaf or of the
        median leaf, whichever is larger."""
        def norm(x):
            return float(np.linalg.norm(np.asarray(x, np.float64)))
        nb = {k: norm(v) for k, v in b.items()}
        med = statistics.median(nb.values())
        return max(abs(norm(a[k]) - nb[k]) / max(nb[k], med) for k in b)

    @staticmethod
    def compare(prog: dict, ref: dict) -> Dict[str, float]:
        """The start: ``loss_gap``, the largest relative gap of a step's loss;
        ``grad_gap`` / ``change_gap``: over the trainable leaves, the largest
        gap between the program's and the reference's norm of the first
        gradient / of the change after the steps, against the reference's norm
        of that leaf or of the median leaf, whichever is larger. The window's
        sampled steps: ``step_loss_gap``, ``step_grad_gap`` and
        ``step_change_gap``, the same of each step's loss, gradient and change,
        the largest over the steps; ``missing_steps``: planned steps that never
        came."""
        worst = Traffic.norm_gap

        def loss_gap(p, r):
            return abs(p - r) / abs(r)
        pairs = list(zip(prog["steps"], ref["steps"]))
        return {"loss_gap": max(loss_gap(p, r) for p, r in zip(prog["losses"], ref["losses"])),
                "grad_gap": worst(prog["grad"], ref["grad"]),
                "change_gap": worst(prog["change"], ref["change"]),
                "step_loss_gap": max([loss_gap(p["loss"], r["loss"]) for p, r in pairs],
                                     default=0.0),
                "step_grad_gap": max([worst(p["grad"], r["grad"]) for p, r in pairs],
                                     default=0.0),
                "step_change_gap": max([worst(p["change"], r["change"]) for p, r in pairs],
                                       default=0.0),
                "missing_steps": float(prog["missing"])}

    def readings(self) -> Dict[str, float]:
        return self.compare(self._program(), self._reference())

    def control_readings(self, dtype) -> Dict[str, Dict[str, float]]:
        """The control (the reference in ``dtype`` in the program's place), and
        a fault planted in the reference in the program's place: the loss
        over half of the image's columns."""
        ref = self._reference()
        return {f"control_{str(dtype).split('.')[-1]}": self.compare(self._reference(dtype), ref),
                "fault_half_columns": self.compare(
                    self._reference(columns=slice(0, self.W // 2)), ref)}

    def bound_seconds(self, kernel: str, traced: list):
        """For ``soft_bwd``: seconds an H100 needs at least for the traced
        steps' fused soft launches (:func:`bounds.soft_fused_bound_s` of each
        step's scene)."""
        if kernel != "soft_bwd":
            return None
        cam = self._ref_camera(torch.float32)
        total = 0.0
        for init, moved, tau in traced:
            arrays = dict(init, **{p: t.cpu().numpy() for p, t in moved.items()})
            total += bounds.soft_fused_bound_s(cam, self.ref_scene(torch.float32, arrays), tau)
        return total
