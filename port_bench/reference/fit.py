"""The fit's step, followed by the reference: the soft pixel loss of the
port's ``train.soft_pixel_loss`` (its plain version), its gradient by
autograd, and Adam as ``torch.optim.Adam`` defines it (betas 0.9 / 0.999, eps
1e-8), written out here. Every quantity is computed in the dtype of the
scene's tensors."""
from __future__ import annotations

from typing import Dict, Sequence

import torch

from .scene import LEAF_PATHS, Scene
from .soft import render_image_soft, row_chunk_for

BETA1, BETA2, EPS = 0.9, 0.999, 1e-8


def soft_image(camera, scene, tau: float) -> torch.Tensor:
    """The soft render ``(w, h, 3)`` in column blocks that fit."""
    return render_image_soft(camera, scene, tau=tau,
                             row_chunk=row_chunk_for(camera.resolution, scene))


def soft_value_and_grad(camera, scene, target, tau: float, trainable: Sequence[str],
                        columns=None):
    """``(loss, {path: gradient})`` of ``mean((soft image - target)^2)``;
    ``columns`` (a slice) keeps only those columns in the mean."""
    leaves = [t.detach().requires_grad_(p in trainable)
              for p, t in zip(LEAF_PATHS, scene.leaves())]
    img = soft_image(camera, Scene.from_leaves(leaves), tau)
    if columns is not None:
        img, target = img[columns], target[columns]
    loss = torch.mean((img - target) ** 2)
    grads = torch.autograd.grad(loss, [leaves[LEAF_PATHS.index(p)] for p in trainable])
    return loss.detach(), dict(zip(trainable, grads))


def adam_step(p, g, m, v, t: int, lr: float):
    """Adam's ``t``-th step of leaf ``p`` with gradient ``g`` from moments
    ``m``, ``v`` (those after step ``t - 1``): ``(p, m, v)`` after it."""
    c1, c2 = 1.0 - BETA1 ** t, 1.0 - BETA2 ** t
    g = g.to(p.dtype)
    m = BETA1 * m + (1.0 - BETA1) * g
    v = BETA2 * v + (1.0 - BETA2) * g * g
    denom = torch.sqrt(v) / (c2 ** 0.5) + EPS
    return p - (lr / c1) * m / denom, m, v


class Adam:
    """Adam over ``params`` (``{path: tensor}``), updated in place."""

    def __init__(self, params: Dict[str, torch.Tensor], lr: float):
        self.params, self.lr, self.t = params, lr, 0
        self.m = {k: torch.zeros_like(v) for k, v in params.items()}
        self.v = {k: torch.zeros_like(v) for k, v in params.items()}

    def step(self, grads: Dict[str, torch.Tensor]) -> None:
        self.t += 1
        for k, p in self.params.items():
            new, self.m[k], self.v[k] = adam_step(p, grads[k], self.m[k], self.v[k], self.t,
                                                  self.lr)
            p.copy_(new)


def follow_soft_fit(camera, true_scene, init_scene, tau: float, lr: float,
                    trainable: Sequence[str], steps: int = 3, columns=None) -> dict:
    """The first ``steps`` steps of a soft fit stage from ``init_scene``
    against the soft render of ``true_scene``: each step's loss, the first
    step's gradient, and each trainable leaf's change after the last step."""
    with torch.no_grad():
        target = soft_image(camera, true_scene, tau)
    scene = Scene.from_leaves([t.detach().clone() for t in init_scene.leaves()])
    params = {p: scene.leaves()[LEAF_PATHS.index(p)] for p in trainable}
    start = {p: t.clone() for p, t in params.items()}
    opt = Adam(params, lr)
    losses, first = [], None
    for _ in range(steps):
        loss, grads = soft_value_and_grad(camera, scene, target, tau, trainable, columns)
        losses.append(float(loss))
        first = grads if first is None else first
        with torch.no_grad():
            opt.step(grads)
    return {"losses": losses, "grad": {p: g.detach() for p, g in first.items()},
            "change": {p: (params[p] - start[p]).detach() for p in trainable}}
