"""Command-line entry point: ``python -m python_ray_tracer_tpu_torch.cli
render|fit``.

``render`` reproduces the reference main.py flow (main.py:8-55): build the demo
scene, render at the reference's settings (1000x1000, amb=0, lamb=0.6,
refl=0.3, depth=2, AA on), print a synchronised time, save a PNG. ``fit`` is
the inverse-rendering demo of ``python_ray_tracer_tpu.cli fit``: ``--mode
hard`` recovers perturbed sphere centers, ``--mode camera`` a perturbed camera
pose. ``--backend cuda`` runs the hand-written CUDA kernels, ``--backend
torch`` the plain PyTorch version.
"""
from __future__ import annotations

import argparse
import os

import torch

from . import train
from .models.camera import Camera
from .models.scene import (BLUE, GREY, RED, Lights, Materials, Planes, Scene,
                           Spheres, default_scene)
from .ops.cuda.render_cuda import render_image_cuda
from .ops.render import render_image, to_framebuffer
from .utils.config import BACKENDS, RenderConfig, resolve_backend
from .utils.image import save_png
from .utils.metrics import MetricsLogger
from .utils.timing import rays_per_image, time_fn


def _add_render_args(p: argparse.ArgumentParser) -> None:
    d = RenderConfig()
    p.add_argument("--width", type=int, default=d.width)
    p.add_argument("--height", type=int, default=d.height)
    p.add_argument("--ambient", type=float, default=d.ambient)
    p.add_argument("--lambert", type=float, default=d.lambert)
    p.add_argument("--reflection", type=float, default=d.reflection)
    p.add_argument("--depth", type=int, default=d.depth)
    p.add_argument("--no-aliasing", action="store_true")
    p.add_argument("--fov", type=float, default=d.fov)
    p.add_argument("--clean", action="store_true",
                   help="disable reference-quirk compat mode")
    p.add_argument("--backend", choices=BACKENDS, default=d.backend,
                   help="auto = cuda when a card is visible, else torch")
    p.add_argument("--out", type=str, default="output/render.png")


def _build(args):
    cfg = RenderConfig(width=args.width, height=args.height, ambient=args.ambient,
                       lambert=args.lambert, reflection=args.reflection,
                       depth=args.depth, aliasing=not args.no_aliasing, fov=args.fov,
                       compat=not args.clean, backend=resolve_backend(args.backend))
    device = "cuda" if torch.cuda.is_available() else "cpu"
    mats = Materials.build(cfg.ambient, cfg.lambert, cfg.reflection, cfg.specular,
                           cfg.shininess, device=device)
    scene = default_scene(mats, device=device)
    cam = Camera.build((cfg.width, cfg.height), cfg.camera_position,
                       cfg.camera_euler, cfg.fov, device=device)
    return cfg, scene, cam


def _render_fn(cfg: RenderConfig):
    kw = dict(depth=cfg.depth, aliasing=cfg.aliasing, compat=cfg.compat)
    if cfg.backend == "cuda":
        return lambda cam, scene: render_image_cuda(cam, scene, **kw)
    return lambda cam, scene: render_image(cam, scene, **kw)


def cmd_render(args) -> int:
    cfg, scene, cam = _build(args)
    fn = _render_fn(cfg)
    secs = time_fn(fn, cam, scene, warmup=1, iters=5)
    img = fn(cam, scene)
    n_rays = rays_per_image(cfg.width, cfg.height, depth=cfg.depth,
                            aliasing=cfg.aliasing, n_lights=scene.lights.count)
    print(f"time: {secs * 1000:,.3f} ms  "
          f"({n_rays / secs / 1e6:,.1f} Mrays/s, {cfg.width}x{cfg.height}, "
          f"backend={cfg.backend}, device={cam.device})")
    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    save_png(to_framebuffer(img), args.out)
    print(f"saved {args.out}")
    return 0


def _loss_span(losses) -> str:
    """first -> last loss for the fit summary; tolerates --steps 0."""
    if not losses:
        return "(0 steps)"
    return f"{losses[0]:.3e} -> {losses[-1]:.3e}"


def fit_scene_two_spheres(cfg: RenderConfig, device) -> Scene:
    """The well-separated 2-sphere scene of ``python_ray_tracer_tpu.cli
    cmd_fit`` (cli.py:194-199): hard-visibility gradients mislead on the
    crowded demo scene."""
    mats = Materials.build(cfg.ambient, cfg.lambert, cfg.reflection, device=device)
    return Scene(Spheres.build([([2.5, 0.5, 1.0], 0.8, RED),
                                ([1.5, -0.9, 0.5], 0.5, BLUE)], device),
                 Planes.build([([5, 0, 0], [0, 0, 1], GREY)], device),
                 Lights.build([[2.5, -2.0, 3.0], [2.5, 2.0, 3.0]], device), mats)


def cmd_fit(args) -> int:
    """Inverse-render demo on the 2-sphere scene. ``--mode hard`` shifts the
    sphere centers by (0.2, -0.15, 0.1) and recovers them by pixel-gradient
    descent; ``--mode camera`` fixes the scene and recovers a perturbed camera
    pose. Target and fit render without AA, as in the JAX CLI."""
    cfg, _, cam = _build(args)
    device = cam.device
    scene = fit_scene_two_spheres(cfg, device)

    def render(c, s):
        kw = dict(depth=cfg.depth, aliasing=False, compat=cfg.compat)
        if cfg.backend == "cuda":
            return render_image_cuda(c, s, **kw)
        return render_image(c, s, **kw)

    target = render(cam, scene)
    logger = MetricsLogger("fit")
    if args.mode == "camera":
        init_cam = Camera.build(cam.resolution,
                                cam.position.cpu().numpy() + [0.1, -0.08, 0.08],
                                [1.5, -27.5, 2.0], float(cam.fov), device=device)
        fitted, losses = train.fit_camera(init_cam, scene, target, steps=args.steps,
                                          lr=args.lr, depth=cfg.depth,
                                          compat=cfg.compat, logger=logger,
                                          backend=cfg.backend)
        p0 = float((init_cam.position - cam.position).abs().max())
        p1 = float((fitted.position - cam.position).abs().max())
        print(f"loss: {_loss_span(losses)}  camera pos err: {p0:.3f} -> {p1:.4f}")
        img = render(fitted, scene)
    else:
        init = Scene.from_leaves(scene.leaves())
        init.spheres = Spheres(
            scene.spheres.center + torch.tensor([0.2, -0.15, 0.1], device=device),
            scene.spheres.radius, scene.spheres.albedo)
        fitted, losses = train.fit_scene(init, cam, target, steps=args.steps, lr=args.lr,
                                         depth=cfg.depth, compat=cfg.compat,
                                         logger=logger, trainable=("spheres.center",),
                                         backend=cfg.backend)
        errs = torch.linalg.norm(fitted.spheres.center - scene.spheres.center, dim=1)
        err0 = float((init.spheres.center - scene.spheres.center).abs().max())
        print(f"loss: {_loss_span(losses)}  "
              f"center err: {err0:.3f} -> median {float(errs.median()):.4f} "
              f"/ max {float(errs.max()):.4f}")
        img = render(cam, fitted)
    if args.out:
        os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
        save_png(to_framebuffer(img), args.out)
        print(f"saved {args.out}")
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python_ray_tracer_tpu_torch")
    sub = ap.add_subparsers(dest="cmd", required=True)
    _add_render_args(sub.add_parser("render", help="render the demo scene to PNG"))
    pf = sub.add_parser("fit", help="inverse-render demo (fit a perturbed scene or "
                                    "camera back)")
    _add_render_args(pf)
    pf.set_defaults(out="output/fit.png")   # don't clobber render's default PNG
    pf.add_argument("--steps", type=int, default=150)
    pf.add_argument("--lr", type=float, default=1e-2)
    pf.add_argument("--mode", choices=["hard", "camera"], default="hard",
                    help="hard: recover sphere centers; camera: recover the camera "
                         "pose. The default is hard until the soft-visibility "
                         "renderer is ported (the JAX CLI's default is soft)")
    args = ap.parse_args(argv)
    if args.cmd == "fit":
        return cmd_fit(args)
    return cmd_render(args)


if __name__ == "__main__":
    raise SystemExit(main())
