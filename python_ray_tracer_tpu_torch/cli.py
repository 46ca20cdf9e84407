"""Command-line entry point: ``python -m python_ray_tracer_tpu_torch.cli
render|fit|animate``.

``render`` reproduces the reference main.py flow (main.py:8-55): build the demo
scene, render at the reference's settings (1000x1000, amb=0, lamb=0.6,
refl=0.3, depth=2, AA on), print a synchronised time, save a PNG; ``--soft TAU``
renders with the soft-visibility renderer instead, and ``--adaptive-aa EPS``
supersamples only the pixels whose centers curve by more than EPS (the worklist
kernel; ``--backend cuda`` with AA on). ``fit`` is the
inverse-rendering demo of ``python_ray_tracer_tpu.cli fit``: ``--mode soft``
(the default) recovers the perturbed sphere centers of the demo scene through
the soft renderer with tau annealing, ``--mode hard`` those of a well-separated
2-sphere scene through the hard renderer, ``--mode camera`` a perturbed camera
pose. ``animate`` renders ``--frames`` frames on an orbit around the scene
(``animation.render_frames``), prints the time a frame and writes a GIF.
``--backend cuda`` (the default) runs the hand-written CUDA kernels on the card
and raises without one; ``--backend torch`` is the explicit request for the
plain PyTorch version on the CPU.
"""
from __future__ import annotations

import argparse
import os
import sys

import numpy as np
import torch

from . import animation, train
from .models.camera import Camera
from .models.scene import (BLUE, GREY, RED, Lights, Materials, Planes, Scene,
                           Spheres, default_scene, random_scene)
from .ops.cuda.adaptive_cuda import render_image_adaptive_cuda
from .ops.cuda.render_cuda import render_image_cuda
from .ops.cuda.soft_cuda import render_image_soft_cuda, render_image_soft_plain
from .ops.render import render_image, to_framebuffer
from .utils.config import BACKENDS, RenderConfig, resolve_backend
from .utils.image import save_png
from .utils.metrics import MetricsLogger
from .utils.timing import rays_per_image, time_fn

FIT_SHIFT = (0.2, -0.15, 0.1)   # the fit demos' sphere-center perturbation


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
                   help="cuda (default): the CUDA kernels on the card, an error "
                        "without one; torch: the plain PyTorch version on the CPU")
    p.add_argument("--soft", type=float, default=0.0, metavar="TAU",
                   help="render with the soft-visibility renderer at this tau")
    p.add_argument("--adaptive-aa", type=float, default=None, metavar="EPS",
                   help="adaptive 3x3 AA (cuda backend, AA on): trace the 9 samples "
                        "only of pixels whose center curvature exceeds EPS (in [0, 1] "
                        "units; try 0.002, about 0.5/255), the tent filter elsewhere")
    p.add_argument("--adaptive-budget", type=float, default=0.25,
                   help="worklist length as a share of the pixels (static; pixels "
                        "flagged past it keep the tent value and are reported)")
    p.add_argument("--spheres", type=int, default=0,
                   help="random N-sphere scene instead of the demo scene: the "
                        "JAX package's scene of the same N, drawn from "
                        "jax.random.key(0)")
    p.add_argument("--out", type=str, default="output/render.png")


def _build(args):
    cfg = RenderConfig(width=args.width, height=args.height, ambient=args.ambient,
                       lambert=args.lambert, reflection=args.reflection,
                       depth=args.depth, aliasing=not args.no_aliasing, fov=args.fov,
                       compat=not args.clean, backend=resolve_backend(args.backend))
    device = "cuda" if cfg.backend == "cuda" else "cpu"
    mats = Materials.build(cfg.ambient, cfg.lambert, cfg.reflection, cfg.specular,
                           cfg.shininess, device=device)
    if args.spheres > 0:
        scene = random_scene(args.spheres, materials=mats, key=0, device=device)
    else:
        scene = default_scene(mats, device=device)
    cam = Camera.build((cfg.width, cfg.height), cfg.camera_position,
                       cfg.camera_euler, cfg.fov, device=device)
    return cfg, scene, cam


def _render_fn(cfg: RenderConfig, soft_tau: float = 0.0, adaptive_eps=None,
               adaptive_budget: float = 0.25):
    """``(fn(cam, scene) -> image, adaptive keywords or None)``: the render
    call the flags ask for, and the keywords of
    :func:`render_image_adaptive_cuda` when that is it. ``--adaptive-aa`` is
    ignored, with a note on stderr, under ``--soft``, without AA and on the
    plain backend (as the JAX CLI ignores it off its Pallas backend)."""
    ignored = None
    if soft_tau > 0.0:
        ignored = "--soft renders use the soft renderer"
    elif not cfg.aliasing:
        ignored = "requires aliasing on"
    elif cfg.backend != "cuda":
        ignored = "cuda backend only"
    if adaptive_eps is not None and ignored:
        print(f"[adaptive-aa] ignored: {ignored}", file=sys.stderr)
    if soft_tau > 0.0:
        if cfg.backend == "cuda":
            return lambda cam, scene: render_image_soft_cuda(cam, scene, tau=soft_tau), None
        return lambda cam, scene: render_image_soft_plain(cam, scene, tau=soft_tau), None
    if adaptive_eps is not None and not ignored:
        akw = dict(depth=cfg.depth, compat=cfg.compat, eps=adaptive_eps,
                   budget_frac=adaptive_budget)
        return lambda cam, scene: render_image_adaptive_cuda(cam, scene, **akw), akw
    kw = dict(depth=cfg.depth, aliasing=cfg.aliasing, compat=cfg.compat)
    if cfg.backend == "cuda":
        return lambda cam, scene: render_image_cuda(cam, scene, **kw), None
    return lambda cam, scene: render_image(cam, scene, row_chunk=cfg.row_chunk, **kw), None


def cmd_render(args) -> int:
    cfg, scene, cam = _build(args)
    fn, adaptive = _render_fn(cfg, args.soft, args.adaptive_aa, args.adaptive_budget)
    secs = time_fn(fn, cam, scene, warmup=1, iters=5)
    if adaptive is None:
        img = fn(cam, scene)
    else:   # the frame that gives the stats is the PNG's: no extra render
        img, stats = render_image_adaptive_cuda(cam, scene, **adaptive, with_stats=True)
        flagged, dropped = int(stats["flagged"]), int(stats["dropped"])
        print(f"[adaptive-aa] flagged {flagged:,} px "
              f"({flagged / (cfg.width * cfg.height):.1%}), dropped {dropped:,} "
              f"(raise --adaptive-budget if > 0)")
    n_rays = rays_per_image(cfg.width, cfg.height, depth=cfg.depth,
                            aliasing=cfg.aliasing, n_lights=scene.lights.count)
    soft = f", soft tau={args.soft:g}" if args.soft > 0.0 else ""
    print(f"time: {secs * 1000:,.3f} ms  "
          f"({n_rays / secs / 1e6:,.1f} Mrays/s, {cfg.width}x{cfg.height}, "
          f"backend={cfg.backend}, device={cam.device}{soft})")
    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    save_png(to_framebuffer(img), args.out)
    print(f"saved {args.out}")
    return 0


def _loss_span(losses) -> str:
    """first -> last loss for the fit summary; tolerates --steps 0."""
    if not losses:
        return "(0 steps)"
    return f"{losses[0]:.3e} -> {losses[-1]:.3e}"


def _center_err_span(err0: float, errs: torch.Tensor) -> str:
    """The summary's center errors as the JAX CLI prints them
    (``python_ray_tracer_tpu/cli.py:252-256``): ``np.median`` of the float32
    per-sphere norms, which for an even count is the mean of the two middle
    values (``torch.median`` returns the lower)."""
    errs = errs.detach().cpu().numpy()
    return f"center err: {err0:.3f} -> median {float(np.median(errs)):.4f} / max {errs.max():.4f}"


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
    """Inverse-render demo. ``--mode soft`` (default) shifts every sphere
    center of the demo scene (or ``--spheres N``) by (0.2, -0.15, 0.1) and
    recovers them through the soft renderer with tau annealed 0.15 -> 0.05 ->
    0.02 (``train.fit_scene_soft``); ``--mode hard`` does the same through the
    hard renderer on the well-separated 2-sphere scene (or ``--spheres N``);
    ``--mode camera`` fixes that scene and recovers a perturbed camera pose.
    Hard targets and every fitted PNG render without AA, as in the JAX CLI."""
    cfg, scene, cam = _build(args)
    device = cam.device
    if args.mode in ("hard", "camera") and args.spheres <= 0:
        print(f"[fit] --mode {args.mode}: using the built-in 2-sphere well-separated "
              f"scene (hard-visibility gradients mislead on the crowded demo scene); "
              f"pass --spheres N to fit a scene of your own", file=sys.stderr)
        scene = fit_scene_two_spheres(cfg, device)

    def render(c, s):
        kw = dict(depth=cfg.depth, aliasing=False, compat=cfg.compat)
        if cfg.backend == "cuda":
            return render_image_cuda(c, s, **kw)
        return render_image(c, s, **kw)

    logger = MetricsLogger("fit")
    if args.mode == "camera":
        target = render(cam, scene)
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
            scene.spheres.center + torch.tensor(FIT_SHIFT, device=device),
            scene.spheres.radius, scene.spheres.albedo)
        if args.mode == "soft":
            if args.bounce_depth and cfg.backend == "cuda":
                print("[fit] --bounce-depth 1: no kernel covers the mirror bounce (in "
                      "either package), so targets and steps run the plain PyTorch "
                      "version on the card")
            fitted, losses = train.fit_scene_soft(init, cam, scene, steps=args.steps,
                                                  lr=args.lr, logger=logger,
                                                  backend=cfg.backend,
                                                  bounce_depth=args.bounce_depth)
        else:
            fitted, losses = train.fit_scene(init, cam, render(cam, scene),
                                             steps=args.steps, lr=args.lr,
                                             depth=cfg.depth, compat=cfg.compat,
                                             logger=logger, trainable=("spheres.center",),
                                             backend=cfg.backend)
        errs = torch.linalg.norm(fitted.spheres.center - scene.spheres.center, dim=1)
        err0 = float((init.spheres.center - scene.spheres.center).abs().max())
        print(f"loss: {_loss_span(losses)}  {_center_err_span(err0, errs)}")
        img = render(cam, fitted)
    if args.out:
        os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
        save_png(to_framebuffer(img), args.out)
        print(f"saved {args.out}")
    return 0


def cmd_animate(args) -> int:
    """Orbit animation (``python_ray_tracer_tpu.cli cmd_animate``): ``--frames``
    cameras on a circle of radius 4 around (1, 0, 1), 1.5 above it, rendered
    by :func:`animation.render_frames` in blocks of 12 frames, timed (one
    warm-up pass, then 3), and saved as a GIF at ``--fps``."""
    cfg, scene, cam = _build(args)
    cams = animation.orbit_cameras((cfg.width, cfg.height), center=[1.0, 0.0, 1.0],
                                   radius=4.0, height=1.5, n_frames=args.frames,
                                   fov=cfg.fov, device=cam.device)
    kw = dict(depth=cfg.depth, aliasing=cfg.aliasing, compat=cfg.compat,
              backend=cfg.backend)
    secs = time_fn(animation.render_frames, cams, scene, warmup=1, iters=3, **kw)
    frames = animation.render_frames(cams, scene, **kw)
    print(f"{args.frames} frames in {secs * 1000:,.1f} ms "
          f"({secs * 1000 / args.frames:,.3f} ms/frame, {cfg.width}x{cfg.height}, "
          f"backend={cfg.backend}, device={cam.device})")
    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    animation.save_animation(frames, args.out, fps=args.fps)
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
    pf.add_argument("--mode", choices=["soft", "hard", "camera"], default="soft",
                    help="soft (default): recover sphere centers through the soft "
                         "renderer; hard: through the hard renderer; camera: "
                         "recover the camera pose")
    pf.add_argument("--bounce-depth", type=int, default=0, choices=[0, 1],
                    help="soft mode: add a depth-1 mirror bounce (makes reflection "
                         "trainable; renders through the plain PyTorch version)")
    pa = sub.add_parser("animate", help="orbit-animation GIF")
    _add_render_args(pa)
    pa.set_defaults(out="output/orbit.gif")
    pa.add_argument("--frames", type=int, default=24)
    pa.add_argument("--fps", type=int, default=12)
    args = ap.parse_args(argv)
    if args.cmd == "fit":
        return cmd_fit(args)
    if args.cmd == "animate":
        return cmd_animate(args)
    return cmd_render(args)


if __name__ == "__main__":
    raise SystemExit(main())
