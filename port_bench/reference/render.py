"""The hard render of chosen pixels of many frames, as the port's plain
``ops/render.py`` renders whole frames (frozen at fa8828e): each pixel's
centre sample and, with AA, its 8 half-offset samples in the same order, the
compat channel swaps, the border ring of single samples, and the
framebuffer's quantisation (scale, round half to even, clamp). Rays are traced
in blocks of :func:`ray_block` rays so that a 1000-sphere scene fits."""
from __future__ import annotations

import torch

from .shade import sample

# The 8 neighbour half-offsets in (x, y) pixel-index space, in the order the
# plain render accumulates them (ops/render.py _AA_OFFSETS).
AA_OFFSETS = ((-0.5, 0.0), (0.5, 0.0), (0.0, 0.5), (0.0, -0.5),
              (-0.5, 0.5), (0.5, 0.5), (-0.5, -0.5), (0.5, -0.5))


def ray_block(scene, budget: int = 1 << 28) -> int:
    """Rays a block may hold so that its largest intermediate, the shadow
    rays' ``(rays, lights, spheres, 3)`` differences, stays under ``budget``
    elements."""
    per_ray = 3 * max(scene.lights.count, 1) * max(scene.spheres.count + scene.planes.count, 1)
    return max(1024, budget // per_ray)


def trace_rays(origins, dirs, scene, *, depth: int, compat: bool) -> torch.Tensor:
    """``sample`` of rays ``(R, 3)`` in blocks -> colours ``(R, 3)``."""
    n = ray_block(scene)
    return torch.cat([sample(o, d, scene, depth=depth, compat=compat)
                      for o, d in zip(torch.split(origins, n), torch.split(dirs, n))])


def render_pixels(camera, scene, pixels: torch.Tensor, *, depth: int, aliasing: bool,
                  compat: bool) -> torch.Tensor:
    """uint8 ``(F, P, 3)``: the framebuffer values of pixels ``(F, P, 2)``
    (integer ``(x, y)``) of ``F`` frames, ``camera`` holding one camera a
    frame; channel ``c`` of a pixel is the port framebuffer's ``[c, x, y]``."""
    W, H = camera.resolution
    dt = camera.dtype
    xy = pixels.to(camera.device, dt)
    offs = [(0.0, 0.0)] + (list(AA_OFFSETS) if aliasing else [])
    pos = torch.stack([xy + torch.tensor(o, dtype=dt, device=xy.device) for o in offs],
                      dim=2)                                         # (F, P, S, 2)
    d = camera.ray_directions(pos, compat=compat)
    o = camera.origins(d)
    with torch.no_grad():
        rgb = trace_rays(o.reshape(-1, 3), d.reshape(-1, 3), scene, depth=depth,
                         compat=compat).reshape(pos.shape[:-1] + (3,))
    primary = rgb[:, :, 0]
    if not aliasing:
        img = primary[..., [0, 2, 1]] if compat else primary
    else:
        acc = torch.zeros_like(primary)
        for s in range(1, len(offs)):
            acc = acc + rgb[:, :, s]
        gx, gy = xy[..., 0], xy[..., 1]
        interior = ((gx >= 1.0) & (gx <= W - 2) & (gy >= 1.0) & (gy <= H - 2))[..., None]
        if compat:
            pr, pg, pb = primary.unbind(-1)
            nr, ng, nb = acc.unbind(-1)
            aa = torch.stack([pr + nr, pb + ng, pg + nb], dim=-1) / 9.0
            img = torch.where(interior, aa, torch.stack([pr, pb, pg], dim=-1))
        else:
            img = torch.where(interior, (primary + acc) / 9.0, primary)
    return torch.clamp(torch.round(img * 255.0), 0.0, 255.0).to(torch.uint8)
