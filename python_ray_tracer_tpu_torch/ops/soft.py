"""Soft-visibility differentiable renderer in plain PyTorch (silhouette-aware
gradients).

Counterpart of ``python_ray_tracer_tpu/ops/soft.py`` and the port's plain
version of the soft CUDA kernels (``ops/cuda/soft_cuda.py``,
``ops/cuda/soft_bwd_cuda.py``); autograd of it is their gradients' reference.

  * every sphere gets a smooth coverage ``alpha_i = sigmoid(-(b_i - r_i) /
    (tau * r_i))``, ``b_i`` the ray's closest-approach distance to the center;
  * objects are alpha-composited front to back in depth order (a stable
    argsort: ties go to the lower index, spheres before planes);
  * shadows are transmission products ``prod_j (1 - alpha_j)`` over the
    spheres along the shadow ray; planes are opaque and cast no shadow;
  * ``bounce_depth=1`` adds a hard-visibility mirror bounce under the soft
    compositing weights (``trace_once`` in clean mode).

Every ``sqrt`` whose argument can clamp to 0 takes a double ``where`` (``d2 >
1e-12``, ``chord2 > 1e-12``, ``n2 > 0``): sqrt's infinite derivative at 0
would turn a masked zero cotangent into NaN. The camera grid is the clean-mode
one and the channels are unswapped, as in the JAX package.
"""
from __future__ import annotations

import torch
from torch.utils.checkpoint import checkpoint

from .intersect import _dot
from .shade import BIAS, trace_once


def _norm(v: torch.Tensor) -> torch.Tensor:
    n2 = _dot(v, v)[..., None]
    return torch.sqrt(torch.where(n2 > 0, n2, torch.ones_like(n2)))


def _sphere_soft_cover(ray_o, ray_d, center, radius, tau):
    """Per-sphere soft coverage and blend depth ``(alpha, t)``, each ``(...,
    N)``. ``t`` is the near-hit distance inside the silhouette and the
    closest-approach distance outside (continuous at the boundary), clamped
    to >= 1e-4; spheres behind the camera (``t_ca <= 0``) cover nothing."""
    L = center - ray_o[..., None, :]                       # (..., N, 3)
    t_ca = _dot(L, ray_d[..., None, :])                    # closest approach
    d2 = _dot(L, L) - t_ca * t_ca                          # b^2
    d2_pos = d2 > 1e-12
    b = torch.sqrt(torch.where(d2_pos, d2, torch.full_like(d2, 1e-12)))
    alpha = torch.sigmoid(-(b - radius) / (tau * radius))
    alpha = torch.where(t_ca > 0.0, alpha, torch.zeros_like(alpha))
    chord2 = radius * radius - d2
    inside = chord2 > 1e-12
    half_chord = torch.sqrt(torch.where(inside, chord2, torch.ones_like(chord2)))
    t = torch.where(inside, t_ca - half_chord, t_ca)
    return alpha, torch.clamp(t, min=1e-4)


def _plane_cover(ray_o, ray_d, origin, normal):
    """Opaque plane coverage: alpha 1 where hit, 0 otherwise; t the hit distance."""
    denom = _dot(ray_d[..., None, :], normal)
    ok = torch.abs(denom) > 1e-8
    denom_safe = torch.where(ok, denom, torch.ones_like(denom))
    t = _dot(origin - ray_o[..., None, :], normal) / denom_safe
    alpha = (ok & (t > 0.0)).to(ray_d.dtype)
    return alpha, torch.clamp(t, min=1e-4)


def _light_transmission(P, L_dir, scene, tau):
    """Product of ``(1 - alpha)`` over the spheres along each shadow ray from
    ``P`` in unit direction ``L_dir``; planes are not occluders."""
    if scene.spheres.count == 0:
        return torch.ones(torch.broadcast_shapes(P.shape[:-1], L_dir.shape[:-1]),
                          dtype=P.dtype, device=P.device)
    alpha, _ = _sphere_soft_cover(P, L_dir, scene.spheres.center, scene.spheres.radius,
                                  tau)
    return torch.prod(1.0 - alpha, dim=-1)


def _shade_all(P, N, albedo, scene, tau):
    """Ambient + soft-shadowed Lambert at per-object points ``P (..., K, 3)``."""
    m = scene.materials
    rgb = m.ambient * albedo
    if scene.lights.count:
        Lv = scene.lights.position - P[..., None, :]        # (..., K, Lg, 3)
        Ld = Lv / _norm(Lv)
        vis = _light_transmission(P[..., None, :], Ld, scene, tau)   # (..., K, Lg)
        lam = m.lambert * _dot(Ld, N[..., None, :])
        lam = torch.where(lam > 0.0, lam, torch.zeros_like(lam)) * vis
        rgb = rgb + lam.sum(dim=-1)[..., None] * albedo
    return rgb


def _mirror_bounce_rgb(P, N, ray_d, scene):
    """Hard-visibility mirror-bounce radiance from per-object hit points
    ``P, N (..., K, 3)``; the origin is nudged along N, then R (reference
    trace.py:107-110)."""
    ddn = _dot(ray_d[..., None, :], N)[..., None]
    R = ray_d[..., None, :] - 2.0 * ddn * N
    R = R / _norm(R)
    return trace_once(P + BIAS * N + BIAS * R, R, scene, compat=False).rgb


def render_rays_soft(ray_o, ray_d, scene, *, tau: float = 0.05,
                     bounce_depth: int = 0) -> torch.Tensor:
    """Soft-composited radiance for a batch of rays -> ``(..., 3)``.
    ``bounce_depth`` is 0 or 1 (the mirror bounce weighted by
    ``materials.reflection``)."""
    if bounce_depth not in (0, 1):
        raise ValueError(f"the soft renderer takes bounce_depth 0 or 1, got {bounce_depth}")
    refl = scene.materials.reflection
    parts_alpha, parts_t, parts_rgb = [], [], []
    o = ray_o[..., None, :]
    d = ray_d[..., None, :]
    if scene.spheres.count:
        a_s, t_s = _sphere_soft_cover(ray_o, ray_d, scene.spheres.center,
                                      scene.spheres.radius, tau)
        P_s = o + t_s[..., None] * d
        N_s = P_s - scene.spheres.center
        N_s = N_s / _norm(N_s)
        rgb_s = _shade_all(P_s, N_s, scene.spheres.albedo, scene, tau)
        if bounce_depth:
            rgb_s = rgb_s + refl * _mirror_bounce_rgb(P_s, N_s, ray_d, scene)
        parts_alpha.append(a_s)
        parts_t.append(t_s)
        parts_rgb.append(rgb_s)
    if scene.planes.count:
        a_p, t_p = _plane_cover(ray_o, ray_d, scene.planes.origin, scene.planes.normal)
        P_p = o + t_p[..., None] * d
        N_p = scene.planes.normal.expand(P_p.shape)
        rgb_p = _shade_all(P_p, N_p, scene.planes.albedo, scene, tau)
        if bounce_depth:
            rgb_p = rgb_p + refl * _mirror_bounce_rgb(P_p, N_p, ray_d, scene)
        parts_alpha.append(a_p)
        parts_t.append(t_p)
        parts_rgb.append(rgb_p)
    if not parts_alpha:
        return torch.zeros(torch.broadcast_shapes(ray_o.shape, ray_d.shape),
                           dtype=ray_d.dtype, device=ray_d.device)
    alpha = torch.cat(parts_alpha, dim=-1)                 # (..., K)
    t = torch.cat(parts_t, dim=-1)
    # (..., K, 3); without lights the ambient term has no batch axes yet
    rgb = torch.cat([c.expand(*a.shape, 3) for a, c in zip(parts_alpha, parts_rgb)], dim=-2)

    # Front-to-back compositing in depth order: w_i = alpha_i * prod_closer(1 - a).
    order = torch.argsort(t, dim=-1, stable=True)
    a_sorted = torch.gather(alpha, -1, order)
    rgb_sorted = torch.gather(rgb, -2, order[..., None].expand(rgb.shape))
    trans = torch.cumprod(1.0 - a_sorted, dim=-1)
    trans_excl = torch.cat([torch.ones_like(trans[..., :1]), trans[..., :-1]], dim=-1)
    w = a_sorted * trans_excl
    return (w[..., None] * rgb_sorted).sum(dim=-2)


def _rows(xs, ys, camera, scene, tau, bounce_depth):
    gx, gy = torch.meshgrid(xs, ys, indexing="ij")
    d = camera.ray_directions(torch.stack([gx, gy], dim=-1), compat=False)
    o = camera.ray_origin().expand(d.shape)
    return render_rays_soft(o, d, scene, tau=tau, bounce_depth=bounce_depth)


def render_image_soft(camera, scene, *, tau: float = 0.05, row_chunk: int | None = None,
                      bounce_depth: int = 0, x_offset: int = 0,
                      local_width: int | None = None) -> torch.Tensor:
    """Full-image soft render -> float ``(w, h, 3)``, clean orientation and
    channels; with ``x_offset`` / ``local_width`` the ``(local_width, h, 3)``
    slice of it at those columns. ``row_chunk`` renders blocks of that many x
    columns at a time (the last block may be shorter); when autograd records
    the call, each block is checkpointed and recomputed in the backward pass,
    so peak memory is one block's intermediates."""
    w, h = camera.resolution
    dev = camera.device
    w = w - x_offset if local_width is None else local_width
    xs = torch.arange(x_offset, x_offset + w, dtype=torch.float32, device=dev)
    ys = torch.arange(h, dtype=torch.float32, device=dev)
    if row_chunk is None or row_chunk >= w:
        return _rows(xs, ys, camera, scene, tau, bounce_depth)
    leaves = [camera.position, camera.rotation, camera.fov, *scene.leaves()]
    remat = torch.is_grad_enabled() and any(t.requires_grad for t in leaves)
    blocks = []
    for xb in torch.split(xs, row_chunk):
        if remat:
            blocks.append(checkpoint(_rows, xb, ys, camera, scene, tau, bounce_depth,
                                     use_reentrant=False))
        else:
            blocks.append(_rows(xb, ys, camera, scene, tau, bounce_depth))
    return torch.cat(blocks)


def row_chunk_for(resolution, scene, budget_bytes: float = 1 << 30) -> int | None:
    """Columns a :func:`render_image_soft` block may hold so that its largest
    intermediate, ``f32[rows, h, K, nl, ns, 3]`` (the shadow covers), stays
    under ``budget_bytes``; None when the whole image fits."""
    w, h = resolution
    ns, nl = scene.spheres.count, scene.lights.count
    k = ns + scene.planes.count
    per_col = 4 * 3 * h * max(k, 1) * (max(ns, 1) * max(nl, 1) + k)
    rows = max(1, int(budget_bytes // per_col))
    return None if rows >= w else rows
