"""Batched ray/primitive intersection in plain PyTorch.

Counterpart of ``python_ray_tracer_tpu/ops/intersect.py``: distances to every
object are computed as broadcast arithmetic over an ``(..., N_obj)`` axis and the
closest hit is an ``argmin`` reduction. Misses are boolean masks.

Compat semantics kept exactly:
  * far clip: hits count only if ``0 < t < 999`` (reference trace.py:17, 26, 36);
  * plane parallel threshold ``|d . n| < 1e-3`` (intersections.py:46, 55);
  * nearest *positive* quadratic root (intersections.py:28-38);
  * tie-break: spheres before planes, lower index first (``argmin`` returns the
    first occurrence, matching the reference's strict ``<``).
"""
from __future__ import annotations

import torch

FAR = 999.0   # reference init distance, trace.py:17
BIG = 1e30    # internal "no hit" distance


def _dot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Dot product over the last (xyz) axis, summed left to right."""
    return (a[..., 0] * b[..., 0] + a[..., 1] * b[..., 1]) + a[..., 2] * b[..., 2]


def _safe_div(num, den, eps=1e-30):
    return num / torch.where(torch.abs(den) > eps, den, torch.ones_like(den))


def _big_like(t: torch.Tensor) -> torch.Tensor:
    return torch.full_like(t, BIG)


def intersect_spheres(ray_o, ray_d, center, radius, *, compat: bool = True):
    """Distances from rays ``(..., 3)`` to spheres ``center (N,3)``, ``radius (N,)``.

    Returns ``(t, valid)`` of shape ``(..., N)``; ``t`` is ``BIG`` where invalid.
    ``compat`` renormalizes the direction as the reference does
    (intersections.py:14)."""
    if compat:
        ray_d = ray_d / torch.sqrt(_dot(ray_d, ray_d))[..., None]
    L = ray_o[..., None, :] - center                      # (..., N, 3)
    a = _dot(ray_d, ray_d)[..., None]                     # (..., 1)
    b = 2.0 * _dot(L, ray_d[..., None, :])                # (..., N)
    c = _dot(L, L) - radius * radius                      # (..., N)
    disc = b * b - 4.0 * a * c
    has_root = disc >= 0.0
    # The root is taken only where disc > 0 (it is 0 at disc == 0 either way):
    # sqrt's derivative is infinite at 0, so a ray with disc == 0 exactly in
    # float32 would turn its zero cotangent into NaN.
    pos = disc > 0.0
    sq = torch.where(pos, torch.sqrt(torch.where(pos, disc, torch.ones_like(disc))),
                     torch.zeros_like(disc))
    inv2a = _safe_div(torch.ones_like(a), 2.0 * a)
    t_near = (-b - sq) * inv2a
    t_far = (-b + sq) * inv2a
    near_pos = (-b - sq) > 0.0
    far_pos = (-b + sq) > 0.0
    t = torch.where(near_pos, t_near, t_far)
    valid = has_root & (near_pos | far_pos)
    return torch.where(valid, t, _big_like(t)), valid


def intersect_planes(ray_o, ray_d, origin, normal, *, compat: bool = True):
    """Distances from rays to planes ``origin (M,3)``, unit ``normal (M,3)``.
    Parallel threshold 1e-3 in compat mode, 1e-8 otherwise."""
    eps = 1e-3 if compat else 1e-8
    denom = _dot(ray_d[..., None, :], normal)             # (..., M)
    not_parallel = torch.abs(denom) >= eps
    lp = origin - ray_o[..., None, :]                     # (..., M, 3)
    t = _safe_div(_dot(lp, normal), denom)
    valid = not_parallel & (t > 0.0)
    return torch.where(valid, t, _big_like(t)), valid


def _all_t(ray_o, ray_d, scene, compat):
    ts, _ = intersect_spheres(ray_o, ray_d, scene.spheres.center,
                              scene.spheres.radius, compat=compat)
    tp, _ = intersect_planes(ray_o, ray_d, scene.planes.origin,
                             scene.planes.normal, compat=compat)
    t_all = torch.cat([ts, tp], dim=-1)
    if compat:
        # Far-clip quirk: a hit at t >= 999.0 is a miss (trace.py:17, 26).
        t_all = torch.where(t_all < FAR, t_all, _big_like(t_all))
    return t_all, ts.shape[-1]


def closest_hit(ray_o, ray_d, scene, *, compat: bool = True):
    """Closest hit over the whole scene (reference ``get_intersection``).

    Returns a dict with ``t``, ``hit``, ``obj`` (index into the concatenated
    [spheres ++ planes] axis) and ``is_plane``, each of the batch shape."""
    batch = torch.broadcast_shapes(ray_o.shape[:-1], ray_d.shape[:-1])
    dev = ray_d.device
    if scene.spheres.count == 0 and scene.planes.count == 0:
        return dict(t=torch.full(batch, BIG, device=dev),
                    hit=torch.zeros(batch, dtype=torch.bool, device=dev),
                    obj=torch.zeros(batch, dtype=torch.long, device=dev),
                    is_plane=torch.zeros(batch, dtype=torch.bool, device=dev))
    t_all, n_sph = _all_t(ray_o, ray_d, scene, compat)
    t = torch.amin(t_all, dim=-1)
    obj = torch.argmin(t_all, dim=-1)
    return dict(t=t, hit=t < BIG, obj=obj, is_plane=obj >= n_sph)


def any_hit(ray_o, ray_d, scene, *, compat: bool = True):
    """Occlusion query for shadow rays: a full closest-hit with no maximum
    distance (reference trace.py:92-96), subject to the same far clip."""
    batch = torch.broadcast_shapes(ray_o.shape[:-1], ray_d.shape[:-1])
    if scene.spheres.count == 0 and scene.planes.count == 0:
        return torch.zeros(batch, dtype=torch.bool, device=ray_d.device)
    t_all, _ = _all_t(ray_o, ray_d, scene, compat)
    return torch.amin(t_all, dim=-1) < BIG
