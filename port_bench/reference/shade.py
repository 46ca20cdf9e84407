# Frozen copy of python_ray_tracer_tpu_torch/ops/shade.py at commit
# fa8828e2546d4fbea5df42a59f967d164dc1f66a. Changed: the bounce weight of sample() takes the
# dtype of the colours, so that the whole chain computes in the inputs' dtype.
"""Shading core in plain PyTorch: closest-hit shading, shadows, Lambert, Phong,
mirror bounces.

Counterpart of ``python_ray_tracer_tpu/ops/shade.py``. Every function works on an
arbitrary ray batch; hit/miss, shadow and back-facing decisions are boolean masks,
and the reference's recursive mirror reflection (trace.py:115-133) is a
fixed-depth loop carrying ``(rgb, origin, direction, alive)``.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from .intersect import _dot, any_hit, closest_hit

BIAS = 2e-4  # shadow/mirror acne offset, reference trace.py:82


def _normalize(v: torch.Tensor) -> torch.Tensor:
    n2 = _dot(v, v)[..., None]
    return v / torch.sqrt(torch.where(n2 > 0, n2, torch.ones_like(n2)))


def reflect(d: torch.Tensor, n: torch.Tensor) -> torch.Tensor:
    """Unit mirror reflection of ``d`` about unit normal ``n`` (reference
    common.py:114-120, which also renormalizes)."""
    return _normalize(d - 2.0 * _dot(d, n)[..., None] * n)


class TraceState(NamedTuple):
    rgb: torch.Tensor        # (..., 3) color of this trace, [0,1] scale
    point: torch.Tensor      # (..., 3) biased hit point (next bounce origin)
    direction: torch.Tensor  # (..., 3) unit reflection direction
    alive: torch.Tensor      # (...,)   ray hit something this trace


def _surface_attributes(P, hits, scene):
    """Albedo and unit normal of the hit object for every ray (masked gathers
    over the concatenated [spheres ++ planes] axis)."""
    n_sph, n_pln = scene.spheres.count, scene.planes.count
    obj, is_plane = hits["obj"], hits["is_plane"]
    if n_sph and n_pln:
        albedo = torch.cat([scene.spheres.albedo, scene.planes.albedo])[obj]
        n_sphere = _normalize(P - scene.spheres.center[torch.clamp(obj, max=n_sph - 1)])
        n_plane = scene.planes.normal[torch.clamp(obj - n_sph, 0, n_pln - 1)]
        normal = torch.where(is_plane[..., None], n_plane, n_sphere)
    elif n_sph:
        albedo = scene.spheres.albedo[obj]
        normal = _normalize(P - scene.spheres.center[obj])
    else:
        albedo = scene.planes.albedo[obj]
        normal = scene.planes.normal[obj]
    return albedo, normal


def trace_once(ray_o, ray_d, scene, *, compat: bool = True) -> TraceState:
    """One shading evaluation (reference ``trace``, trace.py:45-112), batched.
    Dead lanes carry zero rgb and unspecified point/direction."""
    if scene.spheres.count == 0 and scene.planes.count == 0:
        shape = torch.broadcast_shapes(ray_o.shape, ray_d.shape)
        return TraceState(rgb=torch.zeros(shape, device=ray_d.device),
                          point=ray_o.expand(shape), direction=ray_d.expand(shape),
                          alive=torch.zeros(shape[:-1], dtype=torch.bool,
                                            device=ray_d.device))
    m = scene.materials
    hits = closest_hit(ray_o, ray_d, scene, compat=compat)
    alive = hits["hit"]
    P = ray_o + torch.where(alive, hits["t"], torch.zeros_like(hits["t"]))[..., None] * ray_d
    albedo, N = _surface_attributes(P, hits, scene)

    rgb = m.ambient * albedo                              # trace.py:77
    # Shadow rays + Lambert per light, from the normal-biased point (trace.py:79-102).
    Pb = P + BIAS * N
    if scene.lights.count:
        L = _normalize(scene.lights.position - Pb[..., None, :])       # (..., L, 3)
        occluded = any_hit(Pb[..., None, :], L, scene, compat=compat)  # (..., L)
        lam = m.lambert * _dot(L, N[..., None, :])                     # (..., L)
        lam = torch.where(~occluded & (lam > 0.0), lam, torch.zeros_like(lam))
        rgb = rgb + lam.sum(dim=-1)[..., None] * albedo
        if not compat:
            # Clean-mode Phong highlight, shadow-masked; pow as a masked
            # exp(s*log(x)) so masked lanes never see log(0).
            R = reflect(ray_d, N)
            spec = _dot(L, R[..., None, :])
            smask = ~occluded & (spec > 0.0)
            s_safe = torch.where(smask, spec, torch.ones_like(spec))
            p = torch.where(smask, torch.exp(m.shininess * torch.log(s_safe)),
                            torch.zeros_like(spec))
            rgb = rgb + (m.specular * p.sum(dim=-1))[..., None]

    # Mirror direction + acne bias along it (trace.py:104-110).
    R = reflect(ray_d, N)
    Pb = Pb + BIAS * R
    rgb = torch.where(alive[..., None], rgb, torch.zeros_like(rgb))
    return TraceState(rgb=rgb, point=Pb, direction=R, alive=alive)


def sample(ray_o, ray_d, scene, *, depth: int, compat: bool = True) -> torch.Tensor:
    """Primary trace + ``depth`` mirror bounces (reference ``sample``).

    Bounce ``i`` contributes ``reflection**(i+1) * rgb_i``, gated on the previous
    trace having hit; once dead, a ray stays dead."""
    refl = scene.materials.reflection
    st = trace_once(ray_o, ray_d, scene, compat=compat)
    rgb = st.rgb
    w = torch.ones((), dtype=rgb.dtype, device=rgb.device)
    for _ in range(depth):
        prev_alive = st.alive
        st = trace_once(st.point, st.direction, scene, compat=compat)
        w = w * refl
        rgb = rgb + (w * prev_alive.to(rgb.dtype))[..., None] * st.rgb
        st = st._replace(alive=st.alive & prev_alive)
    return rgb
