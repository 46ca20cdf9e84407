"""The inputs the benchmark makes and hands to both sides: the scene's arrays
from a configuration file, and camera poses. Float32 numpy throughout; the
same arrays become the port's dataclasses (``system``) and the reference's
(``reference.scene``)."""
from __future__ import annotations

import math

import numpy as np

from .frozen import prng


def _f32(x) -> np.ndarray:
    return np.asarray(x, dtype=np.float32)


def _draw_spheres(spec: dict) -> tuple:
    """The sphere cloud of ``random_scene(count, key=key)``: the JAX package's
    draw from ``jax.random.key(key)``, by the frozen stream."""
    n = int(spec["count"])
    keys = iter(prng.split(int(spec["key"]), 5))
    lo, hi = spec["center_lo"], spec["center_hi"]
    center = np.stack([prng.uniform(next(keys), (n,), lo[i], hi[i]) for i in range(3)],
                      axis=-1)
    radius = prng.uniform(next(keys), (n,), *spec["radius"])
    albedo = prng.uniform(next(keys), (n, 3), *spec["albedo"])
    return center, radius, albedo


def scene_arrays(config: dict) -> dict:
    """The scene of a configuration as float32 arrays, keyed by leaf path.
    Colours given in 0-255 become albedo in [0, 1]; plane normals are made
    unit length, as the port's constructors make them."""
    sc = config["scene"]
    if "sphere_cloud" in sc:
        center, radius, albedo = _draw_spheres(sc["sphere_cloud"])
    else:
        sp = sc["spheres"]
        center = _f32([s["center"] for s in sp]).reshape(-1, 3)
        radius = _f32([s["radius"] for s in sp])
        albedo = _f32([s["color"] for s in sp]).reshape(-1, 3) / np.float32(255.0)
    pl = sc["planes"]
    normal = _f32([p["normal"] for p in pl]).reshape(-1, 3)
    normal = normal / np.sqrt((normal * normal).sum(axis=-1, keepdims=True))
    m = sc["materials"]
    return {
        "spheres.center": _f32(center), "spheres.radius": _f32(radius),
        "spheres.albedo": _f32(albedo),
        "planes.origin": _f32([p["origin"] for p in pl]).reshape(-1, 3),
        "planes.normal": _f32(normal),
        "planes.albedo": _f32([p["color"] for p in pl]).reshape(-1, 3) / np.float32(255.0),
        "lights.position": _f32(sc["lights"]).reshape(-1, 3),
        "materials.ambient": _f32(m["ambient"]), "materials.lambert": _f32(m["lambert"]),
        "materials.reflection": _f32(m["reflection"]),
        "materials.specular": _f32(m["specular"]), "materials.shininess": _f32(m["shininess"]),
    }


def euler_rotation(roll: float, pitch: float, yaw) -> np.ndarray:
    """``Rz(yaw) Ry(pitch) Rx(roll)``, angles in degrees, with the reference
    renderer's transposed ``Ry`` (``[[c, 0, -s], [0, 1, 0], [s, 0, c]]``),
    worked out in float64 and rounded once to float32: ``(3, 3)``, or
    ``(..., 3, 3)`` for an array of yaws."""
    r, p = math.radians(roll), math.radians(pitch)
    y = np.radians(np.asarray(yaw, np.float64))
    cy, sy, z, o = np.cos(y), np.sin(y), np.zeros_like(y), np.ones_like(y)
    rz = np.stack([np.stack([cy, -sy, z], -1), np.stack([sy, cy, z], -1),
                   np.stack([z, z, o], -1)], -2)
    ry = np.array([[math.cos(p), 0, -math.sin(p)], [0, 1, 0], [math.sin(p), 0, math.cos(p)]])
    rx = np.array([[1, 0, 0], [0, math.cos(r), -math.sin(r)], [0, math.sin(r), math.cos(r)]])
    return (rz @ ry @ rx).astype(np.float32)


def rng(seed: int, *stream: int) -> np.random.Generator:
    """A numpy generator of ``seed`` (any whole number) and a stream label."""
    return np.random.default_rng([int(seed) & (2 ** 64 - 1), *stream])
