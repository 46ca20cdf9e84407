"""Scene representation as dataclasses of float32 tensors.

PyTorch counterpart of ``python_ray_tracer_tpu/models/scene.py``. The scene is a
structure of arrays (``Spheres.center`` is ``(N, 3)``, ``Spheres.radius`` is
``(N,)`` ...), so every intersection sweep is a batched reduction over the object
axis. Colors are given in the reference's 0-255 range and kept as albedo in
[0, 1]; :meth:`Scene.to_soa` scales them back to 0-255 for the reference's
``(7,N)/(3,L)/(9,M)`` packed layout.
"""
from __future__ import annotations

import dataclasses
from typing import List, Sequence, Tuple, Union

import numpy as np
import torch

from ..utils import prng
from ..utils.config import resolve_device

# Typing aliases (reference scene/common.py:5-6).
Vector3D = Union[torch.Tensor, np.ndarray, list, Tuple[float, float, float]]
Color = Union[List[int], Tuple[int, int, int], Sequence[float]]

# Named colors (0-255 ints), reference scene/colors.py:1-6.
RED = (255, 70, 70)
GREEN = (70, 255, 70)
BLUE = (70, 70, 255)
YELLOW = (255, 255, 70)
GREY = (125, 125, 125)
MAGENTA = (139, 0, 139)


def _f32(x, device) -> torch.Tensor:
    if isinstance(x, torch.Tensor):
        return x.to(device=device, dtype=torch.float32)
    return torch.as_tensor(np.asarray(x, np.float32), device=device)


@dataclasses.dataclass
class Spheres:
    """Batch of spheres: ``center (N,3)``, ``radius (N,)``, ``albedo (N,3)`` in [0,1]."""

    center: torch.Tensor
    radius: torch.Tensor
    albedo: torch.Tensor

    @staticmethod
    def build(items: Sequence[tuple], device=None) -> "Spheres":
        """Build from ``[(origin, radius, color255), ...]``. Empty list is allowed.
        ``device``: None is the card (``utils.config.resolve_device``)."""
        device = resolve_device(device)
        if len(items) == 0:
            return Spheres(torch.zeros((0, 3), device=device),
                           torch.zeros((0,), device=device),
                           torch.zeros((0, 3), device=device))
        return Spheres(_f32([it[0] for it in items], device),
                       _f32([it[1] for it in items], device),
                       _f32([it[2] for it in items], device) / 255.0)

    @property
    def count(self) -> int:
        return self.center.shape[0]


@dataclasses.dataclass
class Planes:
    """Batch of infinite planes: ``origin (M,3)``, unit ``normal (M,3)``, ``albedo (M,3)``."""

    origin: torch.Tensor
    normal: torch.Tensor
    albedo: torch.Tensor

    @staticmethod
    def build(items: Sequence[tuple], device=None) -> "Planes":
        device = resolve_device(device)
        if len(items) == 0:
            z3 = torch.zeros((0, 3), device=device)
            return Planes(z3, z3.clone(), z3.clone())
        normals = _f32([it[1] for it in items], device)
        # Normalized at build time, as the reference does (scene.py:50).
        normals = normals / torch.linalg.norm(normals, dim=-1, keepdim=True)
        return Planes(_f32([it[0] for it in items], device), normals,
                      _f32([it[2] for it in items], device) / 255.0)

    @property
    def count(self) -> int:
        return self.origin.shape[0]


@dataclasses.dataclass
class Lights:
    """Batch of point lights: ``position (L,3)``."""

    position: torch.Tensor

    @staticmethod
    def build(positions: Sequence, device=None) -> "Lights":
        device = resolve_device(device)
        if len(positions) == 0:
            return Lights(torch.zeros((0, 3), device=device))
        return Lights(_f32(positions, device))

    @property
    def count(self) -> int:
        return self.position.shape[0]


@dataclasses.dataclass
class Materials:
    """Global shading coefficients as 0-d tensors. ``ambient``, ``lambert`` and
    ``reflection`` are the reference main.py's ``amb, lamb, refl``;
    ``specular``/``shininess`` drive the clean-mode Phong highlight."""

    ambient: torch.Tensor
    lambert: torch.Tensor
    reflection: torch.Tensor
    specular: torch.Tensor
    shininess: torch.Tensor

    @staticmethod
    def build(ambient=0.0, lambert=0.6, reflection=0.3, specular=0.0,
              shininess=32.0, device=None) -> "Materials":
        device = resolve_device(device)
        return Materials(*(_f32(v, device) for v in
                           (ambient, lambert, reflection, specular, shininess)))


# Paths of a Scene's 12 tensors in dataclass order: the JAX Scene pytree's
# leaf order and the order of Scene.leaves().
LEAF_PATHS = ("spheres.center", "spheres.radius", "spheres.albedo",
              "planes.origin", "planes.normal", "planes.albedo",
              "lights.position", "materials.ambient", "materials.lambert",
              "materials.reflection", "materials.specular", "materials.shininess")


@dataclasses.dataclass
class Scene:
    spheres: Spheres
    planes: Planes
    lights: Lights
    materials: Materials

    @property
    def device(self) -> torch.device:
        return self.materials.ambient.device

    def leaves(self) -> List[torch.Tensor]:
        """The 12 tensors in :data:`LEAF_PATHS` order."""
        return [t for grp in (self.spheres, self.planes, self.lights, self.materials)
                for t in vars(grp).values()]

    @staticmethod
    def from_leaves(t: Sequence[torch.Tensor]) -> "Scene":
        """Inverse of :meth:`leaves`."""
        return Scene(Spheres(*t[0:3]), Planes(*t[3:6]), Lights(t[6]), Materials(*t[7:12]))

    def to_soa(self):
        """Pack to the reference's column-major SoA float32 numpy arrays:
        ``(spheres (7,N), lights (3,L), planes (9,M))``, albedo in 0-255."""
        def np32(t):
            return t.detach().cpu().numpy().astype(np.float32)
        sp = np.zeros((7, self.spheres.count), np.float32)
        sp[0:3] = np32(self.spheres.center).T
        sp[3] = np32(self.spheres.radius)
        sp[4:7] = np32(self.spheres.albedo).T * np.float32(255.0)
        li = np32(self.lights.position).T.copy()
        pl = np.zeros((9, self.planes.count), np.float32)
        pl[0:3] = np32(self.planes.origin).T
        pl[3:6] = np32(self.planes.normal).T
        pl[6:9] = np32(self.planes.albedo).T * np.float32(255.0)
        return sp, li, pl

    @staticmethod
    def from_soa(spheres, lights, planes, materials: Materials | None = None,
                 device=None) -> "Scene":
        """Inverse of :meth:`to_soa`; accepts reference-layout arrays."""
        device = resolve_device(device)
        spheres, lights, planes = (np.asarray(a, np.float32)
                                   for a in (spheres, lights, planes))
        sph = Spheres(_f32(spheres[0:3].T, device), _f32(spheres[3], device),
                      _f32(spheres[4:7].T, device) / 255.0)
        pln = Planes(_f32(planes[0:3].T, device), _f32(planes[3:6].T, device),
                     _f32(planes[6:9].T, device) / 255.0)
        lts = Lights(_f32(lights.T, device))
        return Scene(sph, pln, lts, materials or Materials.build(device=device))


def default_scene(materials: Materials | None = None, device=None) -> Scene:
    """The reference demo scene: 3 lights, 6 spheres, 1 grey ground plane
    (reference scene.py:100-115)."""
    device = resolve_device(device)
    lights = Lights.build([[2.5, -2.0, 3.0], [2.5, 2.0, 3.0], [5.0, 0.1, 6.0]],
                          device)
    spheres = Spheres.build([
        ([2.2, 0.3, 1.0], 1.0, RED),
        ([0.6, 0.7, 0.4], 0.4, BLUE),
        ([0.6, -0.8, 0.5], 0.5, YELLOW),
        ([-1.2, 0.2, 0.5], 0.5, MAGENTA),
        ([-1.7, -0.5, 0.3], 0.3, GREEN),
        ([-2.0, 1.31, 1.3], 1.3, RED),
    ], device)
    planes = Planes.build([([5, 0, 0], [0, 0, 1], GREY)], device)
    return Scene(spheres, planes, lights,
                 materials or Materials.build(device=device))


def random_scene(n_spheres: int = 100, n_lights: int = 3,
                 materials: Materials | None = None, *, key=0,
                 generator: torch.Generator | None = None,
                 device=None) -> Scene:
    """Procedural N-sphere scene for scaling runs: the JAX package's
    ``random_scene(jax.random.key(key), n_spheres, n_lights, materials)`` bit
    for bit. ``key`` is an int seed, as ``jax.random.key(seed)``, or ``(2,)``
    key data; the draws are made on the host (:mod:`..utils.prng`) and moved
    to ``device`` as float32. At most 3 lights, as in the JAX package.

    An explicit ``generator`` draws instead from ``torch.rand`` on it, the
    port's own stream for its tests (``key`` is then unused)."""
    device = resolve_device(device)
    keys = iter(prng.split(key, 5))
    def uniform(shape, lo, hi):
        k = next(keys)
        if generator is not None:
            return lo + (hi - lo) * torch.rand(shape, generator=generator)
        return torch.from_numpy(prng.uniform(k, shape, lo, hi))
    centers = torch.stack([uniform((n_spheres,), -8.0, 8.0),
                           uniform((n_spheres,), -8.0, 8.0),
                           uniform((n_spheres,), 0.2, 4.0)], dim=-1)
    spheres = Spheres(centers.to(device), uniform((n_spheres,), 0.15, 0.8).to(device),
                      uniform((n_spheres, 3), 0.2, 1.0).to(device))
    planes = Planes.build([([5, 0, 0], [0, 0, 1], GREY)], device)
    lpos = _f32([[2.5, -2.0, 6.0], [2.5, 2.0, 6.0], [5.0, 0.1, 9.0]], device)
    return Scene(spheres, planes, Lights(lpos[:n_lights]),
                 materials or Materials.build(device=device))
