"""The scene as the reference reads it: the same structure of arrays as the
port's ``models/scene.py`` (``Spheres.center (N, 3)``, ...), built from the
arrays the benchmark makes and hands to both sides."""
from __future__ import annotations

import dataclasses
from typing import List, Sequence

import numpy as np
import torch


@dataclasses.dataclass
class Spheres:
    center: torch.Tensor
    radius: torch.Tensor
    albedo: torch.Tensor

    @property
    def count(self) -> int:
        return self.center.shape[0]


@dataclasses.dataclass
class Planes:
    origin: torch.Tensor
    normal: torch.Tensor
    albedo: torch.Tensor

    @property
    def count(self) -> int:
        return self.origin.shape[0]


@dataclasses.dataclass
class Lights:
    position: torch.Tensor

    @property
    def count(self) -> int:
        return self.position.shape[0]


@dataclasses.dataclass
class Materials:
    ambient: torch.Tensor
    lambert: torch.Tensor
    reflection: torch.Tensor
    specular: torch.Tensor
    shininess: torch.Tensor


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

    def leaves(self) -> List[torch.Tensor]:
        return [t for grp in (self.spheres, self.planes, self.lights, self.materials)
                for t in vars(grp).values()]

    @staticmethod
    def from_leaves(t: Sequence[torch.Tensor]) -> "Scene":
        return Scene(Spheres(*t[0:3]), Planes(*t[3:6]), Lights(t[6]), Materials(*t[7:12]))

    def to(self, device=None, dtype=None) -> "Scene":
        return Scene.from_leaves([x.to(device=device, dtype=dtype) for x in self.leaves()])


def from_arrays(arrays: dict, device, dtype=torch.float32) -> Scene:
    """A scene of the benchmark's numpy arrays (``port_bench.scenes``'s keys,
    in :data:`LEAF_PATHS` order)."""
    return Scene.from_leaves([torch.as_tensor(np.asarray(arrays[p]), device=device)
                              .to(dtype) for p in LEAF_PATHS])
