"""Pinhole camera: pose, Euler rotations, and analytic pixel-grid generation.

PyTorch counterpart of ``python_ray_tracer_tpu/models/camera.py``. Pixel ``(x, y)``
maps to camera-space ``(focal, y0 + x*dy, z0 + y*dz)``, a closed-form function of
the (fractional) pixel index, so AA half-offset samples need no stored grid.

Rotation convention: the reference's ``rotation_y`` is transposed
(``[[c,0,-s],[0,1,0],[s,0,c]]``, rotation.py:18-20); the default pose
``euler=[0,-30,0]`` depends on it. ``compat=True`` keeps the reference's
``AR = int(width / height)`` aspect-ratio truncation (camera.py:22).
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

import torch

from ..utils.config import resolve_device


def _stack3x3(rows) -> torch.Tensor:
    return torch.stack([torch.stack(r) for r in rows])


def rotation_x(phi: torch.Tensor) -> torch.Tensor:
    """Rotation about X by ``phi`` radians (reference rotation.py:4-11)."""
    c, s = torch.cos(phi), torch.sin(phi)
    o, z = torch.ones_like(c), torch.zeros_like(c)
    return _stack3x3([[o, z, z], [z, c, -s], [z, s, c]])


def rotation_y(theta: torch.Tensor) -> torch.Tensor:
    """Rotation about Y, *reference sign convention* (rotation.py:14-21)."""
    c, s = torch.cos(theta), torch.sin(theta)
    o, z = torch.ones_like(c), torch.zeros_like(c)
    return _stack3x3([[c, z, -s], [z, o, z], [s, z, c]])


def rotation_z(psi: torch.Tensor) -> torch.Tensor:
    """Rotation about Z by ``psi`` radians (reference rotation.py:24-31)."""
    c, s = torch.cos(psi), torch.sin(psi)
    o, z = torch.ones_like(c), torch.zeros_like(c)
    return _stack3x3([[c, -s, z], [s, c, z], [z, z, o]])


def _mm3(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """3x3 product as explicit f32 multiply-and-sum (no TF32 matmul path)."""
    return (a[:, 0, None] * b[0] + a[:, 1, None] * b[1]) + a[:, 2, None] * b[2]


def euler_rotation(roll, pitch, yaw, is_radians: bool = False,
                   device=None) -> torch.Tensor:
    """``Rz(yaw) @ Ry(pitch) @ Rx(roll)``, angles in degrees by default
    (reference rotation.py:34-43), on ``device`` (None: the card)."""
    device = resolve_device(device)
    ang = [torch.as_tensor(a, dtype=torch.float32, device=device)
           for a in (roll, pitch, yaw)]
    if not is_radians:
        ang = [torch.deg2rad(a) for a in ang]
    roll, pitch, yaw = ang
    return _mm3(rotation_z(yaw), _mm3(rotation_y(pitch), rotation_x(roll)))


@dataclasses.dataclass
class Camera:
    """Pinhole camera: ``rotation`` is the 3x3 world-from-camera matrix,
    ``position`` the eye point, ``fov`` the full horizontal field of view in
    degrees. ``resolution`` is ``(w, h)``."""

    position: torch.Tensor
    rotation: torch.Tensor
    fov: torch.Tensor
    resolution: Tuple[int, int] = (256, 256)

    @staticmethod
    def build(resolution: Tuple[int, int], position, euler, fov: float = 45.0,
              device=None) -> "Camera":
        # The pose is computed on the CPU and then moved to the device (None:
        # the card), so a camera has the same bits on every device (device
        # trig may differ in the last ulp).
        device = resolve_device(device)
        return Camera(
            position=torch.as_tensor(position, dtype=torch.float32).to(device),
            rotation=euler_rotation(euler[0], euler[1], euler[2], device="cpu").to(device),
            fov=torch.as_tensor(fov, dtype=torch.float32).to(device),
            resolution=tuple(int(v) for v in resolution))

    @property
    def device(self) -> torch.device:
        return self.position.device

    def to(self, device) -> "Camera":
        return Camera(self.position.to(device), self.rotation.to(device),
                      self.fov.to(device), self.resolution)

    def grid_params(self, compat: bool = True):
        """Closed-form pixel-grid coefficients ``(focal, y0, dy, z0, dz)`` as f32
        0-d tensors: pixel ``(x, y)`` maps to ``(focal, y0 + x*dy, z0 + y*dz)``
        (reference ``np.mgrid[AR:-AR:wj, 1:-1:hj]``, camera.py:23)."""
        w, h = self.resolution
        ar = float(int(w / h)) if compat else float(w) / float(h)
        dev = self.fov.device

        def f32(v):
            return torch.tensor(v, dtype=torch.float32, device=dev)
        focal = 1.0 / torch.tan(torch.deg2rad(self.fov) / 2.0)
        dy = f32(-2.0 * ar / (w - 1)) if w > 1 else f32(0.0)
        dz = f32(-2.0 / (h - 1)) if h > 1 else f32(0.0)
        return focal.to(torch.float32), f32(ar), dy, f32(1.0), dz

    def pixel_locations(self, compat: bool = True) -> torch.Tensor:
        """Dense ``(3, w, h)`` image-plane grid (reference camera.py:18-26 layout)."""
        w, h = self.resolution
        focal, y0, dy, z0, dz = self.grid_params(compat)
        dev = self.fov.device
        xs = torch.arange(w, dtype=torch.float32, device=dev)
        ys = torch.arange(h, dtype=torch.float32, device=dev)
        return torch.stack([focal.expand(w, h), (y0 + xs * dy)[:, None].expand(w, h),
                            (z0 + ys * dz)[None, :].expand(w, h)])

    def ray_origin(self) -> torch.Tensor:
        return self.position

    def ray_directions(self, pixel_xy: torch.Tensor,
                       compat: bool = True) -> torch.Tensor:
        """Unit world-space ray directions for fractional pixel coords ``(..., 2)``."""
        focal, y0, dy, z0, dz = self.grid_params(compat)
        px, py = pixel_xy[..., 0], pixel_xy[..., 1]
        p = torch.stack([focal.expand(px.shape), y0 + px * dy, z0 + py * dz],
                        dim=-1)
        # R @ p as an explicit multiply-and-sum, not a matmul.
        rp = self.rotation * p[..., None, :]
        d = (rp[..., 0] + rp[..., 1]) + rp[..., 2]
        n = torch.sqrt(((d[..., 0:1] * d[..., 0:1] + d[..., 1:2] * d[..., 1:2])
                        + d[..., 2:3] * d[..., 2:3]))
        return d / n


def default_camera(resolution: Tuple[int, int] = (1000, 1000),
                   device=None) -> Camera:
    """The reference's camera (main.py:24), on ``device`` (None: the card)."""
    return Camera.build(resolution, position=[-2.0, 0.0, 2.0],
                        euler=[0.0, -30.0, 0.0], device=device)
