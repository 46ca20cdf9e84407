"""Pinhole cameras of many frames: the port's ``models/camera.py`` grid and ray
generation (frozen at fa8828e), batched over a leading frame axis and computed
in the dtype of the camera's tensors."""
from __future__ import annotations

import dataclasses
from typing import Tuple

import torch


@dataclasses.dataclass
class Camera:
    """``position (..., 3)``, ``rotation (..., 3, 3)`` (world from camera),
    ``fov (...)`` in degrees; the leading axes are frames (none for one
    camera). ``resolution`` is ``(w, h)``."""

    position: torch.Tensor
    rotation: torch.Tensor
    fov: torch.Tensor
    resolution: Tuple[int, int]

    @property
    def device(self) -> torch.device:
        return self.position.device

    @property
    def dtype(self) -> torch.dtype:
        return self.position.dtype

    def grid_params(self, compat: bool = True):
        """``(focal, y0, dy, z0, dz)``: pixel ``(x, y)`` maps to ``(focal, y0 +
        x dy, z0 + y dz)`` (reference ``np.mgrid[AR:-AR:wj, 1:-1:hj]``)."""
        w, h = self.resolution
        ar = float(int(w / h)) if compat else float(w) / float(h)

        def t(v):
            return torch.tensor(v, dtype=self.dtype, device=self.device)
        focal = 1.0 / torch.tan(torch.deg2rad(self.fov) / 2.0)
        dy = t(-2.0 * ar / (w - 1)) if w > 1 else t(0.0)
        dz = t(-2.0 / (h - 1)) if h > 1 else t(0.0)
        return focal, t(ar), dy, t(1.0), dz

    def ray_origin(self) -> torch.Tensor:
        return self.position

    def ray_directions(self, pixel_xy: torch.Tensor, compat: bool = True) -> torch.Tensor:
        """Unit directions for fractional pixel coordinates ``(*frames, ...,
        2)``: the camera's frame axes lead, any axes between them and the last
        are the frame's samples."""
        focal, y0, dy, z0, dz = self.grid_params(compat)
        extra = pixel_xy.dim() - 1 - self.fov.dim()
        focal = focal.reshape(focal.shape + (1,) * extra)
        rot = self.rotation.reshape(self.rotation.shape[:-2] + (1,) * extra + (3, 3))
        px, py = pixel_xy[..., 0], pixel_xy[..., 1]
        p = torch.stack([focal.expand(px.shape), y0 + px * dy, z0 + py * dz], dim=-1)
        rp = rot * p[..., None, :]
        d = (rp[..., 0] + rp[..., 1]) + rp[..., 2]
        n = torch.sqrt(((d[..., 0:1] * d[..., 0:1] + d[..., 1:2] * d[..., 1:2])
                        + d[..., 2:3] * d[..., 2:3]))
        return d / n

    def origins(self, like: torch.Tensor) -> torch.Tensor:
        """The eye point of each frame, broadcast to ``like``'s ``(..., 3)``."""
        extra = like.dim() - self.position.dim()
        pos = self.position.reshape(self.position.shape[:-1] + (1,) * extra + (3,))
        return pos.expand(like.shape)

    def to(self, device=None, dtype=None) -> "Camera":
        return Camera(self.position.to(device=device, dtype=dtype),
                      self.rotation.to(device=device, dtype=dtype),
                      self.fov.to(device=device, dtype=dtype), self.resolution)
