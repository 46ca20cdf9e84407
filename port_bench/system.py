"""The system under test: the port, ``python_ray_tracer_tpu_torch``.

:class:`Port` takes the benchmark's arrays into the port's dataclasses, and
names the backend and device; each traffic kind (``kinds/<kind>.py``) calls
the port's public entry points that it drives itself. ``backend="cuda"`` is
the benchmark's; ``"torch"`` (the port's plain path on the CPU) serves the
CPU tests of the harness, which plant faults in those calls. Besides the
kinds, only this module imports the port.
"""
from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from python_ray_tracer_tpu_torch.models.camera import Camera
from python_ray_tracer_tpu_torch.models.scene import LEAF_PATHS, Scene
from python_ray_tracer_tpu_torch.ops.cuda import (hit_extents_cuda, light_cells_cuda,
                                                  render_bwd_cuda, render_cuda,
                                                  shadow_lists_cuda, soft_bwd_cuda, soft_cuda)

# The port's launch counters, by the kernel whose records they count in a
# trace (the name the kernel has in csrc/).
COUNTERS = {
    "render_fwd_kernel": render_cuda.LAUNCHES,
    "soft_fwd_kernel": soft_cuda.LAUNCHES,
    "soft_bwd_kernel": soft_bwd_cuda.LAUNCHES,
    "render_bwd_kernel": render_bwd_cuda.LAUNCHES,
    "hit_extents_kernel": hit_extents_cuda.LAUNCHES,
    "light_cells_kernel": light_cells_cuda.LAUNCHES,
    "shadow_lists_kernel": shadow_lists_cuda.LAUNCHES,
}


def launch_counts() -> Dict[str, int]:
    """Launches so far of each counted kernel."""
    return {k: sum(c.values()) for k, c in COUNTERS.items()}


class Port:
    def __init__(self, backend: str = "cuda", device: str | None = None):
        self.backend = backend
        self.device = torch.device(device or ("cuda" if backend == "cuda" else "cpu"))

    def scene(self, arrays: dict) -> Scene:
        return Scene.from_leaves([torch.from_numpy(np.array(arrays[p])).to(self.device)
                                  for p in LEAF_PATHS])

    def cameras(self, position, rotation, fov, resolution) -> Camera:
        """A camera (or a stack of them, leading frame axis) of device tensors."""
        return Camera(position, rotation, fov, tuple(resolution))
