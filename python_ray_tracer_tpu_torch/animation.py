"""Multi-frame rendering along a camera trajectory (``animation.py`` of the JAX
package).

:func:`orbit_cameras` stacks the cameras of a circle around the scene,
:func:`render_frames` renders them, and :func:`save_animation` writes an
animated GIF. On the ``"cuda"`` backend every frame is one launch of the
render kernel (``render_cuda``) on the current stream: every frame's
parameters are packed on the host and copied in one transfer before the first
launch, so no launch waits on the host. (The JAX package's
``frames_per_launch`` sets how many frames one compiled program holds; a
launch here is one frame whatever the block, so the port has no such option.)
"""
from __future__ import annotations

import math
from typing import Sequence, Tuple

import numpy as np
import torch

from .models.camera import Camera, euler_rotation
from .models.scene import Scene
from .ops.cuda import render_cuda
from .ops.render import render_image, to_framebuffer
from .utils.config import require_cuda, resolve_backend, resolve_device
from .utils.image import encode_gif, framebuffer_to_array


def stack_cameras(cameras: Sequence[Camera]) -> Camera:
    """Stack same-resolution cameras leaf-wise into one camera whose tensors
    have a leading frame axis."""
    if not cameras:
        raise ValueError("stack_cameras needs at least one camera "
                         "(cli animate: --frames must be >= 1)")
    res = cameras[0].resolution
    if any(c.resolution != res for c in cameras):
        raise ValueError("stack_cameras: resolutions must match")
    return Camera(torch.stack([c.position for c in cameras]),
                  torch.stack([c.rotation for c in cameras]),
                  torch.stack([c.fov for c in cameras]), res)


def orbit_cameras(resolution: Tuple[int, int], center, radius: float, height: float,
                  n_frames: int, fov: float = 45.0, start_deg: float = 180.0,
                  device=None) -> Camera:
    """Cameras on a horizontal circle around ``center``, each looking at it:
    a yaw toward the center and a pitch down to it, in the reference's
    rotation convention (the camera looks along its rotated +x). The poses
    are computed on the CPU (as ``Camera.build``'s) and then moved to
    ``device`` (None: the card)."""
    device = resolve_device(device)
    cx, cy, cz = (float(v) for v in center)
    cams = []
    for k in range(n_frames):
        az = math.radians(start_deg + 360.0 * k / n_frames)
        px, py, pz = cx + radius * math.cos(az), cy + radius * math.sin(az), cz + height
        dx, dy, dz = cx - px, cy - py, cz - pz
        yaw = math.degrees(math.atan2(dy, dx))
        pitch = math.degrees(math.atan2(dz, math.hypot(dx, dy)))
        cams.append(Camera(torch.tensor([px, py, pz], dtype=torch.float32),
                           euler_rotation(0.0, pitch, yaw, device="cpu"),
                           torch.tensor(fov, dtype=torch.float32), tuple(resolution)))
    return stack_cameras(cams).to(device)


def frame_camera(cameras: Camera, k: int) -> Camera:
    """Frame ``k``'s camera of a stacked trajectory."""
    return Camera(cameras.position[k], cameras.rotation[k], cameras.fov[k],
                  cameras.resolution)


def render_frames(cameras: Camera, scene, *, depth: int = 2, aliasing: bool = True,
                  compat: bool = True, backend: str = "cuda") -> torch.Tensor:
    """Render every camera of a stacked trajectory -> ``(n, w, h, 3)``.

    ``"cuda"``: each frame is ``render_cuda.render_image_cuda``'s launch
    (``aa_shared`` with AA, else ``aa_none``) on CUDA tensors, which this
    backend requires; the frames' parameter vectors are packed on the host
    and copied in one transfer, and the launches then follow one another on
    the current stream with no host sync; without a card it raises
    (``utils.config.resolve_backend``). ``"torch"``: the plain renderer, a
    frame at a time, on the tensors' own device."""
    n = cameras.position.shape[0]
    if resolve_backend(backend) == "torch":
        return torch.stack([render_image(frame_camera(cameras, k), scene, depth=depth,
                                         aliasing=aliasing, compat=compat)
                            for k in range(n)])
    dev = require_cuda("render_frames(backend='cuda')", cameras.position,
                       scene.spheres.center)
    mode = "aa_shared" if aliasing else "aa_none"
    W, H = cameras.resolution
    _, tables, counts = render_cuda.packed_inputs(frame_camera(cameras, 0), scene,
                                                  depth=depth, compat=compat)
    # what packing reads on the host, fetched once: the poses and materials
    host_cams = cameras.to("cpu")
    host_scene = Scene.from_leaves([t.detach().cpu() for t in scene.leaves()])
    cheap = render_cuda.shadow_cheap_ok(host_scene, compat)
    large = scene.spheres.count > render_cuda.CULL_MIN_SPHERES
    frames = torch.empty((n, W, H, 3), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        params = torch.stack([render_cuda.pack_params(frame_camera(host_cams, k), host_scene,
                                                      compat)
                              for k in range(n)]).to(dev)
        for k in range(n):
            # a large scene's tables are the frame's own, as the render
            # wrapper builds them
            tabs = dict(zip(("vis", "shadow", "tree", "cells"),
                            render_cuda.large_scene_tables(
                                frame_camera(cameras, k), scene, depth=depth,
                                aliasing=aliasing, compat=compat,
                                packed=(params[k], tables, counts)))) if large else {}
            render_cuda.launch(frames[k], params[k], tables, counts, depth=depth, mode=mode,
                               compat=compat, cheap_shadow=cheap, **tabs)
    return frames


def save_animation(frames: torch.Tensor, path: str, *, fps: int = 12) -> None:
    """Write frames ``(n, w, h, 3)`` (float, [0, 1] scale) as an animated GIF,
    each frame the uint8 framebuffer of ``to_framebuffer`` in display
    orientation: the file the JAX package's ``save_animation`` writes with
    Pillow (``duration=int(1000 / fps)``, ``loop=0``), byte for byte, written
    by ``utils.image.encode_gif`` (each frame's adaptive palette, identical
    frames merged, later frames cropped to what changed, the compiled LZW of
    ``utils.native``)."""
    imgs = [framebuffer_to_array(to_framebuffer(f.detach().cpu())) for f in frames]
    with open(path, "wb") as fh:
        fh.write(encode_gif(np.stack(imgs), duration=int(1000 / fps)))
