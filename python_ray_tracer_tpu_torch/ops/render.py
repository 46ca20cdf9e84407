"""Image-level rendering in plain PyTorch: analytic ray generation, 3x3
supersampling, framebuffer quantization.

Counterpart of ``python_ray_tracer_tpu/ops/render.py`` and the port's plain
version of the CUDA render kernels (``ops/cuda/render_cuda.py``). The 9 AA sample
directions are analytic half-pixel offsets in index space (the reference's
midpoints between neighbouring pixel locations, kernels.py:43-50).

Compat quirks kept:
  * AA accumulation swaps G/B of the neighbour samples (kernels.py:59-60) and
    the store swaps G/B again (common.py:61-63): ``out = (R_p+R_n, B_p+G_n,
    G_p+B_n)/9`` on interior pixels and ``(R_p, B_p, G_p)`` on the border ring;
  * border pixels take a single center sample; the outermost ring counts as
    border (the reference's ``<=`` bound reads out of bounds there);
  * rounding is round-half-to-even (``torch.round``).
"""
from __future__ import annotations

import torch

from .shade import sample

# 8 neighbour half-offsets in (x, y) pixel-index space (kernels.py:32-50).
_AA_OFFSETS = (
    (-0.5, 0.0), (0.5, 0.0), (0.0, 0.5), (0.0, -0.5),
    (-0.5, 0.5), (0.5, 0.5), (-0.5, -0.5), (0.5, -0.5),
)


def render_rays(pixel_xy, camera, scene, *, depth: int, compat: bool = True):
    """Shade fractional pixel coordinates ``(..., 2)`` -> rgb ``(..., 3)``."""
    d = camera.ray_directions(pixel_xy, compat=compat)
    o = camera.ray_origin().expand(d.shape)
    return sample(o, d, scene, depth=depth, compat=compat)


def _render_block(xs, ys, camera, scene, *, depth, aliasing, compat):
    """Float ``(W, H, 3)`` block spanned by index vectors ``xs (W,)`` x ``ys (H,)``,
    with the compat channel semantics applied, before quantization."""
    w_total, h_total = camera.resolution
    gx, gy = torch.meshgrid(xs, ys, indexing="ij")
    center = torch.stack([gx, gy], dim=-1)                 # (W, H, 2)
    primary = render_rays(center, camera, scene, depth=depth, compat=compat)

    if not aliasing:
        # Store-time G/B swap (common.py:61-63) with no AA to undo it.
        return primary[..., [0, 2, 1]] if compat else primary

    acc = torch.zeros_like(primary)
    for ox, oy in _AA_OFFSETS:
        off = torch.tensor([ox, oy], dtype=primary.dtype, device=primary.device)
        acc = acc + render_rays(center + off, camera, scene, depth=depth,
                                compat=compat)
    interior = ((gx >= 1.0) & (gx <= w_total - 2) &
                (gy >= 1.0) & (gy <= h_total - 2))[..., None]
    if compat:
        pr, pg, pb = primary.unbind(-1)
        nr, ng, nb = acc.unbind(-1)
        aa = torch.stack([pr + nr, pb + ng, pg + nb], dim=-1) / 9.0
        return torch.where(interior, aa, torch.stack([pr, pb, pg], dim=-1))
    return torch.where(interior, (primary + acc) / 9.0, primary)


def render_image(camera, scene, *, depth: int = 2, aliasing: bool = True,
                 compat: bool = True, row_chunk: int | None = None, x_offset: int = 0,
                 local_width: int | None = None) -> torch.Tensor:
    """Render the full image -> float ``(w, h, 3)`` in [0, ~1] scale; with
    ``x_offset`` / ``local_width`` the ``(local_width, h, 3)`` slice of it at
    columns ``[x_offset, x_offset + local_width)`` (rays and the border ring
    are the frame's: a slice is the frame's columns).

    ``row_chunk`` renders blocks of that many x columns at a time to bound peak
    memory on large images."""
    w, h = camera.resolution
    dev = camera.device
    lw = w - x_offset if local_width is None else local_width
    ys = torch.arange(h, dtype=torch.float32, device=dev)
    xs = torch.arange(x_offset, x_offset + lw, dtype=torch.float32, device=dev)
    w = lw
    kw = dict(depth=depth, aliasing=aliasing, compat=compat)
    if row_chunk is None or row_chunk >= w:
        return _render_block(xs, ys, camera, scene, **kw)
    return torch.cat([_render_block(xb, ys, camera, scene, **kw)
                      for xb in torch.split(xs, row_chunk)])


def to_framebuffer(img: torch.Tensor) -> torch.Tensor:
    """Quantize a float [0,1]-scale ``(w, h, 3)`` image to the reference's uint8
    ``(3, w, h)`` framebuffer: scale, round half to even, clamp (common.py:52-57)."""
    x = torch.clamp(torch.round(img * 255.0), 0.0, 255.0).to(torch.uint8)
    return torch.movedim(x, -1, 0).contiguous()
