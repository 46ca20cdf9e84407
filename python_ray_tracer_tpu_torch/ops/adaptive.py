"""Adaptive 3x3 supersampling in plain PyTorch: curvature flags, the tent
fallback, the static-budget worklist and its trace.

Counterpart of the jnp parts of ``python_ray_tracer_tpu/ops/pallas/
render_adaptive.py`` and the plain version of the worklist kernel
(``ops/cuda/adaptive_cuda.py``, ``csrc/render_fwd_kernel.cuh``
``render_list_kernel``). The pipeline renders the pixel centers, flags the
interior pixels where the centers are not locally linear (max |second
difference| over x, y and both diagonals, dilated by one pixel), gives every
pixel the tent value (the 9-sample average with samples bilinearly
interpolated from the centers: exact on locally linear intensity), and traces
the 9 samples of the first ``K = budget_frac * W * H`` flagged pixels, whose
averages replace their tent values. Pixels flagged past the budget keep the
tent value, in pixel-index order, and the stats report them.

Images are ``(W, H, 3)``; a flat pixel index is ``x * H + y``. The compaction
is a cumulative sum and a binary search with a static ``K``: no host sync.
The JAX module's TPU tile policy (``tile_w``, ``tile_h``, ``row_block``,
``interpret``) has no counterpart here.
"""
from __future__ import annotations

import torch

from .render import _AA_OFFSETS, render_image, render_rays

# The 9 AA samples in (x, y) index space, the center first (the kernels'
# order, render_cuda.AA_OFFSETS).
AA_OFFSETS = ((0.0, 0.0),) + _AA_OFFSETS
# The tent filter's weights, [sx + 1][sy + 1]; they sum to 9.
_TENT = ((0.25, 1.0, 0.25), (1.0, 4.0, 1.0), (0.25, 1.0, 0.25))


def _interior(W: int, H: int, dev) -> torch.Tensor:
    """Bool ``(W, H)``: pixels off the one-pixel border ring (the ring never
    gets AA, reference kernels.py:27-30)."""
    m = torch.zeros((W, H), dtype=torch.bool, device=dev)
    m[1:W - 1, 1:H - 1] = True
    return m


def stored_to_rgb(img: torch.Tensor, compat: bool) -> torch.Tensor:
    """A render's stored channel layout -> (r, g, b): compat stores (r, b, g)."""
    if not compat:
        return img
    return torch.stack([img[..., 0], img[..., 2], img[..., 1]], dim=-1)


def curvature_flags(C: torch.Tensor, eps: float) -> torch.Tensor:
    """Bool ``(W, H)``: interior pixels whose max |second difference| over x,
    y and both diagonals (maxed over channels, then max-dilated over 3x3)
    exceeds ``eps``. ``C`` is the (r, g, b) centers image ``(W, H, 3)``. The
    rolls wrap around as ``jnp.roll`` does: that only adds flags next to the
    border ring (``render_adaptive._curvature_flags``)."""
    W, H = C.shape[0], C.shape[1]
    d = torch.zeros((W, H), dtype=C.dtype, device=C.device)
    for ax, ay in ((1, 0), (0, 1), (1, 1), (1, -1)):
        p = torch.roll(C, (ax, ay), dims=(0, 1))
        m = torch.roll(C, (-ax, -ay), dims=(0, 1))
        d = torch.maximum(d, (p - 2.0 * C + m).abs().amax(dim=-1))
    d = torch.maximum(d, torch.maximum(torch.roll(d, 1, 0), torch.roll(d, -1, 0)))
    d = torch.maximum(d, torch.maximum(torch.roll(d, 1, 1), torch.roll(d, -1, 1)))
    return (d > eps) & _interior(W, H, C.device)


def tent_image(C: torch.Tensor, compat: bool) -> torch.Tensor:
    """The fallback image ``(W, H, 3)`` in the kernels' stored channel layout:
    on interior pixels the 9-sample AA average with samples bilinearly
    interpolated from the (r, g, b) centers ``C``, composed under compat with
    the reference's accumulation and store swaps; on the border ring the
    stored center (``render_adaptive._tent_image``, operation for
    operation)."""
    W, H = C.shape[0], C.shape[1]
    T = torch.zeros_like(C)
    for sx in (-1, 0, 1):
        for sy in (-1, 0, 1):
            T = T + _TENT[sx + 1][sy + 1] * torch.roll(C, (sx, sy), dims=(0, 1))
    T = T / 9.0
    Cr, Cg, Cb = C.unbind(-1)
    if compat:
        aa = torch.stack([T[..., 0], (Cb + 9.0 * T[..., 1] - Cg) / 9.0,
                          (Cg + 9.0 * T[..., 2] - Cb) / 9.0], dim=-1)
        border = torch.stack([Cr, Cb, Cg], dim=-1)
    else:
        aa, border = T, C
    return torch.where(_interior(W, H, C.device)[..., None], aa, border)


def budget_slots(W: int, H: int, budget_frac: float) -> int:
    """The worklist's static length K: ``budget_frac`` of the pixels, at least
    1 and at most all of them."""
    return max(1, min(int(budget_frac * W * H), W * H))


def compact(flags: torch.Tensor, K: int):
    """The first ``K`` flagged flat indices ``x * H + y`` in ascending order
    (int32 ``(K,)``, slots past the flagged count hold ``W * H``), the flagged
    count and the dropped count ``max(flagged - K, 0)`` (int32 0-dim tensors
    on the flags' device): ``jnp.nonzero(flat, size=K, fill_value=W * H)`` and
    the JAX stats, with no host sync. Slot j holds the first pixel whose
    running flag count reaches j + 1."""
    cum = torch.cumsum(flags.reshape(-1), 0, dtype=torch.int32)
    want = torch.arange(1, K + 1, dtype=torch.int32, device=flags.device)
    idx = torch.searchsorted(cum, want, out_int32=True)
    flagged = cum[-1]
    return idx, flagged, torch.clamp(flagged - K, min=0)


def tent_and_worklist(C: torch.Tensor, *, compat: bool, eps: float, K: int):
    """The glue between the centers pass and the worklist trace, on the
    centers' device: ``(tent, idx, flagged, dropped)`` from the (r, g, b)
    centers ``C`` (:func:`tent_image`, :func:`curvature_flags`,
    :func:`compact`)."""
    return (tent_image(C, compat), *compact(curvature_flags(C, eps), K))


def trace_worklist_plain(camera, scene, idx: torch.Tensor, count, image: torch.Tensor, *,
                         depth: int, compat: bool, chunk: int | None = None) -> torch.Tensor:
    """A copy of ``image (W, H, 3)`` (the tent image) with the first
    ``min(count, len(idx))`` listed pixels replaced by their 9-sample AA
    average, in the stored layout: the samples in :data:`AA_OFFSETS` order
    through :func:`..render.render_rays`, combined in the per-sample kernel's
    association (the compat center stored as (r, b, g), the neighbours added
    unswapped, then times float32(1/9): ``render_adaptive.py:280-289``).
    ``chunk`` bounds the pixels traced at once. Reads ``count`` on the host."""
    H = image.shape[1]
    n = min(int(count), idx.shape[0])
    out = image.clone()
    if n == 0:
        return out
    sel = idx[:n].to(torch.int64)
    flat = out.view(-1, 3)
    inv9 = torch.tensor(1.0 / 9.0, dtype=torch.float32, device=image.device)
    for p in torch.split(sel, n if chunk is None else max(1, chunk)):
        xy = torch.stack([p // H, p % H], dim=-1).to(torch.float32)
        acc = None
        for k, (ox, oy) in enumerate(AA_OFFSETS):
            off = torch.tensor([ox, oy], dtype=torch.float32, device=image.device)
            s = render_rays(xy + off, camera, scene, depth=depth, compat=compat)
            if k == 0:     # the compat center stored (r, b, g): the same swap
                acc = stored_to_rgb(s, compat)
            else:
                acc = acc + s
        flat[p] = acc * inv9
    return out


def render_image_adaptive_plain(camera, scene, *, depth: int = 2, compat: bool = True,
                                eps: float = 1.0 / 255, budget_frac: float = 0.25,
                                with_stats: bool = False):
    """Adaptive-AA render -> float ``(w, h, 3)`` (the layout of
    :func:`..render.render_image` with ``aliasing=True``), in plain PyTorch
    (``render_adaptive.render_image_adaptive``). ``eps``: the curvature
    threshold in [0, 1] color units; ``eps < 0`` flags every interior pixel.
    ``budget_frac``: the worklist's length as a share of the pixels. Returns
    ``image`` or ``(image, {"flagged": n, "dropped": n})`` with 0-dim int32
    tensors."""
    W, H = camera.resolution
    C = stored_to_rgb(render_image(camera, scene, depth=depth, aliasing=False,
                                   compat=compat), compat)
    tent, idx, flagged, dropped = tent_and_worklist(C, compat=compat, eps=eps,
                                                    K=budget_slots(W, H, budget_frac))
    out = trace_worklist_plain(camera, scene, idx, flagged, tent, depth=depth,
                               compat=compat)
    if with_stats:
        return out, {"flagged": flagged, "dropped": dropped}
    return out
