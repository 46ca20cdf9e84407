"""The large-scene tables of the render kernel, built with plain PyTorch.

Counterparts of three table functions of
``python_ray_tracer_tpu/ops/pallas/render_pallas.py``, which are plain ``jnp``
outside any kernel there and stay plain tensor code here (they run on the
device of their inputs; dot products are multiply-and-sum, never a matmul):

  * :func:`sphere_groups` (``_sphere_groups``, ``_morton30``): Morton-ordered
    groups of 16 spheres with a bounding ball each, for bounce sweeps;
  * :func:`tile_visibility` (``_tile_visibility``): per render tile, the
    spheres whose ball meets the cone around the tile's primary rays;
  * :func:`shadow_visibility_lists` (``_shadow_visibility_lists``): per (tile,
    light), the spheres that can block a shadow ray from the tile's hit box
    (a row of the hit-extent kernel, ``hit_extents_cuda``) toward the light or
    beyond it.

A tile is one 16x16 block of ``csrc/render_fwd_kernel.cuh``; tile ``(tx, ty)`` covers
pixels ``x in [16 tx, 16 tx + 16)``, ``y in [16 ty, 16 ty + 16)`` and has id
``tx * n_ty + ty`` (:func:`tile_grid`), the id the kernels compute from
``blockIdx``. Lists are compacted to ``K`` slots a row; a row that needs more
gets the count ``-1`` and its sweep falls back to all spheres, so any ``K`` is
conservative. Both list functions compact with a running count instead of the
JAX package's stable argsort: the kept entries and their order are the same
(ascending sphere index for the primary lists, so the closest-hit winner and
its tie class do not move; largest apparent size from the light first for the
shadow lists), and the slots past a row's count, which no sweep reads, hold 0.
The device tables have no size budget (they live in device memory; the TPU's
capacity policy answers its SMEM limits).
"""
from __future__ import annotations

import torch

from ..intersect import FAR, _dot

TILE = 16          # pixels a side of a render tile (csrc/render_fwd_kernel.cuh TILE)
GROUP_SIZE = 16    # spheres a Morton group (csrc/rt_common.cuh GROUP)


def tile_grid(width: int, height: int, tile: int = TILE):
    """``(n_tx, n_ty)``: tiles along x and along y."""
    return -(-width // tile), -(-height // tile)


def list_capacity(ns: int) -> int:
    """Slots a list row: 32 covers ~100-sphere scenes, denser scenes get more
    (the JAX package's tiers, without its SMEM budgets)."""
    return min(ns, 32 if ns <= 256 else 64 if ns <= 2048 else 128)


def _norm(v: torch.Tensor) -> torch.Tensor:
    return torch.sqrt(_dot(v, v))


def _morton30(x, y, z):
    """30-bit Morton code of 10-bit coordinates (int64 tensors)."""
    def spread(v):
        v = (v | (v << 16)) & 0x030000FF
        v = (v | (v << 8)) & 0x0300F00F
        v = (v | (v << 4)) & 0x030C30C3
        v = (v | (v << 2)) & 0x09249249
        return v
    return spread(x) | (spread(y) << 1) | (spread(z) << 2)


def sphere_groups(centers, radii, group_size: int = GROUP_SIZE, order_from=None):
    """Spatially clustered sphere groups for the grouped bounce sweeps.

    Morton-orders the centers (10 bits an axis over their bounding box; equal
    codes keep ascending sphere index) and cuts the order into ``G = ceil(ns /
    group_size)`` groups. Returns ``(perm, bounds)``: ``perm (G * group_size,)``
    int32, the sweep order in original sphere indices (the pad slots of the
    one partial group hold 0: the kernels sweep them, and visiting sphere 0
    twice changes nothing); ``bounds (G * 4,)`` float32, ``[cx, cy, cz, R]``
    a group, ``R`` inflated so that every member ball lies strictly inside. A
    ray that misses a group's ball misses every member, whatever its origin
    and direction. With ``order_from`` the groups are ordered by their
    centers' distance from that point (the camera), front to back."""
    ns = centers.shape[0]
    G = -(-ns // group_size)
    npad = G * group_size
    dev = centers.device
    lo = centers.min(dim=0).values
    span = torch.clamp(centers.max(dim=0).values - lo, min=1e-6)
    q = torch.clamp((centers - lo) / span * 1023.0, 0.0, 1023.0).to(torch.int64)
    code = _morton30(q[:, 0], q[:, 1], q[:, 2])
    perm = torch.argsort(code, stable=True)
    perm_pad = torch.cat([perm, torch.zeros(npad - ns, dtype=torch.int64, device=dev)])
    c_s = centers[perm_pad].reshape(G, group_size, 3)
    r_s = radii[perm_pad].reshape(G, group_size)
    valid = (torch.arange(npad, device=dev) < ns).reshape(G, group_size)
    w = valid.to(torch.float32)
    cnt = torch.clamp(w.sum(dim=1, keepdim=True), min=1.0)
    gc = (c_s * w[..., None]).sum(dim=1) / cnt                       # (G, 3)
    dist = _norm(c_s - gc[:, None, :]) + r_s
    R = torch.where(valid, dist, torch.zeros_like(dist)).amax(dim=1)
    R = R * 1.001 + 1e-3
    if order_from is not None:
        origin = torch.as_tensor(order_from, dtype=torch.float32, device=dev)
        g_order = torch.argsort(_norm(gc - origin[None, :]), stable=True)
        gc, R = gc[g_order], R[g_order]
        perm_pad = perm_pad.reshape(G, group_size)[g_order].reshape(-1)
    bounds = torch.cat([gc, R[:, None]], dim=1).reshape(-1)
    return perm_pad.to(torch.int32), bounds.to(torch.float32).contiguous()


def _compact(keep: torch.Tensor, values: torch.Tensor, K: int):
    """Rows of ``keep (R, n)`` bool -> ``(idx (R * k,), cnt (R,))`` int32 with
    ``k = min(K, n)``: each row's first ``k`` kept ``values`` in column order,
    then zeros; ``cnt`` is the row's kept count, or -1 where it exceeds ``k``."""
    rows, n = keep.shape
    k = min(K, n)
    pos = torch.cumsum(keep, dim=1) - 1
    # entries that are dropped all land in one extra column, cut off below
    slot = torch.where(keep & (pos < k), pos, torch.full_like(pos, k))
    buf = torch.zeros((rows, k + 1), dtype=torch.int32, device=keep.device)
    buf.scatter_(1, slot, values.to(torch.int32).expand(rows, n).contiguous())
    cnt = keep.sum(dim=1, dtype=torch.int32)
    cnt = torch.where(cnt > k, torch.full_like(cnt, -1), cnt)
    return buf[:, :k].reshape(-1).contiguous(), cnt


def tile_visibility(camera, scene, *, compat: bool, tile: int = TILE, K=None):
    """Conservative per-tile sphere visibility for the primary closest-hit
    sweep.

    Each tile's primary rays, with a margin of one pixel on every side (which
    covers the AA half-offsets), lie in the cone through the four corner
    directions; a sphere is kept if its ball meets that cone (and, in compat
    mode, is not wholly beyond the 999 far clip). A pixel grid's ray pencil is
    convex, so a dropped sphere misses every ray of the tile and the listed
    sweep's closest hit is the full sweep's, bit for bit. Returns ``(idx
    (n_tiles * k,), cnt (n_tiles,))`` int32, ``k = min(K or ns, ns)``, entries
    in ascending sphere index."""
    ns = scene.spheres.count
    W, H = camera.resolution
    n_tx, n_ty = tile_grid(W, H, tile)
    dev = camera.device
    focal, y0, dy, z0, dz = camera.grid_params(compat)
    u0 = (torch.arange(n_tx, dtype=torch.float32, device=dev) * tile)[:, None, None]
    v0 = (torch.arange(n_ty, dtype=torch.float32, device=dev) * tile)[None, :, None]
    cu = torch.tensor([-1.0, -1.0, tile + 1.0, tile + 1.0], device=dev)
    cv = torch.tensor([-1.0, tile + 1.0, -1.0, tile + 1.0], device=dev)
    gx, gy = torch.broadcast_tensors(u0 + cu, v0 + cv)               # (n_tx, n_ty, 4)
    p = torch.stack([focal.expand(gx.shape), y0 + gx * dy, z0 + gy * dz], dim=-1)
    rp = camera.rotation * p[..., None, :]
    d = (rp[..., 0] + rp[..., 1]) + rp[..., 2]                       # R @ p
    d = d / _norm(d)[..., None]
    axis = (d[:, :, 0] + d[:, :, 1]) + (d[:, :, 2] + d[:, :, 3])
    axis = axis / _norm(axis)[..., None]                             # (n_tx, n_ty, 3)
    cos_min = _dot(d, axis[:, :, None, :]).amin(dim=2)
    theta = torch.acos(torch.clamp(cos_min, -1.0, 1.0)) + 1e-3

    w = scene.spheres.center - camera.position                       # (ns, 3)
    dist = _norm(w)
    r = scene.spheres.radius
    safe = torch.clamp(dist, min=1e-12)
    cos_a = _dot(w[None, None], axis[:, :, None, :]) / safe
    alpha = torch.acos(torch.clamp(cos_a, -1.0, 1.0))                # (n_tx, n_ty, ns)
    half = torch.asin(torch.clamp(r / safe, 0.0, 1.0))
    visible = (dist <= r + 1e-3) | (alpha <= theta[..., None] + half + 1e-3)
    if compat:
        visible = visible & ((dist - r) <= FAR)
    return _compact(visible.reshape(n_tx * n_ty, ns),
                    torch.arange(ns, device=dev)[None, :], ns if K is None else K)


def shadow_visibility_lists(ext, lights, centers, radii, *, K: int, compat: bool,
                            to_sorted=None):
    """Per-(tile, light) conservative occluder lists from hit-extent rows.

    ``ext (T, 8)``: ``[min xyz, max xyz, count, 0]`` a tile (one trace level).
    A sphere can block some shadow ray of a tile only if it meets the region
    swept by rays from points of the tile's hit box through the light and on
    beyond it by ``FAR`` (the any-hit query has no maximum distance: a sphere
    past the light still shadows). The test is a capsule around the segment
    box centre -> light plus a cone past the light, each widened by the
    sphere's radius and a scale-aware slack; where the light lies within two
    half-diagonals of the box the cone is ill-defined and the row keeps every
    sphere. Rows of tiles without hits keep none (count 0). Within a row,
    entries run from the largest apparent size from that light (``r / |c -
    L|``) down; ``to_sorted`` (original index -> position in a sorted sphere
    table) remaps the entries. Returns ``(idx (T * nl * k,), cnt (T * nl,))``
    int32 with ``k = min(K, ns)``; row ``tile * nl + l`` is light ``l``'s."""
    T, ns, nl = ext.shape[0], centers.shape[0], lights.shape[0]
    lo, hi = ext[:, 0:3], ext[:, 3:6]
    has = ext[:, 6] > 0.5                                            # (T,)
    b = 0.5 * (lo + hi)
    e = 0.5 * (hi - lo)
    hdiag = _norm(e)                                                 # (T,)
    # The slack covers the rounding of b, e and hdiag, ~0.5 ulp of the largest
    # coordinate; rows without hits carry the +-1e30 sentinels and must not
    # feed the scale.
    coord = torch.where(has[:, None], torch.maximum(lo.abs(), hi.abs()),
                        torch.zeros_like(lo))
    scale = torch.maximum(coord.amax() if T else lights.new_zeros(()),
                          lights.abs().amax() if nl else lights.new_zeros(()))
    slack = torch.clamp(2e-6 * scale, min=1e-3)
    s = lights[None, :, :] - b[:, None, :]                           # (T, nl, 3)
    ss = torch.clamp(_dot(s, s), min=1e-12)                          # (T, nl)
    dlb = torch.sqrt(ss)
    cull_ok = dlb > 2.0 * hdiag[:, None]
    u = s / dlb[..., None]
    slope = hdiag[:, None] / torch.clamp(dlb - hdiag[:, None], min=1e-6)
    rmink = torch.sqrt(1.0 + slope * slope)
    extent = FAR if compat else 1e9

    w = centers[None, None, :, :] - b[:, None, None, :]              # (T, 1, ns, 3)
    ws = _dot(w, s[:, :, None, :])                                   # (T, nl, ns)
    tt = torch.clamp(ws / ss[:, :, None], 0.0, 1.0)
    d2 = _dot(w, w) - 2.0 * tt * ws + tt * tt * ss[:, :, None]
    reach = radii[None, None, :] + hdiag[:, None, None] + slack
    near_seg = d2 <= reach * reach

    v = centers[None, None, :, :] - lights[None, :, None, :]         # (1, nl, ns, 3)
    proj = _dot(v, u[:, :, None, :])                                 # (T, nl, ns)
    lat2 = torch.clamp(_dot(v, v) - proj * proj, min=0.0)
    allow = proj * slope[:, :, None] + (radii[None, None, :] + slack) * rmink[:, :, None]
    in_cone = ((proj > -radii[None, None, :]) & (proj < extent + radii[None, None, :]) &
               (lat2 <= allow * allow) & (allow > 0.0))
    visible = (near_seg | in_cone | ~cull_ok[:, :, None]) & has[:, None, None]

    # Largest apparent occluder first: sort the spheres once a light, then
    # compact each row in that order.
    ang = radii[None, :] / torch.clamp(_norm(centers[None, :, :] - lights[:, None, :]),
                                       min=1e-6)                    # (nl, ns)
    order = torch.argsort(-ang, dim=1, stable=True)                  # (nl, ns)
    keep = torch.gather(visible, 2, order[None].expand(T, nl, ns))
    values = order if to_sorted is None else to_sorted.to(order.device).long()[order]
    return _compact(keep.reshape(T * nl, ns),
                    values[None].expand(T, nl, ns).reshape(T * nl, ns), K)
