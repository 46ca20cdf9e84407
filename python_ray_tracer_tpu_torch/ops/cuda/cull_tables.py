"""The large-scene tables of the render kernel, built with plain PyTorch.

Counterparts of three table functions of
``python_ray_tracer_tpu/ops/pallas/render_pallas.py``, which are plain ``jnp``
outside any kernel there and stay plain tensor code here (they run on the
device of their inputs; dot products are multiply-and-sum, never a matmul):

  * :func:`sphere_groups` (``_sphere_groups``, ``_morton30``): Morton-ordered
    groups of spheres with a bounding ball each; the kernels' bounce sweeps
    take its order, under :func:`bounce_tree`'s boxes instead of its balls;
  * :func:`tile_visibility` (``_tile_visibility``): per render tile, the
    spheres whose ball meets the cone around the tile's primary rays;
  * :func:`shadow_visibility_lists` (``_shadow_visibility_lists``): per (tile,
    level, light), the spheres that can block a shadow ray from the tile's
    hit box at that trace level (a row of the hit-extent kernel,
    ``hit_extents_cuda``) toward the light or beyond it; on the card the
    render path builds them with the hand-written kernel of
    ``shadow_lists_cuda``, which computes these rows, and this function is its
    plain version;
  * :func:`bounce_tree` (no JAX counterpart): the bounce sweeps' two-level
    box tree over the Morton order, with :func:`tree_closest_hit_plain` and
    :func:`tree_occluded_plain`, plain traversals that mirror the kernels'
    (``csrc/rt_common.cuh`` ``closest_hit_tree``, ``occluded_tree``) and are
    the tests' reference, used by nothing on the card path.

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

from typing import NamedTuple

import torch

from ..intersect import BIG, FAR, _dot

TILE = 16          # pixels a side of a render tile (csrc/render_fwd_kernel.cuh TILE)
GROUP_SIZE = 16    # spheres a Morton group of the JAX package's _sphere_groups
# The bounce tree's shape, spheres a leaf and leaves a parent: mirrors of
# csrc/rt_common.cuh LEAF and FAN, compile-time constants of the kernels
# (fixed from the sweep of chip_smoke.py's [tree-sweep] at 1000 spheres; see
# PERF.md).
LEAF = 4
FAN = 8
# csrc/rt_common.cuh box_ray / box_span: the grown box's margin a unit of
# S = |o| + reach, the slab t's relative and absolute widening, and the clamp
# of the slab slope 1/d.
SLAB_DELTA = 1.5e-3
SLAB_W = 2.0 ** -20
SLAB_INV_CLAMP = 2.0 ** 64


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


def tile_visibility(camera, scene, *, compat: bool, tile: int = TILE, K=None,
                    x_offset: int = 0, local_width: int | None = None):
    """Conservative per-tile sphere visibility for the primary closest-hit
    sweep.

    Each tile's primary rays, with a margin of one pixel on every side (which
    covers the AA half-offsets), lie in the cone through the four corner
    directions; a sphere is kept if its ball meets that cone (and, in compat
    mode, is not wholly beyond the 999 far clip). A pixel grid's ray pencil is
    convex, so a dropped sphere misses every ray of the tile and the listed
    sweep's closest hit is the full sweep's, bit for bit. Returns ``(idx
    (n_tiles * k,), cnt (n_tiles,))`` int32, ``k = min(K or ns, ns)``, entries
    in ascending sphere index. ``x_offset`` / ``local_width``: the tiles of
    the slice ``[x_offset, x_offset + local_width)`` of the frame (default
    the whole frame), their corners taken in the frame's pixels
    (``render_pallas._tile_visibility(x_offset=)``)."""
    ns = scene.spheres.count
    W, H = camera.resolution
    lw = W - x_offset if local_width is None else local_width
    n_tx, n_ty = tile_grid(lw, H, tile)
    dev = camera.device
    focal, y0, dy, z0, dz = camera.grid_params(compat)
    u0 = (torch.arange(n_tx, dtype=torch.float32, device=dev) * tile
          + float(x_offset))[:, None, None]
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


def extent_scale(ext) -> torch.Tensor:
    """0-dim float32: the largest coordinate magnitude ``max(|lo|, |hi|)`` of
    the hit-extent rows ``ext (T, 8)`` that have hits (0 where none has): the
    boxes' part of the lists' scale (csrc/hit_extents.cu writes it beside the
    rows). Rows of tiles without hits carry the +-1e30 sentinels and must not
    feed it."""
    if ext.shape[0] == 0:
        return ext.new_zeros(())
    has = ext[:, 6] > 0.5
    coord = torch.where(has[:, None], torch.maximum(ext[:, 0:3].abs(), ext[:, 3:6].abs()),
                        torch.zeros_like(ext[:, 0:3]))
    return coord.amax()


def light_order(lights, centers, radii) -> torch.Tensor:
    """``(nl, ns)`` int64: each light's spheres from the largest apparent size
    ``r / |c - L|`` down (a stable sort: equal sizes keep ascending index), the
    order of every (tile, light) row of :func:`shadow_visibility_lists`."""
    ang = radii[None, :] / torch.clamp(_norm(centers[None, :, :] - lights[:, None, :]),
                                       min=1e-6)                    # (nl, ns)
    return torch.argsort(-ang, dim=1, stable=True)


class ShadowRows(NamedTuple):
    """:func:`shadow_rows`: ``keep (T, nl, ns)`` bool, whether row ``(tile,
    light)`` keeps each sphere, in the light's :func:`light_order`; ``has
    (T,)``, whether the tile has hits (a row without keeps none); ``cull_ok
    (T, nl)``, whether the row's cone is defined (a row without keeps every
    sphere); ``order (nl, ns)``."""
    keep: torch.Tensor
    has: torch.Tensor
    cull_ok: torch.Tensor
    order: torch.Tensor


def shadow_rows(ext, lights, centers, radii, *, compat: bool, scale=None) -> ShadowRows:
    """The decisions of :func:`shadow_visibility_lists` before compaction.
    ``scale``: the boxes' part of the lists' scale (0-dim or ``(1,)``; None:
    :func:`extent_scale` of ``ext``)."""
    T, ns, nl = ext.shape[0], centers.shape[0], lights.shape[0]
    lo, hi = ext[:, 0:3], ext[:, 3:6]
    has = ext[:, 6] > 0.5                                            # (T,)
    b = 0.5 * (lo + hi)
    e = 0.5 * (hi - lo)
    hdiag = _norm(e)                                                 # (T,)
    # The slack covers the rounding of b, e and hdiag, ~0.5 ulp of the largest
    # coordinate.
    box = extent_scale(ext) if scale is None else scale.reshape(())
    scale = torch.maximum(box, lights.abs().amax() if nl else lights.new_zeros(()))
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
    # read each row in that order.
    order = light_order(lights, centers, radii)                      # (nl, ns)
    keep = torch.gather(visible, 2, order[None].expand(T, nl, ns))
    return ShadowRows(keep, has, cull_ok, order)


def shadow_visibility_lists(ext, lights, centers, radii, *, K: int, compat: bool,
                            to_sorted=None, scale=None):
    """Per-(tile, light) conservative occluder lists from hit-extent rows.

    ``ext (T, 8)``: ``[min xyz, max xyz, count, 0]`` a tile, or, for the
    lists of L trace levels, a (tile, level) (``T`` the tiles times L, row
    ``tile * L + level``: the hit-extent kernel's layout), whose rows are
    then ``(tile * L + level) * nl + l``.
    A sphere can block some shadow ray of a tile only if it meets the region
    swept by rays from points of the tile's hit box through the light and on
    beyond it by ``FAR`` (the any-hit query has no maximum distance: a sphere
    past the light still shadows). The test is a capsule around the segment
    box centre -> light plus a cone past the light, each widened by the
    sphere's radius and a scale-aware slack (``2e-6`` of the largest of
    ``scale``, default :func:`extent_scale` of ``ext``, and the lights'
    coordinates, at least ``1e-3``); where the light lies within two
    half-diagonals of the box the cone is ill-defined and the row keeps every
    sphere. Rows of tiles without hits keep none (count 0). Within a row,
    entries run from the largest apparent size from that light (``r / |c -
    L|``, :func:`light_order`) down; ``to_sorted`` (original index ->
    position in a sorted sphere table) remaps the entries. Returns ``(idx (T *
    nl * k,), cnt (T * nl,))`` int32 with ``k = min(K, ns)``; row ``tile * nl
    + l`` is light ``l``'s. csrc/shadow_lists.cu computes the same rows on the
    card (``shadow_lists_cuda``)."""
    T, ns, nl = ext.shape[0], centers.shape[0], lights.shape[0]
    rows = shadow_rows(ext, lights, centers, radii, compat=compat, scale=scale)
    order = rows.order
    values = order if to_sorted is None else to_sorted.to(order.device).long()[order]
    return _compact(rows.keep.reshape(T * nl, ns),
                    values[None].expand(T, nl, ns).reshape(T * nl, ns), K)


class BounceTree(NamedTuple):
    """The bounce sweeps' tree as the kernels take it (csrc/rt_common.cuh
    ``Tables``): ``perm (n_leaves * LEAF,)`` int32, the spheres in Morton
    order, leaf ``l`` holding slots ``[l * LEAF, (l + 1) * LEAF)``; ``box``
    float32, ``reach`` (the largest ``|c| + r``, rounded up), then the
    parents' boxes, then the leaves', 6 floats each (lo xyz, hi xyz); parent
    ``p`` covers leaves ``[p * FAN, min((p + 1) * FAN, n_leaves))``. A tree
    built with another ``leaf`` / ``fan`` (:func:`bounce_tree`'s keywords)
    has ``perm.numel() // n_leaves`` slots a leaf."""
    perm: torch.Tensor
    box: torch.Tensor
    n_leaves: int


def tree_box_words(n_leaves: int, fan: int = FAN) -> int:
    """Floats of a tree's ``box`` (csrc/rt_common.cuh ``tree_box_words``)."""
    return 1 + 6 * (-(-n_leaves // fan) + n_leaves)


def _outward(x: torch.Tensor, down: bool) -> torch.Tensor:
    """float64 -> the nearest float32 on the outer side (below for ``down``)."""
    f = x.to(torch.float32)
    off = f.double() > x if down else f.double() < x
    return torch.where(off, torch.nextafter(f, torch.full_like(f, -BIG if down else BIG)), f)


def bounce_tree(centers, radii, leaf: int = LEAF, fan: int = FAN) -> BounceTree:
    """The two-level box tree of the kernels' bounce sweeps, with ``leaf``
    spheres a leaf and ``fan`` leaves a parent (the kernels take the default,
    :data:`LEAF` and :data:`FAN`; chip_smoke.py's sweep builds kernels for
    the others).

    The order is :func:`sphere_groups`' Morton permutation (cut into groups of
    ``leaf``); the pad slots of the last leaf repeat its last real member (a
    second visit changes no hit), not sphere 0, so its box stays tight. A leaf's
    box bounds its member balls inflated as the groups' balls are (``r * 1.001
    + 1e-3``), in float64 and rounded outward to float32; a parent's box is
    the min / max of its leaves' boxes (exact). ``reach`` bounds ``|c| + r``
    from above; the kernels' slab test grows every box by ``1.5e-3 (|o| +
    reach)`` for a ray from ``o`` (rt_common.cuh derives it). Plain tensor ops
    on the inputs' device, no host sync."""
    ns = centers.shape[0]
    if ns < 1 or leaf < 1 or fan < 1:
        raise ValueError(f"bounce_tree: {ns} spheres, leaf {leaf}, fan {fan}")
    n_leaves = -(-ns // leaf)
    perm = sphere_groups(centers, radii, group_size=leaf)[0].long()
    perm[ns:] = perm[ns - 1]
    c = centers.double()[perm].reshape(n_leaves, leaf, 3)
    r = (radii.double()[perm] * 1.001 + 1e-3).reshape(n_leaves, leaf, 1)
    lo = _outward((c - r).amin(dim=1), down=True)
    hi = _outward((c + r).amax(dim=1), down=False)
    n_par = -(-n_leaves // fan)
    pad = n_par * fan - n_leaves
    lo_p = torch.cat([lo, lo[-1:].expand(pad, 3)]).reshape(n_par, fan, 3).amin(dim=1)
    hi_p = torch.cat([hi, hi[-1:].expand(pad, 3)]).reshape(n_par, fan, 3).amax(dim=1)
    reach = _outward((torch.sqrt(_dot(centers.double(), centers.double())) +
                      radii.double()).amax()[None], down=False)
    box = torch.cat([reach, torch.cat([lo_p, hi_p], dim=1).reshape(-1),
                     torch.cat([lo, hi], dim=1).reshape(-1)])
    return BounceTree(perm.to(torch.int32), box.contiguous(), n_leaves)


def _tree_shape(tree: BounceTree, fan: int):
    """``(leaf, n_parents)`` of a tree built with ``fan`` leaves a parent."""
    leaf = tree.perm.numel() // tree.n_leaves
    if tree.perm.numel() != tree.n_leaves * leaf or \
            tree.box.numel() != tree_box_words(tree.n_leaves, fan):
        raise ValueError(f"bounce tree: {tree.perm.numel()} slots and {tree.box.numel()} "
                         f"box floats for {tree.n_leaves} leaves, fan {fan}")
    return leaf, -(-tree.n_leaves // fan)


def _fma(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """float32 ``a * b + c`` with the product exact (in float64, where a
    product of two floats is exact) and the sum rounded in float64, then to
    float32: a fused multiply-add but for a rare second rounding."""
    return (a.double() * b.double() + c.double()).to(torch.float32)


def tree_spans(tree: BounceTree, o: torch.Tensor, d: torch.Tensor):
    """``(t0, t1)``, each ``(R, n_parents + n_leaves)``: the widened entry and
    exit of every node's grown box for the rays ``o + t d`` (``(R, 3)``
    float32), as csrc/rt_common.cuh ``box_ray`` / ``box_span`` compute them,
    operation for operation: the slope ``1/d`` clamped to +-2^64, the planes'
    offsets ``(-o -+ delta) / d`` rounded, each plane's t one fma (see
    :func:`_fma`; a second rounding lies inside the margins the header
    derives)."""
    nodes = tree.box[1:].reshape(-1, 6)
    s = torch.sqrt(_dot(o, o)) + tree.box[0]
    delta = (SLAB_DELTA * s)[:, None]
    inv = torch.clamp(1.0 / d, -SLAB_INV_CLAMP, SLAB_INV_CLAMP)
    lo_off = ((-o - delta) * inv)[:, None, :]
    hi_off = ((-o + delta) * inv)[:, None, :]
    a = _fma(nodes[None, :, 0:3], inv[:, None, :], lo_off)
    b = _fma(nodes[None, :, 3:6], inv[:, None, :], hi_off)
    t0 = torch.minimum(a, b).amax(dim=-1)
    t1 = torch.maximum(a, b).amin(dim=-1)
    return t0 - (t0.abs() + s[:, None]) * SLAB_W, t1 + (t1.abs() + s[:, None]) * SLAB_W


def _visit(t0, t1, t_max):
    return (t0 <= t1) & (t1 >= 0.0) & (t0 <= t_max)


def sphere_hits_plain(o, d, centers, radii, *, compat: bool):
    """``(t, valid)``, each ``(R, ns)``: every sphere's hit as rt_common.cuh
    ``hit_sphere`` computes it (the hoisted quadratic, nearest positive root,
    under the far clip in compat), in float32."""
    a, od, oo = _dot(d, d), _dot(o, d), _dot(o, o)
    cd = _dot(d[:, None, :], centers[None])
    oc = _dot(o[:, None, :], centers[None])
    cc = _dot(centers, centers)
    b = 2.0 * (od[:, None] - cd)
    c = (oo[:, None] - 2.0 * oc) + (cc - radii * radii)[None]
    disc = b * b - (4.0 * a)[:, None] * c
    sq = torch.sqrt(torch.clamp(disc, min=0.0))
    near, far = -b - sq, -b + sq
    t = torch.where(near > 0.0, near, far) * (1.0 / (2.0 * a))[:, None]
    return t, (disc >= 0.0) & (far > 0.0) & (t < (FAR if compat else BIG))


def sphere_occludes_plain(o, d, centers, radii, *, compat: bool, cheap: bool):
    """``(R, ns)`` bool: does each sphere block each shadow ray, as
    rt_common.cuh ``sphere_occludes`` decides (``cheap``: the sqrt-free
    closest-approach test; else the root form under the far clip in compat)."""
    if not cheap:
        return sphere_hits_plain(o, d, centers, radii, compat=compat)[1]
    a, od, oo = _dot(d, d), _dot(o, d), _dot(o, o)
    cd = _dot(d[:, None, :], centers[None])
    oc = _dot(o[:, None, :], centers[None])
    cterm = (oo[:, None] - 2.0 * oc) + (_dot(centers, centers) - radii * radii)[None]
    g = cd - od[:, None]
    tc = torch.clamp(g * (1.0 / a)[:, None], min=0.0, max=FAR if compat else None)
    return cterm <= tc * (2.0 * g - a[:, None] * tc)


def tree_closest_hit_plain(tree: BounceTree, o, d, centers, radii, *, compat: bool,
                           tie: bool = True, fan: int = FAN):
    """The kernels' tree sweep (``closest_hit_tree``) over spheres only, with
    plain tensor ops on rays ``(R, 3)``: parents in order, then their leaves,
    then the members, a node skipped where :func:`tree_spans` says no member
    can beat the running winner; the winner is the least ``(t, index)`` (with
    ``tie=False`` a strict ``<`` in visit order, for the tests to show that
    the rule matters). ``fan``: the tree's leaves a parent. Returns ``(t,
    obj, boxes, spheres)``: the winner's t (the far clip for none) and index
    (-1), and the box and sphere tests each ray made."""
    R = o.shape[0]
    leaf, n_par = _tree_shape(tree, fan)
    t_all, ok_all = sphere_hits_plain(o, d, centers, radii, compat=compat)
    t0, t1 = tree_spans(tree, o, d)
    h_t = torch.full((R,), FAR if compat else BIG, dtype=torch.float32, device=o.device)
    h_obj = torch.full((R,), -1, dtype=torch.int64, device=o.device)
    n_boxes = torch.zeros(R, dtype=torch.int64, device=o.device)
    n_spheres = torch.zeros_like(n_boxes)
    perm = tree.perm.long().tolist()
    for p in range(n_par):
        vp = _visit(t0[:, p], t1[:, p], h_t)
        n_boxes += 1
        for lf in range(p * fan, min((p + 1) * fan, tree.n_leaves)):
            n_boxes += vp
            vl = vp & _visit(t0[:, n_par + lf], t1[:, n_par + lf], h_t)
            for j in perm[lf * leaf:(lf + 1) * leaf]:
                n_spheres += vl
                tj = t_all[:, j]
                wins = tj < h_t
                if tie:
                    wins = wins | ((tj == h_t) & (j < h_obj))
                take = vl & ok_all[:, j] & wins
                h_t = torch.where(take, tj, h_t)
                h_obj = torch.where(take, torch.full_like(h_obj, j), h_obj)
    return h_t, h_obj, n_boxes, n_spheres


def tree_occluded_plain(tree: BounceTree, o, d, centers, radii, *, compat: bool,
                        cheap: bool, fan: int = FAN):
    """The kernels' tree shadow sweep (``occluded_tree``) over spheres only:
    ``(occluded (R,) bool, boxes, spheres)``, the box and sphere tests each
    ray made before its first occluder (or the end). ``fan``: the tree's
    leaves a parent."""
    R = o.shape[0]
    leaf, n_par = _tree_shape(tree, fan)
    occ_all = sphere_occludes_plain(o, d, centers, radii, compat=compat, cheap=cheap)
    t0, t1 = tree_spans(tree, o, d)
    t_max = FAR if compat else BIG
    occ = torch.zeros(R, dtype=torch.bool, device=o.device)
    n_boxes = torch.zeros(R, dtype=torch.int64, device=o.device)
    n_spheres = torch.zeros_like(n_boxes)
    perm = tree.perm.long().tolist()
    for p in range(n_par):
        vp = _visit(t0[:, p], t1[:, p], t_max) & ~occ
        n_boxes += ~occ
        for lf in range(p * fan, min((p + 1) * fan, tree.n_leaves)):
            n_boxes += vp & ~occ
            vl = vp & ~occ & _visit(t0[:, n_par + lf], t1[:, n_par + lf], t_max)
            for j in perm[lf * leaf:(lf + 1) * leaf]:
                n_spheres += vl & ~occ
                occ = occ | (vl & occ_all[:, j])
    return occ, n_boxes, n_spheres
