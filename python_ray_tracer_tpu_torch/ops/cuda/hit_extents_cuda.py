"""Hit extents through the hand-written CUDA kernel (``csrc/hit_extents.cu``).

Counterpart of ``render_pallas._hit_extents_pallas`` (TPU kernel
``_make_hit_extent_kernel``): per render tile and trace level, the box around
the biased hit points of the sample chains that the render kernel will start
shadow rays from, and their count, as rows ``[min xyz, max xyz, count, 0]``
of a float32 ``(n_tiles * n_levels, 8)`` tensor, levels fastest (a tile
without hits keeps ``+-1e30`` and count 0), and, into a ``scale`` buffer
where one is given, the largest coordinate magnitude of the rows with hits
(``cull_tables.extent_scale``, the plain scale). ``shadow_lists_cuda`` (the
list kernel, plain version ``cull_tables.shadow_visibility_lists``) turns the
rows and the scale into the render kernel's per-(tile, light) occluder lists.

:func:`hit_extents_cuda` takes CUDA tensors only (``ValueError`` on others,
before any launch); :func:`hit_extents_plain` (and ``extent_scale``) is the
plain version, by its own name. The plain version reduces the hit points of
``ops/intersect.py`` per tile with tensor ops; the tests and
``chip_smoke.py`` hold the kernel against it under :func:`extent_rule`, and
the kernel's scale against ``extent_scale`` of its own rows (bit for bit).
"""
from __future__ import annotations

import ctypes

import torch

from ..intersect import BIG, _all_t
from ..shade import BIAS, _surface_attributes, reflect
from . import render_cuda
from ...utils.config import require_cuda
from .cull_tables import LEAF, TILE, tile_grid, tree_box_words

MAX_LEVELS = 4     # trace levels a pass of the kernel keeps (csrc/hit_extents.cu)
# Kernel launches; a plain counter, reset with reset_launch_counts().
LAUNCHES = {"hit_extents": 0}
# Of those, the launches with bounce levels in the global form.
GLOBAL_LAUNCHES = {"hit_extents": 0}
HX_WARPS = 8                  # warps a block (csrc/hit_extents.cu)
TILE_WARPS = (1, 4)           # warps a tile without and with AA (RT_HX_*TILE_WARPS)
_PLAIN_BLOCK = 1 << 26   # elements of the plain version's largest intermediate


def reset_launch_counts() -> None:
    LAUNCHES["hit_extents"] = 0
    GLOBAL_LAUNCHES["hit_extents"] = 0


def staged_bytes(ns: int, npl: int, aliasing: bool, vis_k: int, tree) -> int:
    """Shared memory of a block of the launch with bounce levels in the
    staged form (csrc/hit_extents.cu): the parameters, the planes, each
    group's gathered slice (7 rows of ``vis_k``), the merge rows, the sphere
    table and the bounce tree (``tree``: a ``cull_tables.BounceTree`` or
    None)."""
    tw = TILE_WARPS[int(aliasing)]
    words = render_cuda.N_PARAMS + 9 * npl + (HX_WARPS // tw) * 7 * vis_k + \
        (HX_WARPS * MAX_LEVELS * 8 if tw > 1 else 0) + 7 * ns
    if tree is not None:
        words += tree_box_words(tree.n_leaves) + tree.n_leaves * LEAF
    return 4 * words


def _positions(n_tx: int, n_ty: int, tile: int, aliasing: bool, dev, x_offset: int = 0):
    """Sample positions a tile: ``(px, py)`` of shape ``(n_tx * n_ty, P)``, the
    centers and, with AA, the two half-axis grids and the corners (the render
    kernel's four shared grids: 256 + 272 + 272 + 289 positions at tile 16),
    in the frame's pixels (a slice's tiles start at ``x_offset``)."""
    grids = [(tile, tile, 0.0, 0.0)]
    if aliasing:
        grids += [(tile + 1, tile, -0.5, 0.0), (tile, tile + 1, 0.0, -0.5),
                  (tile + 1, tile + 1, -0.5, -0.5)]
    x0 = (torch.arange(n_tx, dtype=torch.float32, device=dev) * tile
          + float(x_offset))[:, None, None]
    y0 = (torch.arange(n_ty, dtype=torch.float32, device=dev) * tile)[None, :, None]
    px, py = [], []
    for nx, ny, du, dv in grids:
        kx, ky = torch.meshgrid(torch.arange(nx, dtype=torch.float32, device=dev),
                                torch.arange(ny, dtype=torch.float32, device=dev),
                                indexing="ij")
        gx, gy = torch.broadcast_tensors((x0 + du) + kx.reshape(-1), (y0 + dv) + ky.reshape(-1))
        px.append(gx.reshape(n_tx * n_ty, -1))
        py.append(gy.reshape(n_tx * n_ty, -1))
    return torch.cat(px, dim=1), torch.cat(py, dim=1)


def hit_extents_plain(camera, scene, *, aliasing: bool, compat: bool = True,
                      n_levels: int = 1, tile: int = TILE, vis=None, x_offset: int = 0,
                      local_width: int | None = None) -> torch.Tensor:
    """The hit-extent rows with plain tensor ops, on the inputs' device.

    ``tile`` is the tile's side in pixels. ``vis = (idx, cnt, k)``: the primary
    cone-cull lists of :func:`cull_tables.tile_visibility`; a tile's level-0
    closest hit then sweeps only its listed spheres (all of them where its
    count is -1), as the kernel does. ``x_offset`` / ``local_width``: the
    rows of the slice ``[x_offset, x_offset + local_width)``'s tiles, which
    keep the frame's bounds (the kernel's)."""
    W, H = camera.resolution
    lw = W - x_offset if local_width is None else local_width
    n_tx, n_ty = tile_grid(lw, H, tile)
    n_tiles = n_tx * n_ty
    dev = camera.device
    ns, npl = scene.spheres.count, scene.planes.count
    out = torch.zeros((n_tiles, n_levels, 8), dtype=torch.float32, device=dev)
    out[..., 0:3] = BIG
    out[..., 3:6] = -BIG
    if ns + npl == 0:
        return out.reshape(-1, 8)
    px, py = _positions(n_tx, n_ty, tile, aliasing, dev, x_offset)
    listed = None
    if vis is not None:
        idx, cnt, k = vis
        slots = torch.arange(k, device=dev)[None, :] < cnt[:, None]
        listed = torch.zeros((n_tiles, ns + 1), dtype=torch.bool, device=dev)
        # slots past a row's count go to the extra column
        listed.scatter_(1, torch.where(slots, idx.reshape(n_tiles, k).long(),
                                       torch.full_like(slots, ns, dtype=torch.long)),
                        torch.ones_like(slots))
        listed = listed[:, :ns] | (cnt < 0)[:, None]
    step = max(1, _PLAIN_BLOCK // (px.shape[1] * (ns + npl)))
    for t0 in range(0, n_tiles, step):
        sl = slice(t0, t0 + step)
        x, y = px[sl], py[sl]
        used = (x >= 0.0) & (x <= W - 1.0) & (y >= 0.0) & (y <= H - 1.0)
        d = camera.ray_directions(torch.stack([x, y], dim=-1), compat=compat)
        o = camera.ray_origin().expand(d.shape)
        for level in range(n_levels):
            t_all, _ = _all_t(o, d, scene, compat)
            if level == 0 and listed is not None:
                t_all = torch.cat([torch.where(listed[sl, None, :], t_all[..., :ns],
                                               torch.full_like(t_all[..., :ns], BIG)),
                                   t_all[..., ns:]], dim=-1)
            t = torch.amin(t_all, dim=-1)
            obj = torch.argmin(t_all, dim=-1)
            alive = t < BIG
            P = o + torch.where(alive, t, torch.zeros_like(t))[..., None] * d
            _, N = _surface_attributes(P, dict(obj=obj, is_plane=obj >= ns), scene)
            Pb = P + BIAS * N
            used = used & alive
            m = used[..., None]
            out[sl, level, 0:3] = torch.where(m, Pb, torch.full_like(Pb, BIG)).amin(dim=1)
            out[sl, level, 3:6] = torch.where(m, Pb, torch.full_like(Pb, -BIG)).amax(dim=1)
            out[sl, level, 6] = used.sum(dim=1).to(torch.float32)
            if level + 1 < n_levels:
                d = reflect(d, N)
                o = Pb + BIAS * d
    return out.reshape(-1, 8)


def extent_rule(rows: torch.Tensor, plain: torch.Tensor) -> dict:
    """Hold hit-extent rows against the plain version's. Counts must be equal
    and the rows of tiles without hits bit-equal (the sentinels). Each box
    coordinate must lie within ``1e-3 + 1e-6 m^2`` of the plain one, ``m`` the
    plain row's largest coordinate magnitude: at scene scale the two hit
    points differ by float32 reassociation (the kernel's hoisted quadratic and
    FMA contraction against the plain root form, ~1e-5), but a ground-plane
    hit near the horizon has ``t = h / (d . n)`` with ``d . n`` near 0, so a
    rounding of ``d . n`` moves ``t`` by ~1e-7 t^2 / h. Returns ``ok``,
    ``counts_equal``, ``sentinels_equal``, ``max_abs_err`` and ``ratio`` (the
    worst difference over its allowance)."""
    has = plain[:, 6] > 0
    counts_equal = bool(torch.equal(rows[:, 6:], plain[:, 6:]))
    sentinels_equal = bool(torch.equal(rows[~has], plain[~has]))
    err = ratio = 0.0
    if bool(has.any()):
        a, b = rows[has, :6], plain[has, :6]
        m = b.abs().amax(dim=1, keepdim=True)
        diff = (a - b).abs()
        err = float(diff.max())
        ratio = float((diff / (1e-3 + 1e-6 * m * m)).max())
    return dict(ok=counts_equal and sentinels_equal and ratio <= 1.0,
                counts_equal=counts_equal, sentinels_equal=sentinels_equal,
                max_abs_err=err, ratio=ratio)


def _check_table(name, t, dtype, n, dev):
    if t.device != dev or t.dtype != dtype or t.dim() != 1 or t.shape[0] != n or \
            not t.is_contiguous():
        raise ValueError(f"{name}: expected a contiguous {dtype} ({n},) tensor on {dev}, "
                         f"got {t.dtype} {tuple(t.shape)} on {t.device}")


def check_tables(vis, shadow, tree, *, n_tiles: int, ns: int, nl: int, dev,
                 cells=None) -> None:
    """Raise on tables the kernels do not take: ``vis = (idx, cnt, k)``,
    ``shadow = (idx, cnt, k, levels)`` (rows ``(tile * levels + level) *
    nl + light``), ``tree`` a ``cull_tables.BounceTree`` of the kernels' shape
    (``cull_tables.LEAF`` / ``FAN``) whose leaves hold every sphere's slot,
    ``cells`` a ``light_cells_cuda.LightCells`` of the kernels' shape for
    ``nl`` lights, each or None."""
    if vis is not None:
        idx, cnt, k = vis
        if not 1 <= k <= ns:
            raise ValueError(f"primary lists: k={k} for {ns} spheres")
        _check_table("primary list indices", idx, torch.int32, n_tiles * k, dev)
        _check_table("primary list counts", cnt, torch.int32, n_tiles, dev)
    if shadow is not None:
        idx, cnt, k, levels = shadow
        if not 1 <= k <= ns or nl < 1 or levels < 1:
            raise ValueError(f"shadow lists: k={k}, {levels} levels for {ns} spheres, "
                             f"{nl} lights")
        rows = n_tiles * levels * nl
        _check_table("shadow list indices", idx, torch.int32, rows * k, dev)
        _check_table("shadow list counts", cnt, torch.int32, rows, dev)
    if tree is not None:
        if tree.n_leaves * LEAF < max(ns, 1) or (tree.n_leaves - 1) * LEAF >= ns:
            raise ValueError(f"bounce tree: {tree.n_leaves} leaves of {LEAF} for {ns} "
                             f"spheres")
        _check_table("tree sweep order", tree.perm, torch.int32, tree.n_leaves * LEAF, dev)
        _check_table("tree boxes", tree.box, torch.float32, tree_box_words(tree.n_leaves),
                     dev)
    if cells is not None:
        from .light_cells_cuda import check_cells
        check_cells(cells, nl, dev)


def table_args(vis, shadow, tree, cells=None) -> list:
    """The C argument lists of the four tables, in the order the entry
    points take them: ``[idx, cnt, k]`` for the primary lists, ``[idx, cnt,
    k, levels]`` for the shadow lists, ``[perm, box, n_leaves]`` for the tree,
    ``[idx, cnt, hdr]`` for the light cells (null pointers and zeros for one
    that is off; the shadow lists' levels 1)."""
    args = [[None, None, 0] if vis is None else
            [vis[0].data_ptr(), vis[1].data_ptr(), int(vis[2])],
            [None, None, 0, 1] if shadow is None else
            [shadow[0].data_ptr(), shadow[1].data_ptr(), int(shadow[2]),
             int(shadow[3])]]
    args.append([None, None, 0] if tree is None else
                [tree.perm.data_ptr(), tree.box.data_ptr(), tree.n_leaves])
    args.append([None, None, None] if cells is None else
                [cells.idx.data_ptr(), cells.cnt.data_ptr(), cells.hdr.data_ptr()])
    return args


def check_scale(scale, dev) -> None:
    """Raise on a scale buffer the kernels do not take (a contiguous float32
    ``(1,)`` tensor on ``dev``)."""
    if not isinstance(scale, torch.Tensor) or scale.device != dev or \
            scale.dtype != torch.float32 or scale.shape != (1,) or not scale.is_contiguous():
        got = (f"{scale.dtype} {tuple(scale.shape)} on {scale.device}"
               if isinstance(scale, torch.Tensor) else repr(scale))
        raise ValueError(f"scale: expected a contiguous float32 (1,) tensor on {dev}, got {got}")


def launch(out, params, tables, counts, *, W: int, H: int, aliasing: bool, compat: bool,
           n_levels: int, vis=None, tree=None, scale=None, lib=None,
           W_global: int | None = None, form: int | None = None) -> torch.Tensor:
    """Launch the kernel on the current stream for inputs already packed and
    checked: ``out (n_tiles * n_levels, 8)``, ``params`` and ``tables`` as for
    ``render_cuda.launch``; ``vis``, ``tree`` and ``scale`` (a ``(1,)``
    float32 buffer for the rows' scale, or None) are checked here. ``W``:
    the slice's width where ``W_global`` (the frame's, default ``W``) is
    wider, its offset the packed ``P_X0``. ``lib``: a
    library built with other warps a tile (``-DRT_HX_TILE_WARPS`` /
    ``-DRT_HX_AA_TILE_WARPS``, chip_smoke.py's sweep), default the package's.
    A launch with bounce levels stages the scene and the tree in the form
    ``render_cuda.scene_form`` gives for :func:`staged_bytes` (``form``:
    another, the same rows). Counts the launch in :data:`LAUNCHES`."""
    from ._build import load_library
    lib = lib or load_library()
    (sph, pln, _), (ns, npl, nl) = tables, counts
    check_tables(vis, None, tree, n_tiles=out.shape[0] // n_levels, ns=ns, nl=nl,
                 dev=out.device)
    if scale is not None:
        check_scale(scale, out.device)
    v, _, g, _ = table_args(vis, None, tree)
    if n_levels == 1:
        form = 0
    elif form is None:
        form = render_cuda.scene_form(
            ns, npl, nl,
            staged_bytes=staged_bytes(ns, npl, aliasing, 0 if vis is None else int(vis[2]),
                                      tree),
            limit=render_cuda.SMEM_BLOCK)
    rc = lib.rt_hit_extents(
        params.data_ptr(), sph.data_ptr(), ns, pln.data_ptr(), npl, out.data_ptr(),
        None if scale is None else scale.data_ptr(), W, H,
        W if W_global is None else W_global, n_levels, int(aliasing),
        int(compat), *v, *g, int(form), ctypes.c_void_p(torch.cuda.current_stream().cuda_stream))
    if rc != 0:
        raise RuntimeError(f"hit-extent kernel failed: CUDA error {rc} "
                           f"({lib.rt_error_string(rc).decode()})")
    LAUNCHES["hit_extents"] += 1
    if form:
        GLOBAL_LAUNCHES["hit_extents"] += 1
    return out


def hit_extents_cuda(camera, scene, *, aliasing: bool, compat: bool = True,
                     n_levels: int = 1, vis=None, tree=None, scale=None, x_offset: int = 0,
                     local_width: int | None = None) -> torch.Tensor:
    """Hit-extent rows ``(n_tiles * n_levels, 8)`` of a render of ``scene``
    from ``camera``, for 16x16 tiles. ``vis`` and ``tree`` are the primary
    lists and the bounce tree the render will use (``cull_tables``), so the
    hit points are the render kernel's own. ``scale``: a ``(1,)`` float32
    buffer on the camera's device that receives the rows' scale
    (``cull_tables.extent_scale``), or None. ``x_offset`` / ``local_width``:
    the rows of that slice's tiles (``render_cuda.render_image_cuda``'s
    slice). CUDA tensors only (``ValueError`` on others): one launch of the
    kernel."""
    dev = require_cuda("hit_extents_cuda", camera.position)
    lw = render_cuda.slice_width(camera, x_offset, local_width)
    if scale is not None:
        check_scale(scale, dev)
    if n_levels < 1:
        raise ValueError(f"n_levels must be at least 1, got {n_levels}")
    render_cuda._check_inputs(camera, scene, dev)
    W, H = camera.resolution
    if W < 1 or H < 1:
        raise ValueError(f"empty resolution {camera.resolution}")
    n_tx, n_ty = tile_grid(lw, H)
    counts = (scene.spheres.count, scene.planes.count, scene.lights.count)
    params = render_cuda.pack_params(camera, scene, compat, x_offset).to(dev)
    out = torch.empty((n_tx * n_ty * n_levels, 8), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        return launch(out, params, render_cuda.scene_tables(scene), counts, W=lw, H=H,
                      W_global=W, aliasing=aliasing, compat=compat, n_levels=n_levels,
                      vis=vis, tree=tree, scale=scale)
