"""Forward render through the hand-written CUDA kernel (``csrc/render_fwd*.cu*``).

Counterpart of ``python_ray_tracer_tpu/ops/pallas/render_pallas.py``: one launch
covers ray generation, closest hit, shading with shadow rays, mirror bounces and
the AA accumulation with the compat swaps. Three kernel modes:

  * ``aa_none``: no AA (the TPU ``_make_kernel`` at S=1);
  * ``aa_per_sample``: 9 samples walked per thread (``_make_kernel`` at S=9);
  * ``aa_shared``: the 4 shared half-offset sample grids of
    ``_make_kernel_aa_shared``, evaluated per block into shared memory.

Scenes of more than :data:`CULL_MIN_SPHERES` spheres take the large-scene path
(``render_pallas._render_image_pallas``'s, with the same three keywords): the
per-tile cone cull of the primary sweep, the two-pass shadow pipeline (the
hit-extent kernel, ``hit_extents_cuda``, then the list kernel,
``shadow_lists_cuda``: per-(tile, light) occluder lists for the level-0 shadow
sweeps), per-light direction-cell occluder lists for the
bounce-level shadow rays (the light cells, built on the card by the kernel of
``light_cells_cuda``; with the shadow lists, where the frame has bounces) and,
from :data:`GROUP_MIN_SPHERES` spheres up, bounce sweeps through a two-level box
tree over the Morton order (the ``group_cull`` keyword;
``cull_tables.bounce_tree``). :func:`large_scene_tables` builds the tables
(``cull_tables``, ``hit_extents_cuda``, ``shadow_lists_cuda``,
``light_cells_cuda``) for each frame. Every cull is exact:
the image is bit-identical to the full sweep's. No scene is too large: past
the size whose tables a block stages, a launch takes the kernels' global form
(:func:`scene_form`; ``csrc/render_fwd_global.cu``), the same bits.

:func:`render_image_cuda` takes CUDA tensors only: on tensors anywhere else it
raises ``ValueError`` and launches nothing (the plain PyTorch version is
``ops/render.render_image``, by its own name). Camera,
grid and material scalars are packed on the host into the TPU kernel's ``_P_*``
parameter layout (:func:`pack_params`). Every entry point takes the slice form
of ``render_pallas._render_image_pallas``: ``x_offset`` and ``local_width``
render columns ``[x_offset, x_offset + local_width)`` of the camera's frame,
with rays from the frame's pixel indices and the frame's border ring, so
frames stitched from slices equal the whole frame bit for bit (the
ray-parallel package, ``parallel/``). :func:`render_image_fast` is the
differentiable form (``render_pallas.render_image_fast``): the render kernel
forward, the backward kernel (``render_bwd_cuda``) for its gradient.
"""
from __future__ import annotations

import ctypes

import numpy as np
import torch

from ...models.camera import Camera
from ...models.scene import Scene
from ...utils.config import require_cuda
from ..intersect import FAR
from . import cull_tables

# AA half-offsets in (x, y) index space; s=0 is the primary (center) sample
# (reference kernels.py:32-50).
AA_OFFSETS = ((0.0, 0.0), (-0.5, 0.0), (0.5, 0.0), (0.0, 0.5), (0.0, -0.5),
              (-0.5, 0.5), (0.5, 0.5), (-0.5, -0.5), (0.5, -0.5))

# params vector layout (same as the TPU kernel's; mirrored in csrc/rt_common.cuh)
P_ORIGIN = 0      # 3: camera origin
P_ROT = 3         # 9: rotation, row-major
P_FOCAL = 12
P_Y0, P_DY, P_Z0, P_DZ = 13, 14, 15, 16
P_AMB, P_LAMB, P_REFL = 17, 18, 19
P_SPEC, P_SHIN = 20, 21   # Phong specular/shininess (clean mode only)
P_X0 = 22         # global x of a ray-parallel slice's first column
P_OFFS = 23       # 2*9: AA offsets
N_PARAMS = P_OFFS + 2 * len(AA_OFFSETS)

MODES = ("aa_none", "aa_per_sample", "aa_shared")   # C enum order
# Kernel launches per mode; a plain counter, reset with reset_launch_counts().
LAUNCHES = {m: 0 for m in MODES}
# Of those, the launches in the global form (scene_form 1).
GLOBAL_LAUNCHES = {m: 0 for m in MODES}

# Shared memory a block may use (227 KB), and what the render kernel may stage
# beside the shared-AA sample grids: the parameters, the scene's tables and,
# on the large-scene path, the bounce tree, the tile's primary list and its
# per-light occluder lists.
SMEM_BLOCK = 227 * 1024
_SMEM_LIMIT = SMEM_BLOCK - 3 * 4 * 1089

# The forms of a kernel that stages the scene (scene_form): the staged form and
# the global form (the sphere table and the bounce tree read where they lie in
# device memory).
FORMS = ("staged", "global")

# The large-scene path's automatic thresholds (the JAX package's): the cone
# cull and the shadow lists for more spheres than CULL_MIN_SPHERES, the bounce
# tree (the JAX package's Morton groups) from GROUP_MIN_SPHERES spheres up.
CULL_MIN_SPHERES = 16
GROUP_MIN_SPHERES = 256


def reset_launch_counts() -> None:
    for m in MODES:
        LAUNCHES[m] = 0
        GLOBAL_LAUNCHES[m] = 0


def slice_width(camera, x_offset: int = 0, local_width: int | None = None) -> int:
    """The width of the slice ``[x_offset, x_offset + local_width)`` of the
    camera's frame (``local_width`` None: the frame's width, as the JAX
    wrappers take it); raises ``ValueError`` for a slice that is not whole
    columns inside the frame."""
    W = camera.resolution[0]
    lw = W if local_width is None else local_width
    if int(x_offset) != x_offset or int(lw) != lw or x_offset < 0 or lw < 1 or \
            x_offset + lw > W:
        raise ValueError(f"slice [{x_offset}, {x_offset} + {lw}) is not inside the "
                         f"frame's {W} columns")
    return int(lw)


def pack_params(camera, scene, compat: bool, x_offset: int = 0) -> torch.Tensor:
    """The 41-float parameter vector (``render_pallas._pack_params``), computed
    on the CPU in float32 whatever the device of the inputs; ``x_offset`` is
    the global x of a slice's first column (``P_X0``)."""
    cam = camera.to("cpu")
    m = scene.materials
    focal, y0, dy, z0, dz = cam.grid_params(compat)
    mats = torch.stack([m.ambient, m.lambert, m.reflection, m.specular,
                        m.shininess]).to("cpu", torch.float32)
    return torch.cat([
        cam.position.float(), cam.rotation.float().reshape(-1),
        torch.stack([focal, y0, dy, z0, dz]), mats,
        torch.tensor([float(x_offset)], dtype=torch.float32),
        torch.tensor(AA_OFFSETS, dtype=torch.float32).reshape(-1)])


def list_levels(depth: int, shadow_list_levels: int | None = None) -> int:
    """The trace levels that get shadow lists, as the JAX wrapper resolves
    ``shadow_list_levels`` (``render_pallas._render_image_pallas``): None is
    level 0 alone, else ``max(1, min(depth + 1, shadow_list_levels))``."""
    if shadow_list_levels is None:
        return 1
    return max(1, min(depth + 1, int(shadow_list_levels)))


def shadow_cheap_ok(scene, compat: bool) -> bool:
    """Whether the sqrt-free shadow test is exact for this scene
    (``render_pallas._shadow_cheap_ok``): always in clean mode; in compat mode
    only if every radius is < FAR/2, else a shadow segment can sit inside a
    ball whose selected root passes the 999 clip."""
    if not compat:
        return True
    r = scene.spheres.radius.detach().cpu().numpy()
    return bool(np.all(r < 0.5 * FAR))


def scene_tables(scene):
    """SoA tables ``sph (7,ns)``, ``pln (9,npl)``, ``lts (3,nl)`` on the scene's
    device, with albedo in [0,1] (a zero column stands in for an empty set)."""
    s, p, l = scene.spheres, scene.planes, scene.lights
    dev = scene.device

    def table(parts, rows, n):
        if n == 0:
            return torch.zeros((rows, 1), device=dev)
        return torch.cat(parts).float().contiguous()
    sph = table([s.center.T, s.radius[None], s.albedo.T], 7, s.count)
    pln = table([p.origin.T, p.normal.T, p.albedo.T], 9, p.count)
    lts = table([l.position.T], 3, l.count)
    return sph, pln, lts


def uses_tree(ns: int, depth: int, group_cull: bool | None = None) -> bool:
    """Whether :func:`large_scene_tables` builds the bounce tree: ``group_cull``
    (None: from :data:`GROUP_MIN_SPHERES` spheres up), on the large-scene
    path, for a render with bounces."""
    want = ns >= GROUP_MIN_SPHERES if group_cull is None else bool(group_cull)
    return want and ns > CULL_MIN_SPHERES and depth > 0


def _smem_bytes(ns: int, npl: int, nl: int, tree: bool = False, levels: int = 1) -> int:
    """Shared memory a block stages beside the AA sample grids, with both
    lists on at their largest row capacity, the shadow lists of ``levels``
    trace levels, and, with ``tree``, the bounce tree (~2.7 words a sphere:
    with it, 1 plane, 3 lights and one listed level, the largest scene is 5600
    spheres; without it, 7753)."""
    words = N_PARAMS + 7 * ns + 9 * npl + 3 * nl
    if ns > CULL_MIN_SPHERES:
        k = cull_tables.list_capacity(ns)
        words += k + levels * nl * (k + 1)
        if tree:
            n_leaves = -(-ns // cull_tables.LEAF)
            words += cull_tables.tree_box_words(n_leaves) + n_leaves * cull_tables.LEAF
    return 4 * words


def scene_form(ns: int, npl: int, nl: int, tree: bool = False,
               staged_bytes: int | None = None, limit: int = _SMEM_LIMIT,
               levels: int = 1) -> int:
    """The form (an index of :data:`FORMS`) of a kernel that stages the scene,
    one rule for every such kernel: staged where its staged form's shared
    memory (``staged_bytes``; default the render kernel's, :func:`_smem_bytes`
    with ``tree`` and the shadow lists of ``levels`` trace levels) fits
    ``limit`` (default the render kernel's room beside the AA sample grids);
    else global. At 1 plane, 3 lights and one listed level the render kernel
    stages up to 7753 spheres (5600 with the tree); more listed levels move
    those sizes down. Every scene the staged form takes keeps it, so those
    frames do not change."""
    b = _smem_bytes(ns, npl, nl, tree, levels) if staged_bytes is None else staged_bytes
    return int(b > limit)


def _check_inputs(camera, scene, dev):
    """Raise on inputs the kernels do not take: a tensor off ``dev``, not
    float32, or of another shape than the scene's counts give. No scene is too
    large: past the size a block stages, the kernels take their global form
    (:func:`scene_form`)."""
    tensors = {"camera.position": camera.position, "camera.rotation": camera.rotation,
               "camera.fov": camera.fov}
    for grp in ("spheres", "planes", "lights", "materials"):
        obj = getattr(scene, grp)
        for k, v in vars(obj).items():
            tensors[f"scene.{grp}.{k}"] = v
    for name, t in tensors.items():
        if t.device != dev:
            raise ValueError(f"{name} is on {t.device}, expected {dev}")
        if t.dtype != torch.float32:
            raise TypeError(f"{name} has dtype {t.dtype}, expected float32")
    ns, npl, nl = scene.spheres.count, scene.planes.count, scene.lights.count
    shapes = {"spheres.center": (scene.spheres.center, (ns, 3)),
              "spheres.radius": (scene.spheres.radius, (ns,)),
              "spheres.albedo": (scene.spheres.albedo, (ns, 3)),
              "planes.origin": (scene.planes.origin, (npl, 3)),
              "planes.normal": (scene.planes.normal, (npl, 3)),
              "planes.albedo": (scene.planes.albedo, (npl, 3)),
              "lights.position": (scene.lights.position, (nl, 3)),
              "camera.rotation": (camera.rotation, (3, 3)),
              "camera.position": (camera.position, (3,))}
    for name, (t, want) in shapes.items():
        if tuple(t.shape) != want:
            raise ValueError(f"{name} has shape {tuple(t.shape)}, expected {want}")


def large_scene_tables(camera, scene, *, depth: int, aliasing: bool, compat: bool,
                       cull: bool = True, shadow_lists: bool | None = None,
                       group_cull: bool | None = None, K: int | None = None,
                       packed=None, light_cells: bool = True, x_offset: int = 0,
                       local_width: int | None = None,
                       shadow_list_levels: int | None = None):
    """The render kernel's tables for this frame: ``(vis, shadow, tree,
    cells)``, ``(idx, cnt, k)``, ``(idx, cnt, k, levels)``, a
    ``cull_tables.BounceTree`` and a ``light_cells_cuda.LightCells``, each
    None where that cull is off (``render_pallas._render_image_pallas``'s
    resolution of its ``cull``, ``shadow_lists``, ``group_cull`` and
    ``shadow_list_levels``; None is "auto"). The cone cull and the shadow
    lists need more than :data:`CULL_MIN_SPHERES` spheres (the lists also a
    light); the bounce tree (``group_cull``, the JAX package's Morton groups)
    is automatic from :data:`GROUP_MIN_SPHERES` spheres and needs ``depth >
    0``. The shadow lists cover the first ``levels`` trace levels
    (:func:`list_levels`: level 0 alone by default; rows ``(tile * levels +
    level) * nl + light``) and come from one launch of the hit-extent kernel
    on the same primary lists (and, past level 0, the same bounce tree, so
    its bounce hit points are the render's), then one launch of the list
    kernel on its rows and scale (``shadow_lists_cuda``; no host sync between
    them). The JAX package
    switches its Morton groups off where ``levels > 1``; the tree stays on
    here, since the hit-extent kernel sweeps it as the render does. The light
    cells, the lists of the bounce shadow rays past the listed levels, come
    from one launch of the light-cell kernel where the shadow lists are on and
    ``depth >= levels`` (``light_cells=False`` leaves them off, for the tests
    and ``chip_smoke.py``). ``K``: slots a tile list row (default
    ``cull_tables.list_capacity``; the light cells' slots are the kernels'
    constant). ``packed``: the caller's ``(params, scene_tables, counts)`` for
    checked CUDA inputs, which the hit-extent and light-cell launches then
    share instead of packing them again. ``x_offset`` / ``local_width``: the
    tables of that slice's tiles (its primary lists from cones in the frame's
    pixels, its hit extents at the frame's positions); the bounce tree and
    the light cells depend on the scene alone and are the frame's."""
    from . import hit_extents_cuda as hx
    from .light_cells_cuda import light_cells_cuda
    from .shadow_lists_cuda import shadow_lists_cuda
    ns, nl = scene.spheres.count, scene.lights.count
    rolled = ns > CULL_MIN_SPHERES
    k = cull_tables.list_capacity(ns) if K is None else min(K, ns)
    vis = shadow = tree = cells = None
    lw = slice_width(camera, x_offset, local_width)
    if cull and rolled:
        vis = (*cull_tables.tile_visibility(camera, scene, compat=compat, K=k,
                                            x_offset=x_offset, local_width=lw), k)
    if uses_tree(ns, depth, group_cull):
        tree = cull_tables.bounce_tree(scene.spheres.center, scene.spheres.radius)
    lists = (shadow_lists is None or shadow_lists) and rolled and nl > 0
    levels = list_levels(depth, shadow_list_levels)
    if lists and light_cells and depth >= levels:
        sph, _, lts = scene_tables(scene) if packed is None else packed[1]
        cells = light_cells_cuda(sph, lts, ns, nl)
    if lists:
        scale = torch.empty(1, dtype=torch.float32, device=camera.device)
        bounce_tree = tree if levels > 1 else None
        if packed is None:
            ext = hx.hit_extents_cuda(camera, scene, aliasing=aliasing, compat=compat,
                                      n_levels=levels, vis=vis, tree=bounce_tree,
                                      scale=scale, x_offset=x_offset, local_width=lw)
        else:
            W, H = camera.resolution
            n_tx, n_ty = cull_tables.tile_grid(lw, H)
            ext = hx.launch(torch.empty((n_tx * n_ty * levels, 8), dtype=torch.float32,
                                        device=camera.device), *packed, W=lw, H=H,
                            W_global=W, aliasing=aliasing, compat=compat, n_levels=levels,
                            vis=vis, tree=bounce_tree, scale=scale)
        shadow = (*shadow_lists_cuda(ext, scale, scene.lights.position, scene.spheres.center,
                                     scene.spheres.radius, K=k, compat=compat), k, levels)
    return vis, shadow, tree, cells


def render_image_cuda(camera, scene, *, depth: int = 2, aliasing: bool = True,
                      compat: bool = True, aa_share: bool = True, cull: bool = True,
                      shadow_cull: bool = False, cheap_shadow: bool | None = None,
                      shadow_lists: bool | None = None,
                      shadow_list_levels: int | None = None,
                      group_cull: bool | None = None, x_offset: int = 0,
                      local_width: int | None = None) -> torch.Tensor:
    """Render -> float ``(w, h, 3)`` image, as :func:`..render.render_image`;
    with ``x_offset`` / ``local_width`` the ``(local_width, h, 3)`` slice of
    it at those columns (``render_pallas.render_image_pallas``'s).

    CUDA tensors only (``ValueError`` on others, before any launch): the
    kernel on the current stream (mode
    ``aa_shared`` when ``aliasing and aa_share``, ``aa_per_sample`` for AA
    without sharing, else ``aa_none``), after the hit-extent and list kernels
    where the shadow lists are on. ``cull``, ``shadow_lists``,
    ``shadow_list_levels`` and ``group_cull`` are the JAX wrapper's
    (:func:`large_scene_tables`); ``cheap_shadow`` picks the sqrt-free
    shadow test (None: :func:`shadow_cheap_ok`, as the JAX wrapper resolves
    it; pass True only for a scene where that holds). ``shadow_cull`` (the
    JAX wrapper's runtime capsule cull of the shadow sweeps that have no list)
    is taken for the JAX signature and changes no launch: at the defaults
    every shadow sweep of a large scene has a table here (the lists at the
    listed levels, the light cells past them), each as exact as the capsule.
    None of them changes a pixel."""
    lw = slice_width(camera, x_offset, local_width)
    require_cuda("render_image_cuda", camera.position)
    mode = ("aa_shared" if aa_share else "aa_per_sample") if aliasing else "aa_none"
    return render_packed(camera, scene, packed_inputs(camera, scene, depth=depth,
                                                      compat=compat, x_offset=x_offset),
                         depth=depth, mode=mode, compat=compat, cull=cull,
                         shadow_lists=shadow_lists, group_cull=group_cull,
                         x_offset=x_offset, local_width=lw, cheap_shadow=cheap_shadow,
                         shadow_list_levels=shadow_list_levels)


def packed_inputs(camera, scene, *, depth: int, compat: bool, x_offset: int = 0):
    """Check CUDA inputs (device, dtype, shapes, depth, resolution) and pack
    them for the kernels: ``(params, tables, counts)``, the parameter
    vector (``x_offset`` in ``P_X0``) and :func:`scene_tables` on the camera's
    device and ``(ns, npl, nl)``."""
    dev = require_cuda("the render kernels", camera.position)
    if depth < 0:
        raise ValueError(f"depth must be >= 0, got {depth}")
    _check_inputs(camera, scene, dev)
    W, H = camera.resolution
    if W < 1 or H < 1:
        raise ValueError(f"empty resolution {camera.resolution}")
    slice_width(camera, x_offset, W - x_offset)
    return (pack_params(camera, scene, compat, x_offset).to(dev), scene_tables(scene),
            (scene.spheres.count, scene.planes.count, scene.lights.count))


def render_packed(camera, scene, packed, *, depth: int, mode: str, compat: bool,
                  cull: bool = True, shadow_lists: bool | None = None,
                  group_cull: bool | None = None, tabs=None, x_offset: int = 0,
                  local_width: int | None = None, cheap_shadow: bool | None = None,
                  shadow_list_levels: int | None = None) -> torch.Tensor:
    """:func:`render_image_cuda`'s CUDA path on :func:`packed_inputs`: the
    large-scene tables (with the hit-extent and list kernels where the shadow
    lists are on; ``tabs``, :func:`large_scene_tables`' result, where the
    caller has them already), then one launch of the render kernel in
    ``mode``. ``x_offset`` / ``local_width``: the slice, whose offset the
    packed parameters must hold (:func:`packed_inputs`)."""
    params, tables, counts = packed
    dev = params.device
    W, H = camera.resolution
    lw = slice_width(camera, x_offset, local_width)
    out = torch.empty((lw, H, 3), dtype=torch.float32, device=dev)
    cheap = shadow_cheap_ok(scene, compat) if cheap_shadow is None else bool(cheap_shadow)
    with torch.cuda.device(dev):
        vis, shadow, tree, cells = tabs if tabs is not None else large_scene_tables(
            camera, scene, depth=depth, aliasing=mode != "aa_none", compat=compat,
            cull=cull, shadow_lists=shadow_lists, group_cull=group_cull, packed=packed,
            x_offset=x_offset, local_width=lw, shadow_list_levels=shadow_list_levels)
        return launch(out, params, tables, counts, depth=depth,
                      mode=mode, compat=compat, cheap_shadow=cheap, vis=vis,
                      shadow=shadow, tree=tree, cells=cells, W_global=W)


def launch(out, params, tables, counts, *, depth: int, mode: str, compat: bool,
           cheap_shadow: bool, vis=None, shadow=None, tree=None,
           cells=None, W_global: int | None = None, form: int | None = None) -> torch.Tensor:
    """Launch the kernel on the current stream for inputs already packed and
    checked by :func:`packed_inputs`: ``out (W, H, 3)``, ``params
    (N_PARAMS,)``, the :func:`scene_tables` and the object counts
    ``(ns, npl, nl)``, all tensors float32 and contiguous on the current
    device; ``vis``, ``shadow``, ``tree`` and ``cells`` as
    :func:`large_scene_tables` returns them (int32 lists for 16x16 tiles,
    checked here). ``W_global``: the frame's width where ``out`` is a slice
    of it (at the packed ``P_X0``; default ``out``'s width). A scene of more
    than :data:`CULL_MIN_SPHERES` spheres runs the kernel's large-scene
    instantiation whichever tables are on, so a render with every table off
    differs from a culled one only in the sweeps, in the form
    :func:`scene_form` gives it (``form``: another, for the tests and
    ``chip_smoke.py``; the same bits in each). Counts the launch in
    :data:`LAUNCHES` (and :data:`GLOBAL_LAUNCHES`)."""
    from ._build import load_library
    from .hit_extents_cuda import check_tables, table_args
    lib = load_library()
    W, H = out.shape[0], out.shape[1]
    Wg = W if W_global is None else W_global
    (sph, pln, lts), (ns, npl, nl) = tables, counts
    n_tx, n_ty = cull_tables.tile_grid(W, H)
    check_tables(vis, shadow, tree, n_tiles=n_tx * n_ty, ns=ns, nl=nl, dev=out.device,
                 cells=cells)
    v, sh, g, c = table_args(vis, shadow, tree, cells)
    large = ns > CULL_MIN_SPHERES
    if form is None:
        form = scene_form(ns, npl, nl, tree is not None,
                          levels=1 if shadow is None else shadow[3]) if large else 0
    if form and not large:
        raise ValueError(f"a scene of {ns} spheres has no global form")
    args = (params.data_ptr(), sph.data_ptr(), ns, pln.data_ptr(), npl, lts.data_ptr(), nl,
            out.data_ptr(), W, H, Wg, depth, MODES.index(mode), int(compat),
            int(cheap_shadow))
    stream = ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)
    if form:
        rc = lib.rt_render_fwd_global(*args, *v, *sh, *g, *c, stream)
    else:
        rc = lib.rt_render_fwd(*args, int(large), *v, *sh, *g, *c, stream)
    if rc != 0:
        raise RuntimeError(f"render kernel ({mode}, {FORMS[form]}) failed: CUDA error {rc} "
                           f"({lib.rt_error_string(rc).decode()})")
    LAUNCHES[mode] += 1
    if form:
        GLOBAL_LAUNCHES[mode] += 1
    return out


class _RenderImageFast(torch.autograd.Function):
    """Render kernel forward; backward kernel (cotangent mode, camera slots
    included) backward, through the forward's own large-scene tables (the
    same camera, scene and samples). Inputs after the five settings: the
    camera's position, rotation and fov, then the scene's 12 tensors in
    dataclass order."""

    @staticmethod
    def forward(ctx, resolution, depth, aliasing, compat, culls, *leaves):
        camera, scene = _assemble(resolution, leaves)
        ctx.settings = (resolution, depth, aliasing, compat)
        ctx.save_for_backward(*leaves)
        cull, shadow_lists, group_cull = culls
        packed = packed_inputs(camera, scene, depth=depth, compat=compat)
        with torch.cuda.device(camera.position.device):
            ctx.tabs = large_scene_tables(camera, scene, depth=depth, aliasing=aliasing,
                                          compat=compat, cull=cull,
                                          shadow_lists=shadow_lists, group_cull=group_cull,
                                          packed=packed)
        return render_packed(camera, scene, packed, depth=depth,
                             mode="aa_shared" if aliasing else "aa_none", compat=compat,
                             tabs=ctx.tabs)

    @staticmethod
    def backward(ctx, g):
        from .render_bwd_cuda import scene_grads_cuda
        resolution, depth, aliasing, compat = ctx.settings
        camera, scene = _assemble(resolution, ctx.saved_tensors)
        scene_g, cam_g = scene_grads_cuda(camera, scene, g.float().contiguous(),
                                          depth=depth, compat=compat,
                                          aliasing=aliasing, return_camera=True,
                                          tabs=ctx.tabs)
        return (None, None, None, None, None, cam_g.position, cam_g.rotation,
                cam_g.fov, *scene_g.leaves())


def _assemble(resolution, leaves):
    pos, rot, fov, *s = leaves
    return Camera(pos, rot, fov, resolution), Scene.from_leaves(s)


def render_image_fast(camera, scene, depth: int = 2, aliasing: bool = True,
                      compat: bool = True, cull: bool = True,
                      shadow_lists: bool | None = None,
                      group_cull: bool | None = None) -> torch.Tensor:
    """Differentiable render -> float ``(w, h, 3)`` of CUDA tensors (others
    raise ``ValueError``; autograd of ``ops/render.render_image`` is the
    plain version): the forward is the render kernel (on the large-scene
    path for a large scene, with :func:`render_image_cuda`'s three cull
    keywords) and the backward is the
    backward kernel, for the scene and the camera alike, through the same
    tables (every cull is exact, so its recomputed forward is the render
    kernel's). No light-count fallback: the kernel has no such limit."""
    require_cuda("render_image_fast", camera.position)
    return _RenderImageFast.apply(tuple(camera.resolution), depth, aliasing, compat,
                                  (cull, shadow_lists, group_cull),
                                  camera.position, camera.rotation, camera.fov,
                                  *scene.leaves())
