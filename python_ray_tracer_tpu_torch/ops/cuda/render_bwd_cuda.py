"""Scene and camera gradients through the hand-written CUDA backward kernel
(``csrc/render_bwd.cu``).

Counterpart of ``python_ray_tracer_tpu/ops/pallas/render_bwd.py``. The kernel
recomputes each sample chain's forward pass, reverse-sweeps it with
hand-derived adjoints, and adds the adjoints into per-thread columns (or, for
large scenes, per-warp rows) of the flat gradient vector of
:func:`grad_layout`, which each block reduces once into its partial column; a
second kernel sums the per-block partials in a fixed order, so two runs give
the same bits. :func:`plan` picks the launch (threads a block, the grid,
columns or rows). Four kernel modes:

  * ``cot_noaa`` / ``cot_aa``: an image cotangent in (:func:`scene_grads_cuda`);
    the AA form traces the forward's shared-sample lattice, 1089 chains a
    16x16 tile, each with the cotangent :func:`lattice_cotangents` gives it.
    It is also the adjoint of the ``aa_per_sample`` render
    (``scene_grads_cuda(aliasing=True, aa_share=False)``): the AA offsets are
    0 and +-0.5, so a pixel's half-offset samples are its neighbours' (the
    same float32 positions, the same rays), and the per-sample combine's
    adjoint at each distinct position is the cotangent the lattice gives it;
  * ``fused_noaa``: the training step in one launch: render, MSE against the
    target, loss slot, reverse sweep (:func:`loss_and_scene_grads_cuda`);
  * ``fused_aa``: the AA training step, in one of two forms. Two launches:
    the ``aa_shared`` render kernel makes the image, then the backward kernel
    forms the loss and cotangent per pixel and runs the lattice's reverse
    chains. One launch (the kernel's ``FUSED_AA1``): each block traces its
    tile's lattice chains through the render's own trace, keeping each
    trace's (t, hit object, occlusion bits) in a device-memory record buffer
    (:func:`rec_floats`), forms the pixels, the loss and the cotangents from
    their colors, and replays the records in the reverse sweep with no
    closest-hit or shadow sweep. The wrappers take the one launch: on the
    card it is 12-31% faster on the fit scene, the demo scene and 100
    spheres, and ties at 1000 (chip_smoke.py ``[fused-aa1]``, PERF.md §6);
    the two launches stay for the tests and ``chip_smoke.py``.

A scene of more than ``render_cuda.CULL_MIN_SPHERES`` spheres reads the
render's large-scene tables (``render_cuda.large_scene_tables``: the tiles'
primary and level-0 shadow lists, the bounce tree, the light cells; the same
16x16 tiles, so one build serves the render and the backward of a frame).
Every cull is exact, so the gradients and loss are the bits of the same
launch with every table off; ``cull``, ``shadow_lists`` and ``group_cull``
turn them off as the JAX wrappers' keywords do.

Every entry point takes the slice form of ``render_bwd._scene_grads_pallas``:
``x_offset`` / ``local_width`` give the gradient partials (and, fused, the
loss partial) of the columns ``[x_offset, x_offset + local_width)`` of the
camera's frame, with rays from the frame's pixels and the frame's
denominator, so the partials of a frame's slices sum to the frame's.

The plain versions (:func:`scene_grads_plain`, :func:`loss_and_scene_grads_plain`)
are ``torch.autograd`` of ``ops/render.py`` packed into the same layout;
:func:`scene_grads_lattice_plain` is the AA cotangent form written as the
kernel computes it (autograd of the lattice chains' colors weighted by their
cotangents). The wrappers take CUDA tensors only: on tensors anywhere else
they raise ``ValueError`` before any launch, and the plain versions are
reached by their own names.
"""
from __future__ import annotations

import ctypes
import math
from typing import NamedTuple

import torch

from ...models.camera import Camera
from ...models.scene import LEAF_PATHS, Lights, Materials, Planes, Scene, Spheres
from ...utils.config import require_cuda
from ..render import render_image, render_rays
from . import cull_tables, render_cuda

MODES = ("cot_noaa", "cot_aa", "fused_noaa", "fused_aa")   # C enum order
# Kernel launches per mode, the one-launch fused AA step under its own key
# ("fused_aa" counts the two-launch step's backward alone); a plain counter,
# reset with reset_launch_counts().
COUNTED = MODES + ("fused_aa1",)
LAUNCHES = {m: 0 for m in COUNTED}
# Of those, the launches in the third form (rows in device memory) and
# those that read a large-scene table.
ROWS_LAUNCHES = {m: 0 for m in COUNTED}
TABLE_LAUNCHES = {m: 0 for m in COUNTED}
FUSED_AA1 = 4                # the C enum's one-launch fused AA step
# Calls of the plain versions, so a run can show that it never took them.
PLAIN_CALLS = {"scene_grads": 0, "loss_and_scene_grads": 0}

MAX_DEPTH = 8                # residual slots a thread keeps (render_bwd.cu)
TILE = 16                    # a block's work unit: a 16x16 tile of pixels
LATTICE = 1089               # the AA lattice's sample chains a tile (C, U, V, UV grids)
SMEM_LIMIT = 227 * 1024      # shared memory a block can have on Hopper
SM_SMEM = 228 * 1024         # shared memory of one SM
BLOCKS_PER_SM = 4            # the planner's blocks a multiprocessor
H100_SMS = 132

# The JAX package's rule for the backward kernel against autodiff
# (tests/test_pallas_bwd.py): these leaves max|d| / max|g| < 5e-2 (a.e.
# gradients: the grazing clamp and silhouette pixels differ from autodiff's
# root-formula values); every other leaf rtol 1e-3 / atol 1e-7; the loss rel
# 1e-5. The plane's origin and normal are held as geometry here: they place
# the hit point through t = n.(p0 - o) / n.d, and on the card at 64x64 and
# above the ground plane's grazing hits near the horizon (n.d ~ 1e-3, rounded
# with FMA in the kernel and without it in the plain version) put their
# smallest components 1e-4..1e-3 apart.
GEOMETRY_GROUPS = ("spheres.center", "spheres.radius", "planes.origin", "planes.normal",
                   "lights.position", "camera.position", "camera.rotation", "camera.fov")
CAMERA_GRAD_GROUPS = ("camera.position", "camera.rotation", "camera.fov")


def reset_launch_counts() -> None:
    for m in COUNTED:
        LAUNCHES[m] = 0
        ROWS_LAUNCHES[m] = 0
        TABLE_LAUNCHES[m] = 0
    for k in PLAIN_CALLS:
        PLAIN_CALLS[k] = 0


def grad_layout(ns: int, npl: int, nl: int):
    """Slot index map for the flat gradient vector and its length
    (``render_bwd.grad_layout``)."""
    slots = {}
    k = 0
    for j in range(ns):
        for c in range(7):
            slots[("sph", j, c)] = k
            k += 1
    for j in range(npl):
        for c in range(9):
            slots[("pln", j, c)] = k
            k += 1
    for l in range(nl):
        for c in range(3):
            slots[("light", l, c)] = k
            k += 1
    for name in ("amb", "lamb", "refl", "spec", "shin"):
        slots[name] = k
        k += 1
    for c in range(3):
        slots[("cam_pos", c)] = k
        k += 1
    for r in range(3):
        for c in range(3):
            slots[("rot", r, c)] = k
            k += 1
    slots["fov"] = k
    return slots, k + 1


def n_grads(ns: int, npl: int, nl: int, fused: bool = False) -> int:
    return 7 * ns + 9 * npl + 3 * nl + 18 + int(fused)


def unflatten_grads(flat: torch.Tensor, ns: int, npl: int, nl: int, resolution, *,
                    return_camera: bool, fused_loss: bool):
    """Flat vector (+ trailing loss slot when ``fused_loss``) -> ``Scene``
    (and ``Camera``) gradients, as ``render_bwd.unflatten_grads``: returns
    ``scene_g``, ``(scene_g, camera_g)``, ``(loss, scene_g)`` or ``(loss,
    scene_g, camera_g)``."""
    if flat.shape != (n_grads(ns, npl, nl, fused_loss),):
        raise ValueError(f"flat gradient has shape {tuple(flat.shape)}, expected "
                         f"({n_grads(ns, npl, nl, fused_loss)},)")
    off = 7 * ns
    sph = flat[:off].reshape(ns, 7)
    pln = flat[off:off + 9 * npl].reshape(npl, 9)
    off += 9 * npl
    lts = flat[off:off + 3 * nl].reshape(nl, 3)
    off += 3 * nl
    scene_g = Scene(Spheres(sph[:, 0:3], sph[:, 3], sph[:, 4:7]),
                    Planes(pln[:, 0:3], pln[:, 3:6], pln[:, 6:9]),
                    Lights(lts), Materials(*(flat[off + i] for i in range(5))))
    out = (scene_g,)
    if return_camera:
        off += 5
        out += (Camera(flat[off:off + 3], flat[off + 3:off + 12].reshape(3, 3),
                       flat[off + 12], tuple(resolution)),)
    if fused_loss:
        out = (flat[-1],) + out
    return out[0] if len(out) == 1 else out


def flatten_grads(scene_g: Scene, camera_g: Camera | None = None,
                  loss: torch.Tensor | None = None) -> torch.Tensor:
    """Inverse of :func:`unflatten_grads`: ``Scene`` (+ ``Camera``) gradients
    (+ loss) -> flat float32 vector; absent camera slots are 0."""
    s, p = scene_g.spheres, scene_g.planes
    dev = scene_g.materials.ambient.device
    m = scene_g.materials
    parts = [torch.cat([s.center, s.radius[:, None], s.albedo], 1).reshape(-1),
             torch.cat([p.origin, p.normal, p.albedo], 1).reshape(-1),
             scene_g.lights.position.reshape(-1),
             torch.stack([m.ambient, m.lambert, m.reflection, m.specular,
                          m.shininess])]
    if camera_g is None:
        parts.append(torch.zeros(13, device=dev))
    else:
        parts += [camera_g.position.reshape(3), camera_g.rotation.reshape(9),
                  camera_g.fov.reshape(1)]
    if loss is not None:
        parts.append(loss.reshape(1))
    return torch.cat([t.to(dev, torch.float32) for t in parts])


def grad_groups(flat: torch.Tensor, ns: int, npl: int, nl: int) -> dict:
    """A flat vector (with or without the loss slot) -> ``{"spheres.center":
    tensor, ..., "camera.fov": tensor[, "loss": tensor]}``."""
    fused = flat.shape[0] == n_grads(ns, npl, nl, True)
    out = unflatten_grads(flat, ns, npl, nl, (1, 1), return_camera=True,
                          fused_loss=fused)
    scene_g, cam_g = out[-2], out[-1]
    groups = {}
    for path in LEAF_PATHS + CAMERA_GRAD_GROUPS:
        grp, leaf = path.split(".")
        groups[path] = getattr(cam_g if grp == "camera" else getattr(scene_g, grp), leaf)
    if fused:
        groups["loss"] = out[0]
    return groups


def grad_rule(flat: torch.Tensor, ref: torch.Tensor, ns: int, npl: int, nl: int,
              scale_ref: torch.Tensor | None = None) -> dict:
    """Hold a kernel's flat gradient against its plain version's under
    :data:`GEOMETRY_GROUPS`' rule: ``{group: (max|d| / max|g|, ok)}`` (max|d|
    itself where the plain group is all zero). ``g`` is ``scale_ref``
    (default ``ref``): :func:`kernel_and_plain` passes the plain gradient over
    all pixels, the gradient a user gets, since its held-out pixels may carry
    most of a group (one pixel of a 34-light 24x16 AA frame carries nearly
    all of its fov gradient, and what is left is a cancelling sum ~1000x
    smaller)."""
    got, want, scales = (grad_groups(f.detach().double().cpu(), ns, npl, nl)
                         for f in (flat, ref, ref if scale_ref is None else scale_ref))
    out = {}
    for path, b in want.items():
        a = got[path]
        d = (a - b).abs()
        scale = float(scales[path].abs().max()) if b.numel() else 0.0
        rel = float(d.max()) / scale if scale > 0 else (float(d.max()) if d.numel() else 0.0)
        if path in GEOMETRY_GROUPS:
            ok = rel < 5e-2
        elif path == "loss":
            ok = float(d.max()) <= 1e-5 * scale
        else:
            ok = bool((d <= 1e-7 + 1e-3 * b.abs()).all())
        out[path] = (rel, ok)
    return out


# Share of pixels held out of a kernel-against-plain gradient comparison: the
# ones where the kernel's render and the plain render disagree most, as the
# forward rule allows 0.1% of pixels to flip. One sample on a near tie (a hit
# or shadow decided by float32 rounding) or near a tangent (an a.e.
# t-adjoint 1/(2at + b) whose denominator is mostly rounding) can carry most
# of a leaf group's gradient at 64x64 and above; such a pixel shows up as the
# largest forward disagreement.
HELD_OUT_FRAC = 1e-3


def held_out(img_a: torch.Tensor, img_b: torch.Tensor,
             frac: float = HELD_OUT_FRAC) -> torch.Tensor:
    """Boolean ``(w, h)`` mask of the ``ceil(frac * w * h)`` pixels where two
    ``(w, h, 3)`` renders differ most (max over channels)."""
    d = (img_a - img_b).abs().amax(-1).reshape(-1)
    held = torch.zeros(d.shape, dtype=torch.bool, device=d.device)
    held[torch.topk(d, math.ceil(frac * d.numel())).indices] = True
    return held.reshape(img_a.shape[:2])


def kernel_and_plain(mode: str, camera, scene, x, *, depth: int = 2, compat: bool = True,
                     aa_form: str = "one", aa_share: bool | None = None):
    """The wrapper's and the plain version's flat gradients for one kernel
    mode on the same input ``x`` (the target in the fused modes, else the
    cotangent), camera slots included, with the :func:`held_out` pixels taken
    out of both sides: in the cotangent modes their cotangent is zeroed; in
    the fused modes each side's own loss and gradient on those pixels (its
    cotangent mode on ``2 (render - target) / n`` there) is subtracted.
    ``aa_form``: the fused AA step's form (:func:`loss_and_scene_grads_cuda`).
    ``aa_share``: with ``cot_aa``, the render and cotangent wrapper's (False:
    the ``aa_per_sample`` render and its adjoint). Returns ``(kernel_flat,
    plain_flat, plain_all_pixels, held)``, the third for :func:`grad_rule`'s
    ``scale_ref``."""
    aa = mode.endswith("_aa")
    kw = dict(depth=depth, compat=compat, aliasing=aa)
    share = {} if aa_share is None else dict(aa_share=aa_share)
    img_k = render_cuda.render_image_cuda(camera, scene, **kw, **share)
    img_p = render_image(camera, scene, **kw)
    held = held_out(img_k, img_p)[..., None]

    def cot_kernel(g):
        return flatten_grads(*scene_grads_cuda(camera, scene, g.contiguous(),
                                               return_camera=True, **kw, **share))

    def cot_plain(g):
        return scene_grads_plain(camera, scene, g, **kw)

    if not mode.startswith("fused"):
        keep = x * ~held
        return cot_kernel(keep), cot_plain(keep), cot_plain(x), held[..., 0]
    loss, scene_g, cam_g = loss_and_scene_grads_cuda(camera, scene, x, return_camera=True,
                                                     aa_form=aa_form, **kw)
    plain_all = loss_and_scene_grads_plain(camera, scene, x, **kw)
    sides = ((flatten_grads(scene_g, cam_g, loss), img_k, cot_kernel),
             (plain_all, img_p, cot_plain))
    out = []
    for flat, img, cot in sides:
        d = (img - x) * held
        out.append(flat - torch.cat([cot(2.0 * d / x.numel()),
                                     ((d * d).sum() / x.numel()).reshape(1)]))
    return out[0], out[1], plain_all, held[..., 0]


# --- the launch plan ---------------------------------------------------------------

class Plan(NamedTuple):
    """One backward launch's shape: ``nt`` threads a block, ``cols`` (every
    slot in per-thread columns of shared memory; else the object and light
    slots in per-warp rows), ``blocks`` (the grid; block b walks tiles b, b +
    blocks, ...), ``tiles`` (the most tiles a block walks), the block's
    shared memory in bytes, ``staged`` (the sphere table copied into
    shared memory; else the global form reads it from device memory,
    render_bwd_kernel.cuh's head) and ``device_rows`` (the third form: the
    global form with the warps' rows in a device-memory scratch buffer of
    :func:`scratch_floats` floats), and ``tree_smem`` (the staged form copies
    the bounce tree into shared memory too; else reads it where it lies)."""
    nt: int
    cols: bool
    blocks: int
    tiles: int
    smem: int
    staged: bool = True
    device_rows: bool = False
    tree_smem: bool = False


def smem_bytes(ns: int, npl: int, nl: int, fused: bool, aa: bool, nt: int,
               cols: bool, staged: bool = True, device_rows: bool = False,
               tables: int = 0, one_launch: bool = False) -> int:
    """Shared memory of one block (``bwd_smem_words`` in
    render_bwd_kernel.cuh): the scene (the sphere table only when
    ``staged``), the ``tables`` words (:func:`table_words`), the one-launch
    fused AA step's lattice colors (3 x 1089 words), a tile's pixel
    cotangents with AA, and the slot columns (``cols``) or the warps' rows of
    the object and light slots (not with ``device_rows``) beside the 18-19
    tail slots' columns."""
    n = n_grads(ns, npl, nl, fused)
    mat = 7 * ns + 9 * npl + 3 * nl
    words = render_cuda.N_PARAMS + mat - (0 if staged else 7 * ns) + tables + \
        (3 * LATTICE if one_launch else 0) + (6 * TILE * TILE if aa else 0)
    words += n * nt if cols else (0 if device_rows else (nt // 32) * mat) + (n - mat) * nt
    return 4 * words


def table_words(tabs, nl: int) -> tuple:
    """``(lists, tree)``: words of ``render_cuda.large_scene_tables``' result
    ``(vis, shadow, tree, cells)`` that a block keeps in shared memory
    (``bwd_table_words``): one tile's primary list and its occluder lists (``nl``
    a listed trace level) with their counts, and the bounce tree where the
    staged form copies it (the light cells stay in device memory)."""
    vis, shadow, tree, _ = tabs
    lists = (vis[2] if vis is not None else 0) + \
        (shadow[3] * nl * (shadow[2] + 1) if shadow is not None else 0)
    if tree is None:
        return lists, 0
    return lists, cull_tables.tree_box_words(tree.n_leaves) + tree.n_leaves * cull_tables.LEAF


def rec_floats(shape: "Plan", depth: int) -> int:
    """Device memory of the one-launch fused AA step's records (floats): each
    block's 3 words for each trace level of each of a tile's 1089 lattice
    chains."""
    return shape.blocks * 3 * (depth + 1) * LATTICE


def scratch_floats(ns: int, npl: int, nl: int, shape: Plan) -> int:
    """Device memory of a launch's rows (floats): the third form's blocks x
    warps x the object and light slots, else 0."""
    if not shape.device_rows:
        return 0
    return shape.blocks * (shape.nt // 32) * (7 * ns + 9 * npl + 3 * nl)


def n_tiles(W: int, H: int) -> int:
    return math.ceil(W / TILE) * math.ceil(H / TILE)


def plan(ns: int, npl: int, nl: int, W: int, H: int, *, aa: bool, fused: bool,
         large: bool, n_sm: int = H100_SMS, blocks_per_sm: int = BLOCKS_PER_SM,
         staged: bool | None = None, device_rows: bool | None = None, lists: int = 0,
         tree: int = 0, one_launch: bool = False, tree_smem: bool | None = None) -> Plan:
    """The backward launch for a scene and image. For a small scene (``large``
    False: the slot columns exist only in the small-scene kernels, which
    always stage the scene) the most threads a block (128, 64, 32) whose slot
    columns fit a block's shared memory, else the most whose per-warp rows
    fit. For a large scene, per-warp rows at the most threads a block that
    either form fits, the staged form where both do: on the card the global
    form is ~24% slower at the same threads, and 1.4-1.6x faster at twice
    the staged form's threads (1000-4080 spheres; chip_smoke.py phase 22
    ``[repair-form]``, PERF.md §6). Then ``blocks_per_sm`` blocks on each of
    ``n_sm`` multiprocessors (fewer where their shared memory does not fit
    one), at most one a tile, the tiles dealt out evenly. ``W``: the launch's
    (a slice's) width. ``staged`` True or False: that form's plan alone (the
    global form only for a large scene). A large scene that neither form fits
    (past 8208 spheres at 1 plane and 3 lights, 7984 fused with AA) takes the
    third form at 128 threads: the global form with the warps' rows in device
    memory, the same bits as the others at the same launch shape
    (``device_rows`` True: that form alone; False: never). ``lists`` and
    ``tree``: the large-scene tables' words in shared memory (:func:`table_words`):
    a tile's lists in every form, and the bounce tree, which the staged form
    copies too where that keeps the plan's threads and blocks a
    multiprocessor (on the card 2-3% faster than reading it where it lies at
    1000 spheres, chip_smoke.py ``[bwd-tables-time]``, PERF.md §6;
    ``tree_smem`` False: never, True: wherever it fits); ``one_launch``: the
    one-launch fused AA step's colors. Raises ``ValueError`` where no plan
    fits."""
    forms = (True, False) if large else (True,)
    forms = forms if staged is None else tuple(f for f in forms if f == staged)
    tries = [(cols, nt, form, False) for cols in ((False,) if large else (True, False))
             for nt in (128, 64, 32) for form in forms]
    if device_rows:
        tries = []
    if large and device_rows is not False and staged is not True:
        tries.append((False, 128, False, True))
    def per_sm(smem):
        return max(1, min(blocks_per_sm, SM_SMEM // (smem + 1024)))
    for cols, nt, form, rows in tries:
        smem = smem_bytes(ns, npl, nl, fused, aa, nt, cols, form, rows, lists, one_launch)
        if smem > SMEM_LIMIT:
            continue
        with_tree = smem + 4 * tree
        tree_in = bool(tree) and form and not cols and tree_smem is not False and \
            with_tree <= SMEM_LIMIT and (tree_smem or per_sm(with_tree) == per_sm(smem))
        smem = with_tree if tree_in else smem
        tiles = math.ceil(n_tiles(W, H) / min(n_tiles(W, H), n_sm * per_sm(smem)))
        return Plan(nt, cols, math.ceil(n_tiles(W, H) / tiles), tiles, smem, form, rows,
                    tree_in)
    raise ValueError(f"scene (ns={ns}, npl={npl}, nl={nl}) needs "
                     f"{smem_bytes(ns, npl, nl, fused, aa, 32, False, not large, large)} B "
                     f"of shared memory in the backward kernel, a block has at most "
                     f"{SMEM_LIMIT} B")


# --- the AA lattice -----------------------------------------------------------------
#
# render_fwd_kernel.cuh's AA_SHARED traces, for the 16x16 tile at (x0, y0)
# (x tiles outermost), 1089 distinct sample positions: C[kx][ky] at (x0 + kx,
# y0 + ky) (256), U[kx][ky] at x - 0.5 (17 x 16), V[kx][ky] at y - 0.5 (16 x
# 17) and UV[kx][ky] at both (17 x 17), in that order, kx major. Pixel (kx,
# ky) of the tile combines C[kx][ky] with its 8 neighbours U[kx][ky],
# U[kx+1][ky], V[kx][ky], V[kx][ky+1] and the four UV corners, times
# float32(1/9), inside the image's border ring; on the ring it takes C alone.
# Compat stores the centre sample (r, b, g) and the neighbours unswapped.

INV9 = float(torch.tensor(1.0 / 9.0, dtype=torch.float32))


def _lattice_grid():
    """Float ``(1089, 2)``: (kx + du, ky + dv) of the lattice positions from
    the tile corner, in the kernels' order."""
    parts = []
    for nx, ny, du, dv in ((TILE, TILE, 0.0, 0.0), (TILE + 1, TILE, -0.5, 0.0),
                           (TILE, TILE + 1, 0.0, -0.5), (TILE + 1, TILE + 1, -0.5, -0.5)):
        kx, ky = torch.meshgrid(torch.arange(nx), torch.arange(ny), indexing="ij")
        parts.append(torch.stack([kx.reshape(-1), ky.reshape(-1)], dim=-1).float()
                     + torch.tensor([du, dv]))
    return torch.cat(parts)                                  # (1089, 2): k + d


def tile_origins(W: int, H: int, device=None, x_offset: int = 0) -> torch.Tensor:
    """Float ``(n_tiles, 2)`` tile corners (x0, y0), x tiles outermost, of a
    ``W`` x ``H`` image, or of a slice ``W`` wide whose first column is the
    frame's ``x_offset`` (corners in the frame's pixels)."""
    tx, ty = torch.meshgrid(torch.arange(math.ceil(W / TILE)),
                            torch.arange(math.ceil(H / TILE)), indexing="ij")
    corners = (TILE * torch.stack([tx.reshape(-1), ty.reshape(-1)], dim=-1)).float()
    return (corners + torch.tensor([float(x_offset), 0.0])).to(device)


def lattice_positions(W: int, H: int, device=None, x_offset: int = 0) -> torch.Tensor:
    """Float ``(n_tiles, 1089, 2)``: every tile's lattice sample positions in
    pixel-index space, (x0 + kx + du, y0 + ky + dv) (a slice's: the frame's
    pixels, :func:`tile_origins`)."""
    return (tile_origins(W, H, device, x_offset)[:, None, :]
            + _lattice_grid().to(device)[None])


def _tiled(img: torch.Tensor, W: int, H: int) -> torch.Tensor:
    """``(W, H, C)`` -> ``(n_tiles, 16, 16, C)``, zero past the image."""
    tx, ty = math.ceil(W / TILE), math.ceil(H / TILE)
    pad = img.new_zeros((tx * TILE, ty * TILE, img.shape[-1]))
    pad[:W, :H] = img
    return pad.reshape(tx, TILE, ty, TILE, -1).permute(0, 2, 1, 3, 4).reshape(
        tx * ty, TILE, TILE, -1)


def _interior(W: int, H: int, device, x_offset: int = 0,
              W_global: int | None = None) -> torch.Tensor:
    """``(W, H, 1)``: the pixels inside the frame's border ring, for a slice
    ``W`` wide at the frame's ``x_offset`` of a frame ``W_global`` wide."""
    Wg = W if W_global is None else W_global
    m = torch.zeros((W, H, 1), dtype=torch.bool, device=device)
    m[max(1 - x_offset, 0):max(Wg - 1 - x_offset, 0), 1:H - 1] = True
    return m


def _swap(x: torch.Tensor, compat: bool) -> torch.Tensor:
    return x[..., [0, 2, 1]] if compat else x


def lattice_cotangents(g: torch.Tensor, W: int, H: int, compat: bool, x_offset: int = 0,
                       W_global: int | None = None) -> torch.Tensor:
    """Pixel cotangents ``g (W, H, 3)`` (the stored layout) -> the lattice
    chains' cotangents ``(n_tiles, 1089, 3)`` in sample color space: each
    chain's is the sum of the shares of the in-tile pixels whose 3x3 stencil
    holds it, the adjoint of :func:`lattice_combine` (the kernels' COT_AA and
    FUSED_AA cotangents, csrc/render_bwd_kernel.cuh). ``x_offset`` /
    ``W_global``: ``g`` is the slice of a wider frame at that offset."""
    inside = _interior(W, H, g.device, x_offset, W_global)
    centre = _tiled(_swap(torch.where(inside, g * INV9, g), compat), W, H)
    nb = _tiled(torch.where(inside, g * INV9, torch.zeros_like(g)), W, H)
    T = centre.shape[0]
    nx = torch.nn.functional.pad(nb, (0, 0, 0, 0, 1, 1))       # (T, 18, 16, 3)
    ny = torch.nn.functional.pad(nb, (0, 0, 1, 1))             # (T, 16, 18, 3)
    nxy = torch.nn.functional.pad(nb, (0, 0, 1, 1, 1, 1))      # (T, 18, 18, 3)
    u = nx[:, 1:] + nx[:, :-1]                                 # pixels kx and kx - 1
    v = ny[:, :, 1:] + ny[:, :, :-1]                           # pixels ky and ky - 1
    uv = ((nxy[:, 1:, 1:] + nxy[:, :-1, :-1]) + nxy[:, 1:, :-1]) + nxy[:, :-1, 1:]
    return torch.cat([p.reshape(T, -1, 3) for p in (centre, u, v, uv)], dim=1)


def lattice_combine(samples: torch.Tensor, W: int, H: int, compat: bool, x_offset: int = 0,
                    W_global: int | None = None) -> torch.Tensor:
    """The forward's combine in plain torch: lattice sample colors
    ``(n_tiles, 1089, 3)`` -> the stored ``(W, H, 3)`` image, as
    render_fwd_kernel.cuh's AA_SHARED forms it (of a slice, as
    :func:`lattice_cotangents`)."""
    T = samples.shape[0]
    c, u, v, uv = torch.split(samples, [TILE * TILE, (TILE + 1) * TILE,
                                        TILE * (TILE + 1), (TILE + 1) ** 2], dim=1)
    c = c.reshape(T, TILE, TILE, 3)
    u = u.reshape(T, TILE + 1, TILE, 3)
    v = v.reshape(T, TILE, TILE + 1, 3)
    uv = uv.reshape(T, TILE + 1, TILE + 1, 3)
    n = (u[:, :-1] + u[:, 1:] + v[:, :, :-1] + v[:, :, 1:] + uv[:, :-1, :-1] +
         uv[:, 1:, 1:] + uv[:, :-1, 1:] + uv[:, 1:, :-1])
    tx, ty = math.ceil(W / TILE), math.ceil(H / TILE)

    def untile(t):
        return t.reshape(tx, ty, TILE, TILE, 3).permute(0, 2, 1, 3, 4).reshape(
            tx * TILE, ty * TILE, 3)[:W, :H]
    centre, nsum = untile(_swap(c, compat)), untile(n)
    return torch.where(_interior(W, H, samples.device, x_offset, W_global),
                       (centre + nsum) * INV9, centre)


# --- the plain version: autograd of ops/render.py --------------------------------

def _autograd_flat(camera, scene, objective):
    """Flat gradient of ``objective(camera, scene) -> (scalar, loss or None)``
    with respect to every scene and camera tensor."""
    leaves = [t.detach().clone().requires_grad_(True) for t in
              scene.leaves() + [camera.position, camera.rotation, camera.fov]]
    value, loss = objective(Camera(*leaves[12:], camera.resolution),
                            Scene.from_leaves(leaves[:12]))
    grads = torch.autograd.grad(value, leaves, allow_unused=True)
    g = [torch.zeros_like(t) if d is None else d for t, d in zip(leaves, grads)]
    return flatten_grads(Scene.from_leaves(g[:12]), Camera(*g[12:], camera.resolution),
                         None if loss is None else loss.detach())


def scene_grads_plain(camera, scene, g_image, *, depth: int = 2, compat: bool = True,
                      aliasing: bool = False, x_offset: int = 0,
                      local_width: int | None = None) -> torch.Tensor:
    """Plain version of the cotangent modes: the vector-Jacobian product of
    ``render_image`` (of the slice ``x_offset`` / ``local_width``) with
    ``g_image (w, h, 3)``, as a flat vector of :func:`grad_layout` (camera
    slots included)."""
    PLAIN_CALLS["scene_grads"] += 1

    def objective(cam, sc):
        img = render_image(cam, sc, depth=depth, aliasing=aliasing, compat=compat,
                           x_offset=x_offset, local_width=local_width)
        return (img * g_image.detach()).sum(), None
    return _autograd_flat(camera, scene, objective)


def slice_mse(img: torch.Tensor, target: torch.Tensor, width: int) -> torch.Tensor:
    """A slice's part of the frame's MSE: ``sum((img - target)^2)`` over the
    frame's ``width * h * 3`` elements (``torch.mean`` where the slice is the
    frame), so that the parts of a frame's slices sum to its MSE."""
    d2 = (img - target) ** 2
    if img.shape[0] == width:
        return torch.mean(d2)
    return d2.sum() / (width * img.shape[1] * img.shape[2])


def loss_and_scene_grads_plain(camera, scene, target, *, depth: int = 2,
                               compat: bool = True, aliasing: bool = False,
                               x_offset: int = 0,
                               local_width: int | None = None) -> torch.Tensor:
    """Plain version of the fused modes: ``mean((render - target)^2)`` and its
    gradient, as a flat vector with the loss in the trailing slot; for a
    slice, its part of the frame's MSE (:func:`slice_mse`)."""
    PLAIN_CALLS["loss_and_scene_grads"] += 1

    def objective(cam, sc):
        img = render_image(cam, sc, depth=depth, aliasing=aliasing, compat=compat,
                           x_offset=x_offset, local_width=local_width)
        loss = slice_mse(img, target.detach(), camera.resolution[0])
        return loss, loss
    return _autograd_flat(camera, scene, objective)


def scene_grads_lattice_plain(camera, scene, g_image, *, depth: int = 2,
                              compat: bool = True, x_offset: int = 0) -> torch.Tensor:
    """The AA cotangent form as the kernel computes it, in plain torch: the
    lattice chains' colors (``render_rays`` at :func:`lattice_positions`)
    weighted by :func:`lattice_cotangents`, differentiated by autograd; chains
    whose cotangent is 0 are left out, as the kernel leaves them. Equal to
    :func:`scene_grads_plain` with ``aliasing`` up to float rounding.
    ``g_image``: the frame's cotangent, or the slice's at ``x_offset``."""
    Wg, H = camera.resolution
    W = g_image.shape[0]
    pos = lattice_positions(W, H, g_image.device, x_offset).reshape(-1, 2)
    cot = lattice_cotangents(g_image.detach(), W, H, compat, x_offset, Wg).reshape(-1, 3)
    live = (cot != 0).any(dim=-1)
    pos, cot = pos[live], cot[live]

    def objective(cam, sc):
        return (render_rays(pos, cam, sc, depth=depth, compat=compat) * cot).sum(), None
    return _autograd_flat(camera, scene, objective)


# --- the kernel ------------------------------------------------------------------

def _check(camera, scene, image, depth: int, name: str, lw: int):
    dev = require_cuda("the backward wrappers", camera.position)
    if not 0 <= depth <= MAX_DEPTH:
        raise ValueError(f"depth must be in [0, {MAX_DEPTH}], got {depth}")
    render_cuda._check_inputs(camera, scene, dev)
    W, H = lw, camera.resolution[1]
    if W < 1 or H < 1:
        raise ValueError(f"empty resolution {camera.resolution}")
    if image.device != dev or image.dtype != torch.float32:
        raise ValueError(f"{name} must be float32 on {dev}, got {image.dtype} on "
                         f"{image.device}")
    if tuple(image.shape) != (W, H, 3):
        raise ValueError(f"{name} has shape {tuple(image.shape)}, expected {(W, H, 3)}")
    ns, npl, nl = scene.spheres.count, scene.planes.count, scene.lights.count
    plan(ns, npl, nl, W, H, aa=True, fused=True, large=ns > render_cuda.CULL_MIN_SPHERES)


def launch(out, partial, params, tables, counts, *, image, target, W: int, H: int,
           depth: int, mode: str, compat: bool, cheap_shadow: bool,
           shape: Plan, lib=None, W_global: int | None = None,
           scratch=None, tabs=None, one_launch: bool = False, rec=None) -> torch.Tensor:
    """Launch the backward kernel and its reduction on the current stream, for
    inputs already packed and checked: ``out (n_grads,)``, ``partial
    (n_grads * shape.blocks,)``, ``params``, the ``scene_tables``, the object
    counts, ``image`` (the cotangent, or the rendered image in the two-launch
    ``fused_aa``; None in ``fused_noaa`` and with ``one_launch``) and
    ``target`` (fused modes; else None), all float32, contiguous, on the
    current device, and the launch's :class:`Plan` (its ``staged`` and
    ``device_rows`` pick the form; the third form's rows go to ``scratch``, a
    float32 buffer of at least :func:`scratch_floats`, allocated here where
    None). ``W``: the slice's width where ``W_global`` (the frame's, default
    ``W``) is wider, its offset the packed ``P_X0``. A scene of more than
    ``render_cuda.CULL_MIN_SPHERES`` spheres runs the kernel compiled in the
    arithmetic of the render kernel's large-scene instantiation, so that it
    recomputes that render's own hits, and reads ``tabs``, the frame's (or
    slice's) ``render_cuda.large_scene_tables`` built for this mode's samples
    (None: every table off; the plan's ``tree_smem`` needs the tree). ``one_launch``
    (``fused_aa`` only): the one-launch form, its records in ``rec`` (at least
    :func:`rec_floats`, allocated here where None). ``lib``: a kernel library
    other than the package's (one built with other flags,
    :func:`._build.build`). Counts the launch in :data:`LAUNCHES` (and
    :data:`ROWS_LAUNCHES`, :data:`TABLE_LAUNCHES`) under ``mode``, or under
    ``fused_aa1`` with ``one_launch``."""
    from ._build import load_library
    from .hit_extents_cuda import check_tables, table_args
    (sph, pln, lts), (ns, npl, nl) = tables, counts
    large = ns > render_cuda.CULL_MIN_SPHERES
    tabs = (None, None, None, None) if tabs is None else tuple(tabs)
    if any(t is not None for t in tabs) and not large:
        raise ValueError(f"a scene of {ns} spheres takes no large-scene table")
    if one_launch and mode != "fused_aa":
        raise ValueError(f"the one-launch form is fused_aa's, not {mode}'s")
    if shape.tree_smem and (tabs[2] is None or not shape.staged or shape.device_rows):
        raise ValueError("tree_smem: the staged form with a bounce tree only")
    check_tables(*tabs[:3], n_tiles=n_tiles(W, H), ns=ns, nl=nl, dev=out.device,
                 cells=tabs[3])
    if one_launch:
        need = rec_floats(shape, depth)
        if rec is None:
            rec = torch.empty(need, dtype=torch.float32, device=out.device)
        if rec.dtype != torch.float32 or rec.device != out.device or \
                rec.numel() < need or not rec.is_contiguous():
            raise ValueError(f"backward records: expected {need} contiguous float32 on "
                             f"{out.device}")
    lib = load_library() if lib is None else lib
    targs = [a for t in table_args(*tabs) for a in t]
    stream = ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)
    args = (params.data_ptr(), sph.data_ptr(), ns, pln.data_ptr(), npl, lts.data_ptr(), nl,
            None if image is None else image.data_ptr(),
            None if target is None else target.data_ptr(), partial.data_ptr(),
            shape.blocks, out.shape[0], W, H, W if W_global is None else W_global, depth,
            FUSED_AA1 if one_launch else MODES.index(mode), int(compat), int(cheap_shadow))
    rec_ptr = rec.data_ptr() if one_launch else None
    if shape.device_rows:
        need = scratch_floats(ns, npl, nl, shape)
        if scratch is None:
            scratch = torch.empty(need, dtype=torch.float32, device=out.device)
        if scratch.dtype != torch.float32 or scratch.device != out.device or \
                scratch.numel() < need or not scratch.is_contiguous():
            raise ValueError(f"backward scratch: expected {need} contiguous float32 on "
                             f"{out.device}")
        rc = lib.rt_render_bwd_rows(*args, shape.nt, scratch.data_ptr(), *targs, rec_ptr,
                                    stream)
    else:
        rc = lib.rt_render_bwd(*args, int(large), shape.nt, int(shape.cols),
                               int(shape.staged), *targs, int(shape.tree_smem), rec_ptr,
                               stream)
    if rc == 0:
        rc = lib.rt_reduce_rows(partial.data_ptr(), shape.blocks, out.shape[0],
                                out.data_ptr(), stream)
    if rc != 0:
        raise RuntimeError(f"backward kernel ({mode}{', one launch' if one_launch else ''}) "
                           f"failed: CUDA error {rc} ({lib.rt_error_string(rc).decode()})")
    key = "fused_aa1" if one_launch else mode
    LAUNCHES[key] += 1
    if shape.device_rows:
        ROWS_LAUNCHES[key] += 1
    if any(t is not None for t in tabs):
        TABLE_LAUNCHES[key] += 1
    return out


def launch_plan(camera, scene, mode: str, local_width: int | None = None,
                staged: bool | None = None, device_rows: bool | None = None,
                tabs=None, tree_smem: bool | None = None, one_launch: bool = False) -> Plan:
    """:func:`plan` for a launch of ``mode`` on this camera's image (or a
    slice ``local_width`` wide) and scene, on the current card's
    multiprocessors (``staged``, ``device_rows``, ``tree_smem``: as for
    :func:`plan`), with the tables ``tabs`` (``render_cuda.large_scene_tables``'
    result) and the one-launch form's colors."""
    ns, npl, nl = scene.spheres.count, scene.planes.count, scene.lights.count
    W, H = camera.resolution
    W = W if local_width is None else local_width
    n_sm = torch.cuda.get_device_properties(camera.position.device).multi_processor_count
    lists, tree = table_words((None, None, None, None) if tabs is None else tabs, nl)
    return plan(ns, npl, nl, W, H, aa=mode.endswith("_aa"), fused=mode.startswith("fused"),
                large=ns > render_cuda.CULL_MIN_SPHERES, n_sm=n_sm, staged=staged,
                device_rows=device_rows, lists=lists, tree=tree, one_launch=one_launch,
                tree_smem=tree_smem)


def _run(camera, scene, image, target, *, depth, compat, mode, x_offset=0, lw=None,
         cull=True, shadow_lists=None, group_cull=None, tabs=None, aa_form="one",
         cheap_shadow=None):
    dev = camera.position.device
    Wg, H = camera.resolution
    W = Wg if lw is None else lw
    counts = (scene.spheres.count, scene.planes.count, scene.lights.count)
    n = n_grads(*counts, mode.startswith("fused"))
    one = mode == "fused_aa" and aa_form != "two"
    with torch.cuda.device(dev), torch.no_grad():
        params = render_cuda.pack_params(camera, scene, compat, x_offset).to(dev)
        tables = render_cuda.scene_tables(scene)
        packed = (params, tables, counts)
        if tabs is None and counts[0] > render_cuda.CULL_MIN_SPHERES:
            tabs = render_cuda.large_scene_tables(
                camera, scene, depth=depth, aliasing=mode.endswith("_aa"), compat=compat,
                cull=cull, shadow_lists=shadow_lists, group_cull=group_cull, packed=packed,
                x_offset=x_offset, local_width=W)
        shape = launch_plan(camera, scene, mode, W, tabs=tabs, one_launch=one)
        cheap = render_cuda.shadow_cheap_ok(scene, compat) if cheap_shadow is None \
            else bool(cheap_shadow)
        if mode == "fused_aa" and not one:
            vis, shadow, tree, cells = (None,) * 4 if tabs is None else tabs
            image = render_cuda.launch(torch.empty((W, H, 3), device=dev), params,
                                       tables, counts, depth=depth, mode="aa_shared",
                                       compat=compat, cheap_shadow=cheap, vis=vis,
                                       shadow=shadow, tree=tree, cells=cells, W_global=Wg)
        out = torch.empty(n, device=dev)
        partial = torch.empty(n * shape.blocks, device=dev)
        return launch(out, partial, params, tables, counts,
                      image=None if image is None else image.contiguous(),
                      target=None if target is None else target.contiguous(),
                      W=W, H=H, depth=depth, mode=mode, compat=compat,
                      cheap_shadow=cheap, shape=shape, W_global=Wg, tabs=tabs,
                      one_launch=one)


def scene_grads_cuda(camera, scene, g_image, *, depth: int = 2, compat: bool = True,
                     aliasing: bool = False, return_camera: bool = False,
                     cull: bool = True, x_offset: int = 0, local_width: int | None = None,
                     shadow_lists: bool | None = None, group_cull: bool | None = None,
                     tabs=None, aa_share: bool | None = None,
                     cheap_shadow: bool | None = None):
    """Image cotangent ``(w, h, 3)`` -> ``Scene`` gradients (with
    ``return_camera``: ``(scene_g, camera_g)``), as
    ``render_bwd.scene_grads_pallas``; with ``x_offset`` / ``local_width`` the
    cotangent is the slice's ``(local_width, h, 3)`` and the gradients its
    partials. CUDA tensors only (``ValueError`` on others, before any launch;
    :func:`scene_grads_plain` is the plain version): with ``aliasing``
    ``cot_aa``, the adjoint of the ``aa_shared`` render and, whatever
    ``aa_share`` says, of the ``aa_per_sample`` one, which draws the same
    rays (``aa_share`` is taken for the JAX signature and changes no
    launch), else ``cot_noaa``; on a
    large scene through the tables that ``cull``, ``shadow_lists`` and
    ``group_cull`` give (``render_cuda.large_scene_tables``; ``tabs``: those
    tables where the caller has them, built for the same frame, slice and
    ``aliasing``). ``cheap_shadow``: the sqrt-free shadow test (None:
    ``render_cuda.shadow_cheap_ok``, as ``render_image_cuda`` resolves it; True
    where that guard fails is the caller's choice)."""
    require_cuda("scene_grads_cuda", camera.position)
    ns, npl, nl = scene.spheres.count, scene.planes.count, scene.lights.count
    lw = render_cuda.slice_width(camera, x_offset, local_width)
    mode = "cot_aa" if aliasing else "cot_noaa"
    _check(camera, scene, g_image, depth, "g_image", lw)
    flat = _run(camera, scene, g_image, None, depth=depth, compat=compat, mode=mode,
                x_offset=x_offset, lw=lw, cull=cull, shadow_lists=shadow_lists,
                group_cull=group_cull, tabs=tabs, cheap_shadow=cheap_shadow)
    return unflatten_grads(flat, ns, npl, nl, camera.resolution,
                           return_camera=return_camera, fused_loss=False)


def loss_and_scene_grads_cuda(camera, scene, target, *, depth: int = 2,
                              compat: bool = True, aliasing: bool = False,
                              return_camera: bool = False, cull: bool = True,
                              x_offset: int = 0, local_width: int | None = None,
                              shadow_lists: bool | None = None,
                              group_cull: bool | None = None, aa_form: str = "one",
                              cheap_shadow: bool | None = None):
    """The training step's ``(loss, scene_g)`` (with ``return_camera``:
    ``(loss, scene_g, camera_g)``) for ``loss = mean((render - target)^2)``,
    as ``render_bwd.loss_and_scene_grads_pallas``; with ``x_offset`` /
    ``local_width``, ``target`` is the slice's and the loss and gradients its
    partials over the frame's denominator. CUDA tensors only (``ValueError``
    on others; :func:`loss_and_scene_grads_plain` is the plain version):
    ``fused_noaa``, or with ``aliasing`` the fused AA step in
    its one-launch form (``aa_form="two"``: the ``aa_shared`` render, then the
    backward, for the tests and ``chip_smoke.py``), on a large scene through
    the tables that ``cull``, ``shadow_lists`` and ``group_cull`` give (one
    build serves the two-launch form's render and its backward).
    ``cheap_shadow``: as :func:`scene_grads_cuda`'s. The fused AA step takes
    the shared layout only, as the JAX kernel does (no ``aa_share``)."""
    if aa_form not in ("one", "two"):
        raise ValueError(f"aa_form must be 'one' or 'two', got {aa_form!r}")
    require_cuda("loss_and_scene_grads_cuda", camera.position)
    ns, npl, nl = scene.spheres.count, scene.planes.count, scene.lights.count
    lw = render_cuda.slice_width(camera, x_offset, local_width)
    _check(camera, scene, target, depth, "target", lw)
    flat = _run(camera, scene, None, target, depth=depth, compat=compat,
                mode="fused_aa" if aliasing else "fused_noaa", x_offset=x_offset,
                lw=lw, cull=cull, shadow_lists=shadow_lists, group_cull=group_cull,
                aa_form=aa_form, cheap_shadow=cheap_shadow)
    return unflatten_grads(flat, ns, npl, nl, camera.resolution,
                           return_camera=return_camera, fused_loss=True)
