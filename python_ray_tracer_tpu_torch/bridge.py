"""Build this package's ``Scene`` and ``Camera`` from plain numpy arrays, and
convert gradients between the flat layout and the pytrees.

The arrays can come from the JAX package (its pytree leaves, its flat
``render_bwd.grad_layout`` gradient vector, or ``Scene.to_soa()`` output) or
from a file; nothing here imports JAX. Both packages then render the same scene
bit for bit at their inputs, and their gradients compare slot by slot. The
large-scene tables cross the same way (:func:`tables_from_arrays`,
:func:`tile_rows_from_jax`), so the port's kernels can run on tables the JAX
package built. Each function makes its tensors on ``device``, None (the
default) meaning the card (``utils.config.resolve_device``).
"""
from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np
import torch

from .models.camera import Camera
from .models.scene import LEAF_PATHS, Materials, Scene
from .ops.cuda.render_bwd_cuda import flatten_grads, n_grads, unflatten_grads
from .utils.config import resolve_device


def _t(a, device) -> torch.Tensor:
    return torch.as_tensor(np.array(a, dtype=np.float32), device=resolve_device(device))


def scene_from_leaves(leaves: Sequence[np.ndarray], device=None) -> Scene:
    """Scene from the 12 arrays in :data:`~.models.scene.LEAF_PATHS` order (e.g.
    ``[np.asarray(x) for x in jax.tree_util.tree_leaves(jax_scene)]``)."""
    if len(leaves) != len(LEAF_PATHS):
        raise ValueError(f"expected {len(LEAF_PATHS)} leaves {LEAF_PATHS}, "
                         f"got {len(leaves)}")
    return Scene.from_leaves([_t(a, device) for a in leaves])


def scene_from_soa(spheres: np.ndarray, lights: np.ndarray, planes: np.ndarray,
                   materials: Sequence[float] = (0.0, 0.6, 0.3, 0.0, 32.0),
                   device=None) -> Scene:
    """Scene from reference-layout SoA arrays ``(7,N)/(3,L)/(9,M)`` (albedo in
    0-255) plus ``(ambient, lambert, reflection, specular, shininess)``."""
    return Scene.from_soa(spheres, lights, planes,
                          Materials.build(*materials, device=device), device=device)


def camera_from_arrays(position: np.ndarray, rotation: np.ndarray, fov,
                       resolution: Tuple[int, int], device=None) -> Camera:
    """Camera from its arrays (the JAX Camera's leaves) and resolution."""
    return Camera(_t(position, device), _t(rotation, device), _t(fov, device),
                  tuple(int(v) for v in resolution))


def tile_rows_from_jax(rows: np.ndarray, n_tx: int, n_ty: int, swap_xy: bool,
                       levels: int = 1) -> np.ndarray:
    """Per-tile rows ``(n_tiles * levels, ...)`` in the JAX package's tile
    numbering -> the port's (``tx * n_ty + ty``). The JAX kernels number tiles
    ``i * n_v + j`` over their (sublane, lane) grid: ``(x, y)`` tiles as here
    when ``swap_xy`` is false, ``(y, x)`` tiles when it is true. ``levels``:
    rows of that many trace levels a tile, levels fastest (the hit-extent
    rows of ``n_levels``), which stay together and in order."""
    rows = np.asarray(rows)
    if not swap_xy:
        return rows
    per = rows.reshape(n_ty, n_tx, levels, *rows.shape[1:])
    return per.swapaxes(0, 1).reshape(rows.shape)


def tables_from_arrays(*, vis=None, shadow=None, device=None):
    """The render kernel's list tables from numpy arrays, e.g. those of
    ``render_pallas._tile_visibility`` / ``_shadow_visibility_lists`` built
    with the port's 16x16 tiles and brought into its tile numbering
    (:func:`tile_rows_from_jax`): ``vis = (idx, cnt, k)`` and ``shadow =
    (idx, cnt, k, levels)`` (rows of ``levels`` trace levels a tile) become
    int32 tensors. Returns ``(vis, shadow)`` as
    ``render_cuda.launch`` takes them (its bounce tree has no JAX
    counterpart: ``cull_tables.bounce_tree``)."""
    dev = resolve_device(device)

    def ints(a):
        return torch.as_tensor(np.array(a, dtype=np.int32).reshape(-1), device=dev)
    return tuple(None if t is None else (ints(t[0]), ints(t[1]), *(int(v) for v in t[2:]))
                 for t in (vis, shadow))


def grads_from_flat(flat: np.ndarray, ns: int, npl: int, nl: int, *,
                    resolution: Tuple[int, int] = (1, 1)):
    """A flat gradient vector in ``grad_layout`` order -> ``(scene_g,
    camera_g, loss)``: the port's ``Scene`` and ``Camera`` of gradients, and
    the trailing loss slot (None when the vector has none)."""
    flat = torch.as_tensor(np.asarray(flat, np.float32))
    fused = flat.shape[0] == n_grads(ns, npl, nl, True)
    out = unflatten_grads(flat, ns, npl, nl, resolution, return_camera=True,
                          fused_loss=fused)
    return (out[1], out[2], out[0]) if fused else (out[0], out[1], None)


def flat_from_grads(scene_g: Scene, camera_g: Camera | None = None,
                    loss=None) -> np.ndarray:
    """Inverse of :func:`grads_from_flat`: the flat float32 numpy vector (camera
    slots 0 when ``camera_g`` is None; a trailing loss slot when ``loss`` is
    given)."""
    return flatten_grads(scene_g, camera_g,
                         None if loss is None else torch.as_tensor(loss)).cpu().numpy()
