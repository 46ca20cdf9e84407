"""Lower bounds of a kernel's work for the rooflines, from the cell's own
inputs (scene, cameras, target) and the frozen work arithmetic
(``frozen.work``), never from the port's tables: the same work, whatever
implements the kernel."""
from __future__ import annotations

import torch

from .frozen import work as W


def render_ops(n_positions: float, counts, npl: int, nl: int) -> float:
    """Operations a frame's render needs at least: every distinct sample
    position's ray generation, closest-hit set-up and plane tests, one sphere
    test for each ray that hits a sphere (a culled sweep may skip every
    other), and for every hit at every level its point, a sphere's normal,
    and per light its direction, Lambert term, shadow-ray set-up and plane
    tests (its sphere tests may all be culled); a bounce ray from each hit
    below the last level, at the same floor. ``counts`` is
    ``frozen.work.hard_chain_counts``' ``(levels, 3)`` rays / sphere hits /
    plane hits, already scaled to every position of the frame."""
    c = torch.as_tensor(counts, dtype=torch.float64)
    rays, sph, pln = c[:, 0], c[:, 1], c[:, 2]
    per_ray = W.HIT_SETUP + npl * W.HIT_PLANE
    per_hit = W.SURFACE + nl * (W.LIGHT + W.SHADOW_SETUP + npl * W.HIT_PLANE)
    return float(n_positions * W.RAYGEN + rays.sum() * per_ray
                 + sph.sum() * (W.HIT_SPHERE + W.SPHERE_NORMAL)
                 + (sph.sum() + pln.sum()) * per_hit)


def render_bound_s(W_px: int, H_px: int, n_positions: float, counts, ns: int, npl: int,
                   nl: int) -> float:
    """Seconds one H100 needs at least for a frame: :func:`render_ops`
    against the FP32 peak, or the scene in and the float image out against
    the memory rate, whichever is longer."""
    ms, _ = W.bound_ms(render_ops(n_positions, counts, npl, nl),
                       W._scene_bytes(ns, npl, nl) + 12 * W_px * H_px)
    return ms / 1e3


def soft_fused_bound_s(camera, scene, tau: float) -> float:
    """Seconds one H100 needs at least for a fused soft step's loss and
    gradient (``frozen.work.soft_work``, mode "fused")."""
    ms, _ = W.bound_ms(*W.soft_work(camera, scene, tau, "fused"))
    return ms / 1e3
