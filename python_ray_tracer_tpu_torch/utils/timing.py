"""Synchronised timing and ray-throughput accounting.

CUDA work is asynchronous, so a host clock around a launch measures the enqueue.
:func:`time_fn` times CUDA results with CUDA events recorded around ``iters``
back-to-back calls after a warm-up (which also absorbs the kernels' first-use
build); CPU results are timed with the host clock.
"""
from __future__ import annotations

import time
from typing import Callable

import torch


def _on_cuda(out) -> bool:
    leaves = out if isinstance(out, (tuple, list)) else (out,)
    return any(isinstance(t, torch.Tensor) and t.is_cuda for t in leaves)


def time_fn(fn: Callable, *args, warmup: int = 1, iters: int = 5,
            best_of: int = 1, **kwargs) -> float:
    """Seconds per call of ``fn(*args, **kwargs)``: ``iters`` calls back to
    back after ``warmup`` calls, synchronised once. ``best_of > 1`` repeats
    that measurement and returns the fastest."""
    out = None
    for _ in range(max(warmup, 1)):
        out = fn(*args, **kwargs)
    cuda = _on_cuda(out)
    if cuda:
        torch.cuda.synchronize()
    best = float("inf")
    for _ in range(max(best_of, 1)):
        if not cuda:
            t0 = time.perf_counter()
            for _ in range(iters):
                fn(*args, **kwargs)
            best = min(best, (time.perf_counter() - t0) / iters)
            continue
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(iters):
            fn(*args, **kwargs)
        end.record()
        end.synchronize()
        best = min(best, start.elapsed_time(end) / 1e3 / iters)
    return best


def rays_per_image(width: int, height: int, *, depth: int, aliasing: bool,
                   n_lights: int, primary_only: bool = False) -> int:
    """Count rays traced for one render.

    ``primary_only`` counts one ray per pixel. Otherwise counts every traced ray:
    per pixel, S samples (9 interior / 1 border with AA), each sample casting
    (1 + depth) eye/bounce rays, each of which sweeps n_lights shadow rays on
    hit. Shadow rays are counted optimistically (every trace alive) — a stable
    upper-bound denominator.
    """
    if primary_only:
        return width * height
    if aliasing:
        interior = max(width - 2, 0) * max(height - 2, 0)
        samples = interior * 9 + (width * height - interior)
    else:
        samples = width * height
    per_sample = (1 + depth) * (1 + n_lights)
    return samples * per_sample


# --- bounds: the least time the card could take for a kernel's work ---------------
#
# A kernel's bound is max(operations / peak FP32 rate, bytes / memory rate), with
# the rates of one H100 SXM at its full 700 W (NVIDIA's data sheet): 67 TFLOP/s
# FP32 outside the tensor cores, 3.35 TB/s of HBM3. Bytes count each input read
# once and each output written once. Operations are FP32 adds, multiplies,
# divides, square roots and exps (an FMA is two; compares, selects and shuffles
# are not counted) of the work the FUNCTION needs, not of what a kernel issues:
# each distinct value is computed once, and a term that this run's data makes
# zero is left out. A kernel's recomputation (the soft kernels re-derive every
# occluder's cover inside each object's sweep) and its reduction scheme (warp
# shuffles, per-block partials) are its own choices and are not counted.

H100_FP32_FLOPS = 67e12
H100_HBM_BYTES_PER_S = 3.35e12

# Operations per unit of work, tallied from ops/soft.py's formulas (the
# function's; the kernels' soft_common.cuh evaluates the same terms, b^2 in a
# better-conditioned form that costs 4 operations more).
RAYGEN = 30          # grid point, R p, normalisation
COVER_GEO = 8        # L = c - o, t_ca = L . d: decides whether the sphere is ahead
COVER_D2 = 7         # + b^2 = |L|^2 - t_ca^2: decides whether its alpha is 0
COVER = 22           # + b = sqrt(b^2) and the sigmoid
COVER_T = 26         # + the half chord and the blend depth
PLANE = 14           # n . d, n . (p0 - o), the division
SURFACE = 6          # P = o + t d
SPHERE_NORMAL = 13   # N = (P - c) / |P - c|
LIGHT = 17           # L = (light - P) / |light - P|, lamb L . N
ACCUMULATE = 15      # color += w (amb A + lam_sum A)
NORM_ADJ = 14        # adjoint of v / |v|
COVER_ADJ = 27       # adjoint of a sphere cover (center, radius, ray)
COVER_ADJ_T = 35     # ... with the blend depth's
OBJ_ADJ = 27         # per composited object: shade, weight and albedo cotangents, P chain
SPHERE_ADJ = COVER_ADJ_T + NORM_ADJ + 12   # its own cover's and normal's adjoints
PLANE_ADJ = 35       # t = n . (p0 - o) / n . d: origin, normal and ray cotangents
LIGHT_ADJ = 18 + NORM_ADJ                  # per lit light: Lambert and direction
SHADOW_ADJ = COVER_ADJ + 11                # per sphere on a lit shadow ray
CAMERA_ADJ = NORM_ADJ + 9                  # d = normalize(R p), R's outer product
LOSS = 12            # fused: residual, loss partial, cotangent
# rt_common.cuh closest_hit, for the hard kernels' lower bound
HIT_SETUP = 17       # a, 1/(2a), o.d, o.o
HIT_SPHERE = 29      # one sphere's quadratic and nearest root
HIT_PLANE = 14       # one plane's n.d, n.(p0 - o), division
# rt_common.cuh's sqrt-free shadow sweep (sphere_occludes, CHEAP)
SHADOW_SETUP = 18    # o.o, a, 1/(2a), 1/a, o.d
SHADOW_SPHERE = 26   # o.c, |o-c|^2 - r^2, c.d, the clamped closest approach
# csrc/render_bwd_kernel.cuh's reverse sweep, per live trace: the shade's and
# the mirror direction's adjoints, the hit point's and the material sums
# (bwd_trace up to the object branch), and the hit's own: a sphere's
# quadratic root (center, radius, origin and direction cotangents) with its
# normal's normalisation, or a plane's PLANE_ADJ.
TRACE_ADJ = 95
SPHERE_HIT_ADJ = 90 + NORM_ADJ
AA_COMBINE = 30      # a pixel's 9-sample combine (the fused AA loss needs the image)


# The light-cell build (csrc/light_cells.cu): a row's cone (its central
# direction and four corner directions, each normalised, a dot and a cross
# product), a light's per-sphere terms (w = c - l, |w|^2, rho, the guard, the
# square root), the scene's reach a sphere, and one (row, sphere) cone test.
LC_CELL = 90
LC_SPHERE = 14
LC_REACH = 7
LC_TEST = 12

# The level-0 shadow lists (csrc/shadow_lists.cu, cull_tables.shadow_rows): a
# (tile with hits, light) row's terms (box centre, half-diagonal, the
# direction to the light and its length, the cone's slope and 1 / cos), a
# (light, sphere)'s (c - L, |c - L|^2, r + slack, the cone's far end, the
# apparent size r / |c - L| of the light's order), and one capsule-and-cone
# test a (row, sphere): w = c - b, w.s, |w|^2, the segment parameter and d^2,
# the reach, the projection, the lateral distance and the cone's allowance.
SL_ROW = 37
SL_SPHERE = 14
SL_TEST = 34


def bound_ms(ops: float, nbytes: float) -> tuple:
    """``(ms, "operations" | "bytes")``: the least time one H100 could take,
    and which of the two rates sets it."""
    t_ops, t_bytes = ops / H100_FP32_FLOPS, nbytes / H100_HBM_BYTES_PER_S
    return 1e3 * max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes else "bytes")


def _scene_bytes(ns: int, npl: int, nl: int) -> int:
    return 4 * (41 + 7 * ns + 9 * npl + 3 * nl)


def soft_live_counts(camera, scene, tau: float, *, block: int = 1 << 25) -> dict:
    """What this run's data asks of the soft render (ops/soft.py's math, no
    gradient), summed over the image: ``px`` pixels; ``front`` primary
    (pixel, sphere) pairs with the sphere ahead of the ray (t_ca > 0; alpha is
    0 behind); ``live_s`` / ``live_p`` (pixel, sphere / plane) pairs with
    alpha > 0 (any other object has weight 0 and is no occluder); ``pairs``
    (pixel, live object i, live object j) with j in front of i, and
    ``pairs_s`` those with j a sphere (the weight factors); ``lit`` (pixel,
    live object, light) with a positive Lambert term (only those need a
    shadow ray); ``shadow_front`` / ``shadow_live`` (pixel, live object, lit
    light, sphere) with the sphere ahead of the shadow ray / with alpha > 0
    there. ``block`` bounds the elements of one block's largest
    intermediate."""
    from ..ops.intersect import _dot
    from ..ops.soft import _norm, _plane_cover, _sphere_soft_cover
    w, h = camera.resolution
    ns, npl, nl = scene.spheres.count, scene.planes.count, scene.lights.count
    k = ns + npl
    dev = camera.device
    tot = dict.fromkeys(("front", "live_s", "live_p", "pairs", "pairs_s", "lit",
                         "shadow_front", "shadow_live"), 0)
    tot["px"] = w * h
    if k == 0:
        return tot
    cols = max(1, block // (h * k * max(k, 3 * nl * max(ns, 1))))
    idx = torch.arange(k, device=dev)
    ys = torch.arange(h, dtype=torch.float32, device=dev)
    with torch.no_grad():
        for xb in torch.split(torch.arange(w, dtype=torch.float32, device=dev), cols):
            gx, gy = torch.meshgrid(xb, ys, indexing="ij")
            d = camera.ray_directions(torch.stack([gx, gy], dim=-1), compat=False)
            o = camera.ray_origin().expand(d.shape)
            alpha, t, P, N = [], [], [], []
            if ns:
                c = scene.spheres.center
                tot["front"] += int((_dot(c - o[..., None, :], d[..., None, :]) > 0).sum())
                a_s, t_s = _sphere_soft_cover(o, d, c, scene.spheres.radius, tau)
                P_s = o[..., None, :] + t_s[..., None] * d[..., None, :]
                alpha.append(a_s), t.append(t_s), P.append(P_s)
                N.append((P_s - c) / _norm(P_s - c))
            if npl:
                a_p, t_p = _plane_cover(o, d, scene.planes.origin, scene.planes.normal)
                P_p = o[..., None, :] + t_p[..., None] * d[..., None, :]
                alpha.append(a_p), t.append(t_p), P.append(P_p)
                N.append(scene.planes.normal.expand(P_p.shape))
            alpha, t = torch.cat(alpha, dim=-1), torch.cat(t, dim=-1)
            P, N = torch.cat(P, dim=-2), torch.cat(N, dim=-2)
            live = alpha > 0
            tot["live_s"] += int(live[..., :ns].sum())
            tot["live_p"] += int(live[..., ns:].sum())
            ti, tj = t[..., :, None], t[..., None, :]          # [i, j]: j in front of i
            ahead = (tj < ti) | ((tj == ti) & (idx[None, :] < idx[:, None]))
            ahead &= live[..., :, None] & live[..., None, :]
            tot["pairs"] += int(ahead.sum())
            tot["pairs_s"] += int(ahead[..., :ns].sum())
            if nl:
                Ld = scene.lights.position - P[..., None, :]    # (..., K, nl, 3)
                Ld = Ld / _norm(Ld)
                lit = (scene.materials.lambert * _dot(Ld, N[..., None, :]) > 0) & live[..., None]
                tot["lit"] += int(lit.sum())
                if ns:   # t_ca = c . L - P . L along each shadow ray
                    t_ca = Ld @ scene.spheres.center.T - _dot(P[..., None, :], Ld)[..., None]
                    tot["shadow_front"] += int(((t_ca > 0) & lit[..., None]).sum())
                    a_sh, _ = _sphere_soft_cover(P[..., None, :], Ld, scene.spheres.center,
                                                 scene.spheres.radius, tau)
                    tot["shadow_live"] += int(((a_sh > 0) & lit[..., None]).sum())
    return tot


def soft_work(camera, scene, tau: float, mode: str, live: dict | None = None) -> tuple:
    """(operations, bytes) the soft render's function needs for this run's
    inputs: ``mode`` "fwd" (the image; csrc/soft_fwd.cu), "cot" (the
    gradient of an image cotangent) or "fused" (the MSE loss and its
    gradient; csrc/soft_bwd.cu). Every primary and shadow cover is counted
    once: the ray geometry always, b^2 where the sphere is ahead, the sigmoid
    where its alpha is not 0; the weights' factors once per (object, occluder
    in front) pair; shading and shadow rays only for objects with alpha > 0
    and lights with a positive Lambert term; in the
    gradient modes the forward values once (and the loss once in "fused"),
    each adjoint once, and one add per pixel into each gradient slot its
    camera, materials and live objects reach. ``live``: soft_live_counts of
    these inputs, when already taken."""
    ns, npl, nl = scene.spheres.count, scene.planes.count, scene.lights.count
    c = soft_live_counts(camera, scene, tau) if live is None else live
    px, live_k = c["px"], c["live_s"] + c["live_p"]
    fwd = (px * (RAYGEN + ns * COVER_GEO + npl * PLANE)
           + c["front"] * COVER_D2 + c["live_s"] * (COVER_T - COVER_GEO - COVER_D2)
           + live_k * (SURFACE + 1 + nl * LIGHT) + c["live_s"] * SPHERE_NORMAL
           + c["pairs"]                                   # w_i *= 1 - a_j
           + c["lit"] * (ns * COVER_GEO + 2)              # lam_sum += relu(lam) vis
           + c["shadow_front"] * COVER_D2
           + c["shadow_live"] * (COVER - COVER_GEO - COVER_D2 + 2))   # vis *= 1 - a_j
    out_bytes = 12 * px
    if mode == "fwd":
        return fwd + live_k * ACCUMULATE, _scene_bytes(ns, npl, nl) + out_bytes
    adj = (live_k * OBJ_ADJ + c["live_s"] * SPHERE_ADJ + c["live_p"] * PLANE_ADJ
           + 2 * c["pairs_s"] + c["lit"] * LIGHT_ADJ + c["shadow_live"] * SHADOW_ADJ
           + px * CAMERA_ADJ
           + px * 17 + 7 * c["live_s"] + 9 * c["live_p"])   # the sum over pixels
    ops = fwd + adj
    if mode == "fused":
        ops += live_k * ACCUMULATE + px * LOSS
    n = 7 * ns + 9 * npl + 3 * nl + 18 + int(mode == "fused")
    return ops, _scene_bytes(ns, npl, nl) + out_bytes + 4 * n


def hard_samples(W: int, H: int, mode: str) -> int:
    """Sample chains a hard render launch traces: one a pixel without AA, 9 a
    pixel inside the border ring with AA (4 shared grids a 16x16 tile in
    ``aa_shared``: 1089 chains for 256 pixels)."""
    if mode in ("aa_none", "cot_noaa", "fused_noaa"):
        return W * H
    if mode == "aa_shared":
        return -(-W // 16) * -(-H // 16) * 1089
    interior = max(W - 2, 0) * max(H - 2, 0)
    return W * H + 8 * interior


def hard_work(W: int, H: int, ns: int, npl: int, nl: int, mode: str) -> tuple:
    """(operations, bytes) lower bound of one hard render or backward launch
    (csrc/render_fwd_kernel.cuh, csrc/render_bwd.cu): ray generation and the primary
    closest-hit sweep of every sample chain, and in the backward the ray
    direction's adjoint and one add a chain into each camera and material
    slot. Shadow, bounce and adjoint work depend on the hits and are left
    out."""
    samples = hard_samples(W, H, mode)
    ops = samples * (RAYGEN + HIT_SETUP + ns * HIT_SPHERE + npl * HIT_PLANE)
    nbytes = _scene_bytes(ns, npl, nl) + 12 * W * H      # image out, or image in
    if mode.startswith(("cot", "fused")):
        ops += samples * (18 + NORM_ADJ)     # 18 slot sums a chain
        nbytes += 4 * (7 * ns + 9 * npl + 3 * nl + 19)   # the gradient out
    return ops, nbytes


def bwd_positions(W: int, H: int, aliasing: bool, g=None) -> torch.Tensor:
    """Float ``(N, 2)``: the distinct sample positions the render's gradient
    needs, in pixel-index space. Without AA every pixel; with AA every
    interior pixel's 9 samples and every border pixel's centre, each distinct
    position once (neighbouring pixels share their half-offset samples). With
    ``g`` (an image cotangent ``(W, H, 3)``) only the pixels whose cotangent
    is not 0 count."""
    need = torch.ones((W, H), dtype=torch.bool) if g is None else \
        (g.detach().cpu() != 0).any(dim=-1)
    if not aliasing:
        x, y = torch.nonzero(need, as_tuple=True)
        return torch.stack([x, y], dim=-1).float()
    half = torch.zeros((2 * W + 1, 2 * H + 1), dtype=torch.bool)   # (2x + 1, 2y + 1) is (x, y)
    inner = torch.zeros((W, H), dtype=torch.bool)
    inner[1:W - 1, 1:H - 1] = True
    half[1::2, 1::2] |= need
    for sx in (-1, 0, 1):
        for sy in (-1, 0, 1):
            half[1 + sx:2 * W + 1 + sx:2, 1 + sy:2 * H + 1 + sy:2] |= need & inner
    i, j = torch.nonzero(half, as_tuple=True)
    return torch.stack([(i.float() - 1.0) / 2.0, (j.float() - 1.0) / 2.0], dim=-1)


def hard_chain_counts(camera, scene, positions, *, depth: int, compat: bool = True,
                      block: int = 1 << 18) -> torch.Tensor:
    """What the hard render's chains at ``positions (N, 2)`` meet, by the
    plain trace (ops/shade.py, no gradient): float64 ``(depth + 1, 3)``, per
    trace level the rays traced, the sphere hits and the plane hits (a ray is
    traced at level l from each hit at level l - 1)."""
    from ..ops.intersect import closest_hit
    from ..ops.shade import trace_once
    out = torch.zeros((depth + 1, 3), dtype=torch.float64)
    ns = scene.spheres.count
    with torch.no_grad():
        for pos in torch.split(positions.to(camera.device), block):
            d = camera.ray_directions(pos, compat=compat)
            o = camera.ray_origin().expand(d.shape)
            alive = torch.ones(d.shape[:-1], dtype=torch.bool, device=d.device)
            for lvl in range(depth + 1):
                o, d = o[alive], d[alive]
                out[lvl, 0] += o.shape[0]
                if o.shape[0] == 0 or ns + scene.planes.count == 0:
                    break
                hit = closest_hit(o, d, scene, compat=compat)
                out[lvl, 1] += float((hit["hit"] & (hit["obj"] < ns)).sum())
                out[lvl, 2] += float((hit["hit"] & (hit["obj"] >= ns)).sum())
                if lvl == depth:
                    break
                st = trace_once(o, d, scene, compat=compat)
                alive, o, d = st.alive, st.point, st.direction
    return out


def hard_bwd_work(W: int, H: int, ns: int, npl: int, nl: int, mode: str, counts) -> tuple:
    """(operations, bytes) the hard render's gradient needs for this run's
    inputs (csrc/render_bwd.cu; in ``fused_aa`` with the ``aa_shared``
    render before it): ``counts`` is :func:`hard_chain_counts` of the chains
    at :func:`bwd_positions`. The forward chain once: every traced ray's
    ray generation (level 0) or nothing more, its closest-hit set-up and
    sweep over every object; every live hit's surface, normal and per light
    its direction, Lambert term, a shadow ray's set-up and planes and one
    sphere test (the first may stop it). The reverse sweep once: per live hit
    the trace's adjoint (TRACE_ADJ), each light's (LIGHT_ADJ) and its
    object's (a sphere's quadratic root and normal, or PLANE_ADJ); per chain
    the camera's (CAMERA_ADJ). One add a chain into each slot it touches (the
    5 material and 13 camera slots, the loss, each live hit's 3 nl light and 7
    or 9 object slots). In the fused modes the loss (LOSS a pixel; with AA the
    9-sample combine first). Bytes: the scene, the image or target in (both in
    ``fused_aa``: the render's image is the function's own intermediate, not
    counted), the gradient out."""
    c = torch.as_tensor(counts, dtype=torch.float64)
    rays, sph, pln = c[:, 0], c[:, 1], c[:, 2]
    chains, hits = float(rays[0]), float(sph.sum() + pln.sum())
    fused = mode.startswith("fused")
    fwd = (chains * RAYGEN + float(rays.sum()) * (HIT_SETUP + ns * HIT_SPHERE + npl * HIT_PLANE)
           + hits * (SURFACE + nl * (LIGHT + SHADOW_SETUP + npl * HIT_PLANE + min(ns, 1)
                                     * SHADOW_SPHERE)) + float(sph.sum()) * SPHERE_NORMAL)
    adj = (hits * (TRACE_ADJ + nl * LIGHT_ADJ) + float(sph.sum()) * SPHERE_HIT_ADJ
           + float(pln.sum()) * PLANE_ADJ + chains * CAMERA_ADJ)
    adds = chains * (18 + int(fused)) + hits * 3 * nl + float(sph.sum()) * 7 + float(pln.sum()) * 9
    ops = fwd + adj + adds
    if fused:
        ops += W * H * (LOSS + (AA_COMBINE if mode.endswith("_aa") else 0))
    nbytes = _scene_bytes(ns, npl, nl) + 12 * W * H + 4 * (7 * ns + 9 * npl + 3 * nl + 18
                                                          + int(fused))
    return ops, nbytes


def position_tiles(positions, H: int) -> torch.Tensor:
    """Long ``(N,)``: the 16x16 tile (x tiles outermost, as the tables number
    them) whose chains trace each sample position ``(N, 2)`` (pixel-index
    space; a half-offset position on a tile's low edge is its tile's, a
    corner lattice position at +15.5 the next tile's too, counted once in
    the first)."""
    t = torch.floor((positions.to(torch.float64) + 0.5) / 16.0).to(torch.int64)
    return t[:, 0] * -(-H // 16) + t[:, 1]


def level0_hits_by_tile(camera, scene, positions, *, compat: bool = True,
                        block: int = 1 << 18) -> torch.Tensor:
    """Float64 ``(n_tiles,)``: the primary rays at ``positions (N, 2)`` that
    hit something, by :func:`position_tiles`' tile (the level-0 shadow rays'
    origins, one a light each), by the plain closest hit."""
    from ..ops.intersect import closest_hit
    W, H = camera.resolution
    n_tiles = -(-W // 16) * -(-H // 16)
    out = torch.zeros(n_tiles, dtype=torch.float64)
    tiles = position_tiles(positions, H)
    with torch.no_grad():
        for pos, til in zip(torch.split(positions.to(camera.device), block),
                            torch.split(tiles, block)):
            d = camera.ray_directions(pos, compat=compat)
            o = camera.ray_origin().expand(d.shape)
            hit = closest_hit(o, d, scene, compat=compat)["hit"].cpu()
            out += torch.bincount(til[hit], minlength=n_tiles).to(torch.float64)
    return out


def hard_bwd_work_culled(W: int, H: int, ns: int, npl: int, nl: int, mode: str, counts,
                         positions, hits0, vis=None, shadow=None, tree=None) -> tuple:
    """(operations, bytes) the hard render's gradient needs through the
    large-scene tables (csrc/render_bwd_kernel.cuh's TABLES forms), as
    :func:`large_scene_work` counts them for the render: :func:`hard_bwd_work`
    with each primary ray's closest-hit sweep over its tile's cone-visible
    list (``vis = (idx, cnt, k)``; ``positions`` are the chains'
    :func:`bwd_positions`, by :func:`position_tiles`), each level-0 shadow
    ray's one sphere test only where its (tile, light) occluder list
    (``shadow``) is not empty (``hits0``: :func:`level0_hits_by_tile`, the
    live primary hits by tile), and with the bounce tree (``tree``, a
    ``cull_tables.BounceTree``) a bounce ray's sweep at its floor of one
    sphere test (:func:`bounce_floor`). A table that is None, and a row that
    overflowed, sweeps all ``ns`` spheres, so with every list row full and
    no tree this is :func:`hard_bwd_work`'s count. Bytes: its, and the
    tables in."""
    ops, nbytes = hard_bwd_work(W, H, ns, npl, nl, mode, counts)
    c = torch.as_tensor(counts, dtype=torch.float64)
    n_tiles = -(-W // 16) * -(-H // 16)
    tiles = position_tiles(positions, H)
    swept = _listed(vis, n_tiles, ns)
    if isinstance(swept, torch.Tensor):
        ops -= float((ns - swept.cpu().double()[tiles]).sum()) * HIT_SPHERE
    occ = _listed(shadow, n_tiles * nl, ns)
    if isinstance(occ, torch.Tensor) and ns > 0:
        empty = (occ.cpu().double().reshape(n_tiles, nl) == 0).sum(dim=1)
        ops -= float((torch.as_tensor(hits0, dtype=torch.float64) * empty).sum()) * SHADOW_SPHERE
    if tree is not None:
        ops -= float(c[1:, 0].sum()) * (ns - min(ns, 1)) * HIT_SPHERE
        nbytes += 4 * (tree.box.numel() + tree.perm.numel())
    for tab, rows in ((vis, n_tiles), (shadow, n_tiles * nl)):
        if tab is not None:
            nbytes += 4 * (rows * tab[2] + rows)
    return ops, nbytes


# A live hit's floor past the sweep: its point and normal, then for each
# light the direction and Lambert term, a shadow ray's set-up and its planes.
def _hit_floor(npl: int, nl: int) -> int:
    return SURFACE + SPHERE_NORMAL + nl * (LIGHT + SHADOW_SETUP + npl * HIT_PLANE)


def bounce_floor(live, npl: int, nl: int) -> float:
    """Operations the bounce levels need at least, from live counts ``(...,
    L)`` at trace levels 0..L-1 (L = depth + 1; any leading shape is summed):
    a bounce ray is traced at level l from each hit alive at level l - 1 (its
    set-up, the planes and at least the one sphere test of its sweep), and
    each hit alive at level l >= 1 is shaded (:func:`_hit_floor`)."""
    lv = torch.as_tensor(live, dtype=torch.float64)
    lv = lv.reshape(-1, lv.shape[-1]).sum(dim=0)
    return float(lv[:-1].sum()) * (HIT_SETUP + npl * HIT_PLANE + HIT_SPHERE) + \
        float(lv[1:].sum()) * _hit_floor(npl, nl)


def adaptive_work(idx, n_listed: int, H: int, ns: int, npl: int, nl: int,
                  vis=None, shadow=None, ext=None, W: int | None = None) -> tuple:
    """(operations, bytes) lower bound of one worklist launch
    (csrc/render_fwd_kernel.cuh ``render_list_kernel``) for this run's first
    ``n_listed`` slots of ``idx`` (``min(flagged, K)`` flat indices ``x * H +
    y``): as :func:`large_scene_work`, ray generation and the primary sweep of
    each of their 9 sample chains over the cone-visible spheres of the pixel's
    16x16 tile (``vis = (idx, cnt, k)``; all ``ns`` for a row that
    overflowed, or with ``vis`` None). With ``ext``, the hit-extent rows of
    the AA lattice at levels 0..depth (``W`` wide), the shadow and bounce
    levels too, over the chains that must be alive: a tile whose in-image
    lattice positions (:func:`tile_positions`) hold D dead ones at a level
    has at most 4 D dead chains there (a corner position serves 4 pixels), so
    of its listed pixels' 9 m chains at least ``max(0, 9 m - 4 D)`` live.
    Those count the level-0 shadow rays over the tile's occluder lists
    (``shadow``, as :func:`large_scene_work`) and :func:`bounce_floor`.
    Bytes: the scene, the flagged count and the tables in, each listed
    pixel's index in and its 12 bytes out."""
    ops = 9 * n_listed * (RAYGEN + HIT_SETUP + npl * HIT_PLANE)
    nbytes = _scene_bytes(ns, npl, nl) + 4 + 16 * n_listed
    for tab in (vis, shadow):
        if tab is not None:
            nbytes += 4 * tab[1].numel() * (tab[2] + 1)
    p = idx[:n_listed].to(dtype=torch.int64).cpu()
    rows = (p // H) // 16 * -(-H // 16) + (p % H) // 16    # x tiles outermost
    swept = _listed(vis, 0, ns)
    if isinstance(swept, torch.Tensor):
        ops += 9 * float(swept.cpu()[rows].sum()) * HIT_SPHERE
    else:
        ops += 9 * n_listed * swept * HIT_SPHERE
    if ext is not None:
        n_tiles = -(-W // 16) * -(-H // 16)
        m = torch.bincount(rows, minlength=n_tiles).to(torch.float64)
        live = ext[:, 6].reshape(n_tiles, -1).cpu().to(torch.float64)
        dead = tile_positions(W, H, True).to(torch.float64)[:, None] - live
        chains = torch.clamp(9.0 * m[:, None] - 4.0 * dead, min=0.0)   # (n_tiles, L)
        occ = _listed(shadow, n_tiles * nl, ns)
        occ = occ.reshape(n_tiles, nl).sum(dim=1).cpu().double() if isinstance(
            occ, torch.Tensor) else occ * nl
        ops += float((chains[:, 0] * (nl * (LIGHT + SHADOW_SETUP + npl * HIT_PLANE) +
                                      occ * SHADOW_SPHERE)).sum())
        ops += bounce_floor(chains, npl, nl)
    return ops, nbytes


def _listed(table, n_rows: int, ns: int):
    """Spheres each row's sweep visits: its list's count, or all ``ns`` for a
    row that overflowed (-1) and where the table is off (None). A float
    tensor ``(n_rows,)`` on the table's device, or the number ``ns``."""
    if table is None:
        return float(ns)
    cnt = table[1].to(torch.float32)
    return torch.where(cnt < 0, torch.full_like(cnt, float(ns)), cnt)


def tile_positions(W: int, H: int, aliasing: bool) -> torch.Tensor:
    """Sample positions inside the image ``[0, W-1] x [0, H-1]`` of every 16x16
    tile, float ``(n_tiles,)`` in the tables' tile order (x tiles outermost):
    the pixel centers and, with AA, the half-offset positions of the tile's
    17-wide grids (the -0.5 column and the ragged edge fall outside)."""
    def axis(n):
        x0 = 16.0 * torch.arange(-(-n // 16), dtype=torch.float32)
        centers = (x0[:, None] + torch.arange(16.0) <= n - 1).sum(dim=1)
        half = x0[:, None] - 0.5 + torch.arange(17.0)
        return centers + (((half >= 0) & (half <= n - 1)).sum(dim=1) if aliasing else 0)
    return (axis(W)[:, None] * axis(H)[None, :]).reshape(-1).to(torch.float32)


def hit_extents_work(W: int, H: int, ns: int, npl: int, aliasing: bool, vis, ext,
                     scale: bool = False) -> tuple:
    """(operations, bytes) the hit-extent function (csrc/hit_extents.cu, one
    trace level) needs for this run's tables: every in-image sample position
    of a tile (:func:`tile_positions`) generates its ray and sweeps the tile's
    cone-visible spheres (``vis = (idx, cnt, k)``; all ``ns`` for a row that
    overflowed, or with ``vis`` None) and the planes once; the samples that hit
    (``ext``'s counts, the rows the function returns) form their hit point and
    normal. Bytes: parameters, spheres and planes in, the primary lists and
    counts in, 32 bytes a tile out, and with ``scale`` (a launch that writes
    the rows' scale, as the render path's does) its 4 bytes."""
    pos = tile_positions(W, H, aliasing)
    n_tiles = pos.shape[0]
    swept = _listed(vis, n_tiles, ns)
    if isinstance(swept, torch.Tensor):
        swept = swept.cpu()
    live = float(ext[:, 6].sum())
    ops = float((pos * (RAYGEN + HIT_SETUP + npl * HIT_PLANE + swept * HIT_SPHERE)).sum()) + \
        live * (SURFACE + SPHERE_NORMAL)
    nbytes = 4 * (41 + 7 * ns + 9 * npl) + 32 * n_tiles + (4 if scale else 0)
    if vis is not None:
        nbytes += 4 * (n_tiles * vis[2] + n_tiles)
    return ops, nbytes


def large_scene_work(W: int, H: int, ns: int, npl: int, nl: int, mode: str, vis, shadow,
                     ext) -> tuple:
    """(operations, bytes) lower bound of one render launch on the large-scene
    path for this run's tables: :func:`hard_work`'s ray generation and primary
    sweep, the sweep over each tile's cone-visible spheres only (``vis``), plus
    the level-0 shadow rays, one a light from every live in-image sample
    (``ext``'s counts, the hit-extent rows of this frame), each over its (tile,
    light) occluder list (``shadow``) and the planes. A table that is None
    sweeps all ``ns`` spheres. Where ``ext`` holds levels 0..depth (levels
    fastest, as the hit-extent kernel writes them), the bounce levels'
    :func:`bounce_floor` of its live counts too. Bytes: :func:`hard_work`'s
    and the tables in."""
    n_tiles = -(-W // 16) * -(-H // 16)
    per_tile = hard_samples(W, H, mode) / n_tiles
    swept = _listed(vis, n_tiles, ns)
    swept = float(swept.sum()) if isinstance(swept, torch.Tensor) else swept * n_tiles
    ops = per_tile * (n_tiles * (RAYGEN + HIT_SETUP + npl * HIT_PLANE) + swept * HIT_SPHERE)
    levels = ext[:, 6].reshape(n_tiles, -1).to(torch.float32)
    ops += bounce_floor(levels.cpu(), npl, nl)
    live = levels[:, 0]                                              # (n_tiles,)
    occ = _listed(shadow, n_tiles * nl, ns)
    occ = occ.reshape(n_tiles, nl).sum(dim=1).to(live.device) if isinstance(
        occ, torch.Tensor) else occ * nl
    ops += float((live * (nl * (LIGHT + SHADOW_SETUP + npl * HIT_PLANE) +
                          occ * SHADOW_SPHERE)).sum())
    nbytes = _scene_bytes(ns, npl, nl) + 12 * W * H
    for tab, rows in ((vis, n_tiles), (shadow, n_tiles * nl)):
        if tab is not None:
            nbytes += 4 * (rows * tab[2] + rows)
    return ops, nbytes


def light_cells_work(ns: int, nl: int, r: int = 64, k: int = 32) -> tuple:
    """(operations, bytes) of one light-cell build (csrc/light_cells.cu) for
    ``ns`` spheres and ``nl`` lights at ``r x r`` cells a face and ``k``
    slots a row: every (row, sphere) cone test once, each row's cone, each
    light's per-sphere terms and the reach once; bytes: the spheres' centers
    and radii and the lights in, every row's slots and count and the header
    out."""
    rows = nl * 3 * r * r
    ops = rows * (LC_CELL + ns * LC_TEST) + nl * ns * LC_SPHERE + (ns + nl) * LC_REACH
    return ops, 16 * ns + 12 * nl + 4 * rows * (k + 1) + 8


def shadow_lists_work(ext, lights, centers, radii, *, K: int, compat: bool) -> tuple:
    """(operations, bytes) the shadow-list function (csrc/shadow_lists.cu) needs
    for this frame's hit-extent rows ``ext (T, 8)`` (a tile's, or with the lists
    of L trace levels a (tile, level)'s: ``T`` the tiles times L): each (tile
    with hits, light) row's terms once, each (light, sphere)'s once, and one
    capsule-and-cone test a (row, sphere) up to the point where the row is
    decided: all ``ns`` spheres for a row that keeps at most ``k = min(K, ns)``,
    the spheres up to its (k + 1)-th kept one for a row that overflows; none for
    a row of a tile without hits or a row whose cone is not defined (it keeps
    every sphere). Bytes: the rows and their scale, the spheres, the lights and
    the lights' orders in, every row's slots and count out. The rows' decisions
    are ``cull_tables.shadow_rows``'."""
    from ..ops.cuda.cull_tables import shadow_rows
    T, nl, ns = ext.shape[0], lights.shape[0], centers.shape[0]
    k = min(K, ns)
    rows = shadow_rows(ext, lights, centers, radii, compat=compat)
    live = rows.has[:, None] & rows.cull_ok                          # (T, nl): rows tested
    kept = torch.cumsum(rows.keep, dim=2)                            # (T, nl, ns)
    # spheres tested: up to the first position where k + 1 are kept, else all
    tests = torch.where(kept[..., -1] > k, (kept <= k).sum(dim=2) + 1,
                        torch.full_like(kept[..., -1], ns))
    n_tests = float(torch.where(live, tests, torch.zeros_like(tests)).sum())
    ops = float(rows.has.sum()) * nl * SL_ROW + nl * ns * SL_SPHERE + n_tests * SL_TEST
    nbytes = 32 * T + 4 + 16 * ns + 12 * nl + 4 * nl * ns + 4 * T * nl * (k + 1)
    return ops, nbytes

