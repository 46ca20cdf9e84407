# Frozen copy of the work and bound arithmetic of python_ray_tracer_tpu_torch/utils/timing.py
# (from its lines 72-601) at commit fa8828e2546d4fbea5df42a59f967d164dc1f66a: the part that the
# benchmark's rooflines read (the bounds, the soft work, the hard chains' counts and their sample
# positions). Changed: the plain functions that soft_live_counts and hard_chain_counts call are
# the benchmark's own copies (port_bench.reference), not the port's. Nothing else differs, so a
# later change to the port cannot change what a roofline counts.
"""Operations and bytes that a kernel's function needs, and the bound they give on one H100."""
from __future__ import annotations

import torch

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
    from ..reference.intersect import _dot
    from ..reference.soft import _norm, _plane_cover, _sphere_soft_cover
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
    from ..reference.intersect import closest_hit
    from ..reference.shade import trace_once
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
