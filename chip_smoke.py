#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (python_ray_tracer_tpu_torch) on one card.

Builds the CUDA kernels from ``python_ray_tracer_tpu_torch/csrc``, checks that
``random_scene(n)`` and ``cli render --spheres n``'s scene are the JAX
package's (``[cli-scene]``: digests at 100 and 1000 spheres), builds the
host helper of the output layer (``[native]``: the GIF LZW from
``csrc/host/``, its g++ time, and ``save_png``'s bytes and zlib), holds each
render kernel mode against the plain PyTorch version and against the JAX
package's frozen framebuffers (``tests/goldens/*.npz``, read with numpy), drives
the render path through the CLI (``render --backend cuda`` at 1000x1000 with
AA, 1920x1080 without and with AA), checks that the path launched the kernels
and wrote the right PNGs, and times kernel against plain version with CUDA
events (phases 1-6). Then the backward kernel (phases 7-9): every mode against
its plain version at 256x256 and twice for bit-identical results; the training
path through its entry points at the fit CLI's defaults (``cli fit --mode
hard`` and ``--mode camera`` at 1000x1000, depth 2, the AA ``fit_scene`` step,
``fused=False`` and ``render_image_fast``'s backward), with launch counts and
convergence checked and each mode held against its plain version at those
shapes; and step times (kernel alone, its reduction, host packing, Adam, the
whole ``fit_scene`` step, the plain step), each mode's kernel beside other
launch plans (``[bwd-plan]``: threads a block and blocks a multiprocessor
around the planner's choice), ptxas's rows of the backward and soft forward
sources (``[bwd-regs]``), and the bound ``utils/timing.hard_bwd_work`` of
the run's live counts (``[bound]``, the old lower bound beside it). Then the
soft-visibility kernels
(phases 10-12): the soft forward and both soft backward modes against their
plain versions at every tau of the anneal (demo scene 256x256, 100 seeded
spheres 128x128), twice for bit-identical results; ``cli fit --mode soft``
(its default mode) and ``cli render --soft 0.05`` at 1000x1000 with launch,
convergence and PNG checks; the fit's targets, its step 0 and
``render_image_soft_fast``'s backward held against their plain versions at
that size; the counted plain bounce fit; and times (demo 1000x1000, 100
spheres 512x512, both from the fit's shifted centers; the soft forward and
the backward's two modes at every tau of the anneal, the backward under the
planner's launch plan). Then the
large-scene render path (phases 13-15): the hit-extent kernel (TPU kernel 3)
against its plain version on the CLI's 100 and 1000 spheres at 256x256, twice for
bit-identical rows and scales, the scale that of its rows; the list kernel
(``[lists]``: the level-0 shadow lists, no TPU kernel) against the plain
``shadow_visibility_lists`` on the same rows integer for integer, at 1920x1080,
100 and 1000 spheres, AA and not, compat and clean, at the list capacity and
at K = 4, twice for bit-identical rows; the render kernel with
the cone cull, the shadow lists, the bounce tree, and all three, against all
culls off bit for bit in every mode, compat and clean, and all on against the
plain version; ``cli render --backend cuda --spheres 100|1000`` at 1920x1080
without and with AA, with launch counts, PNG and plain-version checks and the
hit-extent rows held against their plain version at those shapes; and times
(kernel 3 alone, the list kernel alone and through its wrapper beside the plain
function and its bound, the three table functions, the render kernel with all
culls on and all off, the whole wrapper, the plain version, list lengths), and
the hit-extent kernel built with 1, 2, 4 and 8 warps a tile in each mode
(``[extent-sweep]``). Then
adaptive AA (phases 16-18): the worklist kernel (TPU kernel 7) against the
plain trace of the same worklist on the demo scene and 100 and 1000 seeded
spheres at 256x256, compat and clean, twice for bit-identical frames, and
with every interior pixel flagged against the per-sample AA render; ``cli
render --adaptive-aa 0.002`` at 1920x1080 on those three scenes, with launch
counts, the stats line, PNG and full-AA quality checks; and times (the kernel
alone, the centers pass, the flag/tent/compaction ops on the device and the
host, the whole wrapper against the ``aa_shared`` and ``aa_none`` wrappers,
the plain trace, the bound), the kernel held against the plain trace of those
worklists. Then the large-scene bounce sweeps (phase 19, ``[tree-*]``):
kernels 2 (``aa_shared``) and 7 (the worklist kernel) alone
on the demo scene and 100 and 1000 spheres, at 1000 spheres at depth 0, 1 and
2, the live samples of each trace level, the bounce tree's LEAF x FAN sweep
(kernels built for each shape), its box and sphere tests a bounce ray, and
ptxas's registers and spills; the light cells of the bounce shadow rays
(phase 21, ``[lightbuf-*]``): their build kernel against its plain version
integer for integer at 100 and 1000 spheres and its times, what a bounce
shadow ray reads and tests (the plain lookup traversal on every 16th pixel's
chains, each answer held against the full any-hit), ``aa_none`` alone with the
cells on and off (depth 0 / 1 / 2 at 1000 spheres), the centers pass of
adaptive AA, ``aa_shared``, the worklist kernel and ``aa_per_sample``, every
frame with the cells on ``torch.equal`` to the one without, the R x K sweep at
1000 spheres (kernels built with -DRT_LC_R / -DRT_LC_K) and ptxas's
registers; and kernels 1, 2 and 7 through their entry points (phase 20,
``[entry-time]``: wrapper and profiled kernel times, the adaptive wrapper's
centers pass and ``aa_per_sample`` among them, and ptxas's registers of the
small-scene source). Every kernel's entry
in the kernels line carries its bound (``utils/timing.py``: the FP32
operations and bytes the function needs, over the H100's peak rates); the
light-cell and list kernels have entries of their own beside the seven TPU
kernels' (``replaces`` null: no TPU kernel builds such a table). Then the
ray-parallel path (phase 22, :func:`parallel_phase`, ``[ray-par]``,
``[repair]``, ``[animate]``): frames stitched from slices ``torch.equal`` to
the whole frame, the fused steps' slice partials against the frame's, two
ranks on the one card over gloo, the backward kernels at 7753 spheres and
their global form against the staged one (the hard kernel's bits, the soft
kernel's rule, and the times behind the planners' rules), and ``cli animate``
(its GIF written twice at 256x256 and 1000x1000: the same bytes, sizes and
times beside the literal-code writer's);
``python3 chip_smoke.py --phase 22`` runs it alone after the build. Then
phase 23 (``--phase 23`` alone): :func:`faults_phase` (``[faults]``,
``[profile]``: ``device_healthcheck``, ``resilient_fit`` over the fused step
at the fit CLI's width with a NaN and an exception injected, losses
``torch.equal`` to an uninterrupted run's, ``capture_trace`` naming the
scopes and kernels; in the whole run it comes right after phase 6, before
the timing phases' profiler sessions) and :func:`scene_size_phase`
(``[size-*]``: every kernel's global, chunked or device-rows form against
its staged form and both timed, then 16384- and 65536-sphere scenes through the entry points,
each kernel against its plain version). Then phase 24 (``--phase 24``
alone; :func:`bwd_tables_phase`): kernel 4 through the render's
large-scene tables, every mode and form ``torch.equal`` to the same launch
with every table off (``[bwd-tables]``), their times and the whole
``fit_scene`` step at 100 and 1000 spheres (``[bwd-tables-time]``, with the
steps one by one and one profiler trace), the staged form's bounce tree
staged against read in place (``[bwd-tree]``), the one-launch fused AA step
against the two-launch one (``[fused-aa1]``), the large-scene training path
through ``fit_scene`` (``[main]``) and the bounds. Then phase 26
(``--phase 26`` alone): :func:`defaults_phase` (``[defaults]``: scenes,
cameras and orbits made with no device argument lie on the card, every entry
point launches its kernels on them with no plain call, and every kernel
wrapper refuses CPU copies of the same inputs) and :func:`per_sample_phase`
(``[bwd-per-sample]``: the per-sample AA cotangent, ``scene_grads_cuda(
aa_share=False)``, which launches the lattice ``cot_aa``, against its plain
version, through the tables in every form, its slices, and its times).

Run from the repository root with ``python3 chip_smoke.py``. It needs one CUDA
card; without one, or without the package beside it, it exits non-zero. Any
failed phase raises. ``python3 chip_smoke.py --entry-times DIR`` runs phase
20 alone on the package of the checkout in DIR (an older commit unpacked with
``git archive``, say): it calls only entry points whose signatures every tree
of the port shares, so that two trees' times can be set side by side in one
run on one card (each tree's own ``chip_smoke.py`` gives the rest; a tree
whose ``random_scene`` takes no ``key`` drew another scene for ``--spheres n``:
run that tree's own ``chip_smoke.py --entry-times .``).
``python3 chip_smoke.py --ab-times DIR`` does the same for kernels 1, 2, 4, 5
and 6 (:func:`ab_times`: the four backward modes at the fit CLI's shapes, the
soft forward at every tau with each frame's digest, the soft backward's
digests, kernels 1, 2, 4 and 6 alone, and ptxas's rows of the checkout's
sources). The last
line of standard output is ``{"ok": true, "device": {...}}``; the line before
it lists the kernels.

Parity rules. Kernel against the plain version (tests/test_pallas.py::_compare's
rule): float32 reassociation (FMA contraction, the hoisted quadratic) flips
isolated near-tie hit or shadow tests, so uint8 frames are compared by the
COUNT of flipped pixels (some channel off by more than 1 level), which must stay
<= 0.1% of the image. Kernel against the goldens (tests/test_goldens.py's rule):
max diff <= 1 level on every pixel and < 1% changed, except at pixel (8, 33) of
the 64x64 goldens, a near tie on which the JAX Pallas kernel in interpret mode
itself reads 30 levels off demo_64_d2_noaa_clean (tests/torch_goldens.py).
Backward kernel against the plain version: the JAX package's kernel rule
(render_bwd_cuda.grad_rule) with the 0.1% of pixels where the kernel's and the
plain render disagree most held out of both sides (render_bwd_cuda.held_out).
Soft kernels against the plain version: soft_cuda.image_rule and
soft_bwd_cuda.soft_grad_rule, every element within its allowance of the plain
version in float32 or in float64 (where far spheres make the soft cover
cancel, float32 roundings differ by more than the allowance; the kernel must
stay near one of the two). Hit extents against the plain version:
hit_extents_cuda.extent_rule (counts and sentinel rows equal, boxes within
1e-3 + 1e-6 m^2, m the row's largest coordinate). The worklist kernel against
the plain trace: the flip rule over the listed pixels; with every interior
pixel flagged, against the per-sample AA render: ``torch.equal`` above 16
spheres (both in render_fwd.cu's pinned arithmetic), and on the demo scene
tests/test_adaptive.py's rule (max |d| <= 3e-5, uint8 off by at most 1 on at
most 0.2% of the pixels). Adaptive frames against full AA: at most 0.5% of
the pixels that were not dropped (flagged past the budget) off by more than
1 level, and the dropped count the flagged count less the budget's slots. A
render with culls on against culls off: ``torch.equal``, the bounce tree
included (it takes the least (t, index), so no sweep order moves a tie); the
worklist kernel with its tables against the same launch without:
``torch.equal``. The light cells' build kernel against its plain version:
``torch.equal`` on every row, count and the header.
In the kernels line, ``max_rel_err`` is the worst ratio of a
difference to its allowance under the entry's rule (<= 1 passes).
"""
from __future__ import annotations

import ctypes
import json
import os
import struct
import statistics
import subprocess
import sys
import time
import zlib

ROOT = os.path.dirname(os.path.abspath(__file__))
OUT_DIR = os.path.join(ROOT, "output", "chip_smoke")
FLIP_LEVELS = 1          # a channel off by more than this is a flipped pixel
FLIP_FRAC = 1e-3         # flipped pixels allowed, as a share of the image
GOLDEN_CHANGED = 0.01    # share of pixels allowed to change at all vs a golden
NEAR_TIE = (8, 33)       # the one pixel excused from max <= 1, in these goldens:
NEAR_TIE_GOLDENS = ("demo_64_d2_aa_compat", "demo_64_d2_noaa_clean",
                    "kernel_64_d2_aa_compat")
SHARED_AGREE = 0.999     # shared vs per-sample AA: share within 1 level
GOLDEN_CONFIGS = {       # name -> ((w, h), depth, aliasing, compat)
    "demo_64_d2_aa_compat": ((64, 64), 2, True, True),
    "demo_64_d2_noaa_clean": ((64, 64), 2, False, False),
    "demo_48_d4_noaa_compat": ((48, 48), 4, False, True),
    "kernel_48_d2_noaa_compat": ((48, 48), 2, False, True),
    "kernel_64_d2_aa_compat": ((64, 64), 2, True, True),
}
MAIN_PATH = (            # (label, CLI args, kernel mode it must launch)
    ("1000x1000_aa", ["--width", "1000", "--height", "1000"], "aa_shared"),
    ("1920x1080_noaa", ["--width", "1920", "--height", "1080", "--no-aliasing"],
     "aa_none"),
    ("1920x1080_aa", ["--width", "1920", "--height", "1080"], "aa_shared"),
)
REPLACES = {
    "aa_none": "python_ray_tracer_tpu/ops/pallas/render_pallas.py:1487",
    "aa_shared": "python_ray_tracer_tpu/ops/pallas/render_pallas.py:1386",
}
BWD_REPLACES = "python_ray_tracer_tpu/ops/pallas/render_bwd.py:736"
BWD_SOURCE = "python_ray_tracer_tpu_torch/csrc/render_bwd_kernel.cuh"
BWD_PARITY_RES = (256, 256)
FIT_STEPS = 30           # steps of each `cli fit` run on the main path
FIT_RES = (1000, 1000)   # the fit CLI's default size
LOSS_DROP = 0.75         # the fit's last loss must fall below this share of its first
# Device memory the plain AA training step may take at FIT_RES, reckoned from
# its peak at BWD_PARITY_RES; above it the plain AA step runs at BWD_PARITY_RES.
PLAIN_MEM_BUDGET = 60e9
# The soft-visibility kernels (phases 10-12).
SOFT_FWD_SOURCE = "python_ray_tracer_tpu_torch/csrc/soft_fwd.cu"
SOFT_BWD_SOURCE = "python_ray_tracer_tpu_torch/csrc/soft_bwd.cu"
SOFT_FWD_REPLACES = "python_ray_tracer_tpu/ops/pallas/soft_pallas.py:72"
SOFT_BWD_REPLACES = "python_ray_tracer_tpu/ops/pallas/soft_bwd.py:77"
SOFT_TAUS = (0.15, 0.05, 0.02)        # fit_scene_soft's anneal
SOFT_PARITY = (("demo", (256, 256)), ("random100", (128, 128)))
SOFT_TIMES = (("demo", (1000, 1000)), ("random100", (512, 512)))
# (cap, cj) timed beside the soft backward planner's choice at each thread
# count (clipped to the scene's object and sphere counts).
SOFT_PLAN_SWEEP = ((32, 16), (16, 16), (16, 4), (8, 8), (8, 4), (4, 4), (1, 4))
SOFT_FIT_STEPS = 150                  # the fit CLI's default
# Largest intermediate of one checkpointed block of the plain soft version
# (ops/soft.row_chunk_for), and the device memory the plain step may take at
# 1000x1000, reckoned from its peak at a small size.
SOFT_BLOCK_BYTES = 1 << 30
SOFT_PLAIN_BUDGET = 30e9


# The large-scene render path (phases 13-15).
HX_SOURCE = "python_ray_tracer_tpu_torch/csrc/hit_extents.cu"
HX_REPLACES = "python_ray_tracer_tpu/ops/pallas/render_pallas.py:990"
SL_SOURCE = "python_ray_tracer_tpu_torch/csrc/shadow_lists.cu"
# [extent-sweep]: warps a tile of the hit-extent kernel without and with AA
# (hit_extents.cu RT_HX_TILE_WARPS, RT_HX_AA_TILE_WARPS), the first the
# package's; the others each built alone with -D while phases 13-14 run and
# timed against it, so that each mode sees 1, 2, 4 and 8 warps a tile.
HX_SHAPES = ((1, 4), (2, 1), (4, 2), (8, 8))
LIST_KS = (None, 4)      # [lists]: the list capacity, and 4 (rows overflow)
LARGE_SPHERES = (100, 1000)
LARGE_RES = (1920, 1080)
LARGE_PARITY_RES = (256, 256)
LARGE_FRAMES = 7         # wrapper calls of one `cli render` run: warm-up, 5 timed, the PNG's
# Elements of the plain renderer's largest intermediate (a block's shadow
# sweep, columns x height x lights x objects) when it renders in column blocks.
PLAIN_BLOCK_ELEMS = 1 << 27
# benchmarks/large_scene.py's camera, timed beside the CLI's at 100 spheres
BENCH_POSE = ([-12.0, 0.0, 4.0], [0.0, -15.0, 0.0])
CROSSOVER_SPHERES = (32, 64, 100, 200, 300, 500, 700, 1000)
CULLS = {"cull": dict(cull=True, shadow_lists=False, group_cull=False),
         "lists": dict(cull=False, shadow_lists=True, group_cull=False),
         "groups": dict(cull=False, shadow_lists=False, group_cull=True),
         "all": dict(cull=True, shadow_lists=True, group_cull=True)}
ALL_OFF = dict(cull=False, shadow_lists=False, group_cull=False)
# Adaptive AA (phases 16-18): the worklist kernel (TPU kernel 7).
LIST_SOURCE = "python_ray_tracer_tpu_torch/csrc/render_fwd_kernel.cuh"
LIST_REPLACES = "python_ray_tracer_tpu/ops/pallas/render_adaptive.py:97"
ADAPTIVE_SCENES = (0, 100, 1000)     # 0: the demo scene
ADAPTIVE_PARITY_RES = (256, 256)
ADAPTIVE_PARITY_EPS = 0.5 / 255
ADAPTIVE_EPS = 0.002                 # the CLI runs' --adaptive-aa
ADAPTIVE_BUDGET = 0.25               # the CLI's default --adaptive-budget
TREE_SHAPES = ((4, 8), (4, 16), (8, 8), (8, 16))   # (LEAF, FAN) of phase 19's sweep
# The kernels' sources for a library of another tree shape (the render and
# worklist kernels, large and small halves; the sweep needs nothing else).
TREE_SWEEP_SOURCES = ("render_fwd.cu", "render_fwd_small.cu")
# The light cells of the bounce shadow rays (phase 21): the build kernel, the
# (R, K) shapes of the sweep (each built with -DRT_LC_R= -DRT_LC_K= from the
# render, worklist and build kernels' sources).
LC_SOURCE = "python_ray_tracer_tpu_torch/csrc/light_cells.cu"
LC_SHAPES = ((32, 32), (32, 64), (64, 32), (64, 64))
LC_SWEEP_SOURCES = ("render_fwd.cu", "render_fwd_small.cu", "light_cells.cu")
ADAPTIVE_QUALITY = 0.005             # pixels off full AA by > 1 level (tests/test_adaptive.py)
DEMO_ADAPTIVE_ATOL = 3e-5            # all flagged vs per-sample AA, demo scene
DEMO_ADAPTIVE_CHANGED = 0.002
PLAIN_LIST_MAX = 65536               # pixels of the plain trace at 1000 spheres
# Launches of the light-cell kernel on the main paths (phases 14 and 17).
MAIN_COUNTS = {"light_cells": 0}
# [cli-scene]: SHA-256 of the float32 bytes of center, radius and albedo, in
# that order, of the JAX package's random_scene(jax.random.key(0), n), which
# `cli render --spheres n` draws (tests/test_torch_prng.py holds these digests
# against the JAX package's scene).
CLI_SCENE_SHA256 = {
    100: "1702e56205bcc471d4332a20456057def6e95d15d760ba304ceac37d0ac21fa3",
    1000: "8ba9e446ccecf9b05be981ca8860c1bb1e2ed77ffa5ca5fc9081fa8ee13dd7b3",
}


def frame_diff(a, b):
    """(flipped pixels, changed pixels, max level diff) of two uint8 (3,w,h)."""
    d = (a.int() - b.int()).abs().amax(dim=0)
    return int((d > FLIP_LEVELS).sum()), int((d > 0).sum()), int(d.max())


def phase_time(label: str, t0: float) -> float:
    """Print the seconds since ``t0`` that ``label`` took; returns now."""
    now = time.perf_counter()
    print(f"[smoke] {label} in {now - t0:.1f} s")
    return now


def plain_ms(torch, fn, *args, **kwargs) -> float:
    """Milliseconds of one call of a plain version: the first call's where it
    takes a second or more (a warm-up call would double the phase for a
    number that moves less than its noise), else a second call's, the first
    its warm-up."""
    for _ in range(2):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn(*args, **kwargs)
        torch.cuda.synchronize()
        ms = 1e3 * (time.perf_counter() - t0)
        if ms >= 1e3:
            break
    return ms


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise AssertionError(msg)


def read_png(path: str):
    """Decode an 8-bit RGB PNG written by this package (filters 0 and 1)."""
    import numpy as np
    with open(path, "rb") as f:
        data = f.read()
    check(data[:8] == b"\x89PNG\r\n\x1a\n", f"{path}: not a PNG")
    pos, idat, w, h = 8, b"", 0, 0
    while pos < len(data):
        n, kind = struct.unpack(">I4s", data[pos:pos + 8])
        body = data[pos + 8:pos + 8 + n]
        if kind == b"IHDR":
            w, h, depth, ctype = struct.unpack(">IIBB", body[:10])
            check((depth, ctype) == (8, 2), f"{path}: not 8-bit RGB")
        elif kind == b"IDAT":
            idat += body
        pos += 12 + n
    raw = np.frombuffer(zlib.decompress(idat), np.uint8).reshape(h, 1 + 3 * w)
    filt = raw[:, 0]
    check(bool(np.isin(filt, (0, 1)).all()), f"{path}: unsupported filter")
    px = raw[:, 1:].reshape(h, w, 3).astype(np.int64)
    # Sub filter: each byte adds the reconstructed byte one pixel to the left.
    px = np.where((filt == 1)[:, None, None], np.cumsum(px, axis=1) % 256, px)
    return w, h, px.astype(np.uint8)


def seeded(torch, shape, dev, seed: int):
    """Uniform [0, 1) tensor from a seeded CPU generator, moved to ``dev``."""
    return torch.rand(shape, generator=torch.Generator().manual_seed(seed)).to(dev)


def host_and_device_ms(fn, iters=10):
    """(device ms, host ms) a call: CUDA events around `iters` calls back to
    back, and the host clock over the same calls before the synchronise (the
    time to enqueue them)."""
    import torch
    fn()
    torch.cuda.synchronize()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    host = 1e3 * (time.perf_counter() - t0) / iters
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters, host


def counts(scene):
    """(spheres, planes, lights) of a scene."""
    return scene.spheres.count, scene.planes.count, scene.lights.count


def backward_phases(torch, rt, card: str, dev) -> list:
    """Phases 7-9: the backward kernel (TPU kernel 4) against its plain version
    in every mode, the training path through its entry points, and step
    times. Returns the backward entries of the kernels line."""
    import contextlib
    import io
    from python_ray_tracer_tpu_torch import cli, train
    from python_ray_tracer_tpu_torch.ops.cuda import _build, render_cuda
    from python_ray_tracer_tpu_torch.ops.cuda import render_bwd_cuda as rb
    from python_ray_tracer_tpu_torch.utils import timing
    from python_ray_tracer_tpu_torch.utils.config import RenderConfig
    from concurrent.futures import ThreadPoolExecutor
    # [bwd-bounds]: the backward's sources built with other minimums of
    # resident blocks, compiled while phases 7-8 run.
    pool = ThreadPoolExecutor(len(BWD_MIN_BLOCKS))
    bound_builds = {mb: pool.submit(_build.build, BWD_BOUND_SOURCES,
                                    (f"-DRT_BWD_MIN_BLOCKS={mb}",)) for mb in BWD_MIN_BLOCKS}
    pool.shutdown(wait=False)

    def form_of(mode):
        """(kernel mode, aa_form) of a launch counter's key: ``fused_aa1`` is
        the one-launch fused AA step, ``fused_aa`` the two-launch one."""
        return ("fused_aa", "one") if mode == "fused_aa1" else (mode, "two")

    def kernel_flat(mode, cam, scene, x, compat):
        """The wrapper's flat gradient, camera slots included (and the loss
        slot in the fused modes); ``x`` is the target or the cotangent."""
        mode, form = form_of(mode)
        aa = mode.endswith("_aa")
        if mode.startswith("fused"):
            loss, sg, cg = rb.loss_and_scene_grads_cuda(
                cam, scene, x, depth=2, compat=compat, aliasing=aa, return_camera=True,
                aa_form=form)
            return rb.flatten_grads(sg, cg, loss)
        return rb.flatten_grads(*rb.scene_grads_cuda(
            cam, scene, x, depth=2, compat=compat, aliasing=aa, return_camera=True))

    def cotangent(cam, scene, target, aa, compat):
        """d mean((render - target)^2) / d render, through the render kernel."""
        img = rt.render_image_cuda(cam, scene, depth=2, aliasing=aa, compat=compat)
        return (2.0 * (img - target) / img.numel()).contiguous()

    def held(label, mode, cam, scene, x, compat):
        """The wrapper against the plain version under the JAX package's kernel
        rule, with rb.held_out's pixels (0.1%, where the two renders disagree
        most) taken out of both; print each leaf group's worst ratio to its
        allowance and return (max_abs_err, the worst ratio)."""
        mode, form = form_of(mode)
        flat, ref, ref_all, out = rb.kernel_and_plain(mode, cam, scene, x, depth=2,
                                                      compat=compat, aa_form=form)
        check(bool(torch.isfinite(flat).all()), f"{label}: non-finite gradient")
        rule = rb.grad_rule(flat, ref, *counts(scene), ref_all)
        print(f"[bwd] {label} ({int(out.sum())} pixels held out): "
              + " ".join(f"{k}={v:.2e}" for k, (v, _) in rule.items()))
        bad = [k for k, (_, ok) in rule.items() if not ok]
        check(not bad, f"{label}: {bad} outside the rule")
        return float((flat - ref).abs().max()), max(v for v, _ in rule.values())

    # Phase 7: every backward mode (the fused AA step in both forms) against
    # the plain version, demo scene at 256x256, depth 2, compat and clean
    # (Phong on); two runs bit-identical.
    cam = rt.default_camera(BWD_PARITY_RES, device=dev)
    target = seeded(torch, (*BWD_PARITY_RES, 3), dev, 0)
    for compat in (True, False):
        mats = rt.Materials.build(specular=0.0 if compat else 0.6, shininess=8.0,
                                  device=dev)
        scene = rt.default_scene(mats, device=dev)
        for mode in rb.COUNTED:
            x = (target if mode.startswith("fused") else
                 cotangent(cam, scene, target, mode.endswith("_aa"), compat))
            a = kernel_flat(mode, cam, scene, x, compat)
            b = kernel_flat(mode, cam, scene, x, compat)
            torch.cuda.synchronize()
            check(torch.equal(a, b), f"{mode} compat={compat}: two runs differ")
            check(bool(torch.isfinite(a).all()), f"{mode} compat={compat}: not finite")
            held(f"{mode:10s} compat={compat!s:5s} 256x256 d2, 2 runs bit-identical",
                 mode, cam, scene, x, compat)

    # Phase 8: the training path through its entry points at the fit CLI's
    # defaults. Every count is set to 0 just before a path and read just after.
    os.makedirs(OUT_DIR, exist_ok=True)
    main_launches = dict.fromkeys(rb.COUNTED, 0)

    def drive(label, fn, expect):
        rb.reset_launch_counts()
        render_cuda.reset_launch_counts()
        out = fn()
        torch.cuda.synchronize()
        got = dict(rb.LAUNCHES)
        print(f"[main] {label}: backward launches {got}, render launches "
              f"{dict(render_cuda.LAUNCHES)}, plain calls {dict(rb.PLAIN_CALLS)}")
        check(got == {m: expect.get(m, 0) for m in rb.COUNTED},
              f"{label}: backward launches {got}, expected {expect}")
        check(not any(rb.PLAIN_CALLS.values()), f"{label}: the plain version ran")
        for m in rb.COUNTED:
            main_launches[m] += got[m]
        return out

    def cli_fit(mode):
        png = os.path.join(OUT_DIR, f"fit_{mode}.png")
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            rc = cli.main(["fit", "--mode", mode, "--backend", "cuda", "--steps",
                           str(FIT_STEPS), "--out", png])
        print(buf.getvalue(), end="")
        check(rc == 0, f"cli fit --mode {mode} failed")
        check(read_png(png)[:2] == FIT_RES, f"{png}: not {FIT_RES}")
        text = buf.getvalue()
        step0 = float(text.split("[fit] step 0: loss=")[1].split()[0])
        return step0, next(ln for ln in text.splitlines() if ln.startswith("loss: ")).split()

    t0 = time.perf_counter()
    step0_cli, hard = drive(f"cli fit --mode hard --backend cuda --steps {FIT_STEPS}",
                            lambda: cli_fit("hard"), {"fused_noaa": FIT_STEPS})
    # "loss: A -> B  center err: E -> median M / max X": M is np.median, the JAX CLI's
    first, last, err_med, err_max = (float(hard[i]) for i in (1, 3, 9, 12))
    err0 = float(torch.tensor([0.2, -0.15, 0.1]).norm())
    check(last < LOSS_DROP * first, f"fit --mode hard: loss {first} -> {last}")
    check(err_max < err0, f"fit --mode hard: center error {err0} -> {err_max}")
    _, camera = drive(f"cli fit --mode camera --backend cuda --steps {FIT_STEPS}",
                      lambda: cli_fit("camera"), {"fused_noaa": FIT_STEPS})
    p0, p1 = float(camera[7]), float(camera[9])
    check(float(camera[3]) < float(camera[1]), f"fit --mode camera: loss {camera[1:4]}")
    check(p1 < p0, f"fit --mode camera: camera position error {p0} -> {p1}")
    print(f"[main] cli fit: hard loss {first:.4e} -> {last:.4e} ({last / first:.3f}x), "
          f"center error {err0:.4f} -> median {err_med:.4f} / max {err_max:.4f}; camera "
          f"position error {p0} -> {p1}; both runs {time.perf_counter() - t0:.1f} s")

    # The fit CLI's inputs (cmd_fit): the 2-sphere scene, centers shifted.
    cfg = RenderConfig()
    scene = cli.fit_scene_two_spheres(cfg, dev)
    init = rt.Scene.from_leaves(scene.leaves())
    init.spheres = rt.Spheres(
        scene.spheres.center + torch.tensor([0.2, -0.15, 0.1], device=dev),
        scene.spheres.radius, scene.spheres.albedo)
    fit_trainable = ("spheres.center",)

    def camera_at(res):
        return rt.Camera.build(res, cfg.camera_position, cfg.camera_euler, cfg.fov,
                               device=dev)

    cam = camera_at(FIT_RES)
    target = rt.render_image_cuda(cam, scene, depth=2, aliasing=False)
    target_aa = rt.render_image_cuda(cam, scene, depth=2, aliasing=True)
    _, aa_losses = drive("fit_scene(aliasing=True, backend='cuda') 3 steps",
                         lambda: train.fit_scene(init, cam, target_aa, steps=3, lr=1e-2,
                                                 depth=2, aliasing=True, backend="cuda",
                                                 trainable=fit_trainable),
                         {"fused_aa1": 3})
    check(aa_losses[-1] < aa_losses[0], f"AA fit losses {aa_losses}")

    def two_launch_steps(n=2):
        step = train.make_train_step(
            rt.Scene.from_leaves([t.clone() for t in init.leaves()]),
            train.cuda_value_and_grad(cam, target_aa, depth=2, aliasing=True, aa_form="two"),
            lr=1e-2, trainable=fit_trainable)
        return [float(step()) for _ in range(n)]
    two_losses = drive("make_train_step(cuda_value_and_grad(aliasing=True, aa_form='two')) "
                       "2 steps", two_launch_steps, {"fused_aa": 2})
    check(two_losses[0] == aa_losses[0], f"the two forms' first AA losses {two_losses[0]} "
                                         f"and {aa_losses[0]}")
    drive("fit_scene(fused=False, backend='cuda') 2 steps",
          lambda: train.fit_scene(init, cam, target, steps=2, lr=1e-2, depth=2,
                                  backend="cuda", fused=False, trainable=fit_trainable),
          {"cot_noaa": 2})

    def fast_aa_backward():
        leaves = [t.detach().clone().requires_grad_(True) for t in init.leaves()]
        img = render_cuda.render_image_fast(cam, rt.Scene.from_leaves(leaves), depth=2,
                                            aliasing=True)
        torch.mean((img - target_aa) ** 2).backward()
        return leaves[0].grad
    g = drive("render_image_fast(aliasing=True) backward", fast_aa_backward,
              {"cot_aa": 1})
    check(bool(torch.isfinite(g).all()) and bool(g.abs().max() > 0),
          "render_image_fast: no sphere-center gradient")
    print(f"[main] backward launches over the training paths: {main_launches}")
    check(all(main_launches[m] > 0 for m in rb.COUNTED), f"launches {main_launches}")

    # Each mode at the main path's shapes against the plain version; step 0
    # of the hard fit must match its plain version at full size.
    errs = {"fused_noaa": held("fused_noaa step 0 of cli fit --mode hard, 1000x1000 d2",
                               "fused_noaa", cam, init, target, True)}
    check(abs(float(kernel_flat("fused_noaa", cam, init, target, True)[-1]) - step0_cli)
          <= 1e-5 * step0_cli, "cli fit's step-0 loss differs from the kernel's")
    g_noaa = cotangent(cam, init, target, False, True)
    errs["cot_noaa"] = held("cot_noaa 1000x1000 d2", "cot_noaa", cam, init, g_noaa, True)
    # The plain AA step keeps 9 samples x 3 traces of autograd tensors: reckon
    # its memory at full size from its peak at 256x256 before running it.
    small = camera_at(BWD_PARITY_RES)
    t_small = rt.render_image_cuda(small, scene, depth=2, aliasing=True)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    rb.loss_and_scene_grads_plain(small, init, t_small, depth=2, aliasing=True)
    peak = torch.cuda.max_memory_allocated() - base
    full = peak * (FIT_RES[0] * FIT_RES[1]) / (BWD_PARITY_RES[0] * BWD_PARITY_RES[1])
    aa_res = FIT_RES if full < PLAIN_MEM_BUDGET else BWD_PARITY_RES
    print(f"[mem] plain AA step: peak {peak / 1e9:.3f} GB at 256x256, reckoned "
          f"{full / 1e9:.2f} GB at 1000x1000; the plain AA step runs at {aa_res}")
    cam_aa = camera_at(aa_res)
    t_aa = rt.render_image_cuda(cam_aa, scene, depth=2, aliasing=True)
    errs["fused_aa"] = held(f"fused_aa (two launches) {aa_res[0]}x{aa_res[1]} d2", "fused_aa",
                            cam_aa, init, t_aa, True)
    errs["fused_aa1"] = held(f"fused_aa1 (one launch) {aa_res[0]}x{aa_res[1]} d2", "fused_aa1",
                             cam_aa, init, t_aa, True)
    g_aa = cotangent(cam_aa, init, t_aa, True, True)
    errs["cot_aa"] = held(f"cot_aa {aa_res[0]}x{aa_res[1]} d2", "cot_aa", cam_aa, init,
                          g_aa, True)

    # Phase 9: times with CUDA events at 1000x1000, depth 2.
    W, H = FIT_RES
    lib = _build.load_library()
    stream = torch.cuda.current_stream().cuda_stream
    params = render_cuda.pack_params(cam, init, True).to(dev)
    tables = render_cuda.scene_tables(init)
    cnt = counts(init)
    cheap = render_cuda.shadow_cheap_ok(init, True)

    def pack():
        return (render_cuda.pack_params(cam, init, True).to(dev),
                render_cuda.scene_tables(init), render_cuda.shadow_cheap_ok(init, True))

    p = torch.zeros((2, 3), device=dev, requires_grad=True)
    p.grad = torch.ones_like(p)
    adam = torch.optim.Adam([p], lr=1e-2)

    def adam_step():
        adam.step()
        return p

    pack_ms = 1e3 * rt.time_fn(pack, warmup=2, iters=20)
    adam_ms = 1e3 * rt.time_fn(adam_step, warmup=2, iters=50)
    # (input at 1000x1000, input at the plain version's size) of each mode
    inputs = {"fused_noaa": (target, target), "fused_aa": (target_aa, t_aa),
              "fused_aa1": (target_aa, t_aa), "cot_noaa": (g_noaa, g_noaa),
              "cot_aa": (cotangent(cam, init, target_aa, True, True), g_aa)}

    def sweep_and_bounds(mode, aa, fused, t, shape, kernel_only):
        """[bwd-plan] and [bwd-bounds] of one mode."""
        n_sm = torch.cuda.get_device_properties(dev).multi_processor_count
        sweep = {}
        for nt in (128, 64, 32):
            for per_sm in (1, 2, 4, 8, 16):
                q = rb.plan(*cnt, W, H, aa=aa, fused=fused, large=False, n_sm=n_sm,
                            blocks_per_sm=per_sm)
                q = rb.Plan(nt, True, q.blocks, q.tiles, rb.smem_bytes(*cnt, fused, aa, nt, True))
                if (nt, q.blocks) not in sweep:
                    sweep[(nt, q.blocks)] = 1e3 * rt.time_fn(kernel_only, q, warmup=1, iters=10)
        best = min(sweep, key=sweep.get)
        # The package's kernel against builds with a minimum of resident
        # blocks, in turns (package, builds, builds reversed, package), each at
        # the planner's grid and at its minimum's blocks a multiprocessor.
        libs = {mb: _build.declare(ctypes.CDLL(f.result())) for mb, f in bound_builds.items()}
        ref = kernel_only().clone()
        order = [None, *BWD_MIN_BLOCKS, *reversed(BWD_MIN_BLOCKS), None]
        bt = {}
        for mb in order:
            for per_sm in sorted({rb.BLOCKS_PER_SM, mb or rb.BLOCKS_PER_SM}):
                q = rb.plan(*cnt, W, H, aa=aa, fused=fused, large=False, n_sm=n_sm,
                            blocks_per_sm=per_sm)
                ms = 1e3 * rt.time_fn(kernel_only, q, libs.get(mb), warmup=1, iters=10)
                bt.setdefault((mb or 0, q.blocks), []).append(ms)
            got = kernel_only(lib=libs.get(mb)).clone()
            check(bool(torch.isfinite(got).all()), f"{mode} min blocks {mb}: not finite")
            check(float((got - ref).abs().max()) <= 1e-3 * float(ref.abs().max()),
                  f"{mode} min blocks {mb}: gradient off the package's")
        print(f"[bwd-bounds] {mode} {W}x{H} d2 kernel alone ms by (minimum blocks, grid), "
              f"in turns: " + ", ".join(f"{k} " + "/".join(f"{v:.4f}" for v in vs)
                                         for k, vs in bt.items()) + f" | {card}")
        print(f"[bwd-plan] {mode} {W}x{H} d2 kernel alone ms by (threads, blocks): "
              + ", ".join(f"{k} {v:.4f}" for k, v in sweep.items())
              + f"; the planner's ({shape.nt}, {shape.blocks}) ({shape.tiles} tiles a block, "
              f"{shape.smem} B) {t['kernel']:.4f}, the best {best} {sweep[best]:.4f} | {card}")

    times = {}
    regs = bwd_regs_start(_build.CSRC_DIR)
    for key in rb.COUNTED:
        mode, form = form_of(key)
        one = form == "one"
        aa, fused = mode.endswith("_aa"), mode.startswith("fused")
        x, x_plain = inputs[key]
        cam_plain = cam_aa if aa else cam
        n = rb.n_grads(*cnt, fused)
        out = torch.empty(n, device=dev)
        shape = rb.launch_plan(cam, init, mode, one_launch=one)
        img = torch.empty((W, H, 3), device=dev)

        def kernel_only(shape=shape, lib=None):
            partial = partials(shape.blocks)
            two = mode == "fused_aa" and not one
            if two:
                render_cuda.launch(img, params, tables, cnt, depth=2, mode="aa_shared",
                                   compat=True, cheap_shadow=cheap)
            return rb.launch(out, partial, params, tables, cnt,
                             image=img if two else (None if fused else x),
                             target=x if fused else None, W=W, H=H, depth=2, mode=mode,
                             compat=True, cheap_shadow=cheap, shape=shape, lib=lib,
                             one_launch=one, rec=recs(shape) if one else None)

        bufs = {}

        def partials(rows):
            if rows not in bufs:
                bufs[rows] = torch.empty(n * rows, device=dev)
            return bufs[rows]

        def recs(shape):
            if ("rec", shape.blocks) not in bufs:
                bufs[("rec", shape.blocks)] = torch.empty(rb.rec_floats(shape, 2), device=dev)
            return bufs[("rec", shape.blocks)]

        def reduce_only():
            check(lib.rt_reduce_rows(partials(shape.blocks).data_ptr(), shape.blocks, n,
                                     out.data_ptr(), stream) == 0, "reduction launch failed")
            return out

        t = {"kernel": 1e3 * rt.time_fn(kernel_only, warmup=2, iters=20),
             "reduce": 1e3 * rt.time_fn(reduce_only, warmup=2, iters=50), "plan": shape}
        # The plan sweep (the two-launch modes): threads a block and blocks a
        # multiprocessor around the planner's choice, kernel alone (the fused
        # AA step's render included).
        if not one:
            sweep_and_bounds(mode, aa, fused, t, shape, kernel_only)
        if fused:   # the whole fit_scene step: pack, kernel(s), reduction, Adam
            sc = rt.Scene.from_leaves([s.clone() for s in init.leaves()])
            step = train.make_train_step(
                sc, train.cuda_value_and_grad(cam, x, depth=2, aliasing=aa, aa_form=form),
                lr=1e-2, trainable=fit_trainable)
            t["step"] = 1e3 * rt.time_fn(step, warmup=2, iters=10)
        if one:     # the same plain step as the two-launch form's
            t["plain"] = times["fused_aa"]["plain"]
        elif fused:
            sp = rt.Scene.from_leaves([s.clone() for s in init.leaves()])
            pstep = train.make_train_step(
                sp, train.autograd_value_and_grad(
                    train.pixel_loss(cam_plain, x_plain, depth=2, aliasing=aa)),
                lr=1e-2, trainable=fit_trainable)
            t["plain"] = plain_ms(torch, pstep) if aa else \
                1e3 * rt.time_fn(pstep, warmup=1, iters=3)
        else:       # the wrapper alone, and the plain VJP
            t["step"] = 1e3 * rt.time_fn(rb.scene_grads_cuda, cam, init, x, depth=2,
                                         aliasing=aa, warmup=2, iters=10)
            plain_kw = dict(depth=2, aliasing=aa)
            t["plain"] = plain_ms(torch, rb.scene_grads_plain, cam_plain, init, x_plain,
                                  **plain_kw) if aa else \
                1e3 * rt.time_fn(rb.scene_grads_plain, cam_plain, init, x_plain, **plain_kw,
                                 warmup=1, iters=3)
        t["plain_res"] = cam_plain.resolution
        times[key] = t
        print(f"[time] {key} 1000x1000 d2: {'fit_scene step' if fused else 'wrapper'} "
              f"{t['step']:.4f} ms, kernel alone {t['kernel']:.4f} ms (reduction alone "
              f"{t['reduce']:.4f} ms), pack {pack_ms:.4f} ms, Adam {adam_ms:.4f} ms, "
              f"plain {t['plain']:.4f} ms at {t['plain_res'][0]}x{t['plain_res'][1]} "
              f"| {card}")
    # The fit step's two AA forms in turns: a step's host part varies by
    # ~0.5 ms from run to run, more than the kernels differ.
    steps = {f: train.make_train_step(
        rt.Scene.from_leaves([s.clone() for s in init.leaves()]),
        train.cuda_value_and_grad(cam, target_aa, depth=2, aliasing=True, aa_form=f),
        lr=1e-2, trainable=fit_trainable) for f in ("two", "one")}
    ab = _alternate(rt, steps, 10)
    print(f"[time] fit_scene AA step {W}x{H} d2, two launches / one in turns (A, B, B, A "
          f"minima): {ab['two']:.4f} / {ab['one']:.4f} ms | {card}")
    bwd_regs_print(regs, "this tree")
    for mb in BWD_MIN_BLOCKS:
        bwd_regs_print({"render_bwd_small.cu": ptxas_report(
            _build.CSRC_DIR, "render_bwd_small.cu", _build.BUILD_DIR,
            (f"-DRT_BWD_MIN_BLOCKS={mb}",))}, f"min blocks {mb}")

    def entry(name, modes, t):
        e = [errs[m] for m in modes]
        x = inputs[modes[0]][0]
        mode = form_of(modes[0])[0]
        g = None if mode.startswith("fused") else x
        live = timing.hard_chain_counts(
            cam, init, timing.bwd_positions(W, H, mode.endswith("_aa"), g), depth=2)
        bound, bound_by = timing.bound_ms(*timing.hard_bwd_work(W, H, *cnt, mode, live))
        ops, nbytes = timing.hard_work(W, H, *cnt, mode)
        if mode == "fused_aa":      # the fused AA step runs the aa_shared render first
            ops += timing.hard_work(W, H, *cnt, "aa_shared")[0]
        low = timing.bound_ms(ops, nbytes)[0]
        print(f"[bound] {name} {W}x{H} d2: {bound:.4f} ms ({bound_by}; timing.hard_bwd_work: "
              f"the chains' traces, live hits and adjoints, rays / sphere hits / plane hits "
              f"by level {live.int().tolist()}), the old lower bound (timing.hard_work: the "
              f"primary sweep and the slot sums) {low:.4f} ms, vs kernel alone "
              f"{t['kernel']:.4f} ms ({t['kernel'] / bound:.1f}x) | {card}")
        return {"name": name, "route": "cuda", "source": BWD_SOURCE,
                "replaces": BWD_REPLACES, "launches": sum(main_launches[m] for m in modes),
                "max_abs_err": max(a for a, _ in e), "max_rel_err": max(r for _, r in e),
                "ms": t["step"], "plain_ms": t["plain"], "kernel_only_ms": t["kernel"],
                "reduce_ms": t["reduce"], "bound_ms": bound, "bound_by": bound_by,
                "lower_bound_ms": low, "library_ms": None,
                "shape": f"{W}x{H}_d2", "plain_shape": "x".join(map(str, t["plain_res"]))}
    return [entry("render_bwd_fused_noaa", ("fused_noaa",), times["fused_noaa"]),
            entry("render_bwd_fused_aa", ("fused_aa",), times["fused_aa"]),
            entry("render_bwd_fused_aa1", ("fused_aa1",), times["fused_aa1"]),
            entry("render_bwd_cotangent", ("cot_noaa", "cot_aa"), times["cot_noaa"])]


# The backward kernel's sources, whose ptxas rows [bwd-regs] prints.
BWD_REG_SOURCES = ("render_bwd.cu", "render_bwd_small.cu", "render_bwd_global.cu",
                   "render_bwd_one.cu", "render_bwd_one_small.cu", "render_bwd_one_global.cu",
                   "soft_fwd.cu")
# [bwd-bounds]: the backward built with this minimum of resident blocks a
# multiprocessor (render_bwd_kernel.cuh RT_BWD_MIN_BLOCKS) beside the package's
# (5 and 6 were both slower in every mode, PERF.md; one build keeps the run short).
BWD_MIN_BLOCKS = (5,)
BWD_BOUND_SOURCES = ("render_bwd.cu", "render_bwd_small.cu", "render_bwd_global.cu",
                     "render_bwd_one.cu", "render_bwd_one_small.cu",
                     "render_bwd_one_global.cu")


def bwd_regs_start(csrc: str) -> dict:
    """Start ``nvcc -Xptxas -v`` on a checkout's backward and soft forward
    sources; :func:`bwd_regs_print` prints their rows."""
    from python_ray_tracer_tpu_torch.ops.cuda import _build
    return {src: ptxas_report(csrc, src, _build.BUILD_DIR) for src in BWD_REG_SOURCES
            if os.path.isfile(os.path.join(csrc, src))}


def bwd_regs_print(procs: dict, label: str) -> None:
    """``[bwd-regs]``: registers, spill stores and loads, and stack frame of
    every kernel instantiation in :func:`bwd_regs_start`'s sources."""
    for src, proc in procs.items():
        for name, nregs, st, ld, stack in ptxas_lines(proc):
            print(f"[bwd-regs] {label} {src} {name}: {nregs} registers, spill stores {st} B, "
                  f"loads {ld} B, stack {stack} B")


def soft_phases(torch, rt, card: str, dev) -> list:
    """Phases 10-12: the soft forward and backward kernels (TPU kernels 5-6)
    against their plain versions, the soft fit and render through their entry
    points at full width, each kernel held against its plain version at the
    shapes that path gives it, and times. Returns the soft entries of the
    kernels line, whose errors are those of the full-width checks."""
    import contextlib
    import io
    import numpy as np
    from python_ray_tracer_tpu_torch import cli, train
    from python_ray_tracer_tpu_torch.ops.cuda import _build, render_cuda
    from python_ray_tracer_tpu_torch.ops.cuda import render_bwd_cuda as rb
    from python_ray_tracer_tpu_torch.ops.cuda import soft_bwd_cuda as sb
    from python_ray_tracer_tpu_torch.ops.cuda import soft_cuda
    from python_ray_tracer_tpu_torch.ops.soft import row_chunk_for
    from python_ray_tracer_tpu_torch.utils import timing
    from python_ray_tracer_tpu_torch.utils.image import framebuffer_to_array

    def soft_scene(name):
        """The fit CLI's demo scene (RenderConfig materials), or 100 seeded
        random spheres."""
        if name == "demo":
            return rt.default_scene(device=dev)
        return rt.random_scene(100, generator=torch.Generator().manual_seed(0), device=dev)

    def kernel_flat(mode, cam, scene, x, tau):
        if mode == "fused":
            loss, sg, cg = sb.soft_loss_and_grads_cuda(cam, scene, x, tau=tau,
                                                       return_camera=True)
            return rb.flatten_grads(sg, cg, loss)
        return rb.flatten_grads(*sb.soft_scene_grads_cuda(cam, scene, x, tau=tau,
                                                          return_camera=True))

    def plain_flat(mode, cam, scene, x, tau, chunk):
        fn = sb.soft_loss_and_grads_plain if mode == "fused" else sb.soft_scene_grads_plain
        return fn(cam, scene, x, tau=tau, row_chunk=chunk)

    def held_image(label, img, cam, scene, tau):
        """The kernel's image against the plain version in float32 and float64
        under soft_cuda.image_rule; prints the numbers and the element farthest
        from the plain float32 version, and returns ((max_abs_err, worst ratio
        to the allowance), the plain float32 image)."""
        res = cam.resolution
        plain = rt.render_image_soft(cam, scene, tau=tau,
                                     row_chunk=row_chunk_for(res, scene, SOFT_BLOCK_BYTES))
        plain64 = rt.render_image_soft(*soft_cuda.as_double(cam, scene), tau=tau,
                                       row_chunk=row_chunk_for(res, scene,
                                                               SOFT_BLOCK_BYTES // 2))
        r = soft_cuda.image_rule(img, plain, plain64)
        print(f"[soft-fwd] {label} tau={tau}: max|k-plain| {r['max_abs_err']:.3e}, "
              f"max|k-plain64| {r['max_abs_err_f64']:.3e}, max|plain-plain64| "
              f"{r['plain_err_f64']:.3e}, ratio {r['ratio']:.3f}, flipped {r['flipped']}"
              f"/{res[0] * res[1]}; farthest from plain32 {r['worst']}, from plain64 "
              f"{r['worst64']}")
        check(r["ok"], f"soft_fwd {label} tau={tau}: {r}")
        return (r["max_abs_err"], r["ratio"]), plain

    def held(label, mode, cam, scene, x, tau, flat=None, chunk=None):
        """The kernel's flat gradient against the plain version in float32 and
        float64 under soft_bwd_cuda.soft_grad_rule; prints each leaf group's
        worst ratio to its allowance and returns (max_abs_err, the worst
        ratio). ``chunk``: the plain float32 run's block (half in float64)."""
        chunk = row_chunk_for(cam.resolution, scene, SOFT_BLOCK_BYTES) if chunk is None \
            else chunk
        flat = kernel_flat(mode, cam, scene, x, tau) if flat is None else flat
        check(bool(torch.isfinite(flat).all()), f"{label}: non-finite gradient")
        ref = plain_flat(mode, cam, scene, x, tau, chunk)
        cam64, scene64 = soft_cuda.as_double(cam, scene)
        ref64 = plain_flat(mode, cam64, scene64, x.double(), tau,
                           None if chunk is None else max(1, chunk // 2))
        rule = sb.soft_grad_rule(flat, ref, *counts(scene), ref64=ref64)
        plain_rule = sb.soft_grad_rule(ref, ref64, *counts(scene))
        print(f"[soft-bwd] {label}: " + " ".join(f"{k}={v:.3f}" for k, (v, _) in rule.items())
              + f" | plain f32 vs f64 worst {max(v for v, _ in plain_rule.values()):.3f}")
        groups = rb.grad_groups(flat.cpu(), *counts(scene))
        check(all(float(groups[k].abs().max()) == 0.0 for k in
                  ("materials.reflection", "materials.specular", "materials.shininess")),
              f"{label}: refl/spec/shin slots are not 0")
        bad = [k for k, (_, ok) in rule.items() if not ok]
        check(not bad, f"{label}: {bad} outside the rule")
        return float((flat - ref).abs().max()), max(v for v, _ in rule.values())

    # Phase 10: each soft kernel mode against the plain version, every tau of
    # the anneal, two runs bit-identical.
    for name, res in SOFT_PARITY:
        scene = soft_scene(name)
        cam = rt.default_camera(res, device=dev)
        target = seeded(torch, (*res, 3), dev, 1)
        for tau in SOFT_TAUS:
            img = rt.render_image_soft_cuda(cam, scene, tau=tau)
            again = rt.render_image_soft_cuda(cam, scene, tau=tau)
            torch.cuda.synchronize()
            check(torch.equal(img, again), f"soft_fwd {name} tau={tau}: two runs differ")
            _, plain = held_image(f"{name} {res[0]}x{res[1]}, 2 runs bit-identical", img,
                                  cam, scene, tau)
            cot = (2.0 * (plain - target) / plain.numel()).contiguous()
            for mode, x in (("cot", cot), ("fused", target)):
                a = kernel_flat(mode, cam, scene, x, tau)
                b = kernel_flat(mode, cam, scene, x, tau)
                torch.cuda.synchronize()
                check(torch.equal(a, b), f"soft {mode} {name} tau={tau}: two runs differ")
                held(f"{mode:5s} {name} {res[0]}x{res[1]} tau={tau}, 2 runs bit-identical",
                     mode, cam, scene, x, tau, a)

    # Phase 11: the soft path through its entry points at full width. Every
    # count is set to 0 just before a path and read just after.
    os.makedirs(OUT_DIR, exist_ok=True)
    main_launches = {"soft_fwd": 0, "cot": 0, "fused": 0}

    def drive(label, fn, expect):
        sb.reset_launch_counts()
        soft_cuda.reset_launch_counts()
        out = fn()
        torch.cuda.synchronize()
        got = {"soft_fwd": soft_cuda.LAUNCHES["soft_fwd"], **sb.LAUNCHES}
        plain = {**soft_cuda.PLAIN_CALLS, **sb.PLAIN_CALLS}
        print(f"[soft-main] {label}: launches {got}, plain calls {plain}")
        check(got == {k: expect.get(k, 0) for k in got}, f"{label}: launches {got}, "
              f"expected {expect}")
        check(not any(plain.values()), f"{label}: the plain version ran")
        for k in main_launches:
            main_launches[k] += got[k]
        return out

    def cli_fit():
        png = os.path.join(OUT_DIR, "fit_soft.png")
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            rc = cli.main(["fit", "--mode", "soft", "--backend", "cuda", "--out", png])
        print(buf.getvalue(), end="")
        check(rc == 0, "cli fit --mode soft failed")
        check(read_png(png)[:2] == FIT_RES, f"{png}: not {FIT_RES}")
        return buf.getvalue()

    t0 = time.perf_counter()
    text = drive("cli fit --mode soft --backend cuda (1000x1000, 150 steps, taus "
                 "0.15/0.05/0.02)", cli_fit, {"soft_fwd": len(SOFT_TAUS),
                                              "fused": SOFT_FIT_STEPS})
    fit_s = time.perf_counter() - t0
    # the logger's line per stage: "[fit] step N: tau=.. first_loss=.. loss=.."
    stages = [(float(ln.split("first_loss=")[1].split()[0]),
               float(ln.split(" loss=")[1].split()[0]))
              for ln in text.splitlines() if ln.startswith("[fit] step") and "tau=" in ln]
    check(len(stages) == len(SOFT_TAUS), f"soft fit: stage lines {stages}")
    line = next(ln for ln in text.splitlines() if ln.startswith("loss: "))
    median = float(line.split("median ")[1].split()[0])   # np.median, the JAX CLI's
    shift = float(torch.tensor(cli.FIT_SHIFT).norm())
    print(f"[soft-main] cli fit --mode soft: stage losses (first, last) {stages}; median "
          f"center error {shift:.4f} -> {median}; {fit_s:.1f} s with the PNG")
    check(all(b < a for a, b in stages), f"soft fit: a stage's loss did not fall {stages}")
    check(median < shift, f"soft fit: median center error {median}")

    # The fit's targets (one soft_fwd launch a stage; tau 0.05 is also `render
    # --soft 0.05`'s frame) against the plain version at full size.
    cfg_scene = soft_scene("demo")
    cam = rt.default_camera(FIT_RES, device=dev)
    errs = {"soft_fwd": [held_image("cli fit's target 1000x1000", rt.render_image_soft_cuda(
        cam, cfg_scene, tau=tau), cam, cfg_scene, tau)[0] for tau in SOFT_TAUS]}

    # Step 0 of that fit against its plain version at full size: its memory
    # reckoned from the plain step's peak at 128x128 in 8 blocks.
    init = rt.Scene.from_leaves(cfg_scene.leaves())
    init.spheres = rt.Spheres(cfg_scene.spheres.center + torch.tensor(cli.FIT_SHIFT,
                                                                      device=dev),
                              cfg_scene.spheres.radius, cfg_scene.spheres.albedo)
    small = rt.default_camera((128, 128), device=dev)
    t_small = rt.render_image_soft_cuda(small, cfg_scene, tau=SOFT_TAUS[0])
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    sb.soft_loss_and_grads_plain(small, init, t_small, tau=SOFT_TAUS[0], row_chunk=16)
    per_col = (torch.cuda.max_memory_allocated() - base) / 16 * FIT_RES[1] / 128
    full_chunk = max(1, int(SOFT_PLAIN_BUDGET / (2 * per_col)))
    print(f"[soft-mem] plain soft step: {per_col / 1e6:.1f} MB a column at 1000 rows "
          f"(reckoned from 128x128); blocks of {full_chunk} columns at 1000x1000, "
          f"float64 included, stay under {SOFT_PLAIN_BUDGET / 1e9:.0f} GB")
    target = rt.render_image_soft_cuda(cam, cfg_scene, tau=SOFT_TAUS[0])
    step0 = kernel_flat("fused", cam, init, target, SOFT_TAUS[0])
    check(abs(float(step0[-1]) - stages[0][0]) <= 1e-5 * stages[0][0],
          f"cli fit's step-0 loss {stages[0][0]} differs from the kernel's {float(step0[-1])}")
    errs["fused"] = [held("fused step 0 of cli fit --mode soft, 1000x1000 tau=0.15", "fused",
                          cam, init, target, SOFT_TAUS[0], step0, full_chunk)]

    png = os.path.join(OUT_DIR, "render_soft.png")
    drive("cli render --soft 0.05 --backend cuda (1000x1000)",
          lambda: check(cli.main(["render", "--soft", "0.05", "--backend", "cuda",
                                  "--out", png]) == 0, "cli render --soft failed"),
          {"soft_fwd": 7})
    w, h, px = read_png(png)
    check((w, h) == FIT_RES, f"{png}: {w}x{h}")
    frame = framebuffer_to_array(rt.to_framebuffer(rt.render_image_soft_cuda(
        cam, soft_scene("demo"), tau=0.05)))
    check(np.array_equal(px, frame), f"{png}: pixels differ from the kernel's frame")
    print(f"[soft-main] {os.path.relpath(png, ROOT)} {w}x{h} decodes to the kernel's frame")

    def fast_backward():
        """The MSE's scene and camera gradient through render_image_soft_fast,
        and the image cotangent its backward received."""
        leaves = [t.detach().clone().requires_grad_(True)
                  for t in init.leaves() + [cam.position, cam.rotation, cam.fov]]
        img = rt.render_image_soft_fast(rt.Camera(*leaves[12:], cam.resolution),
                                        rt.Scene.from_leaves(leaves[:12]), tau=0.05)
        seen = []
        img.register_hook(seen.append)
        torch.mean((img - target) ** 2).backward()
        grads = [t.grad if t.grad is not None else torch.zeros_like(t) for t in leaves]
        return rb.flatten_grads(rt.Scene.from_leaves(grads[:12]),
                                rt.Camera(*grads[12:], cam.resolution)), seen[0]
    g, cot = drive("render_image_soft_fast backward (1000x1000)", fast_backward,
                   {"soft_fwd": 1, "cot": 1})
    check(bool(g[:3].abs().max() > 0), "render_image_soft_fast: no sphere-center gradient")
    errs["cot"] = [held("cot   render_image_soft_fast's backward, 1000x1000 tau=0.05", "cot",
                        cam, init, cot.contiguous(), 0.05, g, full_chunk)]

    # The mirror bounce has no kernel in either package: counted plain calls.
    sb.reset_launch_counts()
    soft_cuda.reset_launch_counts()
    _, bl = train.fit_scene_soft(init, rt.default_camera((64, 64), device=dev), cfg_scene,
                                 steps=3, backend="cuda", bounce_depth=1)
    torch.cuda.synchronize()
    print(f"[soft-main] fit_scene_soft(bounce_depth=1, backend='cuda') 64x64, 3 steps: "
          f"plain calls {dict(soft_cuda.PLAIN_CALLS)} (3 targets + 3 steps through the "
          f"plain version, as stated: no kernel covers the bounce), kernel launches "
          f"{dict(soft_cuda.LAUNCHES)} {dict(sb.LAUNCHES)}, losses {bl}")
    check(soft_cuda.PLAIN_CALLS["render_image_soft"] == 6 and
          not any(sb.LAUNCHES.values()) and soft_cuda.LAUNCHES["soft_fwd"] == 0,
          "bounce fit: unexpected kernel launches or plain-call counts")
    print(f"[soft-main] soft launches over the main paths: {main_launches}")
    check(all(v > 0 for v in main_launches.values()), f"launches {main_launches}")

    # Phase 12: times with CUDA events; bounds from utils/timing (the work the
    # function needs for these inputs). Both shapes start from the fit's shifted
    # centers against the unshifted scene's render, so the cotangent is not 0.
    lib = _build.load_library()
    stream = torch.cuda.current_stream().cuda_stream
    regs, local = ctypes.c_int(), ctypes.c_int()
    check(lib.rt_soft_bwd_attrs(ctypes.byref(regs), ctypes.byref(local)) == 0,
          "cudaFuncGetAttributes of the soft backward kernel failed")
    print(f"[soft-time] soft backward kernel: {regs.value} registers, {local.value} B of "
          f"local memory a thread (stack frame and spills) | {card}")
    times = {}
    for name, res in SOFT_TIMES:
        scene = soft_scene(name)
        sc = rt.Scene.from_leaves(scene.leaves())
        sc.spheres = rt.Spheres(scene.spheres.center + torch.tensor(cli.FIT_SHIFT, device=dev),
                                scene.spheres.radius, scene.spheres.albedo)
        W, H = res
        camr = rt.default_camera(res, device=dev)
        cnt = counts(sc)
        params = render_cuda.pack_params(camr, sc, compat=False).to(dev)
        tables = render_cuda.scene_tables(sc)
        img = torch.empty((W, H, 3), device=dev)
        reps = 10 if name == "demo" else 3
        t = {}
        for tau in SOFT_TAUS:
            tgt = rt.render_image_soft_cuda(camr, scene, tau=tau)
            cot = (2.0 * (rt.render_image_soft_cuda(camr, sc, tau=tau) - tgt) /
                   tgt.numel()).contiguous()
            live = timing.soft_live_counts(camr, sc, tau)
            fms = 1e3 * rt.time_fn(soft_cuda.launch, img, params, tables, cnt, tau=tau,
                                   warmup=2, iters=2 * reps)
            fb = timing.bound_ms(*timing.soft_work(camr, sc, tau, "fwd", live))
            print(f"[soft-time] {name} {W}x{H} tau={tau} soft_fwd kernel alone {fms:.4f} ms "
                  f"(chunk of {lib.rt_soft_fwd_cap(*cnt, 1)} live objects); bound {fb[0]:.4f} ms "
                  f"({fb[1]}), {fms / fb[0]:.1f}x | {card}")
            for mode, x in (("fused", tgt), ("cot", cot)):
                shape = sb.plan(*cnt, mode == "fused")
                out = torch.empty(rb.n_grads(*cnt, mode == "fused"), device=dev)
                partial = torch.empty(out.numel() * sb.n_blocks(W, H, shape), device=dev)
                ms = 1e3 * rt.time_fn(sb.launch, out, partial, params, tables, cnt, image=x,
                                      W=W, H=H, tau=tau, mode=mode, shape=shape, warmup=1,
                                      iters=reps)
                bound = timing.bound_ms(*timing.soft_work(camr, sc, tau, mode, live))
                t[(mode, tau)] = (ms, bound, shape)
                print(f"[soft-time] {name} {W}x{H} tau={tau} {mode:5s} soft backward kernel "
                      f"alone {ms:.4f} ms (plan nt={shape.nt} cap={shape.cap} cj={shape.cj} "
                      f"store_vis={int(shape.store_vis)}, {shape.smem} B); bound "
                      f"{bound[0]:.4f} ms ({bound[1]}), {ms / bound[0]:.1f}x | {card}")
            if tau == 0.05:
                tgt05, cot05, live05 = tgt, cot, live
        tgt, cot, live = tgt05, cot05, live05
        # The planner's plan beside others, fused at tau 0.05.
        out = torch.empty(rb.n_grads(*cnt, True), device=dev)
        chosen = sb.plan(*cnt, True)
        plans = [chosen] + [
            sb.Plan(nt, c, j, True, sb.smem_bytes(*cnt, True, nt, c, j, True))
            for nt in (128, 64, 32) for c, j in
            ((min(c, cnt[0] + cnt[1]), min(j, max(cnt[0], 1))) for c, j in SOFT_PLAN_SWEEP)]
        sweep = {}
        for p in plans:
            key = (p.nt, p.cap, p.cj, int(p.store_vis))
            if key in sweep or p.smem > sb.SMEM_LIMIT:
                continue
            partial = torch.empty(out.numel() * sb.n_blocks(W, H, p), device=dev)
            sweep[key] = 1e3 * rt.time_fn(sb.launch, out, partial, params, tables, cnt,
                                          image=tgt, W=W, H=H, tau=0.05, mode="fused",
                                          shape=p, warmup=1, iters=reps)
        key, best = next(iter(sweep)), min(sweep, key=sweep.get)
        print(f"[soft-plan] {name} {W}x{H} tau=0.05 fused, ms by (nt, cap, cj, store_vis): "
              + ", ".join(f"{k} {v:.4f}" for k, v in sweep.items())
              + f"; the planner's {key} {sweep[key]:.4f}, the best {best} "
              f"{sweep[best]:.4f} | {card}")
        shape = sb.plan(*cnt, True)
        n = rb.n_grads(*cnt, True)
        out = torch.empty(n, device=dev)
        rows_n = sb.n_blocks(W, H, shape)
        partial = torch.empty(n * rows_n, device=dev)
        sb.launch(out, partial, params, tables, cnt, image=tgt, W=W, H=H, tau=0.05,
                  mode="fused", shape=shape)

        def reduce_only():
            check(lib.rt_reduce_rows(partial.data_ptr(), rows_n, n, out.data_ptr(),
                                     stream) == 0, "reduction launch failed")
            return out
        t.update({
            "fused_kernel": t[("fused", 0.05)][0], "cot_kernel": t[("cot", 0.05)][0],
            "fwd_kernel": rt.time_fn(soft_cuda.launch, img, params, tables, cnt, tau=0.05,
                                     warmup=2, iters=2 * reps),
            "fwd_wrapper": rt.time_fn(rt.render_image_soft_cuda, camr, sc, tau=0.05,
                                      warmup=2, iters=2 * reps),
            "reduce": rt.time_fn(reduce_only, warmup=2, iters=50),
            "cot_wrapper": rt.time_fn(sb.soft_scene_grads_cuda, camr, sc, cot, tau=0.05,
                                      warmup=1, iters=reps),
        })
        sc_step = rt.Scene.from_leaves([s.clone() for s in sc.leaves()])
        step = train.make_train_step(sc_step, train.soft_value_and_grad(
            camr, tgt, tau=0.05, backend="cuda"), lr=1e-2, trainable=("spheres.center",))
        t["step"] = rt.time_fn(step, warmup=1, iters=reps)
        pchunk = row_chunk_for(res, sc, SOFT_BLOCK_BYTES)   # the plain version, same size
        t["plain_fwd"] = plain_ms(torch, rt.render_image_soft, camr, sc, tau=0.05,
                                  row_chunk=pchunk)
        t["plain_step"] = plain_ms(torch, sb.soft_loss_and_grads_plain, camr, sc, tgt,
                                   tau=0.05, row_chunk=pchunk)
        t["plain_cot"] = plain_ms(torch, sb.soft_scene_grads_plain, camr, sc, cot, tau=0.05,
                                  row_chunk=pchunk)
        for k in ("fwd_kernel", "fwd_wrapper", "reduce", "cot_wrapper", "step"):
            t[k] *= 1e3
        for kind in ("fwd", "fused", "cot"):
            t[f"{kind}_bound"] = timing.bound_ms(*timing.soft_work(camr, sc, 0.05, kind, live))
        times[name] = t
        print(f"[soft-time] {name} {W}x{H} tau=0.05: soft_fwd kernel alone "
              f"{t['fwd_kernel']:.4f} ms (bound {t['fwd_bound'][0]:.4f} ms, "
              f"{t['fwd_bound'][1]}), wrapper {t['fwd_wrapper']:.4f} ms; fused soft "
              f"backward kernel alone {t['fused_kernel']:.4f} ms (bound "
              f"{t['fused_bound'][0]:.4f} ms; reduction alone {t['reduce']:.4f} ms), "
              f"fit_scene_soft step {t['step']:.4f} ms; cotangent kernel alone "
              f"{t['cot_kernel']:.4f} ms (bound {t['cot_bound'][0]:.4f} ms), wrapper "
              f"{t['cot_wrapper']:.4f} ms; plain forward {t['plain_fwd']:.4f} ms, plain "
              f"fused step {t['plain_step']:.4f} ms, plain VJP {t['plain_cot']:.4f} ms at "
              f"{W}x{H} | {card}")
        print(f"[soft-bound] {name} {W}x{H} tau=0.05, live terms a pixel: "
              + " ".join(f"{k}={v / live['px']:.4f}" for k, v in live.items() if k != "px"))

    t = times["demo"]

    def entry(name, source, replaces, kind, launches, err, err_at, ms, kernel_ms, plain_ms):
        return {"name": name, "route": "cuda", "source": source, "replaces": replaces,
                "launches": launches, "max_abs_err": max(a for a, _ in err),
                "max_rel_err": max(r for _, r in err), "err_at": err_at, "ms": ms,
                "kernel_only_ms": kernel_ms, "plain_ms": plain_ms,
                "bound_ms": t[f"{kind}_bound"][0], "bound_by": t[f"{kind}_bound"][1],
                "library_ms": None, "shape": "1000x1000_demo_tau0.05",
                "plain_shape": "1000x1000"}
    return [
        entry("soft_fwd", SOFT_FWD_SOURCE, SOFT_FWD_REPLACES, "fwd",
              main_launches["soft_fwd"], errs["soft_fwd"],
              "1000x1000 demo, the fit's targets at tau 0.15/0.05/0.02", t["fwd_wrapper"],
              t["fwd_kernel"], t["plain_fwd"]),
        entry("soft_bwd_fused", SOFT_BWD_SOURCE, SOFT_BWD_REPLACES, "fused",
              main_launches["fused"], errs["fused"],
              "1000x1000 demo, step 0 of cli fit --mode soft (tau 0.15)", t["step"],
              t["fused_kernel"], t["plain_step"]),
        entry("soft_bwd_cotangent", SOFT_BWD_SOURCE, SOFT_BWD_REPLACES, "cot",
              main_launches["cot"], errs["cot"],
              "1000x1000 demo, render_image_soft_fast's backward (tau 0.05)",
              t["cot_wrapper"], t["cot_kernel"], t["plain_cot"]),
    ]


def large_scene_phases(torch, rt, card: str, dev) -> list:
    """Phases 13-15: the hit-extent kernel (TPU kernel 3) against its plain
    version, every cull of the render kernel against the full sweep bit for
    bit, ``cli render --spheres 100|1000`` at 1920x1080 through the large-scene
    path, and times. Returns the large-scene entries of the kernels line."""
    import numpy as np
    from python_ray_tracer_tpu_torch import cli
    from python_ray_tracer_tpu_torch.ops.cuda import cull_tables as ct
    from python_ray_tracer_tpu_torch.ops.cuda import hit_extents_cuda as hx
    from python_ray_tracer_tpu_torch.ops.cuda import light_cells_cuda as lc
    from python_ray_tracer_tpu_torch.ops.cuda import render_cuda
    from python_ray_tracer_tpu_torch.ops.cuda import shadow_lists_cuda as sl
    from python_ray_tracer_tpu_torch.utils import timing
    from python_ray_tracer_tpu_torch.utils.config import RenderConfig
    from python_ray_tracer_tpu_torch.utils.image import framebuffer_to_array

    cfg = RenderConfig()
    hx_builds = start_extent_builds()

    def cli_scene(n, specular=0.0):
        """`cli render --spheres n`'s scene, with a Phong term for the
        clean-mode checks."""
        return scene_of(rt, cfg, n, dev, specular)

    def cli_camera(res, pose=None):
        pos, euler = pose or (cfg.camera_position, cfg.camera_euler)
        return rt.Camera.build(res, pos, euler, cfg.fov, device=dev)

    def plain(cam, scene, aa, compat=True):
        """The plain renderer in column blocks that bound its memory."""
        ns, npl, nl = counts(scene)
        cols = max(1, PLAIN_BLOCK_ELEMS // (cam.resolution[1] * max(nl, 1) * (ns + npl)))
        return rt.render_image(cam, scene, depth=2, aliasing=aa, compat=compat,
                               row_chunk=cols)

    def flips(label, img, ref, res):
        f, changed, dmax = frame_diff(rt.to_framebuffer(img), rt.to_framebuffer(ref))
        print(f"[large] {label}: flipped {f}/{res[0] * res[1]}, changed {changed}, max {dmax}")
        check(f <= FLIP_FRAC * res[0] * res[1], f"{label}: {f} flipped pixels")
        return float((img - ref).abs().max())

    def extents_held(label, cam, scene, aa, compat, vis):
        """Kernel 3 twice (bit-identical rows and scales) against its plain
        version; its scale against the plain scale of its own rows."""
        scales = [torch.full((1,), float("nan"), device=dev) for _ in range(2)]
        a, b = (hx.hit_extents_cuda(cam, scene, aliasing=aa, compat=compat, vis=vis,
                                    scale=sc) for sc in scales)
        torch.cuda.synchronize()
        check(torch.equal(a, b) and torch.equal(*scales),
              f"hit_extents {label}: two runs differ")
        plain_scale = ct.extent_scale(a).reshape(1)
        check(torch.equal(scales[0], plain_scale),
              f"hit_extents {label}: scale {scales[0].item()} vs {plain_scale.item()}")
        rule = hx.extent_rule(a, hx.hit_extents_plain(cam, scene, aliasing=aa,
                                                      compat=compat, vis=vis))
        print(f"[extent] {label}, 2 runs bit-identical: counts equal "
              f"{rule['counts_equal']}, sentinel rows equal {rule['sentinels_equal']}, "
              f"max_abs_err {rule['max_abs_err']:.3e}, ratio {rule['ratio']:.3f}, "
              f"tiles with hits {int((a[:, 6] > 0).sum())}/{a.shape[0]}, scale "
              f"{scales[0].item():.6g} equal to the plain scale of the rows")
        check(rule["ok"], f"hit_extents {label}: {rule}")
        return rule

    def lists_held(label, cam, scene, aa, compat, vis):
        """The list kernel twice (bit-identical rows) against the plain
        function on the same hit-extent rows, at the list capacity and at K =
        4; returns the largest count of differing integers (0)."""
        scale = torch.empty(1, device=dev)
        ext = hx.hit_extents_cuda(cam, scene, aliasing=aa, compat=compat, vis=vis,
                                  scale=scale)
        L, C, R = scene.lights.position, scene.spheres.center, scene.spheres.radius
        parts = []
        for K in LIST_KS:
            K = vis[2] if K is None else K
            a, b = (sl.shadow_lists_cuda(ext, scale, L, C, R, K=K, compat=compat)
                    for _ in range(2))
            want = ct.shadow_visibility_lists(ext, L, C, R, K=K, compat=compat)
            torch.cuda.synchronize()
            check(torch.equal(a[0], b[0]) and torch.equal(a[1], b[1]),
                  f"shadow lists {label} K={K}: two runs differ")
            d_cnt, d_idx = int((a[1] != want[1]).sum()), int((a[0] != want[0]).sum())
            check(d_cnt == 0 and d_idx == 0, f"shadow lists {label} K={K}: {d_cnt} counts "
                  f"and {d_idx} slots differ from the plain function")
            c = a[1]
            parts.append(f"K={K}: equal, rows {c.numel()}, sky {int((c == 0).sum())}, -1 "
                         f"{int((c < 0).sum())}, mean kept {float(c[c > 0].float().mean()):.2f}"
                         if bool((c > 0).any()) else f"K={K}: equal, rows {c.numel()}")
        print(f"[lists] {label}, 2 runs bit-identical, integer for integer the plain "
              f"function's: " + "; ".join(parts))
        return 0.0

    def vis_of(cam, scene, compat):
        k = ct.list_capacity(scene.spheres.count)
        return (*ct.tile_visibility(cam, scene, compat=compat, K=k), k)

    # Phase 13: parity at 256x256, compat and clean, 100 and 1000 spheres.
    res = LARGE_PARITY_RES
    cam = cli_camera(res)
    for n in LARGE_SPHERES:
        for compat in (True, False):
            scene = cli_scene(n, 0.0 if compat else 0.5)
            vis = vis_of(cam, scene, compat)
            for aa in (False, True):
                for v, vname in ((None, "no lists"), (vis, "cone-cull lists")):
                    extents_held(f"{n} spheres {res[0]}x{res[1]} aa={aa} compat={compat} "
                                 f"{vname}", cam, scene, aa, compat, v)
            refs = {aa: plain(cam, scene, aa, compat) for aa in (False, True)}
            for mode in render_cuda.MODES:
                aa = mode != "aa_none"
                kw = dict(depth=2, compat=compat, aliasing=aa, aa_share=mode == "aa_shared")
                off = rt.render_image_cuda(cam, scene, **kw, **ALL_OFF)
                verdicts = []
                for name, culls in CULLS.items():
                    img = rt.render_image_cuda(cam, scene, **kw, **culls)
                    torch.cuda.synchronize()
                    same = torch.equal(img, off)
                    verdicts.append(f"{name} {'bit-identical' if same else 'DIFFERS'}")
                    if not same:
                        px = torch.nonzero((img != off).any(dim=-1))
                        for x, y in px[:8].tolist():
                            print(f"[parity] {n} spheres {mode} compat={compat} {name}: pixel "
                                  f"({x}, {y}) culled {img[x, y].tolist()} "
                                  f"({[hex(v) for v in img[x, y].view(torch.int32).tolist()]}) "
                                  f"full sweep {off[x, y].tolist()} "
                                  f"({[hex(v) for v in off[x, y].view(torch.int32).tolist()]})")
                        check(False, f"{n} spheres {mode} compat={compat} {name}: "
                              f"{px.shape[0]} pixels differ from the full sweep")
                print(f"[parity] {n} spheres {mode:13s} compat={compat!s:5s} {res[0]}x{res[1]} d2 vs "
                      f"all culls off: " + ", ".join(verdicts))
                flips(f"{n} spheres {mode} compat={compat} all culls on vs plain",
                      rt.render_image_cuda(cam, scene, **kw, **CULLS["all"]), refs[aa], res)

    # [lists]: the list kernel at the main path's shape, from the CLI's camera
    # and, at 100 spheres, from one with the horizon in view (sky tiles).
    W, H = LARGE_RES
    for n, pose in [(n, None) for n in LARGE_SPHERES] + [(100, BENCH_POSE)]:
        cam = cli_camera(LARGE_RES, pose)
        where = "" if pose is None else f" camera {pose[0]}"
        for compat in (True, False):
            scene = cli_scene(n, 0.0 if compat else 0.5)
            vis = vis_of(cam, scene, compat)
            for aa in (False, True):
                lists_held(f"{n} spheres {W}x{H}{where} aa={aa} compat={compat}", cam, scene,
                           aa, compat, vis)

    # Phase 14: the main path through the CLI at 1920x1080, counts set to 0
    # just before each run and read just after.
    os.makedirs(OUT_DIR, exist_ok=True)
    W, H = LARGE_RES
    cam = cli_camera(LARGE_RES)
    main = {}
    for n in LARGE_SPHERES:
        scene = cli_scene(n)
        for aa in (False, True):
            mode = "aa_shared" if aa else "aa_none"
            label = f"{n}_spheres_{W}x{H}_{'aa' if aa else 'noaa'}"
            png = os.path.join(OUT_DIR, f"{label}.png")
            args = ["render", "--backend", "cuda", "--spheres", str(n), "--width", str(W),
                    "--height", str(H), "--out", png] + ([] if aa else ["--no-aliasing"])
            render_cuda.reset_launch_counts()
            hx.reset_launch_counts()
            lc.reset_launch_counts()
            sl.reset_launch_counts()
            check(cli.main(args) == 0, f"cli {' '.join(args)} failed")
            torch.cuda.synchronize()
            got = {"hit_extents": hx.LAUNCHES["hit_extents"], **lc.LAUNCHES, **sl.LAUNCHES,
                   **render_cuda.LAUNCHES}
            print(f"[large-main] cli {' '.join(args[:-2])}: launches {got}")
            MAIN_COUNTS["light_cells"] += got["light_cells"]
            check(got["hit_extents"] == LARGE_FRAMES and got[mode] == LARGE_FRAMES and
                  got["light_cells"] == LARGE_FRAMES and got["shadow_lists"] == LARGE_FRAMES and
                  sum(render_cuda.LAUNCHES.values()) == LARGE_FRAMES,
                  f"{label}: launches {got}, expected {LARGE_FRAMES} hit_extents, "
                  f"light_cells, shadow_lists and {mode}")
            w, h, px = read_png(png)
            check((w, h) == LARGE_RES, f"{png}: {w}x{h}")
            img = rt.render_image_cuda(cam, scene, depth=2, aliasing=aa)
            check(img.shape == (W, H, 3) and bool(torch.isfinite(img).all()),
                  f"{label}: frame {tuple(img.shape)} not finite")
            check(np.array_equal(px, framebuffer_to_array(rt.to_framebuffer(img))),
                  f"{png}: pixels differ from the kernel's frame")
            check(torch.equal(img, rt.render_image_cuda(cam, scene, depth=2, aliasing=aa,
                                                        **ALL_OFF)),
                  f"{label}: the culled frame differs from the full sweep")
            t0 = time.perf_counter()
            ref = plain(cam, scene, aa)
            torch.cuda.synchronize()
            plain_ms = 1e3 * (time.perf_counter() - t0)
            err = flips(f"{label} vs plain (PNG decodes to the kernel's frame, which is "
                        f"bit-identical to the full sweep)", img, ref, LARGE_RES)
            del ref
            rule = extents_held(f"{label} (the main path's launch)", cam, scene, aa, True,
                                vis_of(cam, scene, True))
            main[(n, aa)] = dict(launches=got, err=err, plain_ms=plain_ms, rule=rule,
                                 label=label, mode=mode)

    # Phase 15: times with CUDA events.
    def times(label, cam, scene, aa, plain_ms=None):
        mode = "aa_shared" if aa else "aa_none"
        ns, npl, nl = cnt = counts(scene)
        k = ct.list_capacity(ns)
        W, H = cam.resolution
        params = render_cuda.pack_params(cam, scene, True).to(dev)
        tabs = render_cuda.scene_tables(scene)
        cheap = render_cuda.shadow_cheap_ok(scene, True)
        vis, shadow, tree, cells = render_cuda.large_scene_tables(cam, scene, depth=2,
                                                                  aliasing=aa, compat=True)
        ext = torch.empty((vis[1].numel(), 8), device=dev)
        scale = torch.empty(1, device=dev)
        out = torch.empty((W, H, 3), device=dev)
        reps = 20 if ns <= 100 else 5
        # kernel 3 as the render path launches it (with the scale), then the
        # list kernel on its rows
        t = {"k3": 1e3 * rt.time_fn(hx.launch, ext, params, tabs, cnt, W=W, H=H, aliasing=aa,
                                    compat=True, n_levels=1, vis=vis, scale=scale, warmup=2,
                                    iters=50)}
        L, C, R = scene.lights.position, scene.spheres.center, scene.spheres.radius
        order = ct.light_order(L, C, R).to(torch.int32)
        sl_out = (torch.empty_like(shadow[0]), torch.empty_like(shadow[1]))
        t["sl"] = 1e3 * rt.time_fn(sl.launch, *sl_out, ext, scale, L, C, R, order, k=k,
                                   compat=True, warmup=2, iters=50)
        t["sl_wrapper"] = host_and_device_ms(lambda: sl.shadow_lists_cuda(
            ext, scale, L, C, R, K=k, compat=True))
        t["vis"] = host_and_device_ms(lambda: ct.tile_visibility(cam, scene, compat=True, K=k))
        t["lists"] = host_and_device_ms(lambda: ct.shadow_visibility_lists(
            ext, L, C, R, K=k, compat=True))
        want = ct.shadow_visibility_lists(ext, L, C, R, K=k, compat=True)
        check(torch.equal(sl_out[0], want[0]) and torch.equal(sl_out[1], want[1]),
              f"{label}: the timed list kernel's rows differ from the plain function's")
        t["tree"] = host_and_device_ms(lambda: ct.bounce_tree(scene.spheres.center,
                                                              scene.spheres.radius))
        for name, tb in (("on", (vis, shadow, tree, cells)), ("off", (None,) * 4)):
            t[name] = 1e3 * rt.time_fn(render_cuda.launch, out, params, tabs, cnt, depth=2,
                                       mode=mode, compat=True, cheap_shadow=cheap, vis=tb[0],
                                       shadow=tb[1], tree=tb[2], cells=tb[3], warmup=2,
                                       iters=reps)
        # the live counts of every trace level, for the bounds: one launch with
        # the render's tables at n_levels = depth + 1
        ext3 = hx.hit_extents_cuda(cam, scene, aliasing=aa, n_levels=3, vis=vis,
                                   tree=ct.bounce_tree(scene.spheres.center,
                                                       scene.spheres.radius))
        live = ext3[:, 6].reshape(-1, 3).sum(dim=0).tolist()
        t["wrapper"] = 1e3 * rt.time_fn(rt.render_image_cuda, cam, scene, depth=2,
                                        aliasing=aa, warmup=2, iters=reps)
        t["wrapper_off"] = 1e3 * rt.time_fn(rt.render_image_cuda, cam, scene, depth=2,
                                            aliasing=aa, **ALL_OFF, warmup=2, iters=reps)
        t["k3_bound"] = timing.bound_ms(*timing.hit_extents_work(W, H, ns, npl, aa, vis,
                                                                 ext, scale=True))
        t["sl_bound"] = timing.bound_ms(*timing.shadow_lists_work(ext, L, C, R, K=k,
                                                                  compat=True))
        t["on_bound"] = timing.bound_ms(*timing.large_scene_work(W, H, ns, npl, nl, mode, vis,
                                                                 shadow, ext3))
        t["off_bound"] = timing.bound_ms(*timing.large_scene_work(W, H, ns, npl, nl, mode,
                                                                  None, None, ext3))

        def rows(tab):
            c = tab[1].float()
            return (float(c[c >= 0].mean()) if bool((c >= 0).any()) else 0.0,
                    float((c < 0).float().mean()))
        (vm, vo), (sm, so) = rows(vis), rows(shadow)
        plain_txt = "" if plain_ms is None else f", plain {plain_ms:.4f} ms"
        print(f"[large-time] {label}: hit_extents kernel alone {t['k3']:.4f} ms; list kernel "
              f"alone {t['sl']:.4f} ms, its wrapper shadow_lists_cuda {t['sl_wrapper'][0]:.4f} / "
              f"{t['sl_wrapper'][1]:.4f} (device ms / host ms a call), bound "
              f"{t['sl_bound'][0]:.4f} ms ({t['sl_bound'][1]}); table functions "
              f"(device ms / host ms a call) tile_visibility {t['vis'][0]:.4f} / "
              f"{t['vis'][1]:.4f}, shadow_visibility_lists (plain) {t['lists'][0]:.4f} / "
              f"{t['lists'][1]:.4f}, bounce_tree {t['tree'][0]:.4f} / "
              f"{t['tree'][1]:.4f} ({'used' if tree else 'not used at this size'}); "
              f"render kernel alone all culls on {t['on']:.4f} ms, all off {t['off']:.4f} ms "
              f"({t['on'] / t['off']:.3f}x); whole wrapper {t['wrapper']:.4f} ms, with culls "
              f"off {t['wrapper_off']:.4f} ms{plain_txt} | {card}")
        print(f"[large-lists] {label}: K={k}; primary rows mean {vm:.2f} spheres, -1 rows "
              f"{vo:.4f}; shadow rows mean {sm:.2f} spheres, -1 rows {so:.4f}; bounce tree "
              f"{f'{tree.n_leaves} leaves of {ct.LEAF}, fan {ct.FAN}' if tree else 'off'}; "
              f"light cells {'on' if cells is not None else 'off'};"
              f" live samples at levels 0-2 (hit_extents, n_levels 3) {live}")
        print(f"[bound] hit_extents {label}: {t['k3_bound'][0]:.4f} ms ({t['k3_bound'][1]}) vs "
              f"kernel alone {t['k3']:.4f} ms; shadow_lists {t['sl_bound'][0]:.4f} ms "
              f"({t['sl_bound'][1]}) vs kernel alone {t['sl']:.4f} ms; render all culls on "
              f"{t['on_bound'][0]:.4f} ms "
              f"({t['on_bound'][1]}, a lower bound: the listed primary and level-0 shadow "
              f"sweeps and the bounce levels' floor) vs {t['on']:.4f} ms; all off "
              f"{t['off_bound'][0]:.4f} ms vs {t['off']:.4f} ms | {card}")
        return t

    timed = {}
    for n in LARGE_SPHERES:
        scene = cli_scene(n)
        for aa in (False, True):
            m = main[(n, aa)]
            timed[(n, aa)] = times(m["label"], cam, scene, aa, m["plain_ms"])
    extent_sweep(torch, rt, card, dev, hx_builds, cam,
                 {n: cli_scene(n) for n in LARGE_SPHERES})
    bench_cam = cli_camera(LARGE_RES, BENCH_POSE)
    for aa in (False, True):
        label = f"100_spheres_{W}x{H}_{'aa' if aa else 'noaa'}_camera_-12_0_4"
        scene = cli_scene(100)
        img = rt.render_image_cuda(bench_cam, scene, depth=2, aliasing=aa)
        check(torch.equal(img, rt.render_image_cuda(bench_cam, scene, depth=2, aliasing=aa,
                                                    **ALL_OFF)),
              f"{label}: the culled frame differs from the full sweep")
        times(label, bench_cam, scene, aa)

    # Where each cull starts to pay end to end on this card: the whole wrapper
    # (table functions, kernel 3, render kernel) with the automatic choice,
    # with each cull alone and with all off, over the sphere count.
    for n in CROSSOVER_SPHERES:
        scene = cli_scene(n)
        for aa in (False, True):
            ms = {name: 1e3 * rt.time_fn(rt.render_image_cuda, cam, scene, depth=2,
                                         aliasing=aa, **culls, warmup=2, iters=5)
                  for name, culls in (("auto", {}), *CULLS.items(), ("off", ALL_OFF))}
            print(f"[large-crossover] {n} spheres {W}x{H} {'aa' if aa else 'noaa'}, whole "
                  f"wrapper ms: " + ", ".join(f"{k} {v:.4f}" for k, v in ms.items())
                  + f" | {card}")

    n = LARGE_SPHERES[-1]

    def render_entry(aa):
        m, t = main[(n, aa)], timed[(n, aa)]
        return {"name": f"render_fwd_{m['mode']}_large", "route": "cuda",
                "source": "python_ray_tracer_tpu_torch/csrc/render_fwd.cu",
                "replaces": REPLACES[m["mode"]], "launches": m["launches"][m["mode"]],
                "max_abs_err": m["err"], "ms": t["wrapper"], "plain_ms": m["plain_ms"],
                "kernel_only_ms": t["on"], "culls_off_kernel_ms": t["off"],
                "bound_ms": t["on_bound"][0], "bound_by": t["on_bound"][1],
                "library_ms": None, "shape": m["label"]}
    m, t = main[(n, True)], timed[(n, True)]
    # the kernel's own wrapper, as large_scene_tables calls it
    scene = cli_scene(n)
    vis = vis_of(cam, scene, True)
    hx_ms = 1e3 * rt.time_fn(hx.hit_extents_cuda, cam, scene, aliasing=True, vis=vis,
                             scale=torch.empty(1, device=dev), warmup=2, iters=20)
    hx_plain_ms = 1e3 * rt.time_fn(hx.hit_extents_plain, cam, scene, aliasing=True, vis=vis,
                                   warmup=1, iters=1)
    print(f"[large-time] hit_extents wrapper {hx_ms:.4f} ms, plain version "
          f"{hx_plain_ms:.4f} ms at {m['label']} | {card}")
    launches = sum(v["launches"]["hit_extents"] for v in main.values())
    sl_launches = sum(v["launches"]["shadow_lists"] for v in main.values())
    print(f"[large-main] launches over the large-scene main paths: hit_extents {launches}, "
          f"shadow_lists {sl_launches}, "
          f"render {[(v['label'], v['launches'][v['mode']]) for v in main.values()]}")
    check(sl_launches > 0, "the large-scene main paths launched no list kernel")
    return [
        {"name": "hit_extents", "route": "cuda", "source": HX_SOURCE, "replaces": HX_REPLACES,
         "launches": launches, "max_abs_err": m["rule"]["max_abs_err"],
         "max_rel_err": m["rule"]["ratio"], "ms": hx_ms, "kernel_only_ms": t["k3"],
         "plain_ms": hx_plain_ms, "bound_ms": t["k3_bound"][0], "bound_by": t["k3_bound"][1],
         "library_ms": None, "shape": m["label"]},
        {"name": "shadow_lists", "route": "cuda", "source": SL_SOURCE, "replaces": None,
         "launches": sl_launches, "max_abs_err": 0.0, "ms": t["sl_wrapper"][0],
         "kernel_only_ms": t["sl"], "plain_ms": t["lists"][0], "bound_ms": t["sl_bound"][0],
         "bound_by": t["sl_bound"][1], "library_ms": None, "shape": m["label"],
         "part_of": "render_fwd_aa_none_large and render_fwd_aa_shared_large: the level-0 "
                    "shadow rays' tables"},
        render_entry(False), render_entry(True)]


def start_extent_builds() -> dict:
    """Start the compiles of [extent-sweep]'s hit-extent kernels (HX_SHAPES
    other than the package's own), each hit_extents.cu alone, together.
    Returns futures by shape, the package's shape mapped to None."""
    from concurrent.futures import ThreadPoolExecutor
    from python_ray_tracer_tpu_torch.ops.cuda import _build
    others = HX_SHAPES[1:]
    pool = ThreadPoolExecutor(len(others))
    futs = {s: pool.submit(_build.build, ("hit_extents.cu",),
                           (f"-DRT_HX_TILE_WARPS={s[0]}", f"-DRT_HX_AA_TILE_WARPS={s[1]}"))
            for s in others}
    pool.shutdown(wait=False)
    return {HX_SHAPES[0]: None, **futs}


def extent_sweep(torch, rt, card: str, dev, builds: dict, cam, scenes: dict) -> None:
    """``[extent-sweep]``: the hit-extent kernel of every group size in
    HX_SHAPES (the first is the package's) alone at the main path's shapes
    (1920x1080, level 0, the cone-cull lists, with the scale), rows and scale
    ``torch.equal`` to the package's, times with CUDA events over 50 launches,
    each shape timed twice in turns (forward, then backward order) and the
    lesser kept."""
    from python_ray_tracer_tpu_torch.ops.cuda import _build
    from python_ray_tracer_tpu_torch.ops.cuda import cull_tables as ct
    from python_ray_tracer_tpu_torch.ops.cuda import hit_extents_cuda as hx
    from python_ray_tracer_tpu_torch.ops.cuda import render_cuda
    t0 = time.perf_counter()
    libs = {s: None if f is None else _build.declare(ctypes.CDLL(f.result()))
            for s, f in builds.items()}
    print(f"[extent-sweep] {len(libs) - 1} other group sizes built, waited "
          f"{time.perf_counter() - t0:.1f} s")
    W, H = cam.resolution
    for n, scene in scenes.items():
        k = ct.list_capacity(scene.spheres.count)
        vis = (*ct.tile_visibility(cam, scene, compat=True, K=k), k)
        packed = (render_cuda.pack_params(cam, scene, True).to(dev),
                  render_cuda.scene_tables(scene), counts(scene))
        for aa in (False, True):
            runs = {}
            for s, lib in libs.items():
                out = torch.empty((vis[1].numel(), 8), device=dev)
                scale = torch.empty(1, device=dev)
                hx.launch(out, *packed, W=W, H=H, aliasing=aa, compat=True, n_levels=1,
                          vis=vis, scale=scale, lib=lib)
                runs[s] = (out, scale)
            torch.cuda.synchronize()
            ref = runs[HX_SHAPES[0]]
            for s, (out, scale) in runs.items():
                check(torch.equal(out, ref[0]) and torch.equal(scale, ref[1]),
                      f"[extent-sweep] {s[aa]} warps a tile: rows differ from the package's")
            ms = {s: [] for s in libs}
            for s in list(libs) + list(libs)[::-1]:
                out, scale = runs[s]
                ms[s].append(1e3 * rt.time_fn(hx.launch, out, *packed, W=W, H=H, aliasing=aa,
                                              compat=True, n_levels=1, vis=vis, scale=scale,
                                              lib=libs[s], warmup=2, iters=50))
            print(f"[extent-sweep] {n}_spheres {W}x{H} {'aa' if aa else 'noaa'}, kernel alone "
                  f"(rows equal): " + "; ".join(
                      f"{s[aa]} warps a tile{' (the package)' if s == HX_SHAPES[0] else ''} "
                      f"{min(v):.4f} ms" for s, v in ms.items()) + f" | {card}")


def adaptive_phases(torch, rt, card: str, dev) -> list:
    """Phases 16-18: the worklist kernel (TPU kernel 7) against its plain
    version and the all-flagged identity, ``cli render --adaptive-aa`` at
    1920x1080 on the demo scene and 100 and 1000 spheres, and times. Returns
    the kernels line's entry for the worklist kernel."""
    import contextlib
    import io
    import numpy as np
    from python_ray_tracer_tpu_torch import cli
    from python_ray_tracer_tpu_torch.ops import adaptive as adp
    from python_ray_tracer_tpu_torch.ops.cuda import adaptive_cuda as ac
    from python_ray_tracer_tpu_torch.ops.cuda import hit_extents_cuda as hx
    from python_ray_tracer_tpu_torch.ops.cuda import light_cells_cuda as lc
    from python_ray_tracer_tpu_torch.ops.cuda import render_cuda
    from python_ray_tracer_tpu_torch.ops.cuda import shadow_lists_cuda as sl
    from python_ray_tracer_tpu_torch.utils import timing
    from python_ray_tracer_tpu_torch.utils.config import RenderConfig
    from python_ray_tracer_tpu_torch.utils.image import framebuffer_to_array

    cfg = RenderConfig()

    def scene_and_camera(n, res, compat=True):
        """The CLI's scene (`--spheres n`, or the demo scene for 0) and camera,
        with a Phong term in clean mode."""
        scene = scene_of(rt, cfg, n, dev, 0.0 if compat else 0.5)
        return scene, rt.Camera.build(res, cfg.camera_position, cfg.camera_euler, cfg.fov,
                                      device=dev)

    def name(n):
        return "demo" if n == 0 else f"{n}_spheres"

    def worklist(cam, scene, compat, eps, budget):
        """``(packed, tables, tent, idx, flagged, dropped)``, the tables as
        launch_list's keywords."""
        packed, (vis, shadow, tree, cells), *rest = ac.worklist_inputs(
            cam, scene, depth=2, compat=compat, eps=eps, budget_frac=budget)
        return (packed, dict(vis=vis, shadow=shadow, tree=tree, cells=cells), *rest)

    def plain_trace(cam, scene, idx, n, tent, compat):
        """The plain trace of the first n listed pixels, in blocks that bound
        its largest intermediate (a shadow sweep: pixels x lights x objects)."""
        ns, npl, nl = counts(scene)
        chunk = max(1, PLAIN_BLOCK_ELEMS // (max(nl, 1) * (ns + npl)))
        return adp.trace_worklist_plain(cam, scene, idx, n, tent, depth=2, compat=compat,
                                        chunk=chunk)

    def held(label, out, ref, idx, n):
        """The kernel's frame against the plain trace's at the first n listed
        pixels under the flip rule; returns max |d| there and the flipped
        count over its allowance (<= 1 passes)."""
        sel = idx[:n].long()
        d = (rt.to_framebuffer(out).int() - rt.to_framebuffer(ref).int()).abs().amax(0)
        flips = int((d.reshape(-1)[sel] > FLIP_LEVELS).sum())
        err = float((out.reshape(-1, 3)[sel] - ref.reshape(-1, 3)[sel]).abs().max()) \
            if n else 0.0
        print(f"[adaptive] {label}: kernel vs plain trace at {n} listed pixels: flipped "
              f"{flips}, max_abs_err {err:.3e}")
        check(flips <= FLIP_FRAC * n, f"{label}: {flips} flipped of {n} listed pixels")
        rules.append(flips / (FLIP_FRAC * n) if n else 0.0)
        return err

    # Phase 16: parity at 256x256, compat and clean.
    res, rules = ADAPTIVE_PARITY_RES, []
    for n in ADAPTIVE_SCENES:
        for compat in (True, False):
            scene, cam = scene_and_camera(n, res, compat)
            label = f"{name(n)} {res[0]}x{res[1]} compat={compat}"
            packed, tabs, tent, idx, flagged, dropped = worklist(cam, scene, compat,
                                                                 ADAPTIVE_PARITY_EPS, 1.0)
            cheap = render_cuda.shadow_cheap_ok(scene, compat)
            a = ac.launch_list(tent.clone(), *packed, idx, flagged, depth=2, compat=compat,
                               cheap_shadow=cheap, **tabs)
            b = ac.launch_list(tent.clone(), *packed, idx, flagged, depth=2, compat=compat,
                               cheap_shadow=cheap, **tabs)
            off = ac.launch_list(tent.clone(), *packed, idx, flagged, depth=2, compat=compat,
                                 cheap_shadow=cheap)
            torch.cuda.synchronize()
            check(torch.equal(a, b), f"render_list {label}: two runs differ")
            check(torch.equal(a, off), f"render_list {label}: with tables "
                  f"{[k for k, v in tabs.items() if v is not None]} differs from every table "
                  f"off at {int((a != off).any(-1).sum())} pixels")
            n_listed = int(flagged)
            check(int(dropped) == 0 and n_listed > 0, f"{label}: stats {n_listed} {dropped}")
            sub = min(n_listed, PLAIN_LIST_MAX)
            held(f"{label} eps=0.5/255, 2 runs bit-identical", a,
                 plain_trace(cam, scene, idx, sub, tent, compat), idx, sub)
            out, st = rt.render_image_adaptive_cuda(cam, scene, compat=compat, eps=-1.0,
                                                    budget_frac=1.0, with_stats=True)
            ref = rt.render_image_cuda(cam, scene, compat=compat, aliasing=True,
                                       aa_share=False)
            check(int(st["flagged"]) == (res[0] - 2) * (res[1] - 2) and
                  int(st["dropped"]) == 0, f"{label}: all-flagged stats {st}")
            same = torch.equal(out, ref)
            dmax = float((out - ref).abs().max())
            q = (rt.to_framebuffer(out).int() - rt.to_framebuffer(ref).int()).abs()
            changed = float((q.amax(0) > 0).float().mean())
            print(f"[adaptive] {label}: all flagged vs aa_per_sample: "
                  f"{'bit-identical' if same else 'NOT bit-identical'}, max|d| {dmax:.3e}, "
                  f"uint8 max {int(q.max())} on {changed:.5f} of pixels; flagged at "
                  f"eps=0.5/255 {n_listed} ({n_listed / (res[0] * res[1]):.4f})")
            if n > render_cuda.CULL_MIN_SPHERES:
                check(same, f"{label}: all flagged differs from the per-sample render")
            else:
                check(dmax <= DEMO_ADAPTIVE_ATOL and int(q.max()) <= 1 and
                      changed <= DEMO_ADAPTIVE_CHANGED, f"{label}: all flagged vs "
                      f"per-sample: max|d| {dmax}, uint8 max {int(q.max())}, {changed}")

    # Phase 17: the main path through the CLI at 1920x1080, counts set to 0
    # just before each run and read just after.
    os.makedirs(OUT_DIR, exist_ok=True)
    W, H = LARGE_RES
    main, launches = {}, 0
    for n in ADAPTIVE_SCENES:
        scene, cam = scene_and_camera(n, LARGE_RES)
        label = f"{name(n)}_{W}x{H}_adaptive"
        png = os.path.join(OUT_DIR, f"{label}.png")
        args = ["render", "--backend", "cuda", "--adaptive-aa", str(ADAPTIVE_EPS),
                "--width", str(W), "--height", str(H), "--out", png]
        if n:
            args[1:1] = ["--spheres", str(n)]
        render_cuda.reset_launch_counts()
        hx.reset_launch_counts()
        ac.reset_launch_counts()
        lc.reset_launch_counts()
        sl.reset_launch_counts()
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            rc = cli.main(args)
        torch.cuda.synchronize()
        text = buf.getvalue()
        print(text, end="")
        check(rc == 0, f"cli {' '.join(args)} failed")
        got = {**ac.LAUNCHES, **render_cuda.LAUNCHES, **hx.LAUNCHES, **lc.LAUNCHES,
               **sl.LAUNCHES}
        print(f"[adaptive-main] cli {' '.join(args[:-2])}: launches {got}")
        want = {"render_list": LARGE_FRAMES, "aa_none": LARGE_FRAMES, "aa_per_sample": 0,
                "aa_shared": 0, "hit_extents": LARGE_FRAMES if n else 0,
                "light_cells": LARGE_FRAMES if n else 0,
                "shadow_lists": LARGE_FRAMES if n else 0}
        check(got == want, f"{label}: launches {got}, expected {want}")
        launches += got["render_list"]
        MAIN_COUNTS["light_cells"] += got["light_cells"]
        line = next((ln for ln in text.splitlines() if ln.startswith("[adaptive-aa] flagged")),
                    None)
        check(line is not None, f"{label}: no stats line")
        img, st = rt.render_image_adaptive_cuda(cam, scene, eps=ADAPTIVE_EPS,
                                                budget_frac=ADAPTIVE_BUDGET, with_stats=True)
        flagged, dropped = int(st["flagged"]), int(st["dropped"])
        check(f"flagged {flagged:,} px" in line and f"dropped {dropped:,}" in line,
              f"{label}: stats line {line!r}, wrapper {flagged} {dropped}")
        w, h, px = read_png(png)
        check((w, h) == LARGE_RES, f"{png}: {w}x{h}")
        check(img.shape == (W, H, 3) and bool(torch.isfinite(img).all()),
              f"{label}: frame not finite")
        check(np.array_equal(px, framebuffer_to_array(rt.to_framebuffer(img))),
              f"{png}: pixels differ from the wrapper's frame")
        full = rt.render_image_cuda(cam, scene, depth=2, aliasing=True)
        flips, changed, dmax = frame_diff(rt.to_framebuffer(img), rt.to_framebuffer(full))
        share = flips / (W * H)
        # The dropped pixels: those flagged past the budget's K slots, in
        # pixel-index order (the worklist at budget 1 lists every flagged one).
        k = adp.budget_slots(W, H, ADAPTIVE_BUDGET)
        *_, idx_all, all_flagged, _ = worklist(cam, scene, True, ADAPTIVE_EPS, 1.0)
        all_flagged = int(all_flagged)
        check(flagged == all_flagged and dropped == max(all_flagged - k, 0),
              f"{label}: flagged {flagged}, dropped {dropped}; at budget 1.0 flagged "
              f"{all_flagged}, K {k}")
        kept = torch.ones(W * H, dtype=torch.bool, device=dev)
        kept[idx_all[k:all_flagged].long()] = False
        d_lev = (rt.to_framebuffer(img).int() - rt.to_framebuffer(full).int()).abs().amax(0)
        kept_flips = int((d_lev.reshape(-1)[kept] > FLIP_LEVELS).sum())
        kept_share = kept_flips / (W * H - dropped)
        print(f"[adaptive-main] {label}: {os.path.relpath(png, ROOT)} decodes to the "
              f"wrapper's frame; flagged {flagged} ({flagged / (W * H):.4f}; "
              f"{all_flagged / (W * H):.4f} at budget 1.0), dropped {dropped} (flagged - K, "
              f"K {k}); vs full AA (aa_shared): off by > 1 level {flips} ({share:.5f}), of "
              f"them at the {W * H - dropped} pixels not dropped {kept_flips} "
              f"({kept_share:.5f}), changed {changed}, max {dmax} levels")
        check(kept_share <= ADAPTIVE_QUALITY,
              f"{label}: {kept_share:.4%} of the pixels not dropped off full AA")
        main[n] = dict(label=label, flagged=flagged, dropped=dropped, share=share)
    check(launches > 0, "the main path never launched the worklist kernel")

    # Phase 18: times with CUDA events at those shapes; the kernel against the
    # plain trace of the main path's worklists (the first PLAIN_LIST_MAX
    # listed pixels at 1000 spheres).
    times = {}
    for n in ADAPTIVE_SCENES:
        scene, cam = scene_and_camera(n, LARGE_RES)
        label = main[n]["label"]
        ns, npl, nl = counts(scene)
        reps = 20 if n <= 100 else 5
        packed, tabs, tent, idx, flagged, _ = worklist(cam, scene, True, ADAPTIVE_EPS,
                                                       ADAPTIVE_BUDGET)
        cheap = render_cuda.shadow_cheap_ok(scene, True)
        out = tent.clone()
        n_listed = min(int(flagged), idx.numel())

        def centers():
            """The wrapper's centers pass: the AA lattice's tables, then the
            render kernel in mode aa_none on them."""
            return render_cuda.render_packed(
                cam, scene, packed, depth=2, mode="aa_none", compat=True,
                tabs=render_cuda.large_scene_tables(cam, scene, depth=2, aliasing=True,
                                                    compat=True, packed=packed))
        t = {"kernel": 1e3 * rt.time_fn(ac.launch_list, out, *packed, idx, flagged, depth=2,
                                        compat=True, cheap_shadow=cheap, **tabs, warmup=2,
                                        iters=reps),
             "centers": 1e3 * rt.time_fn(centers, warmup=2, iters=reps)}
        C = adp.stored_to_rgb(centers(), True)
        K = adp.budget_slots(W, H, ADAPTIVE_BUDGET)
        t["glue"] = host_and_device_ms(lambda: adp.tent_and_worklist(
            C, compat=True, eps=ADAPTIVE_EPS, K=K), iters=reps)
        flags = adp.curvature_flags(C, ADAPTIVE_EPS)
        t["parts"] = {"curvature_flags": host_and_device_ms(
                          lambda: adp.curvature_flags(C, ADAPTIVE_EPS), iters=reps),
                      "tent_image": host_and_device_ms(lambda: adp.tent_image(C, True),
                                                       iters=reps),
                      "compact": host_and_device_ms(lambda: adp.compact(flags, K),
                                                    iters=reps)}
        t["wrapper"] = host_and_device_ms(lambda: rt.render_image_adaptive_cuda(
            cam, scene, eps=ADAPTIVE_EPS, budget_frac=ADAPTIVE_BUDGET), iters=reps)
        t["shared"] = 1e3 * rt.time_fn(rt.render_image_cuda, cam, scene, depth=2,
                                       aliasing=True, warmup=2, iters=reps)
        t["none"] = 1e3 * rt.time_fn(rt.render_image_cuda, cam, scene, depth=2,
                                     aliasing=False, warmup=2, iters=reps)
        sub = n_listed if n <= 100 else min(n_listed, PLAIN_LIST_MAX)
        t0 = time.perf_counter()
        ref = plain_trace(cam, scene, idx, sub, tent, True)
        torch.cuda.synchronize()
        t["plain"] = 1e3 * (time.perf_counter() - t0)
        t["plain_px"] = sub
        t["err"] = held(label, ac.launch_list(tent.clone(), *packed, idx, flagged, depth=2,
                                               compat=True, cheap_shadow=cheap, **tabs),
                        ref, idx, sub)
        del ref
        # the live counts of the AA lattice at levels 0-2 (one hit_extents
        # launch, n_levels = depth + 1), for the bound
        ext3 = hx.hit_extents_cuda(cam, scene, aliasing=True, n_levels=3, vis=tabs["vis"],
                                   tree=tabs["tree"])
        t["bound"] = timing.bound_ms(*timing.adaptive_work(
            idx, n_listed, H, ns, npl, nl, tabs["vis"], tabs["shadow"], ext3, W))
        t["listed"] = n_listed
        times[n] = t
        print(f"[adaptive-time] {label} eps={ADAPTIVE_EPS} budget={ADAPTIVE_BUDGET}, "
              f"{n_listed} listed pixels, tables "
              f"{[k for k, v in tabs.items() if v is not None]}: list kernel alone "
              f"{t['kernel']:.4f} ms (bound "
              f"{t['bound'][0]:.4f} ms, {t['bound'][1]}); centers pass on packed inputs "
              f"{t['centers']:.4f} ms; flag/tent/compaction ops {t['glue'][0]:.4f} ms device "
              f"/ {t['glue'][1]:.4f} ms host; whole adaptive wrapper {t['wrapper'][0]:.4f} ms "
              f"device / {t['wrapper'][1]:.4f} ms host, against the aa_shared wrapper "
              f"{t['shared']:.4f} ms ({t['wrapper'][0] / t['shared']:.3f}x) and the "
              f"aa_none wrapper {t['none']:.4f} ms; plain trace {t['plain']:.4f} ms for "
              f"{sub} pixels | {card}")
        print(f"[adaptive-glue] {label}, device ms / host ms a call: " + ", ".join(
            f"{k} {d:.4f} / {h:.4f}" for k, (d, h) in t["parts"].items()) + f" | {card}")

    t = times[0]
    return [{"name": "render_adaptive_list", "route": "cuda", "source": LIST_SOURCE,
             "replaces": LIST_REPLACES, "launches": launches,
             "max_abs_err": max(v["err"] for v in times.values()), "max_rel_err": max(rules),
             "ms": t["wrapper"][0], "kernel_only_ms": t["kernel"], "plain_ms": t["plain"],
             "bound_ms": t["bound"][0], "bound_by": t["bound"][1], "library_ms": None,
             "shape": main[0]["label"], "listed_px": t["listed"],
             "shapes": {main[n]["label"]: {
                 "listed_px": v["listed"], "kernel_only_ms": v["kernel"],
                 "wrapper_ms": v["wrapper"][0], "aa_shared_wrapper_ms": v["shared"],
                 "plain_ms": v["plain"], "plain_px": v["plain_px"], "bound_ms": v["bound"][0],
                 "max_abs_err": v["err"], "flagged": main[n]["flagged"],
                 "dropped": main[n]["dropped"]} for n, v in times.items()}}]


def ptxas_report(csrc: str, source: str, out_dir: str, defines=()):
    """Start ``nvcc -Xptxas -v`` on one source of ``csrc`` (the kernels'
    registers, spills and shared memory as ptxas reports them), with extra
    ``defines``; returns the process, whose stderr :func:`ptxas_lines` reads."""
    from python_ray_tracer_tpu_torch.ops.cuda import _build
    os.makedirs(out_dir, exist_ok=True)
    tag = "".join(d.strip("-").replace("=", "") for d in defines)
    return subprocess.Popen(
        [_build.find_nvcc(), *_build.NVCC_FLAGS, *defines, "-Xptxas", "-v", "-I", csrc, "-c",
         "-o", os.path.join(out_dir, f"ptxas_{os.getpid()}_{tag}{source}.o"),
         os.path.join(csrc, source)],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)


def ptxas_lines(proc) -> list:
    """:func:`ptxas_rows` of a :func:`ptxas_report`'s output."""
    _, err = proc.communicate(timeout=900)
    check(proc.returncode == 0, f"nvcc -Xptxas -v failed:\n{err[-3000:]}")
    return ptxas_rows(err)


def ptxas_rows(err: str) -> list:
    """``(kernel, registers, spill stores, spill loads, stack)`` of each entry
    function in the stderr of ``nvcc -Xptxas -v``, names demangled by c++filt
    where it exists."""
    import re
    rows, name, spill = [], None, (0, 0, 0)
    for line in err.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            name = m.group(1)
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, (\d+) bytes "
                      r"spill loads", line)
        if m:
            spill = tuple(int(v) for v in m.groups())
        m = re.search(r"Used (\d+) registers", line)
        if m and name:
            rows.append([name, int(m.group(1)), spill[1], spill[2], spill[0]])
            name = None
    try:
        names = subprocess.run(["c++filt"], input="\n".join(r[0] for r in rows),
                               capture_output=True, text=True, timeout=60).stdout.split("\n")
        for r, n in zip(rows, names):
            r[0] = n.replace("(anonymous namespace)::", "").split("(")[0]
    except OSError:
        pass
    return rows


# The render and worklist kernels' launch bounds in render_fwd_kernel.cuh
# (their minimum of resident blocks a multiprocessor); phase 21 builds them
# again with each replaced by 0 (no minimum, ptxas's own register choice).
MIN_BLOCKS_EXPRS = ("TABLES ? (MODE == AA_PER_SAMPLE ? 2 : 3) : 0", "TABLES ? 2 : 0")


def build_without_min_blocks():
    """The library of render_fwd.cu and render_fwd_small.cu from a copy of
    csrc/ (in the build directory) whose render_fwd_kernel.cuh asks for no
    minimum of resident blocks in any instantiation, with the package's nvcc
    flags and ``-Xptxas -v``; returns its path and ptxas's rows of
    render_fwd.cu (:func:`ptxas_rows`)."""
    import shutil
    from python_ray_tracer_tpu_torch.ops.cuda import _build
    src = os.path.join(_build.BUILD_DIR, f"no_min_blocks_{os.getpid()}")
    shutil.rmtree(src, ignore_errors=True)
    shutil.copytree(_build.CSRC_DIR, src)
    hdr = os.path.join(src, "render_fwd_kernel.cuh")
    with open(hdr) as f:
        text = f.read()
    for expr in MIN_BLOCKS_EXPRS:
        check(text.count(expr) == 1, f"render_fwd_kernel.cuh has no launch bound {expr!r}")
        text = text.replace(expr, "0")
    with open(hdr, "w") as f:
        f.write(text)
    nvcc = _build.find_nvcc()
    objs = [os.path.join(src, f"{name}.o") for name in TREE_SWEEP_SOURCES]
    procs = [subprocess.Popen([nvcc, *_build.NVCC_FLAGS, "-Xptxas", "-v", "-I", src, "-c",
                               "-o", obj, os.path.join(src, name)], stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True)
             for name, obj in zip(TREE_SWEEP_SOURCES, objs)]
    errs = []
    for p in procs:
        _, err = p.communicate(timeout=900)
        check(p.returncode == 0, f"nvcc failed on the copy without minimum blocks:\n{err}")
        errs.append(err)
    so = os.path.join(src, "librt_no_min_blocks.so")
    proc = subprocess.run([nvcc, *_build.NVCC_FLAGS, "-shared", "-o", so, *objs],
                          capture_output=True, text=True, timeout=900)
    check(proc.returncode == 0, f"nvcc link failed:\n{proc.stderr}")
    return so, ptxas_rows(errs[TREE_SWEEP_SOURCES.index("render_fwd.cu")])


def start_sweep_builds():
    """Start the compiles of phases 19 and 21 together: the render and
    worklist kernels for the other bounce-tree shapes (TREE_SHAPES) and the
    other light-cell shapes (LC_SHAPES, with the build kernel), those kernels
    without a minimum of resident blocks (:func:`build_without_min_blocks`),
    and ptxas reports of render_fwd.cu, hit_extents.cu and light_cells.cu.
    Returns ``(futures by ("tree" | "cells", shape) and ("bounds", None),
    ptxas processes by source, start time)``."""
    from concurrent.futures import ThreadPoolExecutor
    from python_ray_tracer_tpu_torch.ops.cuda import _build
    from python_ray_tracer_tpu_torch.ops.cuda import cull_tables as ct
    from python_ray_tracer_tpu_torch.ops.cuda import light_cells_cuda as lc
    t0 = time.perf_counter()
    procs = {src: ptxas_report(_build.CSRC_DIR, src, _build.BUILD_DIR)
             for src in ("render_fwd.cu", "hit_extents.cu", "light_cells.cu")}
    jobs = [("tree", s, TREE_SWEEP_SOURCES, (f"-DRT_LEAF={s[0]}", f"-DRT_FAN={s[1]}"))
            for s in TREE_SHAPES if s != (ct.LEAF, ct.FAN)]
    jobs += [("cells", s, LC_SWEEP_SOURCES, (f"-DRT_LC_R={s[0]}", f"-DRT_LC_K={s[1]}"))
             for s in LC_SHAPES if s != (lc.R, lc.K)]
    pool = ThreadPoolExecutor(len(jobs) + 1)
    futs = {(kind, shape): pool.submit(_build.build, srcs, defs)
            for kind, shape, srcs, defs in jobs}
    futs[("bounds", None)] = pool.submit(build_without_min_blocks)
    pool.shutdown(wait=False)
    return futs, procs, t0


def bounce_phase(torch, rt, card: str, dev, builds) -> list:
    """Phase 19: the large-scene bounce sweeps of kernels 2 (``aa_shared``)
    and 7 (the worklist kernel) at 1920x1080, compat, the CLI's camera and
    scenes: each kernel alone on the demo scene and 100 and 1000 spheres
    (their wrappers: phase 20); at 1000 spheres the depth 0 / 1 / 2 split (the difference
    of two depths is one bounce level's cost), the live samples of each level
    (one hit_extents launch, n_levels 3) and the hit-extent kernel's level-0
    launch alone; the bounce tree's LEAF x FAN sweep at 1000 spheres (a
    library of the two kernels built for each other shape with -DRT_LEAF /
    -DRT_FAN, each frame ``torch.equal`` to the package's) and its box and
    sphere tests a bounce ray (the plain traversal on the chains of every
    16th pixel); ptxas's registers and spills of render_fwd.cu's and
    hit_extents.cu's instantiations. The compiles (:func:`start_sweep_builds`,
    phase 21's among them) all end before the first timing. Returns
    render_fwd.cu's ptxas rows."""
    from python_ray_tracer_tpu_torch.ops.cuda import _build
    from python_ray_tracer_tpu_torch.ops.cuda import adaptive_cuda as ac
    from python_ray_tracer_tpu_torch.ops.cuda import cull_tables as ct
    from python_ray_tracer_tpu_torch.ops.cuda import hit_extents_cuda as hx
    from python_ray_tracer_tpu_torch.ops.cuda import render_cuda
    from python_ray_tracer_tpu_torch.utils.config import RenderConfig

    futs, procs, t0 = builds
    libs = {s: _build.declare(ctypes.CDLL(f.result())) for (kind, s), f in futs.items()
            if kind == "tree"}
    for f in futs.values():
        f.result()
    regs = [ptxas_lines(procs[src]) for src in ("render_fwd.cu", "hit_extents.cu")]
    for s, lib in libs.items():
        check(_build.tree_shape(lib) == s, f"library for {s} reports {_build.tree_shape(lib)}")
    others = list(libs)
    libs[(ct.LEAF, ct.FAN)] = _build.load_library()
    print(f"[tree-build] kernels for tree shapes {others}, light-cell shapes "
          f"{[s for kind, s in futs if kind == 'cells']}, the kernels without a minimum "
          f"of resident blocks and the ptxas reports in "
          f"{time.perf_counter() - t0:.1f} s")

    cfg = RenderConfig()
    W, H = LARGE_RES
    cam = rt.Camera.build(LARGE_RES, cfg.camera_position, cfg.camera_euler, cfg.fov,
                          device=dev)
    stream = ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)
    for n in ADAPTIVE_SCENES:
        scene = scene_of(rt, cfg, n, dev)
        ns, npl, nl = counts(scene)
        reps = 50 if n == 0 else 20 if n <= 100 else 10
        params = render_cuda.pack_params(cam, scene, True).to(dev)
        tabs = render_cuda.scene_tables(scene)
        cheap = render_cuda.shadow_cheap_ok(scene, True)
        t2 = render_cuda.large_scene_tables(cam, scene, depth=2, aliasing=True, compat=True)
        out = torch.empty((W, H, 3), device=dev)
        packed, t7, tent, idx, flagged, _ = ac.worklist_inputs(
            cam, scene, depth=2, compat=True, eps=ADAPTIVE_EPS, budget_frac=ADAPTIVE_BUDGET)
        lout = tent.clone()

        def k2(depth, tb=t2):
            return render_cuda.launch(out, params, tabs, (ns, npl, nl), depth=depth,
                                      mode="aa_shared", compat=True, cheap_shadow=cheap,
                                      vis=tb[0], shadow=tb[1], tree=tb[2], cells=tb[3])

        def k7(depth, tb=t7):
            return ac.launch_list(lout, *packed, idx, flagged, depth=depth, compat=True,
                                  cheap_shadow=cheap, vis=tb[0], shadow=tb[1], tree=tb[2],
                                  cells=tb[3])
        depths = (0, 1, 2) if ns >= 1000 else (2,)
        ms2 = {d: 1e3 * rt.time_fn(k2, d, warmup=2, iters=reps) for d in depths}
        ms7 = {d: 1e3 * rt.time_fn(k7, d, warmup=2, iters=reps) for d in depths}
        on = [k for k, v in zip(("vis", "shadow", "tree", "cells"), t2) if v is not None]
        print(f"[tree-time] {'demo' if n == 0 else f'{n}_spheres'} {W}x{H} compat, tables "
              f"{on}: aa_shared kernel alone " +
              ", ".join(f"depth {d} {v:.4f} ms" for d, v in ms2.items()) +
              f"; worklist kernel alone ({int(flagged)} flagged, tables "
              f"{[k for k, v in zip(('vis', 'shadow', 'tree', 'cells'), t7) if v is not None]})"
              " " +
              ", ".join(f"depth {d} {v:.4f} ms" for d, v in ms7.items()) + f" | {card}")
        if ns < 1000:
            continue
        ext = hx.hit_extents_cuda(cam, scene, aliasing=True, n_levels=3, vis=t2[0])
        k3 = 1e3 * rt.time_fn(hx.launch, ext[:ext.shape[0] // 3], params, tabs, (ns, npl, nl),
                              W=W, H=H, aliasing=True, compat=True, n_levels=1, vis=t2[0],
                              warmup=2, iters=50)
        print(f"[tree-time] {n}_spheres: live samples of the AA lattice at levels 0-2 "
              f"{ext[:, 6].reshape(-1, 3).sum(dim=0).tolist()}; hit_extents kernel alone "
              f"(level 0, the render path's launch) {k3:.4f} ms | {card}")

        # the sweep: each shape's kernels on its own tree, frames held
        # against the package's (the tree's shape moves no pixel)
        ref2, ref7 = k2(2).clone(), k7(2).clone()
        (sph, pln, lts) = tabs
        for (leaf, fan), lib in libs.items():
            tr = ct.bounce_tree(scene.spheres.center, scene.spheres.radius, leaf=leaf,
                                fan=fan)
            v, sh, g, c2 = hx.table_args(t2[0], t2[1], tr, t2[3])
            vl, shl, gl, c7 = hx.table_args(t7[0], t7[1], tr, t7[3])

            def s2():
                rc = lib.rt_render_fwd(params.data_ptr(), sph.data_ptr(), ns, pln.data_ptr(),
                                       npl, lts.data_ptr(), nl, out.data_ptr(), W, H, W, 2,
                                       render_cuda.MODES.index("aa_shared"), 1, int(cheap), 1,
                                       *v, *sh, *g, *c2, stream)
                check(rc == 0, f"aa_shared for tree shape {(leaf, fan)}: CUDA error {rc}")
                return out

            def s7():
                rc = lib.rt_render_list(params.data_ptr(), sph.data_ptr(), ns, pln.data_ptr(),
                                        npl, lts.data_ptr(), nl, idx.data_ptr(),
                                        flagged.data_ptr(), idx.numel(), lout.data_ptr(), W,
                                        H, 2, 1, int(cheap), 1, *vl, *shl, *gl, *c7, stream)
                check(rc == 0, f"worklist kernel for tree shape {(leaf, fan)}: CUDA error {rc}")
                return lout
            s2()
            s7()
            torch.cuda.synchronize()
            check(torch.equal(out, ref2) and torch.equal(lout, ref7),
                  f"tree shape {(leaf, fan)} changed the frame")
            a = 1e3 * rt.time_fn(s2, warmup=2, iters=reps)
            b = 1e3 * rt.time_fn(s7, warmup=2, iters=reps)
            print(f"[tree-sweep] {n}_spheres leaf {leaf} fan {fan}: aa_shared kernel alone "
                  f"{a:.4f} ms, worklist kernel alone {b:.4f} ms, frames equal to the "
                  f"package's{' (the constants)' if (leaf, fan) == (ct.LEAF, ct.FAN) else ''}"
                  f" | {card}")
        # box and sphere tests a bounce ray at levels 1 and 2, with the plain
        # traversal, on the chains of every 16th pixel center
        from python_ray_tracer_tpu_torch.ops import intersect
        from python_ray_tracer_tpu_torch.ops.shade import BIAS, _surface_attributes, reflect
        xs, ys = torch.meshgrid(torch.arange(8, W, 16.0, device=dev),
                                torch.arange(8, H, 16.0, device=dev), indexing="ij")
        d = cam.ray_directions(torch.stack([xs, ys], -1).reshape(-1, 2), compat=True)
        o = cam.ray_origin().expand(d.shape)
        c, r = scene.spheres.center, scene.spheres.radius
        for level in range(3):
            h = intersect.closest_hit(o, d, scene, compat=True)
            alive = h["hit"]
            P = o + torch.where(alive, h["t"], torch.zeros_like(h["t"]))[..., None] * d
            _, N = _surface_attributes(P, h, scene)
            Pb = P + BIAS * N
            if level:
                L = scene.lights.position[0] - Pb[alive]
                L = L / L.norm(dim=-1, keepdim=True)
                for leaf, fan in TREE_SHAPES:
                    tr = ct.bounce_tree(c, r, leaf=leaf, fan=fan)
                    _, _, nb, nsph = ct.tree_closest_hit_plain(tr, o, d, c, r, compat=True,
                                                               fan=fan)
                    _, sb, ss = ct.tree_occluded_plain(tr, Pb[alive], L, c, r, compat=True,
                                                       cheap=cheap, fan=fan)
                    print(f"[tree-work] {n}_spheres level {level} leaf {leaf} fan {fan}: "
                          f"{o.shape[0]} bounce rays, a closest hit {nb.double().mean():.1f}"
                          f" box and {nsph.double().mean():.1f} sphere tests; "
                          f"{L.shape[0]} shadow rays to light 0, {sb.double().mean():.1f} "
                          f"box and {ss.double().mean():.1f} sphere tests")
            d2 = reflect(d, N)
            o, d = (Pb + BIAS * d2)[alive], d2[alive]
    for rows in regs:
        for name, nregs, st, ld, stack in rows:
            print(f"[tree-regs] {name}: {nregs} registers, spill stores {st} B, loads "
                  f"{ld} B, stack {stack} B")
    return regs[0]


def lightbuf_phase(torch, rt, card: str, dev, builds, fwd_regs) -> list:
    """Phase 21 (``[lightbuf-*]``): the light cells of the bounce shadow rays
    at 1920x1080, compat, the CLI's camera and scenes. ``[lightbuf-build]``:
    the build kernel against its plain version, integer for integer, at 100
    and 1000 spheres, its time alone, through its wrapper and the plain
    version's, and its bound. ``[lightbuf-work]``: on the chains of every
    16th pixel (each light at 100 spheres, light 0 at 1000), what a bounce
    shadow ray reads (its row's length), the share that falls back and its
    sphere tests, by the plain lookup traversal, each ray's answer held
    against the full any-hit, beside the sweep of before (the tree's box and
    sphere tests, or the full sweep's). ``[lightbuf-time]``: ``aa_none`` alone
    with the cells on and off (the same kernel; depth 0 / 1 / 2 at 1000
    spheres), the centers pass of adaptive AA (``aa_none`` on the AA
    lattice's tables), ``aa_shared``, the worklist kernel and, at 100 and 1000
    spheres, ``aa_per_sample`` (which take the lookup through ``trace``),
    every frame with the cells on ``torch.equal`` to the one with them off;
    the no-AA wrapper; the bounds. The R x K sweep at 1000 spheres
    (``[lightbuf-sweep]``, libraries from :func:`start_sweep_builds`).
    ``[lightbuf-bounds]``: ``aa_none``, ``aa_shared``, ``aa_per_sample`` and
    the worklist kernel alone at 100 and 1000 spheres with their launch
    bounds and without a minimum of resident blocks (ptxas's own register
    choice, :func:`build_without_min_blocks`), frames ``torch.equal``.
    ``[lightbuf-regs]``: ptxas's registers and spills of render_fwd.cu's
    instantiations (all of them TABLES) and of the build kernel. Returns the
    build kernel's entry of the kernels line."""
    from python_ray_tracer_tpu_torch.ops import intersect
    from python_ray_tracer_tpu_torch.ops.cuda import _build
    from python_ray_tracer_tpu_torch.ops.cuda import adaptive_cuda as ac
    from python_ray_tracer_tpu_torch.ops.cuda import cull_tables as ct
    from python_ray_tracer_tpu_torch.ops.cuda import hit_extents_cuda as hx
    from python_ray_tracer_tpu_torch.ops.cuda import light_cells_cuda as lc
    from python_ray_tracer_tpu_torch.ops.cuda import render_cuda
    from python_ray_tracer_tpu_torch.ops.shade import BIAS, _surface_attributes, reflect
    from python_ray_tracer_tpu_torch.utils import timing
    from python_ray_tracer_tpu_torch.utils.config import RenderConfig

    cfg = RenderConfig()
    W, H = LARGE_RES
    cam = rt.Camera.build(LARGE_RES, cfg.camera_position, cfg.camera_euler, cfg.fov,
                          device=dev)
    per = 3 * lc.R * lc.R

    def rows_of(cells):
        cnt = cells.cnt.float()
        return (float(cnt[cnt >= 0].mean()), int(cells.cnt.max()),
                float((cnt < 0).float().mean()))

    built = {}
    for n in LARGE_SPHERES:
        scene = scene_of(rt, cfg, n, dev)
        ns, npl, nl = counts(scene)
        sph, _, lts = render_cuda.scene_tables(scene)
        c, r, L = scene.spheres.center, scene.spheres.radius, scene.lights.position
        cells = lc.light_cells_cuda(sph, lts, ns, nl)
        plain = lc.light_cells_plain(c, r, L)
        torch.cuda.synchronize()
        for name, a, b in zip(("idx", "cnt", "hdr"), cells, plain):
            if not torch.equal(a, b):
                bad = torch.nonzero(a.reshape(-1) != b.reshape(-1)).reshape(-1)[:8].tolist()
                check(False, f"light cells {n} spheres: {name} differs from the plain "
                      f"version at {bad}")
        buf = lc.empty(nl, dev)
        t = {"kernel": 1e3 * rt.time_fn(lc.launch, buf, sph, lts, ns, nl, warmup=2, iters=50),
             "wrapper": 1e3 * rt.time_fn(lc.light_cells_cuda, sph, lts, ns, nl, warmup=2,
                                         iters=50),
             "plain": 1e3 * rt.time_fn(lc.light_cells_plain, c, r, L, warmup=1, iters=3),
             "bound": timing.bound_ms(*timing.light_cells_work(ns, nl, lc.R, lc.K))}
        mean, longest, over = rows_of(cells)
        print(f"[lightbuf-build] {n}_spheres, {nl} lights, R {lc.R}, K {lc.K}: kernel equals "
              f"the plain version integer for integer (reach {float(cells.hdr[0]):.6g}, "
              f"s_max {float(cells.hdr[1]):.6g}); kernel alone {t['kernel']:.4f} ms, wrapper "
              f"{t['wrapper']:.4f} ms, plain {t['plain']:.4f} ms, bound {t['bound'][0]:.4f} "
              f"ms ({t['bound'][1]}); rows mean {mean:.2f} spheres, longest {longest}, -1 "
              f"rows {over:.4f} | {card}")
        built[n] = (scene, cells, t)

        # what a bounce shadow ray reads and tests, on every 16th pixel's chain
        xs, ys = torch.meshgrid(torch.arange(8, W, 16.0, device=dev),
                                torch.arange(8, H, 16.0, device=dev), indexing="ij")
        d = cam.ray_directions(torch.stack([xs, ys], -1).reshape(-1, 2), compat=True)
        o = cam.ray_origin().expand(d.shape)
        tree = ct.bounce_tree(c, r) if render_cuda.uses_tree(ns, 2) else None
        cheap = render_cuda.shadow_cheap_ok(scene, True)
        for level in range(3):
            h = intersect.closest_hit(o, d, scene, compat=True)
            alive = h["hit"]
            P = o + torch.where(alive, h["t"], torch.zeros_like(h["t"]))[..., None] * d
            _, N = _surface_attributes(P, h, scene)
            Pb = P + BIAS * N
            if level:
                P1 = Pb[alive]
                for li in range(nl if ns < 1000 else 1):
                    v = L[li] - P1
                    dl = v / torch.sqrt(intersect._dot(v, v))[:, None]
                    occ, fb, tests = lc.occluded_cells_plain(cells, P1, dl, li, c, r,
                                                             compat=True, cheap=cheap,
                                                             tree=tree)
                    occ_all = ct.sphere_occludes_plain(P1, dl, c, r, compat=True, cheap=cheap)
                    full = occ_all.any(dim=1)
                    check(torch.equal(occ, full), f"light cells {n} spheres level {level} "
                          f"light {li}: {int((occ != full).sum())} rays differ from the "
                          f"full any-hit")
                    cell = lc.light_cell_of(dl)
                    read = cells.cnt[li * per + cell.clamp(min=0)].float()[~fb]
                    if tree is not None:
                        _, bb, bs = ct.tree_occluded_plain(tree, P1, dl, c, r, compat=True,
                                                           cheap=cheap)
                        before = (f"the tree {bb.double().mean():.2f} box and "
                                  f"{bs.double().mean():.2f} sphere tests")
                    else:
                        first = torch.where(full, occ_all.int().argmax(dim=1) + 1,
                                            torch.full_like(full, ns, dtype=torch.int64))
                        before = f"the full sweep {first.double().mean():.2f} sphere tests"
                    print(f"[lightbuf-work] {n}_spheres level {level} light {li}: "
                          f"{P1.shape[0]} bounce shadow rays, any-hit equal to the full "
                          f"sweep's; fallback {float(fb.double().mean()):.4f}; row read "
                          f"{float(read.double().mean()) if read.numel() else 0.0:.2f} "
                          f"spheres; {float(tests.double().mean()):.2f} sphere tests a ray; "
                          f"before: {before}")
            d2 = reflect(d, N)
            o, d = (Pb + BIAS * d2)[alive], d2[alive]

    # each kernel alone, cells on and off, frames equal
    stream = ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)
    for n in ADAPTIVE_SCENES:
        scene = scene_of(rt, cfg, n, dev)
        ns, npl, nl = cnt = counts(scene)
        params = render_cuda.pack_params(cam, scene, True).to(dev)
        tabs = render_cuda.scene_tables(scene)
        cheap = render_cuda.shadow_cheap_ok(scene, True)
        out = torch.empty((W, H, 3), device=dev)
        reps = 50 if n == 0 else 20 if n <= 100 else 10
        t1 = render_cuda.large_scene_tables(cam, scene, depth=2, aliasing=False, compat=True)
        ta = render_cuda.large_scene_tables(cam, scene, depth=2, aliasing=True, compat=True)
        packed, t7, tent, idx, flagged, _ = ac.worklist_inputs(
            cam, scene, depth=2, compat=True, eps=ADAPTIVE_EPS, budget_frac=ADAPTIVE_BUDGET)
        lout = tent.clone()

        def k(mode, depth, tb):
            return render_cuda.launch(out, params, tabs, cnt, depth=depth, mode=mode,
                                      compat=True, cheap_shadow=cheap, vis=tb[0],
                                      shadow=tb[1], tree=tb[2], cells=tb[3])

        def k7(depth, tb):
            return ac.launch_list(lout, *packed, idx, flagged, depth=depth, compat=True,
                                  cheap_shadow=cheap, vis=tb[0], shadow=tb[1], tree=tb[2],
                                  cells=tb[3])
        runs = [("aa_none", lambda dp, tb: k("aa_none", dp, tb), t1,
                 (0, 1, 2) if ns >= 1000 else (2,)),
                ("centers pass", lambda dp, tb: k("aa_none", dp, tb), ta, (2,)),
                ("aa_shared (inherited)", lambda dp, tb: k("aa_shared", dp, tb), ta, (2,)),
                ("worklist (inherited)", k7, t7, (2,))]
        if n:
            runs.append(("aa_per_sample (inherited)",
                         lambda dp, tb: k("aa_per_sample", dp, tb), ta, (2,)))
        parts = []
        for label, fn, tb, depths in runs:
            for depth in depths:
                on = fn(depth, tb).clone()
                ms_on = 1e3 * rt.time_fn(fn, depth, tb, warmup=2, iters=reps)
                if tb[3] is None:
                    parts.append(f"{label} depth {depth} {ms_on:.4f} ms")
                    continue
                off_tb = (*tb[:3], None)
                off = fn(depth, off_tb).clone()
                torch.cuda.synchronize()
                check(torch.equal(on, off), f"{n} spheres {label} depth {depth}: "
                      f"{int((on != off).any(-1).sum())} pixels differ with the cells off")
                ms_off = 1e3 * rt.time_fn(fn, depth, off_tb, warmup=2, iters=reps)
                parts.append(f"{label} depth {depth} {ms_on:.4f} ms (cells off {ms_off:.4f},"
                             f" {ms_on / ms_off:.3f}x)")
        wrapper = 1e3 * rt.time_fn(rt.render_image_cuda, cam, scene, depth=2, aliasing=False,
                                   warmup=2, iters=reps)
        if n:
            ext3 = hx.hit_extents_cuda(cam, scene, aliasing=False, n_levels=3, vis=t1[0],
                                       tree=ct.bounce_tree(scene.spheres.center,
                                                           scene.spheres.radius))
            bound = timing.bound_ms(*timing.large_scene_work(W, H, ns, npl, nl, "aa_none",
                                                             t1[0], t1[1], ext3))
            cbound = timing.bound_ms(*timing.large_scene_work(W, H, ns, npl, nl, "aa_none",
                                                              ta[0], ta[1], ext3))
            btxt = (f"bound {bound[0]:.4f} ms ({bound[1]}), centers pass {cbound[0]:.4f} ms "
                    f"({cbound[1]})")
        else:
            bound = timing.bound_ms(*timing.hard_work(W, H, ns, npl, nl, "aa_none"))
            btxt = f"bound {bound[0]:.4f} ms ({bound[1]})"
        print(f"[lightbuf-time] {'demo' if n == 0 else f'{n}_spheres'} {W}x{H} compat, "
              f"kernels alone: " + "; ".join(parts) + f"; no-AA wrapper {wrapper:.4f} ms; "
              f"{btxt} | {card}")

    # the R x K sweep: each shape's build kernel and render kernel
    futs = builds[0]
    for shape in LC_SHAPES:
        lib = (_build.load_library() if shape == (lc.R, lc.K) else
               _build.declare(ctypes.CDLL(futs[("cells", shape)].result())))
        check(_build.light_cells_shape(lib) == shape,
              f"library for light cells {shape} reports {_build.light_cells_shape(lib)}")
        for n in LARGE_SPHERES[-1:]:
            scene, ref_cells, _ = built[n]
            ns, npl, nl = counts(scene)
            params = render_cuda.pack_params(cam, scene, True).to(dev)
            sph, pln, lts = render_cuda.scene_tables(scene)
            cheap = render_cuda.shadow_cheap_ok(scene, True)
            t1 = render_cuda.large_scene_tables(cam, scene, depth=2, aliasing=False,
                                                compat=True, light_cells=False)
            cells = lc.launch(lc.empty(nl, dev, *shape), sph, lts, ns, nl, lib=lib)
            plain = lc.light_cells_plain(scene.spheres.center, scene.spheres.radius,
                                         scene.lights.position, r=shape[0], k=shape[1])
            torch.cuda.synchronize()
            check(all(torch.equal(a, b) for a, b in zip(cells, plain)),
                  f"light cells {shape} at {n} spheres differ from the plain version")
            out = torch.empty((W, H, 3), device=dev)
            args = [a for grp in hx.table_args(*t1[:3], cells) for a in grp]

            def s1():
                rc = lib.rt_render_fwd(params.data_ptr(), sph.data_ptr(), ns, pln.data_ptr(),
                                       npl, lts.data_ptr(), nl, out.data_ptr(), W, H, W, 2,
                                       render_cuda.MODES.index("aa_none"), 1, int(cheap), 1,
                                       *args, stream)
                check(rc == 0, f"aa_none for light cells {shape}: CUDA error {rc}")
                return out
            ref = render_cuda.render_packed(cam, scene, (params, (sph, pln, lts),
                                                         (ns, npl, nl)),
                                            depth=2, mode="aa_none", compat=True,
                                            tabs=(*t1[:3], None)).clone()
            s1()
            torch.cuda.synchronize()
            check(torch.equal(out, ref), f"light cells {shape} changed the {n}-sphere frame")
            ms = 1e3 * rt.time_fn(s1, warmup=2, iters=20 if n <= 100 else 10)
            bms = 1e3 * rt.time_fn(lc.launch, cells, sph, lts, ns, nl, lib=lib, warmup=2,
                                   iters=20)
            mean, longest, over = rows_of(cells)
            print(f"[lightbuf-sweep] {n}_spheres R {shape[0]} K {shape[1]}: aa_none kernel "
                  f"alone {ms:.4f} ms, build kernel alone {bms:.4f} ms, rows mean "
                  f"{mean:.2f}, longest {longest}, -1 rows {over:.4f}, frame equal to the "
                  f"cells-off frame{' (the constants)' if shape == (lc.R, lc.K) else ''}"
                  f" | {card}")

    # the launch bounds against none (ptxas's own register choice): each kernel
    # alone, both libraries in turns (A B B A, the least of each), frames equal
    free_so, free_regs = futs[("bounds", None)].result()
    free = _build.declare(ctypes.CDLL(free_so))
    for name, nregs, st, ld, stack in free_regs:
        print(f"[lightbuf-bounds] without a minimum of blocks, {name}: {nregs} registers, "
              f"spill stores {st} B, loads {ld} B, stack {stack} B")
    for n in LARGE_SPHERES:
        scene = scene_of(rt, cfg, n, dev)
        ns, npl, nl = counts(scene)
        params = render_cuda.pack_params(cam, scene, True).to(dev)
        sph, pln, lts = render_cuda.scene_tables(scene)
        cheap = render_cuda.shadow_cheap_ok(scene, True)
        t1 = render_cuda.large_scene_tables(cam, scene, depth=2, aliasing=False, compat=True)
        ta = render_cuda.large_scene_tables(cam, scene, depth=2, aliasing=True, compat=True)
        _, t7, tent, idx, flagged, _ = ac.worklist_inputs(
            cam, scene, depth=2, compat=True, eps=ADAPTIVE_EPS, budget_frac=ADAPTIVE_BUDGET)

        def fwd(lib, mode, tb):
            args = [a for grp in hx.table_args(*tb) for a in grp]
            buf = torch.empty((W, H, 3), device=dev)

            def run():
                rc = lib.rt_render_fwd(params.data_ptr(), sph.data_ptr(), ns, pln.data_ptr(),
                                       npl, lts.data_ptr(), nl, buf.data_ptr(), W, H, W, 2,
                                       render_cuda.MODES.index(mode), 1, int(cheap), 1,
                                       *args, stream)
                check(rc == 0, f"{mode} without minimum blocks: CUDA error {rc}")
                return buf
            return run

        def lst(lib, tb):
            args = [a for grp in hx.table_args(*tb) for a in grp]
            buf = tent.clone()

            def run():
                rc = lib.rt_render_list(params.data_ptr(), sph.data_ptr(), ns, pln.data_ptr(),
                                        npl, lts.data_ptr(), nl, idx.data_ptr(),
                                        flagged.data_ptr(), idx.numel(), buf.data_ptr(), W, H,
                                        2, 1, int(cheap), 1, *args, stream)
                check(rc == 0, f"worklist kernel without minimum blocks: CUDA error {rc}")
                return buf
            return run
        pkg = _build.load_library()
        parts = []
        for label, make in (("aa_none", lambda lib: fwd(lib, "aa_none", t1)),
                            ("aa_shared", lambda lib: fwd(lib, "aa_shared", ta)),
                            ("aa_per_sample", lambda lib: fwd(lib, "aa_per_sample", ta)),
                            ("worklist", lambda lib: lst(lib, t7))):
            a, b = make(pkg), make(free)
            fa, fb = a().clone(), b().clone()
            torch.cuda.synchronize()
            check(torch.equal(fa, fb), f"{n} spheres {label}: the launch bounds changed "
                  f"{int((fa != fb).any(-1).sum())} pixels")
            reps = 20 if n <= 100 else 10
            ms = {id(a): [], id(b): []}
            for fn in (a, b, b, a):
                ms[id(fn)].append(1e3 * rt.time_fn(fn, warmup=2, iters=reps))
            ma, mb = min(ms[id(a)]), min(ms[id(b)])
            parts.append(f"{label} {ma:.4f} ms (no minimum {mb:.4f}, {ma / mb:.3f}x)")
        print(f"[lightbuf-bounds] {n}_spheres {W}x{H} compat depth 2, kernels alone with the "
              f"launch bounds: " + "; ".join(parts) + f"; frames equal | {card}")

    for name, nregs, st, ld, stack in fwd_regs + ptxas_lines(builds[1]["light_cells.cu"]):
        print(f"[lightbuf-regs] {name}: {nregs} registers, spill stores {st} B, loads "
              f"{ld} B, stack {stack} B")
    check(MAIN_COUNTS["light_cells"] > 0, "the main paths launched no light-cell build")
    scene, cells, t = built[LARGE_SPHERES[-1]]
    return [{"name": "light_cells", "route": "cuda", "source": LC_SOURCE,
             "replaces": None, "launches": MAIN_COUNTS["light_cells"],
             "max_abs_err": 0.0, "ms": t["wrapper"], "kernel_only_ms": t["kernel"],
             "plain_ms": t["plain"], "bound_ms": t["bound"][0], "bound_by": t["bound"][1],
             "library_ms": None, "shape": f"{LARGE_SPHERES[-1]}_spheres_3_lights",
             "part_of": "render_fwd_aa_none_large: the bounce shadow rays' tables"}]


def scene_digest(scene) -> str:
    """SHA-256 of the float32 bytes of a scene's sphere centers, radii and
    albedo (CLI_SCENE_SHA256's digest)."""
    import hashlib
    h = hashlib.sha256()
    for t in (scene.spheres.center, scene.spheres.radius, scene.spheres.albedo):
        h.update(t.detach().cpu().float().contiguous().numpy().tobytes())
    return h.hexdigest()


def cli_scene_phase(rt, dev) -> None:
    """``[cli-scene]``: ``random_scene(n)`` on the card and ``cli render
    --spheres n``'s scene (``cli._build``) at the n of CLI_SCENE_SHA256, each
    digest the JAX package's."""
    import argparse
    from python_ray_tracer_tpu_torch import cli
    for n, want in CLI_SCENE_SHA256.items():
        ap = argparse.ArgumentParser()
        cli._add_render_args(ap)
        built = cli._build(ap.parse_args(["--spheres", str(n)]))[1]
        got = {"random_scene": scene_digest(rt.random_scene(n, device=dev)),
               "cli._build": scene_digest(built)}
        print(f"[cli-scene] {n} spheres: sha256 " + ", ".join(
            f"{k} {v}" for k, v in got.items()) + f"; the JAX package's {want}")
        check(built.spheres.center.is_cuda and all(v == want for v in got.values()),
              f"[cli-scene] {n} spheres: {got} on {built.spheres.center.device}, "
              f"expected {want} on the card")


def native_phase(rt, card: str, dev) -> None:
    """``[native]``: the port's host helper (``csrc/host/gif_lzw.cpp``, g++ at
    first use): its build and load time, and the PNG of a demo frame that
    ``save_png`` writes with the standard library's zlib (its version is
    printed: the JAX package's encoder writes the same bytes where it links
    the same zlib), which must be ``encode_png``'s bytes and decode to the
    frame."""
    import numpy as np
    from python_ray_tracer_tpu_torch.utils import image, native
    t0 = time.perf_counter()
    native.load()
    gif_s = time.perf_counter() - t0
    os.makedirs(OUT_DIR, exist_ok=True)
    path = os.path.join(OUT_DIR, "native.png")
    fb = rt.to_framebuffer(rt.render_image_cuda(rt.default_camera((256, 256), device=dev),
                                                rt.default_scene(device=dev)))
    rt.save_png(fb, path)
    want = image.framebuffer_to_array(fb)
    w, h, px = read_png(path)
    with open(path, "rb") as f:
        same = f.read() == image.encode_png(want)
    built = ("none, already built" if native.BUILD_SECONDS is None
             else f"{native.BUILD_SECONDS:.2f} s")
    print(f"[native] gif helper loaded in {gif_s:.2f} s (g++ build: {built}); save_png: "
          f"the standard library's zlib {zlib.ZLIB_RUNTIME_VERSION}, {os.path.getsize(path)} B, "
          f"encode_png's bytes: {same} | {card}")
    check(same, f"{path}: not encode_png's bytes")
    check((w, h) == (256, 256) and np.array_equal(px, want),
          f"{path}: does not decode to the frame")


def scene_of(rt, cfg, n: int, dev, specular: float = 0.0):
    """The CLI's scene (``cli._build``): the demo scene (n = 0) or
    ``random_scene(n)`` from ``jax.random.key(0)`` (``--spheres n``), the JAX
    package's scene, with the CLI's materials and the Phong term
    ``specular``."""
    mats = rt.Materials.build(cfg.ambient, cfg.lambert, cfg.reflection, specular,
                              cfg.shininess, device=dev)
    if n == 0:
        return rt.default_scene(mats, device=dev)
    return rt.random_scene(n, materials=mats, key=0, device=dev)


def entry_times(torch, rt, card: str, dev, label: str) -> None:
    """Phase 20 (``[entry-time]``), also run alone by ``--entry-times DIR`` on
    the package of another checkout: kernels 2, 7 and 1 through the entry
    points a user calls, ``render_image_cuda`` (AA, so ``aa_shared``; AA with
    ``aa_share=False``, so ``aa_per_sample``, at 100 and 1000 spheres; and
    without AA, so ``aa_none``) and ``render_image_adaptive_cuda`` (its
    worklist kernel and its centers pass, ``aa_none``), at 1920x1080, compat,
    the CLI's camera, on the demo scene and 100 spheres at depth 2 and on 1000
    spheres at depth 0, 1 and 2: each wrapper's time (CUDA events) and the
    device time of its kernel a call (torch.profiler; "not measured" where the
    profiler reports none). The entry points' signatures are the same in
    every tree of the port, so two checkouts' lines can be set side by side
    (:func:`scene_of`'s scenes need ``random_scene``'s ``key``).
    ``[entry-regs]``: ptxas's registers and spills of the checkout's
    render_fwd_small.cu (the small-scene instantiations). ``[entry-tables]``:
    at 100 and 1000 spheres, AA and not, the hit-extent kernel alone
    (``hit_extents_cuda.launch``) and the frame's tables through
    ``render_cuda.large_scene_tables``, whose signatures every tree since the
    large-scene path shares."""
    from torch.profiler import ProfilerActivity, profile
    from python_ray_tracer_tpu_torch.ops.cuda import _build
    from python_ray_tracer_tpu_torch.utils.config import RenderConfig
    small_regs = ptxas_report(_build.CSRC_DIR, "render_fwd_small.cu", _build.BUILD_DIR)
    cfg = RenderConfig()
    cam = rt.Camera.build(LARGE_RES, cfg.camera_position, cfg.camera_euler, cfg.fov,
                          device=dev)

    def device_ms(fn, kernel: str, calls: int = 5):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
        us = 0.0
        for e in prof.key_averages():
            if kernel in e.key:
                us += getattr(e, "self_device_time_total",
                              getattr(e, "self_cuda_time_total", 0.0))
        return f"{us / 1e3 / calls:.4f} ms" if us > 0 else "not measured"
    for n in ADAPTIVE_SCENES:
        scene = scene_of(rt, cfg, n, dev)
        for depth in ((0, 1, 2) if n >= 1000 else (2,)):
            def shared():
                return rt.render_image_cuda(cam, scene, depth=depth, aliasing=True)

            def adaptive():
                return rt.render_image_adaptive_cuda(cam, scene, depth=depth,
                                                     eps=ADAPTIVE_EPS,
                                                     budget_frac=ADAPTIVE_BUDGET)
            def none():
                return rt.render_image_cuda(cam, scene, depth=depth, aliasing=False)

            def per_sample():
                return rt.render_image_cuda(cam, scene, depth=depth, aliasing=True,
                                            aa_share=False)
            reps = 20 if n <= 100 else 10
            w2 = 1e3 * rt.time_fn(shared, warmup=2, iters=reps)
            w7 = 1e3 * rt.time_fn(adaptive, warmup=2, iters=reps)
            w1 = 1e3 * rt.time_fn(none, warmup=2, iters=reps)
            ps = ""
            if n and depth == 2:
                w3 = 1e3 * rt.time_fn(per_sample, warmup=2, iters=reps)
                ps = (f"; render_image_cuda aa_share=False {w3:.4f} ms (render_fwd_kernel "
                      f"{device_ms(per_sample, 'render_fwd_kernel')} a call)")
            print(f"[entry-time] {label} {'demo' if n == 0 else f'{n}_spheres'} "
                  f"{LARGE_RES[0]}x{LARGE_RES[1]} depth {depth}: render_image_cuda "
                  f"{w2:.4f} ms (render_fwd_kernel {device_ms(shared, 'render_fwd_kernel')} "
                  f"a call); render_image_adaptive_cuda {w7:.4f} ms (render_list_kernel "
                  f"{device_ms(adaptive, 'render_list_kernel')} a call, its centers pass "
                  f"render_fwd_kernel {device_ms(adaptive, 'render_fwd_kernel')}); "
                  f"render_image_cuda no AA {w1:.4f} ms (render_fwd_kernel "
                  f"{device_ms(none, 'render_fwd_kernel')} a call){ps} | {card}")
    for name, nregs, st, ld, stack in ptxas_lines(small_regs):
        print(f"[entry-regs] {label} render_fwd_small.cu {name}: {nregs} registers, spill "
              f"stores {st} B, loads {ld} B, stack {stack} B")
    # The large-scene tables: kernel 3 alone (CUDA events; with its scale where the
    # tree's launch takes one, as its render path launches it) and the frame's
    # tables through render_cuda.large_scene_tables (device and host ms a call).
    import inspect
    from python_ray_tracer_tpu_torch.ops.cuda import cull_tables as ct
    from python_ray_tracer_tpu_torch.ops.cuda import hit_extents_cuda as hx
    from python_ray_tracer_tpu_torch.ops.cuda import render_cuda
    with_scale = "scale" in inspect.signature(hx.launch).parameters
    W, H = LARGE_RES
    for n in (100, 1000):
        scene = scene_of(rt, cfg, n, dev)
        k = ct.list_capacity(n)
        vis = (*ct.tile_visibility(cam, scene, compat=True, K=k), k)
        packed = (render_cuda.pack_params(cam, scene, True).to(dev),
                  render_cuda.scene_tables(scene), counts(scene))
        ext = torch.empty((vis[1].numel(), 8), device=dev)
        kw = dict(scale=torch.empty(1, device=dev)) if with_scale else {}
        for aa in (False, True):
            k3 = 1e3 * rt.time_fn(hx.launch, ext, *packed, W=W, H=H, aliasing=aa, compat=True,
                                  n_levels=1, vis=vis, **kw, warmup=2, iters=50)
            tables = host_and_device_ms(lambda: render_cuda.large_scene_tables(
                cam, scene, depth=2, aliasing=aa, compat=True))
            print(f"[entry-tables] {label} {n}_spheres {W}x{H} {'aa' if aa else 'noaa'}: "
                  f"hit_extents kernel alone {k3:.4f} ms"
                  f"{' (with its scale)' if with_scale else ''}; large_scene_tables "
                  f"{tables[0]:.4f} / {tables[1]:.4f} ms (device / host a call: the primary "
                  f"lists, hit extents, shadow lists, bounce tree, light cells) | {card}")


def ab_times(torch, rt, card: str, dev, label: str) -> None:
    """``--ab-times DIR``: the backward kernel (TPU kernel 4) and the soft
    forward kernel (TPU kernel 5) of one checkout's package, through entry
    points whose signatures every tree of the port shares, so that two
    checkouts' lines can be set side by side in one call (parent, this, this,
    parent). ``[ab-bwd]``: the four backward modes at the fit CLI's shapes
    (1000x1000, depth 2, compat, the 2-sphere scene from its shifted centers),
    each wrapper's time (CUDA events), the device time a call of its
    kernels (torch.profiler: the backward kernel, its reduction and, in
    fused_aa, the aa_shared render) and a digest of its gradients.
    ``[ab-frames]``: digests of the render's main-path frames (the demo
    scene and 1000 spheres at 1000x1000 AA and 1080p). ``[ab-soft]``: the soft forward at every
    tau on the demo scene at 1000x1000 and 100 spheres at 512x512 (from the
    soft fit's shifted centers), wrapper and device ms and a SHA-256 digest of
    each frame's bytes. ``[ab-softbwd]``: digests of both soft backward modes'
    gradients at tau 0.05 on those shapes. ``[bwd-regs]``: ptxas's rows of the
    checkout's backward and soft forward sources. ``[ab-kernel]``:
    :func:`ab_kernels`."""
    import hashlib
    from torch.profiler import ProfilerActivity, profile
    from python_ray_tracer_tpu_torch import cli
    from python_ray_tracer_tpu_torch.ops.cuda import _build
    from python_ray_tracer_tpu_torch.ops.cuda import render_bwd_cuda as rb
    from python_ray_tracer_tpu_torch.ops.cuda import soft_bwd_cuda as sb
    from python_ray_tracer_tpu_torch.utils.config import RenderConfig
    regs = bwd_regs_start(_build.CSRC_DIR)

    def device_ms(fn, names, calls=5):
        fn()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
        us = dict.fromkeys(names, 0.0)
        for e in prof.key_averages():
            for k in names:
                if k in e.key:
                    us[k] += getattr(e, "self_device_time_total",
                                     getattr(e, "self_cuda_time_total", 0.0))
        total = sum(us.values())
        parts = ", ".join(f"{k} {v / 1e3 / calls:.4f}" for k, v in us.items())
        return (f"{total / 1e3 / calls:.4f} ms ({parts})" if total > 0 else "not measured")

    def digest(t):
        return hashlib.sha256(t.detach().contiguous().cpu().numpy().tobytes()).hexdigest()[:16]

    cfg = RenderConfig()
    scene = cli.fit_scene_two_spheres(cfg, dev)
    init = rt.Scene.from_leaves(scene.leaves())
    init.spheres = rt.Spheres(scene.spheres.center + torch.tensor([0.2, -0.15, 0.1], device=dev),
                              scene.spheres.radius, scene.spheres.albedo)
    cam = rt.Camera.build(FIT_RES, cfg.camera_position, cfg.camera_euler, cfg.fov, device=dev)
    for aa in (False, True):
        target = rt.render_image_cuda(cam, scene, depth=2, aliasing=aa)
        img = rt.render_image_cuda(cam, init, depth=2, aliasing=aa)
        cot = (2.0 * (img - target) / img.numel()).contiguous()
        names = ("render_bwd_kernel", "reduce_rows_kernel") + (("render_fwd_kernel",)
                                                               if aa else ())
        for mode, fn in ((f"fused_{'aa' if aa else 'noaa'}", lambda: rb.loss_and_scene_grads_cuda(
                             cam, init, target, depth=2, aliasing=aa)),
                         (f"cot_{'aa' if aa else 'noaa'}", lambda: rb.scene_grads_cuda(
                             cam, init, cot, depth=2, aliasing=aa))):
            out = fn()
            flat = rb.flatten_grads(out[1], None, out[0]) if mode.startswith("fused") else \
                rb.flatten_grads(out)
            wrapper = 1e3 * rt.time_fn(fn, warmup=2, iters=20)
            dms = device_ms(fn, names if mode.startswith("fused") else names[:2])
            print(f"[ab-bwd] {label} {mode} {FIT_RES[0]}x{FIT_RES[1]} d2: wrapper {wrapper:.4f} ms, "
                  f"device {dms} a call, gradient digest {digest(flat)} | {card}")
    # the main paths' frames (the demo scene's, and the large-scene path's at 1000
    # spheres), each frame's digest
    for name, n in (("demo", 0), ("100 spheres", 100), ("1000 spheres", 1000)):
        sc = scene_of(rt, cfg, n, dev)
        line = []
        for res, aa in ((FIT_RES, True), ((1920, 1080), False), ((1920, 1080), True)):
            frame = rt.render_image_cuda(rt.default_camera(res, device=dev), sc, aliasing=aa)
            line.append(f"{res[0]}x{res[1]} {'AA' if aa else 'no AA'} {digest(frame)}")
        print(f"[ab-frames] {label} {name}: " + ", ".join(line))
    for name, res in SOFT_TIMES:
        base = scene_of(rt, cfg, 0 if name == "demo" else 100, dev)
        sc = rt.Scene.from_leaves(base.leaves())
        sc.spheres = rt.Spheres(base.spheres.center + torch.tensor(cli.FIT_SHIFT, device=dev),
                                base.spheres.radius, base.spheres.albedo)
        camr = rt.default_camera(res, device=dev)
        for tau in SOFT_TAUS:
            def fwd():
                return rt.render_image_soft_cuda(camr, sc, tau=tau)
            frame = fwd()
            wrapper = 1e3 * rt.time_fn(fwd, warmup=2, iters=10)
            print(f"[ab-soft] {label} {name} {res[0]}x{res[1]} tau={tau}: wrapper {wrapper:.4f} ms, "
                  f"device {device_ms(fwd, ('soft_fwd_kernel',))} a call, frame digest "
                  f"{digest(frame)} | {card}")
        tgt = rt.render_image_soft_cuda(camr, base, tau=0.05)
        cot = (2.0 * (rt.render_image_soft_cuda(camr, sc, tau=0.05) - tgt) / tgt.numel()).contiguous()
        loss, sg, cg = sb.soft_loss_and_grads_cuda(camr, sc, tgt, tau=0.05, return_camera=True)
        fused = rb.flatten_grads(sg, cg, loss)
        grads = rb.flatten_grads(*sb.soft_scene_grads_cuda(camr, sc, cot, tau=0.05,
                                                           return_camera=True))
        print(f"[ab-softbwd] {label} {name} {res[0]}x{res[1]} tau=0.05: fused digest "
              f"{digest(fused)}, cotangent digest {digest(grads)}")
    ab_kernels(torch, rt, card, dev, label)
    bwd_regs_print(regs, label)


def ab_kernels(torch, rt, card: str, dev, label: str) -> None:
    """``[ab-kernel]`` (part of :func:`ab_times`): kernels alone (CUDA events,
    launches on inputs packed once) through a checkout's package, with
    keywords every tree of the port shares: render ``aa_shared`` 1000x1000 and
    ``aa_none`` 1080p on the demo scene, the large-scene render (the CLI's
    scene and camera, 1080p, depth 2, no AA and AA) at 100 and 1000 spheres
    with the tables of ``large_scene_tables``' defaults, the hard backward at
    1000x1000 d2 on the fit scene (``fused_noaa``, the two-launch step's
    ``fused_aa``, the one-launch ``fused_aa1`` and ``cot_aa`` on the fit's
    first cotangent), and the fused soft backward at tau 0.05
    on the demo scene and 100 spheres, from the fit's shifted centers."""
    from python_ray_tracer_tpu_torch import cli
    from python_ray_tracer_tpu_torch.ops.cuda import render_bwd_cuda as rb, render_cuda
    from python_ray_tracer_tpu_torch.ops.cuda import soft_bwd_cuda as sb
    from python_ray_tracer_tpu_torch.ops.cuda.soft_cuda import render_image_soft_cuda
    from python_ray_tracer_tpu_torch.utils.config import RenderConfig

    def ms(fn, iters=30):
        return 1e3 * rt.time_fn(fn, warmup=3, iters=iters)
    out = []
    demo = rt.default_scene(device=dev)
    for mode, (W, H) in (("aa_shared", (1000, 1000)), ("aa_none", (1920, 1080))):
        cam = rt.default_camera((W, H), device=dev)
        buf = torch.empty((W, H, 3), device=dev)
        prm = render_cuda.pack_params(cam, demo, True).to(dev)
        tabs = render_cuda.scene_tables(demo)
        out.append((f"render {mode} {W}x{H}", ms(lambda: render_cuda.launch(
            buf, prm, tabs, counts(demo), depth=2, mode=mode, compat=True, cheap_shadow=True))))
    cfg = RenderConfig()
    for n in LV_TIME_NS:
        sc = scene_of(rt, cfg, n, dev)
        cam = rt.Camera.build(LARGE_RES, cfg.camera_position, cfg.camera_euler, cfg.fov,
                              device=dev)
        buf = torch.empty((*LARGE_RES, 3), device=dev)
        prm = render_cuda.pack_params(cam, sc, True).to(dev)
        tabs = render_cuda.scene_tables(sc)
        for aa in (False, True):
            mode = "aa_shared" if aa else "aa_none"
            vis, shadow, tree, cells = render_cuda.large_scene_tables(
                cam, sc, depth=2, aliasing=aa, compat=True)
            out.append((f"render {mode} {n} spheres {LARGE_RES[0]}x{LARGE_RES[1]}", ms(
                lambda: render_cuda.launch(buf, prm, tabs, counts(sc), depth=2, mode=mode,
                                           compat=True, cheap_shadow=True, vis=vis,
                                           shadow=shadow, tree=tree, cells=cells),
                iters=20)))
    fs = cli.fit_scene_two_spheres(RenderConfig(), dev)
    shift = torch.tensor(cli.FIT_SHIFT, device=dev)
    cam = rt.default_camera(FIT_RES, device=dev)
    init = rt.Scene.from_leaves(fs.leaves())
    init.spheres = rt.Spheres(fs.spheres.center + shift, fs.spheres.radius, fs.spheres.albedo)
    prm = render_cuda.pack_params(cam, init, True).to(dev)
    tabs = render_cuda.scene_tables(init)
    for mode in ("fused_noaa", "fused_aa", "fused_aa1", "cot_aa"):
        aa, one = mode != "fused_noaa", mode == "fused_aa1"
        m = "fused_aa" if one else mode
        fused = m.startswith("fused")
        tgt = rt.render_image_cuda(cam, fs, aliasing=aa)
        img = rt.render_image_cuda(cam, init, aliasing=True) if m == "fused_aa" and not one \
            else None
        if not fused:   # the fit's first cotangent
            img = (2.0 * (rt.render_image_cuda(cam, init, aliasing=True) - tgt)
                   / tgt.numel()).contiguous()
        shape = rb.launch_plan(cam, init, m, one_launch=one)
        n = rb.n_grads(*counts(fs), fused)
        o, part = torch.empty(n, device=dev), torch.empty(n * shape.blocks, device=dev)
        rec = torch.empty(rb.rec_floats(shape, 2), device=dev) if one else None
        out.append((f"backward {mode} {FIT_RES[0]}x{FIT_RES[1]} d2", ms(lambda: rb.launch(
            o, part, prm, tabs, counts(fs), image=img, target=tgt if fused else None,
            W=FIT_RES[0], H=FIT_RES[1], depth=2, mode=m, compat=True, cheap_shadow=True,
            shape=shape, one_launch=one, rec=rec))))
    for name, scene, (W, H) in (("demo", demo, FIT_RES),
                                ("100 spheres", scene_of(rt, cfg, 100, dev), (512, 512))):
        cam = rt.default_camera((W, H), device=dev)
        sc = rt.Scene.from_leaves(scene.leaves())
        sc.spheres = rt.Spheres(scene.spheres.center + shift, scene.spheres.radius,
                                scene.spheres.albedo)
        tgt = render_image_soft_cuda(cam, scene, tau=0.05)
        c = counts(scene)
        shape = sb.plan(*c, True)
        n = rb.n_grads(*c, True)
        o, part = torch.empty(n, device=dev), torch.empty(n * sb.n_blocks(W, H, shape), device=dev)
        prm = render_cuda.pack_params(cam, sc, False).to(dev)
        tabs = render_cuda.scene_tables(sc)
        out.append((f"soft fused {name} {W}x{H} tau 0.05", ms(lambda: sb.launch(
            o, part, prm, tabs, c, image=tgt, W=W, H=H, tau=0.05, mode="fused", shape=shape),
            iters=20)))
    print(f"[ab-kernel] {label}: " + "; ".join(f"{k} {v:.4f} ms" for k, v in out) +
          f" | {card}")


# --- phase 22: the ray-parallel path ---------------------------------------------

PAR_RES = (1000, 1000)            # the demo scene's slices: 2, 4 and 8 (125 wide)
PAR_BIG = (1000, (1920, 1080), (2, 8))   # spheres, size, slices (960 and 240 wide)
PAR_STEP_SLICES = 4               # slices of the fused steps held against the frame
PAR_FIT_STEPS = 5                 # sharded fit_scene steps of the two-rank run
REPAIR_NS = 7753                  # the largest scene the render takes (1 plane, 3 lights)
REPAIR_RES = (64, 64)
REPAIR_DEPTH = 1                  # the plain version's depth at 7753 spheres (its memory)
# At 7753 spheres more pixels hold a near-tie hit or shadow decision than the
# 0.1% that render_bwd_cuda.held_out takes out (22-140 of 4096 at 64x64 from
# BENCH_POSE), and one grazing shadow decision can move one sphere's albedo
# gradient by 0.3-0.5% while its pixel moves by less than 1e-5 (the plain
# version in float32 and float64 agree there: the kernel's pinned arithmetic
# decides the tie the other way). The repair check also holds out every pixel
# whose kernel and plain renders differ by more than REPAIR_TIE: 16 float32
# ulps at 1.0, ~20x their rounding differences.
REPAIR_TIE = 2e-6
REPAIR_SOFT_PIXELS = 3            # the soft check's cotangent: the strongest edges
TIME_NS = (4000, 7753)            # the step times past the old limits
# [repair-form]: scenes on each side of the hard planner's form bands
# (render_bwd_cuda.plan; 1 plane, 3 lights) and the modes timed there
FORM_HARD = ((1000, ("cot_noaa", "cot_aa", "fused_noaa", "fused_aa")), (1800, ("fused_noaa",)),
             (2400, ("fused_noaa",)), (3000, ("fused_noaa", "fused_aa")), (4080, ("fused_noaa",)))


def _par_rank(rank, port, q):
    """One rank of phase 22's two-rank run on the one card (gloo): the frame
    gathered from the ranks' slices, then PAR_FIT_STEPS sharded fit_scene
    steps; rank 0 also renders the whole frame, runs the single-process fit
    and times the all-reduce of the step's flat vector. Puts a dict."""
    try:
        sys.path.insert(0, ROOT)
        import torch
        import python_ray_tracer_tpu_torch as rt
        from python_ray_tracer_tpu_torch import cli, train
        from python_ray_tracer_tpu_torch.ops.cuda import _build, render_bwd_cuda as rb
        from python_ray_tracer_tpu_torch.parallel import (distributed, gather_framebuffer,
                                                          initialize, make_mesh,
                                                          render_image_sharded)
        from python_ray_tracer_tpu_torch.utils.config import RenderConfig
        _build.load_library()
        dev = torch.device("cuda", 0)
        initialize(f"tcp://localhost:{port}", world_size=2, rank=rank, backend="gloo")
        mesh = make_mesh()
        out = {"rank": rank, "size": mesh.size}
        scene = rt.default_scene(device=dev)
        cam = rt.default_camera(PAR_RES, device=dev)
        frame = gather_framebuffer(render_image_sharded(cam, scene, mesh), mesh)
        if rank == 0:
            out["frame_equal"] = bool(torch.equal(frame, rt.render_image_cuda(cam, scene)))
        fs = cli.fit_scene_two_spheres(RenderConfig(), dev)
        fcam = rt.default_camera(FIT_RES, device=dev)
        target = rt.render_image_cuda(fcam, fs, aliasing=False)
        init = rt.Scene.from_leaves(fs.leaves())
        init.spheres = rt.Spheres(fs.spheres.center + torch.tensor(cli.FIT_SHIFT, device=dev),
                                  fs.spheres.radius, fs.spheres.albedo)
        kw = dict(steps=PAR_FIT_STEPS, lr=1e-2, depth=2, trainable=("spheres.center",))
        rb.reset_launch_counts()
        distributed.reset_counts()
        _, out["losses"] = train.fit_scene(init, fcam, target, mesh=mesh, **kw)
        out["all_reduce"] = distributed.COLLECTIVES["all_reduce"]
        out["fused_noaa"] = rb.LAUNCHES["fused_noaa"]
        t = torch.zeros(rb.n_grads(2, 1, 2, True), device=dev)
        torch.distributed.barrier()
        for _ in range(3):
            distributed.all_reduce_sum(t, mesh)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(20):
            distributed.all_reduce_sum(t, mesh)
        torch.cuda.synchronize()
        out["all_reduce_ms"] = 1e3 * (time.perf_counter() - t0) / 20
        if rank == 0:
            _, out["single"] = train.fit_scene(init, fcam, target, **kw)
        torch.distributed.destroy_process_group()
        q.put(out)
    except Exception as e:   # the parent fails the phase on it
        import traceback
        q.put({"rank": rank, "error": traceback.format_exc() or repr(e)})


def _plain_chunked(torch, fn, width: int, chunk: int, g):
    """A plain flat gradient as the sum of its column slices' (``fn(x0, lw,
    g slice)``), chunk columns at a time: the plain version's memory at 7753
    spheres."""
    total = 0
    for x0 in range(0, width, chunk):
        lw = min(chunk, width - x0)
        total = total + fn(x0, lw, g[x0:x0 + lw])
    return total


def _hard_against_plain(torch, rt, rb, cam, scene, aa: bool) -> dict:
    """The hard backward's cotangent mode against its plain version at
    REPAIR_DEPTH on a scene past the staged forms: a seeded cotangent with the
    held-out pixels (rb.held_out, and every pixel whose two renders differ by
    more than REPAIR_TIE: one grazing shadow decision there moves one albedo
    gradient off both plain float32 and float64) zeroed, the plain version
    summed over column slices (its memory). Returns ``ok``, the rule's
    numbers, the largest difference and a line for the log."""
    from python_ray_tracer_tpu_torch.ops.render import render_image
    dev = cam.position.device
    W, H = cam.resolution
    kw = dict(depth=REPAIR_DEPTH, aliasing=aa)
    img_k = rt.render_image_cuda(cam, scene, **kw)
    with torch.no_grad():
        img_p = torch.cat([render_image(cam, scene, x_offset=x0, local_width=8, **kw)
                           for x0 in range(0, W, 8)])
    held = (rb.held_out(img_k, img_p) |
            ((img_k - img_p).abs().amax(-1) > REPAIR_TIE))[..., None]
    g = seeded(torch, (W, H, 3), dev, 5) * 1e-2 * ~held
    k = rb.flatten_grads(*rb.scene_grads_cuda(cam, scene, g.contiguous(), return_camera=True,
                                              **kw))
    t0 = time.perf_counter()
    chunk = max(1, (4 if aa else 16) * REPAIR_NS // scene.spheres.count)
    p = _plain_chunked(torch, lambda x0, lw, gs: rb.scene_grads_plain(
        cam, scene, gs, x_offset=x0, local_width=lw, **kw), W, chunk, g)
    plain_s = time.perf_counter() - t0
    rule = rb.grad_rule(k, p, *counts(scene))
    worst = max(rule.items(), key=lambda kv: kv[1][0])
    ok = all(v for _, v in rule.values())
    return {"ok": ok, "rule": rule, "err": float((k - p).abs().max()), "plain_s": plain_s,
            "line": f"against the plain version (column chunks of {chunk}, {plain_s:.1f} s; "
                    f"{int(held.sum())} pixels held out): ok {ok}, worst {worst[0]} "
                    f"{worst[1][0]:.3g}"}


def parallel_phase(torch, rt, card: str, dev) -> None:
    """Phase 22 (``[ray-par]``, ``[repair]``, ``[animate]``): frames stitched
    from slices against the whole frame (``torch.equal``) in the three render
    modes, on the demo scene at 1000x1000 over 2, 4 and 8 slices and at 1000
    spheres 1080p over 2 and 8 with every cull on; the hard fused step (no AA,
    AA) and the soft fused step: the partials of 4 slices summed against the
    frame's (loss rel 1e-6, gradients under grad_rule / soft_grad_rule); two
    ranks on the one card over gloo (the gathered frame, 5 sharded fit_scene
    steps against the single-process fit, one all-reduce a step, the
    all-reduce's time); times of the frame against the sum of its slices;
    the repair: the backward kernels at 7753 spheres against their plain
    versions, the global form against the staged one (bits hard, the rule
    soft) and both timed on scenes on each side of the planners' rules
    (``[repair-form]``), the
    step at 4000 and 7753 spheres; and ``cli animate`` at 256x256, 24 frames,
    against single renders."""
    from python_ray_tracer_tpu_torch import animation, cli
    from python_ray_tracer_tpu_torch.ops.cuda import (hit_extents_cuda, light_cells_cuda,
                                                      render_bwd_cuda as rb, render_cuda,
                                                      shadow_lists_cuda, soft_bwd_cuda as sb,
                                                      soft_cuda)
    from python_ray_tracer_tpu_torch.ops.render import render_image
    from python_ray_tracer_tpu_torch.ops.soft import render_rays_soft
    from python_ray_tracer_tpu_torch.parallel import make_mesh, render_image_sharded
    from python_ray_tracer_tpu_torch.parallel.mesh import column_slice
    from python_ray_tracer_tpu_torch.utils.config import RenderConfig
    wrappers = (render_cuda, hit_extents_cuda, shadow_lists_cuda, light_cells_cuda, rb, sb,
                soft_cuda)

    def reset():
        for m in wrappers:
            m.reset_launch_counts()

    def launches():
        return {k: v for m in wrappers for k, v in m.LAUNCHES.items() if v}

    demo = rt.default_scene(device=dev)
    big = rt.random_scene(PAR_BIG[0], generator=torch.Generator().manual_seed(0), device=dev)

    # Slices against the whole frame (the main path of this phase: counts read after).
    reset()
    for label, scene, (W, H), ns in (("demo", demo, PAR_RES, (2, 4, 8)),
                                     (f"{PAR_BIG[0]} spheres", big, PAR_BIG[1], PAR_BIG[2])):
        cam = rt.default_camera((W, H), device=dev)
        for mode in render_cuda.MODES:
            kw = dict(aliasing=mode != "aa_none", aa_share=mode == "aa_shared")
            whole = rt.render_image_cuda(cam, scene, **kw)
            for n in ns:
                st = torch.cat([render_image_sharded(cam, scene, make_mesh(size=n, rank=i), **kw)
                                for i in range(n)])
                eq = torch.equal(st, whole)
                print(f"[ray-par] {label} {W}x{H} {mode}: {n} slices of {W // n} stitched, "
                      f"torch.equal {eq}")
                check(eq, f"{label} {mode}: {n} slices differ from the whole frame "
                          f"(max {float((st - whole).abs().max())})")
    got = launches()
    print(f"[ray-par] launches of the slices' path: {got}")
    for k in ("aa_none", "aa_per_sample", "aa_shared", "hit_extents", "shadow_lists",
              "light_cells"):
        check(any(v > 0 for kk, v in got.items() if kk == k), f"slices launched no {k}")

    # Times: the whole frame against the sum of its 8 slices' (render).
    for label, scene, (W, H) in (("demo", demo, PAR_RES), (f"{PAR_BIG[0]} spheres", big,
                                                           PAR_BIG[1])):
        cam = rt.default_camera((W, H), device=dev)
        whole_ms = 1e3 * rt.time_fn(rt.render_image_cuda, cam, scene, warmup=2, iters=10)
        part = [1e3 * rt.time_fn(render_image_sharded, cam, scene, make_mesh(size=8, rank=i),
                                 warmup=1, iters=5) for i in range(8)]
        print(f"[ray-par-time] render aa_shared {label} {W}x{H}: whole frame {whole_ms:.4f} ms, "
              f"8 slices {sum(part):.4f} ms summed (each {min(part):.4f}-{max(part):.4f}) | {card}")

    # The fused steps: 4 slices' partials against the frame's.
    fs = cli.fit_scene_two_spheres(RenderConfig(), dev)
    fcam = rt.default_camera(FIT_RES, device=dev)
    shift = torch.tensor(cli.FIT_SHIFT, device=dev)

    def shifted(scene):
        s = rt.Scene.from_leaves(scene.leaves())
        s.spheres = rt.Spheres(scene.spheres.center + shift, scene.spheres.radius,
                               scene.spheres.albedo)
        return s

    def step_case(label, fn, target, rule, cnt):
        W = fcam.resolution[0]

        def whole():
            lo, g, c = fn(target, 0, W)
            return rb.flatten_grads(g, c, lo)

        def part(i):
            x0, lw = column_slice(W, i, PAR_STEP_SLICES)
            lo, g, c = fn(target[x0:x0 + lw].contiguous(), x0, lw)
            return rb.flatten_grads(g, c, lo)
        a = whole()
        b = sum(part(i) for i in range(PAR_STEP_SLICES))
        rel = abs(float(b[-1]) - float(a[-1])) / abs(float(a[-1]))
        res = rule(b, a, *cnt)
        worst = max(res.items(), key=lambda kv: kv[1][0])
        print(f"[ray-par] {label}: loss {float(a[-1]):.8g}, {PAR_STEP_SLICES} slices "
              f"{float(b[-1]):.8g} (rel {rel:.3g}); gradients ok "
              f"{all(ok for _, ok in res.values())}, worst {worst[0]} {worst[1][0]:.3g}")
        check(rel <= 1e-6, f"{label}: slices' loss rel {rel}")
        check(all(ok for _, ok in res.values()), f"{label}: slices' gradients {res}")
        whole_ms = 1e3 * rt.time_fn(whole, warmup=2, iters=10)
        part_ms = [1e3 * rt.time_fn(part, i, warmup=1, iters=5) for i in range(PAR_STEP_SLICES)]
        print(f"[ray-par-time] {label}: whole frame {whole_ms:.4f} ms, {PAR_STEP_SLICES} "
              f"slices {sum(part_ms):.4f} ms summed | {card}")

    init = shifted(fs)
    for aa in (False, True):
        target = rt.render_image_cuda(fcam, fs, aliasing=aa)
        step_case(f"hard fused step, {'AA' if aa else 'no AA'}, {FIT_RES[0]}x{FIT_RES[1]} d2",
                  lambda t, x0, lw, aa=aa: rb.loss_and_scene_grads_cuda(
                      fcam, init, t, aliasing=aa, return_camera=True, x_offset=x0,
                      local_width=lw), target, rb.grad_rule, counts(fs))
    starget = soft_cuda.render_image_soft_cuda(fcam, demo, tau=0.05)
    sinit = shifted(demo)
    step_case(f"soft fused step, tau 0.05, demo {FIT_RES[0]}x{FIT_RES[1]}",
              lambda t, x0, lw: sb.soft_loss_and_grads_cuda(
                  fcam, sinit, t, tau=0.05, return_camera=True, x_offset=x0,
                  local_width=lw), starget, sb.soft_grad_rule, counts(demo))
    got = launches()
    print(f"[ray-par] launches through phase 22's steps: {got}")
    check(got.get("fused_noaa", 0) > 0 and got.get("fused_aa1", 0) > 0 and
          got.get("fused", 0) > 0, f"the sharded steps' kernels did not launch: {got}")

    # Two ranks on the one card (gloo).
    import socket
    import torch.multiprocessing as mp
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    ctx = mp.get_context("spawn")
    q = ctx.Queue()
    procs = [ctx.Process(target=_par_rank, args=(r, port, q)) for r in (0, 1)]
    for p in procs:
        p.start()
    try:
        res = sorted((q.get(timeout=600) for _ in procs), key=lambda r: r["rank"])
        for p in procs:
            p.join(timeout=60)
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join()
    for r in res:
        check("error" not in r, f"rank {r['rank']}: {r.get('error')}")
    r0, r1 = res
    rel = max(abs(a - b) / abs(b) for a, b in zip(r0["losses"], r0["single"]))
    print(f"[ray-par] two ranks on one card (gloo): gathered frame torch.equal "
          f"{r0['frame_equal']}; sharded fit losses {r0['losses']} vs single-process "
          f"{r0['single']} (rel {rel:.3g}); all-reduces {r0['all_reduce']} / "
          f"{r1['all_reduce']} in {PAR_FIT_STEPS} steps; fused_noaa launches "
          f"{r0['fused_noaa']} / {r1['fused_noaa']}")
    check(r0["frame_equal"], "the gathered frame differs from the whole frame")
    check(r0["losses"] == r1["losses"], "the ranks' losses differ")
    check(rel <= 1e-5, f"sharded fit losses rel {rel} off the single-process fit's")
    check(r0["all_reduce"] == r1["all_reduce"] == PAR_FIT_STEPS, "not one all-reduce a step")
    check(r0["fused_noaa"] == r1["fused_noaa"] == PAR_FIT_STEPS, "not one launch a step")
    print(f"[ray-par-time] all-reduce of the step's {rb.n_grads(2, 1, 2, True)} floats: "
          f"{r0['all_reduce_ms']:.4f} / {r1['all_reduce_ms']:.4f} ms (gloo between two "
          f"processes on one card, host clock; says nothing of NCCL across cards) | {card}")

    # The repair: the backward kernels past the staged size.
    huge = rt.random_scene(REPAIR_NS, generator=torch.Generator().manual_seed(1), device=dev)
    # outside the sphere cloud (the CLI's camera sits inside it at this density)
    cam = rt.Camera.build(REPAIR_RES, *BENCH_POSE, device=dev)
    W, H = REPAIR_RES
    cnt = counts(huge)
    for aa in (False, True):
        mode = "cot_aa" if aa else "cot_noaa"
        shape = rb.launch_plan(cam, huge, mode)
        check(not shape.staged, f"{mode} at {REPAIR_NS} spheres planned staged: {shape}")
        res = _hard_against_plain(torch, rt, rb, cam, huge, aa)
        print(f"[repair] hard backward {mode} at {REPAIR_NS} spheres {W}x{H} d{REPAIR_DEPTH}: "
              f"plan {shape}; {res['line']}")
        check(res["ok"], f"{mode} at {REPAIR_NS} spheres: {res['rule']}")
    sshape = sb.plan(*cnt, False)
    check(not sshape.staged, f"soft cot at {REPAIR_NS} spheres planned staged: {sshape}")
    # the soft frame's strongest edges: pixels with partial covers (elsewhere
    # this dense cloud is opaque and in shadow, and the gradients are ~0)
    simg = soft_cuda.render_image_soft_cuda(cam, huge, tau=0.05)
    pixels = _edge_pixels(torch, simg, REPAIR_SOFT_PIXELS)
    g = torch.zeros((W, H, 3), device=dev)
    for i, (x, y) in enumerate(pixels):
        g[x, y] = seeded(torch, (3,), dev, 20 + i) + 0.5
    k = rb.flatten_grads(*sb.soft_scene_grads_cuda(cam, huge, g, tau=0.05, return_camera=True))
    t0 = time.perf_counter()
    p = 0
    for x, y in pixels:
        # one pixel's VJP: its ray alone (a column of 64 would not fit the card)
        def objective(c, s, x=x, y=y):
            d = c.ray_directions(torch.tensor([[float(x), float(y)]], device=dev),
                                 compat=False)
            rgb = render_rays_soft(c.ray_origin().expand(d.shape), d, s, tau=0.05)
            return (rgb[0] * g[x, y]).sum(), None
        p = p + rb._autograd_flat(cam, huge, objective)
        torch.cuda.empty_cache()
    plain_s = time.perf_counter() - t0
    res = sb.soft_grad_rule(k, p, *cnt)
    worst = max(res.items(), key=lambda kv: kv[1][0])
    live = int((rb.grad_groups(k.double().cpu(), *cnt)["spheres.center"].abs().sum(1) > 0).sum())
    print(f"[repair] soft backward cot at {REPAIR_NS} spheres {W}x{H}, cotangent on "
          f"pixels {pixels} ({live} spheres with a gradient): plan {sshape}; against the plain version "
          f"({plain_s:.1f} s): ok {all(ok for _, ok in res.values())}, worst {worst[0]} "
          f"{worst[1][0]:.3g}")
    check(all(ok for _, ok in res.values()), f"soft cot at {REPAIR_NS} spheres: {res}")

    # The global form against the staged one on scenes both take (the hard
    # kernel's bits, the soft kernel's rule) and the kernel-alone times behind
    # the planners' rules, each plan timed in alternation (A, B, B, A).
    def form(p):
        return f"{'staged' if p.staged else 'global'} {p.nt} threads"

    cam = rt.Camera.build((256, 256), *BENCH_POSE, device=dev)
    for n_s, modes in FORM_HARD:
        sc = rt.random_scene(n_s, generator=torch.Generator().manual_seed(2), device=dev)
        cnt = counts(sc)
        params = render_cuda.pack_params(cam, sc, True).to(dev)
        tables = render_cuda.scene_tables(sc)
        cheap = render_cuda.shadow_cheap_ok(sc, True)
        cot = seeded(torch, (256, 256, 3), dev, 6) * 1e-2
        tgt = rt.render_image_cuda(cam, sc, aliasing=False, group_cull=False) * 0.9
        img_aa = rt.render_image_cuda(cam, sc, aliasing=True, group_cull=False)
        for mode in modes:
            fused = mode.startswith("fused")
            chosen = rb.launch_plan(cam, sc, mode)
            other = rb.launch_plan(cam, sc, mode, staged=not chosen.staged)
            n = rb.n_grads(*cnt, fused)
            image = img_aa if mode == "fused_aa" else (None if fused else cot)
            # the bits: the staged plan and the global form at its very shape
            sp = chosen if chosen.staged else other
            twin = sp._replace(staged=False, smem=rb.smem_bytes(*cnt, fused, mode.endswith("_aa"),
                                                                sp.nt, sp.cols, False))
            runs, outs = {}, {}
            for key, p in ((chosen.staged, chosen), (other.staged, other), ("twin", twin),
                           ("sp", sp)):
                o, part = torch.empty(n, device=dev), torch.empty(n * p.blocks, device=dev)
                runs[key] = (lambda p=p, o=o, part=part: rb.launch(
                    o, part, params, tables, cnt, image=image, target=tgt if fused else None,
                    W=256, H=256, depth=2, mode=mode, compat=True, cheap_shadow=cheap, shape=p))
            eq = torch.equal(runs["sp"]().clone(), runs["twin"]())
            runs = {k: runs[k] for k in (True, False)}
            ms = _alternate(rt, runs, 3 if n_s >= 3000 else 10)
            print(f"[repair-form] hard {mode} d2, {n_s} spheres 256x256: planner's "
                  f"{form(chosen)} {ms[chosen.staged]:.4f} ms, {form(other)} "
                  f"{ms[other.staged]:.4f} ms (kernel and reduction alone, minima of 2 "
                  f"alternating runs); global torch.equal to staged at {sp.nt} threads {eq} | "
                  f"{card}")
            check(eq, f"{mode} at {n_s} spheres: the global form differs from the staged form")
    s100 = rt.random_scene(100, generator=torch.Generator().manual_seed(0), device=dev)
    s1000 = rt.random_scene(1000, generator=torch.Generator().manual_seed(2), device=dev)
    for label, base, res, iters in (("demo", demo, FIT_RES, 10), ("100 spheres", s100, (512, 512), 5),
                                    ("1000 spheres", s1000, (64, 64), 2)):
        cam = rt.default_camera(res, device=dev)
        sc = shifted(base)
        cnt = counts(sc)
        params = render_cuda.pack_params(cam, sc, False).to(dev)
        tables = render_cuda.scene_tables(sc)
        stgt = soft_cuda.render_image_soft_cuda(cam, base, tau=0.05)
        cot = seeded(torch, (*res, 3), dev, 7) * 1e-2
        for mode in sb.MODES:
            fused = mode == "fused"
            chosen = sb.plan(*cnt, fused)
            same = chosen._replace(staged=False, smem=sb.smem_bytes(
                *cnt, fused, chosen.nt, chosen.cap, chosen.cj, chosen.store_vis, False))
            own = sb.plan(*cnt, fused, staged=False)
            n = rb.n_grads(*cnt, fused)
            runs = {}
            for name, p in (("staged", chosen), ("global", same), ("global, own plan", own)):
                o = torch.empty(n, device=dev)
                part = torch.empty(n * sb.n_blocks(*res, p), device=dev)
                runs[name] = (lambda p=p, o=o, part=part: sb.launch(
                    o, part, params, tables, cnt, image=stgt if fused else cot, W=res[0],
                    H=res[1], tau=0.05, mode=mode, shape=p))
            # nvcc contracts the two instantiations differently: the rule, not bits
            a, b = runs["staged"]().clone(), runs["global"]()
            rule = sb.soft_grad_rule(b, a, *cnt)
            worst = max(rule.items(), key=lambda kv: kv[1][0])
            ok = all(v for _, v in rule.values())
            line = (f"[repair-form] soft {mode} tau 0.05, {label} {res[0]}x{res[1]}: plan "
                    f"{chosen.nt} threads, cap {chosen.cap}, cj {chosen.cj}; global against "
                    f"staged: torch.equal {torch.equal(a, b)}, max |d| "
                    f"{float((a - b).abs().max()):.3g}, soft_grad_rule ok {ok} (worst "
                    f"{worst[0]} {worst[1][0]:.3g})")
            if fused:
                ms = _alternate(rt, runs, iters)
                line += (f"; staged {ms['staged']:.4f} ms, global {ms['global']:.4f} ms, "
                         f"global with its own plan ({own.nt} threads, cap {own.cap}, cj "
                         f"{own.cj}) {ms['global, own plan']:.4f} ms (kernel and reduction "
                         f"alone, minima of 2 alternating runs)")
            print(f"{line} | {card}")
            check(ok, f"soft {mode}, {label}: the global form off the staged form: {rule}")

    # Step times past the old limits (the planner's form).
    for n_s in TIME_NS:
        sc = rt.random_scene(n_s, generator=torch.Generator().manual_seed(2), device=dev)
        for res in (REPAIR_RES, (256, 256)):
            cam = rt.Camera.build(res, *BENCH_POSE, device=dev)
            tgt = rt.render_image_cuda(cam, sc, aliasing=False, group_cull=False) * 0.9
            shape = rb.launch_plan(cam, sc, "fused_noaa")
            ms = 1e3 * rt.time_fn(rb.loss_and_scene_grads_cuda, cam, sc, tgt, warmup=1, iters=3)
            print(f"[repair-time] hard fused_noaa step d2, {n_s} spheres {res[0]}x{res[1]} "
                  f"({form(shape)}): {ms:.4f} ms | {card}")

    # cli animate on the card, and its frames against single renders.
    reset()
    os.makedirs(OUT_DIR, exist_ok=True)
    path = os.path.join(OUT_DIR, "orbit.gif")
    check(cli.main(["animate", "--backend", "cuda", "--width", "256", "--height", "256",
                    "--frames", "24", "--out", path]) == 0, "cli animate failed")
    with open(path, "rb") as f:
        head = f.read(6)
    check(head == b"GIF89a" and os.path.getsize(path) > 0, f"{path}: not a GIF")
    n_anim = render_cuda.LAUNCHES["aa_shared"]
    cams = animation.orbit_cameras((256, 256), center=[1.0, 0.0, 1.0], radius=4.0,
                                   height=1.5, n_frames=24, device=dev)
    frames = animation.render_frames(cams, demo)
    same = all(torch.equal(frames[k], rt.render_image_cuda(animation.frame_camera(cams, k), demo))
               for k in range(24))
    print(f"[animate] cli animate 256x256, 24 frames: {os.path.relpath(path, ROOT)} "
          f"({os.path.getsize(path)} B), aa_shared launches {n_anim}; render_frames "
          f"torch.equal to single renders on every frame: {same}")
    check(n_anim >= 24 * 5, f"cli animate launched aa_shared {n_anim} times")
    check(same, "render_frames differs from single renders")
    # The GIF writer on this host (numpy, no Pillow): save_animation's time at
    # the 256x256 orbit and at the CLI's default 1000x1000, 24 frames each.
    animate_gif(torch, frames, "256x256", card)
    cams = animation.orbit_cameras((1000, 1000), center=[1.0, 0.0, 1.0], radius=4.0,
                                   height=1.5, n_frames=24, device=dev)
    animate_gif(torch, animation.render_frames(cams, demo), "1000x1000", card)


def gif_images(data: bytes):
    """The delays (hundredths of a second, None without a graphic control
    block) of a GIF file's images, one an image descriptor, found by walking
    its blocks."""
    flags, pos, delay, delays = data[10], 13, None, []
    if flags & 0x80:
        pos += 3 * (2 << (flags & 7))
    while data[pos] != 0x3B:
        kind = data[pos]
        check(kind in (0x21, 0x2C), f"GIF block 0x{kind:02x} at byte {pos}")
        if kind == 0x21:
            if data[pos + 1] == 0xF9:
                delay = data[pos + 4] | (data[pos + 5] << 8)
            pos += 2
        else:
            delays.append(delay)
            delay, local = None, data[pos + 9]
            pos += 10 + (3 * (2 << (local & 7)) if local & 0x80 else 0) + 1
        while data[pos]:
            pos += data[pos] + 1
        pos += 1
    return delays


def animate_gif(torch, frames, label: str, card: str, fps: int = 12) -> None:
    """``[animate]``: write ``frames`` twice with ``animation.save_animation``
    and time each; the two files must be the same bytes, and the file's
    images must follow the merge rule counted from the framebuffers with the
    port's own quantiser: a frame whose quantised pixels equal the previous
    one's adds its delay to it (``int(1000 / fps) * merged // 10``)."""
    import numpy as np
    from python_ray_tracer_tpu_torch import animation
    from python_ray_tracer_tpu_torch.ops.render import to_framebuffer
    from python_ray_tracer_tpu_torch.utils.image import framebuffer_to_array
    from python_ray_tracer_tpu_torch.utils.quantize import adaptive_palette
    files, times = [], []
    for k in range(2):
        path = os.path.join(OUT_DIR, f"orbit_{label}_{k}.gif")
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        animation.save_animation(frames, path, fps=fps)
        times.append(1e3 * (time.perf_counter() - t0))
        with open(path, "rb") as fh:
            files.append(fh.read())
    merged, sizes, last = [], [], None
    for f in frames:
        palette, idx = adaptive_palette(framebuffer_to_array(to_framebuffer(f.cpu())))
        pixels = palette[idx]
        if last is not None and np.array_equal(pixels, last):
            merged[-1] += 1
            continue
        merged.append(1)
        sizes.append(len(palette))
        last = pixels
    data = files[0]
    delays = gif_images(data)
    want = [int(1000 / fps) * m // 10 for m in merged]
    print(f"[animate] save_animation {label}, {len(frames)} frames: {times[0]:.1f} ms, "
          f"again {times[1]:.1f} ms; {len(data)} B; the two "
          f"files equal: {files[0] == files[1]}; {len(delays)} frames written, mean "
          f"palette {sum(sizes) / len(sizes):.1f} colours | {card}")
    check(files[0] == files[1], f"{label} GIF: two writes of the same frames differ")
    check(delays == want, f"{label} GIF: images with delays {delays}, the merge rule "
                          f"counts {want}")


# --- phase 23: scenes of any size; checkpointing, fault recovery, profiling ---------
SIZE_NS = (16384, 65536)           # past every staged form (1 plane, 3 lights)
SIZE_BWD_NS = 16384                # the backward kernels' third form
FORM_NS = (1000, 5000)             # scenes every form takes: each against the staged one
SIZE_RES = (1920, 1080)
SIZE_PARITY_RES = (64, 64)         # the plain versions' frame at SIZE_NS (column slices)
SIZE_FORM_RES = (256, 256)
SOFT_FORM_RES = (64, 64)           # the soft forward's forms (a dense cloud's soft frame is slow)
# The soft backward's third form against its global form at FORM_NS[0]
# spheres: 320 pixel groups of 16 x 8, more than its card-sized grid's 264
# blocks there, so blocks walk groups.
SOFT_ROWS_RES = (320, 128)
# The soft backward's third form at SIZE_BWD_NS spheres: fit_scene_soft's
# frame, with a cotangent on a few pixels (a fused step renders every pixel,
# hours at this density).
SIZE_BWD_SOFT_RES = (1000, 1000)
SIZE_CHUNK = 256                   # the table kernels' chunk where the staged form fits too
LC_MAIN_NS = (100, 1000)           # the light cells' forms at the main path's scenes
SIZE_TAU = 0.02                    # the soft checks' tau: fit_scene_soft's last stage
SIZE_SOFT_PIXELS = 4               # pixels of the soft forward against its plain version
SIZE_SOFT_CANDIDATES = 8           # pixels whose subsets are taken in each order
SIZE_SOFT_MAX_SUBSET = 12288       # spheres of a pixel's plain subset (its memory)
SIZE_SOFT_RES = (8, 8)             # the soft forward's frame at SIZE_NS (seconds at 65536)
SIZE_SEED = 3                      # random_scene(n, generator=torch.Generator().manual_seed(3))


def _soft_subset(torch, cam, scene, x: int, y: int, tau: float, margin: float = 1e-3):
    """The spheres that can have an alpha above 0 on pixel (x, y)'s soft
    rays: its primary ray, and the shadow rays toward every light from the
    blend point of every object whose alpha on the primary ray can be above
    0 (ops/soft.py's covers, in float64, each sphere's dead radius r (1 + 90
    tau) widened by ``margin``). Every other sphere's alpha is below 1e-38 on
    each of those rays (soft_fwd.cu's exact skip), so the plain version over
    the subset is the plain version over the scene, up to float32 rounding
    of its sums: the plain version's memory (objects x spheres x lights a
    ray) then fits at scenes of any size. Returns the sorted indices."""
    c = scene.spheres.center.double()
    r = scene.spheres.radius.double()
    dead2 = (r * (1.0 + 90.0 * tau) + margin) ** 2
    xy = torch.tensor([[float(x), float(y)]], device=c.device)
    d = cam.ray_directions(xy, compat=False)[0].double()
    o = cam.ray_origin().double()

    def live(origins, dirs):                 # (k, 3) rays -> (ns,) any live
        hit = torch.zeros(c.shape[0], dtype=torch.bool, device=c.device)
        for i in range(0, origins.shape[0], 64):
            L = c[None] - origins[i:i + 64, None]
            dd = dirs[i:i + 64, None]
            tca = (L * dd).sum(-1)
            v = L - tca[..., None] * dd
            hit |= ((tca > -margin) & ((v * v).sum(-1) <= dead2)).any(0)
        return hit

    prim = live(o[None], d[None])
    idx = prim.nonzero()[:, 0]
    L = c[idx] - o
    tca = L @ d
    v = L - tca[:, None] * d
    chord2 = r[idx] ** 2 - (v * v).sum(-1)
    t = torch.where(chord2 > 1e-12, tca - chord2.clamp(min=0.0).sqrt(), tca).clamp(min=1e-4)
    pts = [o + t[:, None] * d]
    pl = scene.planes
    for k in range(pl.count):
        n, p0 = pl.normal[k].double(), pl.origin[k].double()
        den = float(n @ d)
        if abs(den) > 1e-8 and float(n @ (p0 - o)) / den > 0:
            pts.append((o + float(n @ (p0 - o)) / den * d)[None])
    P = torch.cat(pts)
    lights = scene.lights.position.double()
    w = lights[None] - P[:, None]
    dirs = w / w.norm(dim=-1, keepdim=True)
    shadow = live(P[:, None].expand(-1, lights.shape[0], -1).reshape(-1, 3), dirs.reshape(-1, 3))
    return (prim | shadow).nonzero()[:, 0]


def _subscene(rt, scene, idx, dtype):
    s = scene.spheres
    sub = rt.Spheres(s.center[idx].to(dtype), s.radius[idx].to(dtype), s.albedo[idx].to(dtype))
    return rt.Scene(sub, *(type(g)(*(t.to(dtype) for t in vars(g).values()))
                           for g in (scene.planes, scene.lights, scene.materials)))


def _soft_pixels_plain(torch, rt, cam, scene, pixels, tau: float, dtype, subsets=None):
    """The plain soft render (ops/soft.py render_rays_soft) of each pixel's
    ray over its :func:`_soft_subset` (``subsets``: already taken), in
    ``dtype``: ``(len(pixels), 3)``."""
    out = []
    for i, (x, y) in enumerate(pixels):
        idx = _soft_subset(torch, cam, scene, x, y, tau) if subsets is None else subsets[i]
        sub = _subscene(rt, scene, idx, dtype)
        xy = torch.tensor([[float(x), float(y)]], device=cam.position.device)
        d = cam.ray_directions(xy, compat=False).to(dtype)
        with torch.no_grad():
            out.append(rt.render_rays_soft(cam.ray_origin().to(dtype)[None], d, sub,
                                           tau=tau)[0])
        torch.cuda.empty_cache()
    return torch.stack(out)


def _soft_check_pixels(torch, cam, scene, tau: float, n: int):
    """Up to ``n`` pixels ``((x, y), subset, live)`` for the soft checks at
    scenes where a pixel inside a dense cloud has most of the scene in its
    :func:`_soft_subset`, ranked by the live spheres on their primary ray
    (``live``, at least one): the pixel nearest the frame's median, the
    densest, then the sparsest ones; each the first of up to
    :data:`SIZE_SOFT_CANDIDATES` in its order whose subset has at most
    :data:`SIZE_SOFT_MAX_SUBSET` spheres (the plain version's memory). Returns
    them and the median live count."""
    W, H = cam.resolution
    c = scene.spheres.center.double()
    dead2 = (scene.spheres.radius.double() * (1.0 + 90.0 * tau) + 1e-3) ** 2
    xy = torch.stack(torch.meshgrid(torch.arange(W), torch.arange(H), indexing="ij"),
                     -1).reshape(-1, 2).float().to(c.device)
    d = cam.ray_directions(xy, compat=False).double()
    L = c[None] - cam.ray_origin().double()
    live = []
    for i in range(0, d.shape[0], 256):
        tca = (L * d[i:i + 256, None]).sum(-1)
        v = L - tca[..., None] * d[i:i + 256, None]
        live.append(((tca > -1e-3) & ((v * v).sum(-1) <= dead2)).sum(-1))
    live = torch.cat(live).cpu()
    ranked = [int(i) for i in torch.argsort(live, stable=True) if live[i] > 0]
    if not ranked:
        return [], 0
    median = int(live[ranked[len(ranked) // 2]])
    out, seen = [], set()

    def take(order, k):
        for i in order[:SIZE_SOFT_CANDIDATES]:
            if k == 0 or len(out) == n:
                return
            if i in seen:
                continue
            seen.add(i)
            sub = _soft_subset(torch, cam, scene, i // H, i % H, tau)
            if sub.numel() <= SIZE_SOFT_MAX_SUBSET:
                out.append(((i // H, i % H), sub, int(live[i])))
                k -= 1
    take(sorted(ranked, key=lambda i: abs(int(live[i]) - median)), 1)
    take(ranked[::-1], 1)
    take(ranked, n)
    return out, median


def _edge_pixels(torch, img, n: int):
    """The ``n`` pixels of a soft frame with the strongest edges."""
    W, H = img.shape[:2]
    edge = torch.zeros((W, H), device=img.device)
    edge[:-1] += (img[1:] - img[:-1]).abs().sum(-1)
    edge[:, :-1] += (img[:, 1:] - img[:, :-1]).abs().sum(-1)
    return [(i // H, i % H) for i in torch.topk(edge.reshape(-1), n).indices.tolist()]


def _alternate(rt, runs: dict, iters: int) -> dict:
    """Each run timed A, B, B, A (CUDA events over ``iters`` calls); the minima."""
    ms = {k: [] for k in runs}
    for k in list(runs) + list(runs)[::-1]:
        ms[k].append(1e3 * rt.time_fn(runs[k], warmup=1, iters=iters))
    return {k: min(v) for k, v in ms.items()}


def scene_size_phase(torch, rt, card: str, dev) -> list:
    """Phase 23, first part (``[size-*]``): every kernel past its staged form.
    On scenes every form takes (FORM_NS spheres, SIZE_FORM_RES), each global
    or chunked form against the staged one: the render kernel in its three
    modes, the worklist kernel, the hit-extent kernel with bounce levels, the
    light-cell and list kernels (torch.equal: pinned sources; the light cells
    also at the main path's LC_MAIN_NS spheres, timed), the soft
    forward (its rule against the plain version, and max |d| to the staged
    form: a contracted source), the hard backward's third form against the
    staged and global forms at the same launch shape (torch.equal) and the
    soft backward's against its global form (soft_grad_rule), with the forms'
    times at the larger scene. Then SIZE_NS spheres: the main render entry
    points at 1080p (their times and forms) with every table kernel inside,
    each against its plain version at SIZE_PARITY_RES (column slices), culls
    on against off, the worklist kernel, hit extents with bounce levels, the
    bounce levels' witness (the plain version in float32 against float64),
    the light cells and the lists against their plain functions, the soft
    forward at SIZE_SOFT_RES against its plain version on a few pixels
    (:func:`_soft_check_pixels`); and the backward kernels at SIZE_BWD_NS in
    their third form against their plain versions (the hard one over the
    frame in column slices, the soft one at SIZE_BWD_SOFT_RES with a
    cotangent on 3 pixels). Returns the kernels line's entries of the new
    forms."""
    from python_ray_tracer_tpu_torch.ops.cuda import (adaptive_cuda as ac, cull_tables as ct,
                                                      hit_extents_cuda as hx,
                                                      light_cells_cuda as lc,
                                                      render_bwd_cuda as rb, render_cuda,
                                                      shadow_lists_cuda as sl,
                                                      soft_bwd_cuda as sb, soft_cuda)
    from python_ray_tracer_tpu_torch.ops.render import render_image
    from python_ray_tracer_tpu_torch.utils import timing
    from python_ray_tracer_tpu_torch.utils.config import RenderConfig
    wrappers = (render_cuda, ac, hx, lc, sl, soft_cuda, rb, sb)

    def reset():
        for m in wrappers:
            m.reset_launch_counts()

    def seeded_scene(n):
        return rt.random_scene(n, generator=torch.Generator().manual_seed(SIZE_SEED), device=dev)

    def plain_frame(cam, scene, **kw):
        W = cam.resolution[0]
        with torch.no_grad():
            return torch.cat([render_image(cam, scene, x_offset=x0, local_width=min(8, W - x0),
                                           **kw) for x0 in range(0, W, 8)])

    entries = {}
    # 1. Every form against the staged form on scenes every form takes.
    cam = rt.Camera.build(SIZE_FORM_RES, *BENCH_POSE, device=dev)
    W, H = SIZE_FORM_RES
    for n in FORM_NS:
        scene = seeded_scene(n)
        cnt = counts(scene)
        packed = render_cuda.packed_inputs(cam, scene, depth=2, compat=True)
        cheap = render_cuda.shadow_cheap_ok(scene, True)
        tabs = {aa: render_cuda.large_scene_tables(cam, scene, depth=2, aliasing=aa, compat=True,
                                                   packed=packed) for aa in (False, True)}
        check(tabs[True][2] is not None, f"{n} spheres: no bounce tree")
        for mode in render_cuda.MODES:
            vis, shadow, tree, cells = tabs[mode != "aa_none"]
            runs = {f: (lambda f=f, o=torch.empty((W, H, 3), device=dev): render_cuda.launch(
                o, *packed, depth=2, mode=mode, compat=True, cheap_shadow=cheap, vis=vis,
                shadow=shadow, tree=tree, cells=cells, form=f)) for f in (0, 1)}
            outs = {f: runs[f]().clone() for f in runs}
            eq = torch.equal(outs[0], outs[1])
            line = f"[size-form] render {mode} d2, {n} spheres {W}x{H}: every form torch.equal {eq}"
            if n == FORM_NS[-1]:
                ms = _alternate(rt, runs, 10)
                entries[f"render_fwd_{mode}"] = ms
                line += ("; kernel alone " + ", ".join(
                    f"{render_cuda.FORMS[f]} {ms[f]:.4f} ms" for f in runs))
            print(f"{line} | {card}")
            check(eq, f"render {mode} at {n} spheres: a global form differs from the staged form")
        # the worklist kernel over every pixel, each form
        vis, shadow, tree, cells = tabs[True]
        idx = torch.arange(W * H, dtype=torch.int32, device=dev)
        flagged = torch.tensor([W * H], dtype=torch.int32, device=dev)
        runs = {f: (lambda f=f, o=torch.zeros((W, H, 3), device=dev): ac.launch_list(
            o, *packed, idx, flagged, depth=2, compat=True, cheap_shadow=cheap, vis=vis,
            shadow=shadow, tree=tree, cells=cells, form=f)) for f in (0, 1)}
        outs = {f: runs[f]().clone() for f in runs}
        eq = torch.equal(outs[0], outs[1])
        line = f"[size-form] worklist kernel, every pixel, {n} spheres: every form torch.equal {eq}"
        if n == FORM_NS[-1]:
            ms = _alternate(rt, runs, 5)
            ext = hx.hit_extents_cuda(cam, scene, aliasing=True, vis=vis)
            entries["render_list"] = ms
            entries["render_list_bound"] = timing.bound_ms(*timing.large_scene_work(
                W, H, *cnt, "aa_per_sample", vis, shadow, ext))
            entries["hit_extents_bound"] = timing.bound_ms(*timing.hit_extents_work(
                W, H, n, cnt[1], True, vis, ext))
            line += "; " + ", ".join(f"{render_cuda.FORMS[f]} {ms[f]:.4f} ms" for f in runs)
        print(f"{line} | {card}")
        check(eq, f"worklist kernel at {n} spheres: a global form differs")
        # hit extents with bounce levels, each form
        n_tiles = -(-W // 16) * -(-H // 16)
        runs = {f: (lambda f=f, o=torch.empty((n_tiles * 3, 8), device=dev): hx.launch(
            o, *packed, W=W, H=H, aliasing=True, compat=True, n_levels=3, vis=vis, tree=tree,
            form=f)) for f in (0, 1)}
        outs = {f: runs[f]().clone() for f in runs}
        eq = torch.equal(outs[0], outs[1])
        line = f"[size-form] hit_extents 3 levels AA, {n} spheres: every form torch.equal {eq}"
        if n == FORM_NS[-1]:
            ms = _alternate(rt, runs, 10)
            entries["hit_extents"] = ms
            line += "; " + ", ".join(f"{render_cuda.FORMS[f]} {ms[f]:.4f} ms" for f in runs)
        print(f"{line} | {card}")
        check(eq, f"hit extents at {n} spheres: a global form differs")
        # the table kernels: staged against chunks of SIZE_CHUNK
        sph, _, lts = packed[1]
        runs = {c: (lambda c=c: lc.launch(lc.empty(cnt[2], dev), sph, lts, n, cnt[2], chunk=c))
                for c in (0, SIZE_CHUNK)}
        a, b = runs[0](), runs[SIZE_CHUNK]()
        eq = all(torch.equal(u, v) for u, v in zip(a, b))
        ext = hx.hit_extents_cuda(cam, scene, aliasing=True, vis=vis,
                                  scale=(scale := torch.empty(1, device=dev)))
        order = ct.light_order(scene.lights.position, scene.spheres.center,
                               scene.spheres.radius).to(torch.int32)
        k = ct.list_capacity(n)

        def lists(c):
            return sl.launch(torch.empty(n_tiles * cnt[2] * k, dtype=torch.int32, device=dev),
                             torch.empty(n_tiles * cnt[2], dtype=torch.int32, device=dev), ext,
                             scale, scene.lights.position.contiguous(),
                             scene.spheres.center.contiguous(),
                             scene.spheres.radius.contiguous(), order, k=k, compat=True,
                             chunk=c)
        la, lb = lists(0), lists(SIZE_CHUNK)
        leq = all(torch.equal(u, v) for u, v in zip(la, lb))
        line = (f"[size-form] light cells / lists, {n} spheres: chunks of {SIZE_CHUNK} "
                f"torch.equal to staged {eq} / {leq}")
        if n == FORM_NS[-1]:
            ms = _alternate(rt, runs, 10)
            lms = _alternate(rt, {c: (lambda c=c: lists(c)) for c in (0, SIZE_CHUNK)}, 10)
            entries["light_cells"], entries["shadow_lists"] = ms, lms
            line += (f"; light cells staged {ms[0]:.4f} / chunked {ms[SIZE_CHUNK]:.4f} ms, lists "
                     f"staged {lms[0]:.4f} / chunked {lms[SIZE_CHUNK]:.4f} ms")
        print(f"{line} | {card}")
        check(eq and leq, f"table kernels at {n} spheres: the chunked form differs")
        # the soft forward: both forms against the plain version on edge pixels
        scam = rt.Camera.build(SOFT_FORM_RES, *BENCH_POSE, device=dev)
        sp = render_cuda.pack_params(scam, scene, False).to(dev)
        runs = {st: (lambda st=st, o=torch.empty((*SOFT_FORM_RES, 3), device=dev):
                     soft_cuda.launch(o, sp, packed[1], cnt, tau=SIZE_TAU, staged=st))
                for st in (True, False)}
        a, b = runs[True]().clone(), runs[False]().clone()
        pix = _edge_pixels(torch, a, SIZE_SOFT_PIXELS)
        p32 = _soft_pixels_plain(torch, rt, scam, scene, pix, SIZE_TAU, torch.float32)
        p64 = _soft_pixels_plain(torch, rt, scam, scene, pix, SIZE_TAU, torch.float64)
        xs, ys = (torch.tensor(v, device=dev) for v in zip(*pix))
        ratio = {}
        for st, img in ((True, a), (False, b)):
            got = img[xs, ys]
            ratio[st] = float(torch.minimum((got - p32).abs().double(),
                                            (got.double() - p64).abs()).max()) / soft_cuda.IMAGE_ATOL
        line = (f"[size-form] soft forward tau {SIZE_TAU}, {n} spheres {SOFT_FORM_RES[0]}x"
                f"{SOFT_FORM_RES[1]}: global against staged "
                f"torch.equal {torch.equal(a, b)}, max |d| {float((a - b).abs().max()):.3g}; "
                f"against the plain version on edge pixels {pix}: staged {ratio[True]:.3g}, "
                f"global {ratio[False]:.3g} of the rule")
        if n == FORM_NS[-1]:
            ms = _alternate(rt, runs, 1)
            entries["soft_fwd"] = ms
            line += f"; staged {ms[True]:.4f} ms, global {ms[False]:.4f} ms"
        print(f"{line} | {card}")
        check(max(ratio.values()) <= 1.0, f"soft forward at {n} spheres off its plain version")
        # the backward kernels' third form against the others at one launch shape
        tgt = rt.render_image_cuda(cam, scene, aliasing=False) * 0.9
        img_aa = rt.render_image_cuda(cam, scene, aliasing=True)
        cot = seeded(torch, (W, H, 3), dev, 6) * 1e-2
        for mode in ("fused_noaa", "cot_aa"):
            fused = mode.startswith("fused")
            chosen = rb.launch_plan(cam, scene, mode)
            glob = rb.launch_plan(cam, scene, mode, staged=False, device_rows=False)
            nr = rb.n_grads(*cnt, fused)
            res, runs = {}, {}
            for name, p in (("planner", chosen), ("global", glob)):
                twin = p._replace(staged=False, device_rows=True, smem=rb.smem_bytes(
                    *cnt, fused, mode.endswith("_aa"), p.nt, False, False, True))
                for key, q in ((name, p), (f"{name} twin", twin)):
                    o, part = torch.empty(nr, device=dev), torch.empty(nr * q.blocks, device=dev)
                    runs[key] = (lambda q=q, o=o, part=part: rb.launch(
                        o, part, packed[0], packed[1], cnt, image=None if fused else cot,
                        target=tgt if fused else None, W=W, H=H, depth=2, mode=mode,
                        compat=True, cheap_shadow=cheap, shape=q))
                    res[key] = runs[key]().clone()
            eq = torch.equal(res["planner"], res["planner twin"]) and \
                torch.equal(res["global"], res["global twin"])
            line = (f"[size-form] hard {mode} d2, {n} spheres: rows in device memory "
                    f"torch.equal to the planner's {'staged' if chosen.staged else 'global'} "
                    f"{chosen.nt}-thread plan and to the global {glob.nt}-thread one: {eq}")
            if n == FORM_NS[-1] and fused:
                ms = _alternate(rt, {k: runs[k] for k in ("planner", "global twin")}, 5)
                entries["render_bwd"] = ms
                line += (f"; planner's {ms['planner']:.4f} ms, device rows at the global "
                         f"plan's shape {ms['global twin']:.4f} ms")
            print(f"{line} | {card}")
            check(eq, f"hard {mode} at {n} spheres: device-memory rows differ")
    # the light cells at the main path's scenes (the CLI's random_scene): the
    # staged form against the chunked one, which the staged form loses to at
    # FORM_NS[-1]
    for n in LC_MAIN_NS:
        scene = scene_of(rt, RenderConfig(), n, dev)
        sph, _, lts = render_cuda.scene_tables(scene)
        nl = scene.lights.count
        runs = {c: (lambda c=c, o=lc.empty(nl, dev): lc.launch(o, sph, lts, n, nl, chunk=c))
                for c in (0, lc.CHUNK)}
        eq = all(torch.equal(u, v) for u, v in zip(runs[0](), runs[lc.CHUNK]()))
        ms = _alternate(rt, runs, 200)
        print(f"[size-form] light cells at the main path's {n} spheres: chunks of {lc.CHUNK} "
              f"torch.equal to staged {eq}; staged {ms[0]:.4f} / chunked {ms[lc.CHUNK]:.4f} ms "
              f"(A, B, B, A minima of 200 launches) | {card}")
        check(eq, f"light cells at {n} spheres: the chunked form differs")
    # the soft backward's third form against its global form at one plan
    # (SOFT_ROWS_RES: its blocks walk pixel groups)
    scene = seeded_scene(FORM_NS[0])
    cnt = counts(scene)
    cam = rt.Camera.build(SOFT_ROWS_RES, *BENCH_POSE, device=dev)
    W, H = SOFT_ROWS_RES
    sparams = render_cuda.pack_params(cam, scene, False).to(dev)
    tables = render_cuda.scene_tables(scene)
    stgt = soft_cuda.render_image_soft_cuda(cam, scene, tau=SIZE_TAU)
    cot = seeded(torch, (W, H, 3), dev, 6) * 1e-2
    for mode in sb.MODES:
        fused = mode == "fused"
        glob = sb.plan(*cnt, fused, staged=False, device_rows=False)
        twin = glob._replace(device_rows=True, smem=sb.smem_bytes(
            *cnt, fused, glob.nt, glob.cap, glob.cj, glob.store_vis, False, True))
        nr = rb.n_grads(*cnt, fused)
        runs = {}
        for key, q in (("global", glob), ("rows", twin)):
            o = torch.empty(nr, device=dev)
            part = torch.empty(nr * sb.n_blocks(W, H, q), device=dev)
            runs[key] = (lambda q=q, o=o, part=part: sb.launch(
                o, part, sparams, tables, cnt, image=stgt if fused else cot, W=W, H=H,
                tau=SIZE_TAU, mode=mode, shape=q))
        a, b = runs["global"]().clone(), runs["rows"]().clone()
        rule = sb.soft_grad_rule(b, a, *cnt)
        worst = max(rule.items(), key=lambda kv: kv[1][0])
        ok = all(v for _, v in rule.values())
        line = (f"[size-form] soft {mode} tau {SIZE_TAU}, {FORM_NS[0]} spheres {W}x{H}: rows in "
                f"device memory ({sb.n_blocks(W, H, twin)} blocks walking "
                f"{sb.n_blocks(W, H, glob)} pixel groups) "
                f"against the global form at its plan ({glob.nt} threads, cap "
                f"{glob.cap}, cj {glob.cj}): torch.equal {torch.equal(a, b)}, max |d| "
                f"{float((a - b).abs().max()):.3g}, soft_grad_rule ok {ok} (worst {worst[0]} "
                f"{worst[1][0]:.3g})")
        if fused:
            ms = _alternate(rt, runs, 1)
            entries["soft_bwd"] = ms
            line += f"; global {ms['global']:.4f} ms, device rows {ms['rows']:.4f} ms"
        print(f"{line} | {card}")
        check(ok, f"soft {mode}: device-memory rows off the global form")
    print(f"[size-form] times above: kernel alone, minima of 2 alternating runs each")

    # 2. Scenes past every staged form, through the entry points.
    big = {}
    for n in SIZE_NS:
        scene = seeded_scene(n)
        cnt = counts(scene)
        cam = rt.Camera.build(SIZE_RES, *BENCH_POSE, device=dev)
        reset()
        for aa in (False, True):
            mode = "aa_shared" if aa else "aa_none"
            img = rt.render_image_cuda(cam, scene, aliasing=aa)
            torch.cuda.synchronize()
            check(img.shape == (*SIZE_RES, 3) and bool(torch.isfinite(img).all()),
                  f"{n} spheres {mode}: image {tuple(img.shape)} not finite")
            ms = 1e3 * rt.time_fn(rt.render_image_cuda, cam, scene, aliasing=aa, warmup=1, iters=2)
            packed = render_cuda.packed_inputs(cam, scene, depth=2, compat=True)
            vis, shadow, tree, cells = render_cuda.large_scene_tables(
                cam, scene, depth=2, aliasing=aa, compat=True, packed=packed)
            kernel_ms = 1e3 * rt.time_fn(
                render_cuda.launch, torch.empty((*SIZE_RES, 3), device=dev), *packed, depth=2,
                mode=mode, compat=True, cheap_shadow=render_cuda.shadow_cheap_ok(scene, True),
                vis=vis, shadow=shadow, tree=tree, cells=cells, warmup=1, iters=2)
            ext = hx.hit_extents_cuda(cam, scene, aliasing=aa, vis=vis)
            bound = timing.bound_ms(*timing.large_scene_work(*SIZE_RES, *cnt, mode, vis, shadow,
                                                             ext))
            big[(n, mode)] = {"ms": ms, "kernel_ms": kernel_ms, "bound": bound}
            print(f"[size-render] render_image_cuda {mode} d2, {n} spheres {SIZE_RES[0]}x"
                  f"{SIZE_RES[1]}: {ms:.4f} ms a frame (wrapper: tables and kernels), kernel "
                  f"alone {kernel_ms:.4f} ms, bound {bound[0]:.4f} ms ({bound[1]}, a lower "
                  f"bound), form {render_cuda.FORMS[render_cuda.scene_form(*cnt, True)]} "
                  f"| {card}")
        got = {"render": dict(render_cuda.GLOBAL_LAUNCHES), "hit_extents": hx.LAUNCHES["hit_extents"],
               "light_cells_chunked": lc.GLOBAL_LAUNCHES["light_cells"],
               "shadow_lists_chunked": sl.GLOBAL_LAUNCHES["shadow_lists"]}
        print(f"[size-render] {n} spheres: launches {got}")
        check(got["render"]["aa_none"] > 0 and got["render"]["aa_shared"] > 0 and
              got["light_cells_chunked"] > 0 and got["shadow_lists_chunked"] > 0,
              f"{n} spheres: not every global or chunked form launched: {got}")
        big[n] = dict(got)
        # the table kernels alone in their chunked form, and their plain functions
        sph, _, lts = render_cuda.scene_tables(scene)
        lc_ms = 1e3 * rt.time_fn(lc.launch, lc.empty(cnt[2], dev), sph, lts, n, cnt[2], warmup=1,
                                 iters=10)
        lc_plain_ms = 1e3 * rt.time_fn(lc.light_cells_plain, scene.spheres.center,
                                       scene.spheres.radius, scene.lights.position, warmup=1,
                                       iters=1)
        big[(n, "light_cells")] = {"ms": lc_ms, "plain_ms": lc_plain_ms,
                                   "bound": timing.bound_ms(*timing.light_cells_work(n, cnt[2]))}
        # each against its plain version at SIZE_PARITY_RES
        pc = rt.Camera.build(SIZE_PARITY_RES, *BENCH_POSE, device=dev)
        pw, ph = SIZE_PARITY_RES
        for mode in render_cuda.MODES:
            aa = mode != "aa_none"
            kw = dict(aliasing=aa, aa_share=mode == "aa_shared")
            img_k = rt.render_image_cuda(pc, scene, **kw)
            off = rt.render_image_cuda(pc, scene, cull=False, shadow_lists=False,
                                       group_cull=False, **kw)
            t0 = time.perf_counter()
            img_p = plain_frame(pc, scene, aliasing=aa)
            torch.cuda.synchronize()
            flips, changed, dmax = frame_diff(rt.to_framebuffer(img_k), rt.to_framebuffer(img_p))
            err = float((img_k - img_p).abs().max())
            big[(n, mode)] = {**big.get((n, mode), {}), "err": err,
                              "plain_s": time.perf_counter() - t0}
            print(f"[size-parity] {mode} d2, {n} spheres {pw}x{ph}: flipped {flips}/{pw * ph} "
                  f"against the plain version (column slices, "
                  f"{time.perf_counter() - t0:.1f} s), max {dmax}; culls on torch.equal to "
                  f"all off {torch.equal(img_k, off)}")
            check(flips <= FLIP_FRAC * pw * ph, f"{mode} at {n} spheres: {flips} flipped")
            check(torch.equal(img_k, off), f"{mode} at {n} spheres: culls change the frame")
            if mode == "aa_per_sample":
                adaptive = rt.render_image_adaptive_cuda(pc, scene, eps=-1.0, budget_frac=1.0)
                eq = torch.equal(adaptive, img_k)
                print(f"[size-parity] worklist kernel, every interior pixel flagged, {n} "
                      f"spheres {pw}x{ph}: torch.equal to aa_per_sample {eq}")
                check(eq, f"worklist kernel at {n} spheres differs from aa_per_sample")
        # hit extents with bounce levels (the global form): level 0 against the
        # plain version (extent_rule); the bounce levels with the tree against
        # the same launch without it (exact culls: equal). A bounce level of
        # a dense cloud is chaotic, so its rows against the plain version's
        # (another rounding of the hit points) are reported, not held; the
        # witness: the plain version in float32 against itself in float64,
        # whose bounce levels part the same way while level 0 agrees.
        vis = (*ct.tile_visibility(pc, scene, compat=True, K=ct.list_capacity(n)),
               ct.list_capacity(n))
        tree = ct.bounce_tree(scene.spheres.center, scene.spheres.radius)
        ext_k = hx.hit_extents_cuda(pc, scene, aliasing=True, n_levels=3, vis=vis, tree=tree)
        ext_n = hx.hit_extents_cuda(pc, scene, aliasing=True, n_levels=3, vis=vis)
        t0 = time.perf_counter()
        ext_p = hx.hit_extents_plain(pc, scene, aliasing=True, n_levels=3, vis=vis)
        hx_plain_ms = 1e3 * (time.perf_counter() - t0)
        pc64 = rt.Camera(pc.position.double(), pc.rotation.double(), pc.fov.double(),
                         pc.resolution)
        ext_64 = hx.hit_extents_plain(pc64, _subscene(rt, scene, torch.arange(n, device=dev),
                                                      torch.float64),
                                      aliasing=True, n_levels=3, vis=vis)
        torch.cuda.empty_cache()
        rule = hx.extent_rule(ext_k[0::3], ext_p[0::3])

        def gap(a, b):
            return [(round(hx.extent_rule(a[lv::3], b[lv::3])["ratio"], 4),
                     int((a[lv::3, 6] != b[lv::3, 6]).sum())) for lv in range(3)]
        print(f"[size-parity] hit_extents 3 levels AA, {n} spheres {pw}x{ph} "
              f"({hx.GLOBAL_LAUNCHES['hit_extents']} global launches): level 0 against the "
              f"plain version {rule}; levels 1-2 with the tree torch.equal to without "
              f"{torch.equal(ext_k, ext_n)}; levels 0 / 1 / 2 (extent_rule ratio, rows whose "
              f"counts differ, of {ext_k.shape[0] // 3}): kernel against the plain version "
              f"{gap(ext_k, ext_p)}, the plain version in float32 against float64 "
              f"{gap(ext_p, ext_64)}, the kernel against float64 {gap(ext_k, ext_64)}")
        check(rule["ok"] and torch.equal(ext_k, ext_n), f"hit extents at {n} spheres: {rule}")
        big[(n, "hit_extents")] = {"err": rule["max_abs_err"], "ratio": rule["ratio"],
                                   "plain_ms": hx_plain_ms}
        # the table kernels against their plain functions
        sph, _, lts = render_cuda.scene_tables(scene)
        cells = lc.light_cells_cuda(sph, lts, *cnt[::2])
        plain_cells = lc.light_cells_plain(scene.spheres.center, scene.spheres.radius,
                                           scene.lights.position)
        ceq = all(torch.equal(a, b) for a, b in zip(cells, plain_cells))
        lcam = rt.Camera.build(SIZE_FORM_RES, *BENCH_POSE, device=dev)
        lvis = (*ct.tile_visibility(lcam, scene, compat=True, K=ct.list_capacity(n)),
                ct.list_capacity(n))
        ext = hx.hit_extents_cuda(lcam, scene, aliasing=True, vis=lvis,
                                  scale=(scale := torch.empty(1, device=dev)))
        kl = sl.shadow_lists_cuda(ext, scale, scene.lights.position, scene.spheres.center,
                                  scene.spheres.radius, K=ct.list_capacity(n), compat=True)
        pl = ct.shadow_visibility_lists(ext, scene.lights.position, scene.spheres.center,
                                        scene.spheres.radius, K=ct.list_capacity(n),
                                        compat=True, scale=scale)
        leq = all(torch.equal(a, b) for a, b in zip(kl, pl))
        L, C, R = scene.lights.position, scene.spheres.center, scene.spheres.radius
        order = ct.light_order(L, C, R).to(torch.int32)
        k = ct.list_capacity(n)
        sl_ms = 1e3 * rt.time_fn(sl.launch, *(torch.empty_like(t) for t in kl), ext, scale, L, C,
                                 R, order, k=k, compat=True, warmup=1, iters=10)
        sl_plain_ms = 1e3 * rt.time_fn(ct.shadow_visibility_lists, ext, L, C, R, K=k,
                                       compat=True, scale=scale, warmup=1, iters=1)
        big[(n, "shadow_lists")] = {"ms": sl_ms, "plain_ms": sl_plain_ms, "bound": timing.bound_ms(
            *timing.shadow_lists_work(ext, L, C, R, K=k, compat=True))}
        print(f"[size-time] {n} spheres, chunked forms alone: light cells {lc_ms:.4f} ms (plain "
              f"{lc_plain_ms:.4f} ms, bound {big[(n, 'light_cells')]['bound'][0]:.4f}), lists at "
              f"{SIZE_FORM_RES[0]}x{SIZE_FORM_RES[1]} {sl_ms:.4f} ms (plain {sl_plain_ms:.4f} ms, "
              f"bound {big[(n, 'shadow_lists')]['bound'][0]:.4f}) | {card}")
        print(f"[size-parity] {n} spheres: light cells (chunked) torch.equal to the plain "
              f"build {ceq}; level-0 lists at {SIZE_FORM_RES[0]}x{SIZE_FORM_RES[1]} (chunked) "
              f"torch.equal to the plain function {leq}")
        check(ceq and leq, f"table kernels at {n} spheres differ from their plain functions")
        # the soft forward (global form) against its plain version
        scam = rt.Camera.build(SIZE_SOFT_RES, *BENCH_POSE, device=dev)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        simg = rt.render_image_soft_cuda(scam, scene, tau=SIZE_TAU)
        torch.cuda.synchronize()
        sms = 1e3 * (time.perf_counter() - t0)   # one frame: seconds at this density
        check(soft_cuda.GLOBAL_LAUNCHES["soft_fwd"] > 0, f"{n} spheres: soft forward not global")
        t0 = time.perf_counter()
        chosen, median = _soft_check_pixels(torch, scam, scene, SIZE_TAU, SIZE_SOFT_PIXELS)
        pick_s = time.perf_counter() - t0
        check(len(chosen) > 0, f"{n} spheres: no pixel's plain subset fits")
        pix = [p for p, _, _ in chosen]
        subs = [sub for _, sub, _ in chosen]
        lives = [v for _, _, v in chosen]
        sizes = [int(sub.numel()) for sub in subs]
        t0 = time.perf_counter()
        p32 = _soft_pixels_plain(torch, rt, scam, scene, pix, SIZE_TAU, torch.float32, subs)
        plain_s = time.perf_counter() - t0
        p64 = _soft_pixels_plain(torch, rt, scam, scene, pix, SIZE_TAU, torch.float64, subs)
        xs, ys = (torch.tensor(v, device=dev) for v in zip(*pix))
        got = simg[xs, ys]
        d32 = (got - p32).abs()
        ratio = float(torch.minimum(d32.double(), (got.double() - p64).abs()).max()) / \
            soft_cuda.IMAGE_ATOL
        px = SIZE_SOFT_RES[0] * SIZE_SOFT_RES[1]
        big[(n, "soft")] = {"ms": sms, "err": float(d32.max()), "ratio": ratio,
                            "plain_ms": 1e3 * plain_s, "plain_px": len(pix),
                            "bound": timing.bound_ms(px * n * timing.COVER_GEO,
                                                     timing._scene_bytes(*cnt) + 12 * px)}
        print(f"[size-parity] soft forward tau {SIZE_TAU}, {n} spheres {SIZE_SOFT_RES[0]}x"
              f"{SIZE_SOFT_RES[1]}: pixels {pix} (live spheres on their rays {lives}, the "
              f"frame's median {median}; plain subsets {sizes} spheres, chosen in "
              f"{pick_s:.1f} s, plain float32 {plain_s:.1f} s): max |d| {float(d32.max()):.3g}, "
              f"{ratio:.3g} of the rule; {sms:.4f} ms a frame (one frame, host clock) | {card}")
        check(ratio <= 1.0 and bool(torch.isfinite(simg).all()),
              f"soft forward at {n} spheres off its plain version")
        big[n]["launches"] = {
            **{f"render_fwd_{m}_global": v for m, v in render_cuda.GLOBAL_LAUNCHES.items()},
            "render_list_global": ac.GLOBAL_LAUNCHES["render_list"],
            "hit_extents_global": hx.GLOBAL_LAUNCHES["hit_extents"],
            "light_cells_chunked": lc.GLOBAL_LAUNCHES["light_cells"],
            "shadow_lists_chunked": sl.GLOBAL_LAUNCHES["shadow_lists"],
            "soft_fwd_global": soft_cuda.GLOBAL_LAUNCHES["soft_fwd"]}
        print(f"[size-main] {n} spheres: launches of the global and chunked forms "
              f"{big[n]['launches']}")

    # 3. The backward kernels at SIZE_BWD_NS: the third form.
    scene = seeded_scene(SIZE_BWD_NS)
    cnt = counts(scene)
    cam = rt.Camera.build(REPAIR_RES, *BENCH_POSE, device=dev)
    W, H = REPAIR_RES
    reset()
    for aa in (False, True):
        mode = "cot_aa" if aa else "cot_noaa"
        shape = rb.launch_plan(cam, scene, mode)
        check(shape.device_rows, f"{mode} at {SIZE_BWD_NS} spheres planned {shape}")
        res = _hard_against_plain(torch, rt, rb, cam, scene, aa)
        print(f"[size-bwd] hard {mode} at {SIZE_BWD_NS} spheres {W}x{H} d{REPAIR_DEPTH}: plan "
              f"{shape}; {res['line']}")
        check(res["ok"], f"{mode} at {SIZE_BWD_NS} spheres: {res['rule']}")
        big[("bwd", mode)] = res
    tgt = rt.render_image_cuda(cam, scene, aliasing=False) * 0.9
    sms = 1e3 * rt.time_fn(rb.loss_and_scene_grads_cuda, cam, scene, tgt, warmup=1, iters=3)
    shape = rb.launch_plan(cam, scene, "fused_noaa")
    nr = rb.n_grads(*cnt, True)
    params = render_cuda.pack_params(cam, scene, True).to(dev)
    kms = 1e3 * rt.time_fn(
        rb.launch, torch.empty(nr, device=dev), torch.empty(nr * shape.blocks, device=dev),
        params, render_cuda.scene_tables(scene), cnt, image=None, target=tgt, W=W, H=H, depth=2,
        mode="fused_noaa", compat=True, cheap_shadow=render_cuda.shadow_cheap_ok(scene, True),
        shape=shape, warmup=1, iters=3)
    big[("bwd", "fused_noaa")] = {"ms": sms, "kernel_ms": kms, "bound": timing.bound_ms(
        *timing.hard_work(W, H, *cnt, "fused_noaa"))}
    print(f"[size-bwd] hard fused_noaa step d2 at {SIZE_BWD_NS} spheres {W}x{H} ({shape}, "
          f"scratch {4 * rb.scratch_floats(*cnt, shape)} B): {sms:.4f} ms, kernel and reduction "
          f"alone {kms:.4f} ms | {card}")
    cam = rt.Camera.build(SIZE_BWD_SOFT_RES, *BENCH_POSE, device=dev)
    W, H = SIZE_BWD_SOFT_RES
    chosen, median = _soft_check_pixels(torch, cam, scene, SIZE_TAU, REPAIR_SOFT_PIXELS)
    check(len(chosen) > 0, f"{SIZE_BWD_NS} spheres: no pixel's plain subset fits")
    pixels = [p for p, _, _ in chosen]
    g = torch.zeros((W, H, 3), device=dev)
    for i, (x, y) in enumerate(pixels):
        g[x, y] = seeded(torch, (3,), dev, 20 + i) + 0.5
    sshape = sb.plan(*cnt, False)
    check(sshape.device_rows, f"soft cot at {SIZE_BWD_NS} spheres planned {sshape}")
    sblocks = sb.n_blocks(W, H, sshape)
    groups = sb.n_blocks(W, H, sshape._replace(device_rows=False))
    snr = rb.n_grads(*cnt, False)
    check(sblocks < groups, f"soft cot at {W}x{H}: {sblocks} blocks for {groups} groups")
    k = rb.flatten_grads(*sb.soft_scene_grads_cuda(cam, scene, g, tau=SIZE_TAU,
                                                   return_camera=True))
    soft_ms = 1e3 * rt.time_fn(sb.soft_scene_grads_cuda, cam, scene, g, tau=SIZE_TAU, warmup=1,
                               iters=3)
    t0 = time.perf_counter()
    p = torch.zeros_like(k)
    n_s = cnt[0]
    for (x, y), idx, _ in chosen:
        sub = _subscene(rt, scene, idx, torch.float32)

        def objective(c, s, x=x, y=y):
            d = c.ray_directions(torch.tensor([[float(x), float(y)]], device=dev), compat=False)
            rgb = rt.render_rays_soft(c.ray_origin().expand(d.shape), d, s, tau=SIZE_TAU)
            return (rgb[0] * g[x, y]).sum(), None
        ps = rb._autograd_flat(cam, sub, objective)
        ns_sub = idx.numel()
        # the subset's sphere slots (7 a sphere) back to the scene's; the
        # rest of the layout is the scene's
        p[:7 * n_s].view(n_s, 7)[idx] += ps[:7 * ns_sub].view(ns_sub, 7)
        p[7 * n_s:] += ps[7 * ns_sub:]
        torch.cuda.empty_cache()
    soft_plain_ms = 1e3 * (time.perf_counter() - t0)
    rule = sb.soft_grad_rule(k, p, *cnt)
    worst = max(rule.items(), key=lambda kv: kv[1][0])
    ok = all(v for _, v in rule.values())
    big[("bwd", "soft")] = {
        "ms": soft_ms, "plain_ms": soft_plain_ms, "err": float((k - p).abs().max()),
        "ratio": worst[1][0], "bound": timing.bound_ms(
            len(pixels) * cnt[0] * timing.COVER_GEO,
            timing._scene_bytes(*cnt) + 12 * W * H + 4 * rb.n_grads(*cnt))}
    print(f"[size-bwd] soft backward cot tau {SIZE_TAU} at {SIZE_BWD_NS} spheres {W}x{H}, "
          f"cotangent on pixels {pixels} (live spheres on their rays "
          f"{[v for _, _, v in chosen]}, the frame's median {median}): plan {sshape}, "
          f"{sblocks} blocks walking {groups} pixel groups, scratch "
          f"{4 * sb.scratch_floats(*cnt, False, W, H, sshape)} B, partials "
          f"{4 * snr * sblocks} B (one block a group: {4 * groups * sshape.nt // 32 * snr} B "
          f"and {4 * groups * snr} B); {soft_ms:.4f} ms; against the plain version over "
          f"each pixel's subset ({time.perf_counter() - t0:.1f} s): ok {ok}, worst {worst[0]} "
          f"{worst[1][0]:.3g}")
    check(ok, f"soft cot at {SIZE_BWD_NS} spheres: {rule}")
    got = {**{f"{m} rows": v for m, v in rb.ROWS_LAUNCHES.items() if v},
           **{f"soft {m} rows": v for m, v in sb.ROWS_LAUNCHES.items() if v}}
    print(f"[size-bwd] launches in the third form: {got}")
    check(rb.ROWS_LAUNCHES["cot_noaa"] > 0 and sb.ROWS_LAUNCHES["cot"] > 0,
          f"the third form did not launch: {got}")
    return _size_entries(entries, big, got)


def _size_entries(form_ms: dict, big: dict, rows: dict) -> list:
    """The kernels line's entries of the global, chunked and device-rows
    forms, from :func:`scene_size_phase`'s measurements: ``launches`` over
    its SIZE_NS runs (rows: its SIZE_BWD_NS run), ``ms`` and the bound at the
    largest scene each ran at, ``plain_ms`` where the plain version ran
    (``plain_shape`` says on what)."""
    n = SIZE_NS[-1]
    big_n = f"{n} spheres {SIZE_RES[0]}x{SIZE_RES[1]}"
    par = f"{n} spheres {SIZE_PARITY_RES[0]}x{SIZE_PARITY_RES[1]}"

    def launches(key):
        return sum(big[m]["launches"][key] for m in SIZE_NS)

    out = []
    for mode in ("aa_none", "aa_shared"):
        r = big[(n, mode)]
        out.append({
            "name": f"render_fwd_{mode}_global", "route": "cuda",
            "source": "python_ray_tracer_tpu_torch/csrc/render_fwd_global.cu",
            "replaces": REPLACES[mode], "launches": launches(f"render_fwd_{mode}_global"),
            "max_abs_err": r["err"], "ms": r["ms"], "kernel_only_ms": r["kernel_ms"],
            "plain_ms": 1e3 * r["plain_s"], "plain_shape": par, "bound_ms": r["bound"][0],
            "bound_by": r["bound"][1], "library_ms": None, "shape": big_n,
            "staged_ms_5000": form_ms[f"render_fwd_{mode}"][0],
            "global_ms_5000": form_ms[f"render_fwd_{mode}"][1]})
    r = big[(n, "aa_per_sample")]
    out.append({
        "name": "render_list_global", "route": "cuda",
        "source": "python_ray_tracer_tpu_torch/csrc/render_fwd_global.cu",
        "replaces": LIST_REPLACES, "launches": launches("render_list_global"),
        "max_abs_err": r["err"], "ms": form_ms["render_list"][1],
        "plain_ms": 1e3 * r["plain_s"], "plain_shape": par + " (the per-sample AA frame it equals)",
        "bound_ms": form_ms["render_list_bound"][0],
        "bound_by": form_ms["render_list_bound"][1], "library_ms": None,
        "shape": f"{FORM_NS[-1]} spheres {SIZE_FORM_RES[0]}x{SIZE_FORM_RES[1]}, every pixel",
        "staged_ms": form_ms["render_list"][0]})
    r = big[(n, "hit_extents")]
    out.append({
        "name": "hit_extents_global", "route": "cuda", "source": HX_SOURCE,
        "replaces": HX_REPLACES, "launches": launches("hit_extents_global"),
        "max_abs_err": r["err"], "max_rel_err": r["ratio"], "ms": form_ms["hit_extents"][1],
        "plain_ms": r["plain_ms"], "plain_shape": par,
        "bound_ms": form_ms["hit_extents_bound"][0],
        "bound_by": form_ms["hit_extents_bound"][1], "library_ms": None,
        "shape": f"3 levels AA, {FORM_NS[-1]} spheres {SIZE_FORM_RES[0]}x{SIZE_FORM_RES[1]}",
        "staged_ms": form_ms["hit_extents"][0]})
    for name, src in (("light_cells", LC_SOURCE), ("shadow_lists", SL_SOURCE)):
        r = big[(n, name)]
        out.append({
            "name": f"{name}_chunked", "route": "cuda", "source": src, "replaces": None,
            "launches": launches(f"{name}_chunked"), "max_abs_err": 0.0, "ms": r["ms"],
            "plain_ms": r["plain_ms"], "bound_ms": r["bound"][0], "bound_by": r["bound"][1],
            "library_ms": None, "shape": f"{n} spheres" + (
                f", {SIZE_FORM_RES[0]}x{SIZE_FORM_RES[1]} rows" if name == "shadow_lists" else "")})
    r = big[(n, "soft")]
    out.append({
        "name": "soft_fwd_global", "route": "cuda", "source": SOFT_FWD_SOURCE,
        "replaces": SOFT_FWD_REPLACES, "launches": launches("soft_fwd_global"),
        "max_abs_err": r["err"], "max_rel_err": r["ratio"], "ms": r["ms"],
        "plain_ms": r["plain_ms"], "plain_shape": f"{r['plain_px']} pixels, each over its subset",
        "bound_ms": r["bound"][0], "bound_by": r["bound"][1], "library_ms": None,
        "shape": f"{n} spheres {SIZE_SOFT_RES[0]}x{SIZE_SOFT_RES[1]} tau {SIZE_TAU}"})
    r, h = big[("bwd", "fused_noaa")], big[("bwd", "cot_noaa")]
    out.append({
        "name": "render_bwd_device_rows", "route": "cuda",
        "source": "python_ray_tracer_tpu_torch/csrc/render_bwd_rows.cu",
        "replaces": BWD_REPLACES, "launches": sum(v for k, v in rows.items()
                                                  if not k.startswith("soft")),
        "max_abs_err": h["err"], "ms": r["ms"], "kernel_only_ms": r["kernel_ms"],
        "plain_ms": 1e3 * h["plain_s"], "bound_ms": r["bound"][0], "bound_by": r["bound"][1],
        "library_ms": None,
        "shape": f"fused_noaa d2, {SIZE_BWD_NS} spheres {REPAIR_RES[0]}x{REPAIR_RES[1]}"})
    r = big[("bwd", "soft")]
    out.append({
        "name": "soft_bwd_device_rows", "route": "cuda", "source": SOFT_BWD_SOURCE,
        "replaces": SOFT_BWD_REPLACES, "launches": sum(v for k, v in rows.items()
                                                       if k.startswith("soft")),
        "max_abs_err": r["err"], "max_rel_err": r["ratio"], "ms": r["ms"],
        "plain_ms": r["plain_ms"], "bound_ms": r["bound"][0], "bound_by": r["bound"][1],
        "library_ms": None, "shape": f"cot tau {SIZE_TAU}, {SIZE_BWD_NS} spheres "
                                     f"{SIZE_BWD_SOFT_RES[0]}x{SIZE_BWD_SOFT_RES[1]}, "
                                     f"{REPAIR_SOFT_PIXELS} pixels' cotangent"})
    return out


FAULT_STEPS = 30                   # resilient_fit's steps on the card (the fit CLI's)
FAULT_CKPT_EVERY = 5
FAULT_NAN_STEP, FAULT_EXC_STEP = 12, 20
FAULT_LR = 1e-2                    # the fit CLI's --lr
PROFILE_TRIES = 3                  # captures of the traced block while records are lost


def faults_phase(torch, rt, card: str, dev) -> None:
    """Phase 23, second part (``[faults]``, ``[profile]``): ``device_healthcheck()``
    on the card; ``resilient_fit`` over ``fit_scene``'s fused step (kernel 4,
    ``fused_noaa``) at the fit CLI's width (its 2-sphere scene, FIT_RES, depth
    2, FAULT_STEPS steps, a checkpoint every FAULT_CKPT_EVERY) with a NaN
    injected at FAULT_NAN_STEP and an exception at FAULT_EXC_STEP: two events,
    restored at the checkpoints before them, and losses torch.equal to an
    uninterrupted run's (the backward is bit-deterministic); then a step that
    fails every time, diagnosed as deterministic. Then ``capture_trace`` with
    ``annotate`` around one ``render_image_cuda`` AA frame (kernel 2) and one
    fit step: the trace file names both scopes and both kernels;
    ``device_memory_stats``."""
    import tempfile
    from python_ray_tracer_tpu_torch import cli, train
    from python_ray_tracer_tpu_torch.ops.cuda import render_bwd_cuda as rb, render_cuda
    from python_ray_tracer_tpu_torch.utils import faults, profiling
    from python_ray_tracer_tpu_torch.utils.config import RenderConfig

    t0 = time.perf_counter()
    status = faults.device_healthcheck()
    print(f"[faults] device_healthcheck(): {status} in {time.perf_counter() - t0:.2f} s")
    check(status == {"cuda:0": True}, f"device_healthcheck() {status}")
    cfg = RenderConfig(width=FIT_RES[0], height=FIT_RES[1])
    scene = cli.fit_scene_two_spheres(cfg, dev)
    cam = rt.Camera.build(FIT_RES, cfg.camera_position, cfg.camera_euler, cfg.fov, device=dev)
    target = rt.render_image_cuda(cam, scene, depth=2, aliasing=False)

    def make_step():
        init = rt.Scene.from_leaves([t.clone() for t in scene.leaves()])
        init.spheres.center += torch.tensor(cli.FIT_SHIFT, device=dev)
        return train.make_train_step(init, train.cuda_value_and_grad(cam, target, depth=2),
                                     lr=FAULT_LR, trainable=("spheres",))

    step = make_step()
    ref = [float(step()) for _ in range(FAULT_STEPS)]

    class Faults:
        """A NaN at FAULT_NAN_STEP and an exception at FAULT_EXC_STEP, once each."""
        def __init__(self):
            self.nan = faults.FaultInjector([FAULT_NAN_STEP], mode="nan")
            self.exc = faults.FaultInjector([FAULT_EXC_STEP], mode="exception")

        def maybe_fail(self, i, loss):
            return self.exc.maybe_fail(i, self.nan.maybe_fail(i, loss))

    rb.reset_launch_counts()
    seen = []
    with tempfile.TemporaryDirectory() as d:
        t0 = time.perf_counter()
        _, _, losses, events = faults.resilient_fit(
            make_step(), steps=FAULT_STEPS, ckpt_dir=d, ckpt_every=FAULT_CKPT_EVERY,
            injector=Faults(), on_restart=lambda s, o, ev: seen.append(ev.step))
        fit_s = time.perf_counter() - t0
    restored = [(ev.step, ev.restored_step) for ev in events]
    same = torch.equal(torch.tensor(losses), torch.tensor(ref))
    print(f"[faults] resilient_fit, fused_noaa, {FIT_RES[0]}x{FIT_RES[1]} d2, {FAULT_STEPS} "
          f"steps, a checkpoint every {FAULT_CKPT_EVERY}, NaN at {FAULT_NAN_STEP} and an "
          f"exception at {FAULT_EXC_STEP}: events {restored} ({[ev.reason for ev in events]}), "
          f"on_restart saw {seen}; {len(losses)} losses torch.equal to the uninterrupted run's "
          f"{same} (first {losses[0]:.6g}, last {losses[-1]:.6g}); fused_noaa launches "
          f"{rb.LAUNCHES['fused_noaa']} in {fit_s:.1f} s")
    check(restored == [(FAULT_NAN_STEP, 10), (FAULT_EXC_STEP, 20)] and seen == [12, 20],
          f"restart events {restored}")
    check(len(losses) == FAULT_STEPS and same, "resilient_fit's losses differ from the run's")
    check(rb.LAUNCHES["fused_noaa"] >= FAULT_STEPS, "resilient_fit did not launch fused_noaa")

    class AlwaysFail(faults.FaultInjector):
        def maybe_fail(self, i, loss):
            return float("nan") if i == 2 else loss

    with tempfile.TemporaryDirectory() as d:
        try:
            faults.resilient_fit(make_step(), steps=5, ckpt_dir=d, ckpt_every=1,
                                 max_restarts=2, injector=AlwaysFail(fail_steps=[]))
            diagnosis = None
        except faults.UnrecoverableTraining as e:
            diagnosis = str(e)
    print(f"[faults] a step that fails every time: {diagnosis}")
    check(diagnosis is not None and "deterministic" in diagnosis, "no deterministic diagnosis")

    # A trace of one AA frame and one fit step.
    t0 = time.perf_counter()
    demo = rt.default_scene(device=dev)
    dcam = rt.default_camera(FIT_RES, device=dev)
    step = make_step()
    rt.render_image_cuda(dcam, demo)
    step()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    trace_dir = os.path.join(OUT_DIR, "trace")
    # The card host's torch.profiler can drop kernel records while the host
    # side keeps every launch call: a capture with fewer kernel records than
    # launch calls is taken again, and the last must be whole.
    for attempt in range(1, PROFILE_TRIES + 1):
        with profiling.capture_trace(trace_dir) as prof:
            with profiling.annotate("rt:render_aa"):
                rt.render_image_cuda(dcam, demo)
            with profiling.annotate("rt:fit_step"):
                step()
            torch.cuda.synchronize()
        with open(prof.trace_path) as f:
            text = f.read()
        events = json.loads(text)["traceEvents"]
        n_kernels = sum(e.get("cat") == "kernel" for e in events)
        n_launches = sum(e.get("cat") == "cuda_runtime" and "Launch" in e.get("name", "")
                         for e in events)
        if n_kernels >= n_launches:
            break
        print(f"[profile] capture {attempt}: {n_kernels} kernel records for {n_launches} "
              f"launch calls; capturing again")
    check(n_kernels >= n_launches, f"every capture lost kernel records ({n_kernels} of "
          f"{n_launches} in the last)")
    names = {k: k in text for k in ("rt:render_aa", "rt:fit_step", "render_fwd_kernel",
                                    "render_bwd_kernel", "reduce_rows_kernel")}
    device_us = {e.key: e.device_time_total for e in prof.key_averages()
                 if "kernel" in e.key and e.device_time_total > 0}
    mem = profiling.device_memory_stats(dev)
    print(f"[profile] capture_trace (capture {attempt}): {os.path.relpath(prof.trace_path, ROOT)} "
          f"({len(text)} B, {n_kernels} kernel records, {n_launches} launch calls) names "
          f"{names}; device us by kernel {device_us}; "
          f"device_memory_stats: peak {mem.get('allocated_bytes.all.peak')} B, "
          f"{len(mem)} keys; {time.perf_counter() - t0:.1f} s | {card}")
    check(all(names.values()), f"the trace lacks {[k for k, v in names.items() if not v]}")
    check(mem.get("allocated_bytes.all.peak", 0) > 0 and
          profiling.device_memory_stats(torch.device("cpu")) == {}, "device_memory_stats")


BT_NS = (100, 1000, 5000)          # [bwd-tables]: every form, tables on against off
BT_RES = (256, 256)
BT_ROWS = (16384, (64, 64))        # the third form alone past 8208 spheres
BT_SLICE = (1000, 96, 64)          # spheres, x_offset, local_width of a BT_RES frame
BT_TIME_NS = (100, 1000)           # [bwd-tables-time] at FIT_RES, depth 2
BT_MAIN_NS = 1000                  # the large-scene main path, its bound and kernels-line entries
BT_PLAIN_RES = (64, 64)            # the plain fused step at those scenes (its memory)
BT_STEPS = 3                       # fit_scene steps of the large-scene main path
AA1_SCENES = (2, 0, 100, 1000)     # [fused-aa1]: the fit scene, the demo scene, random clouds
AA1_DEPTHS = (0, 1, 2, 3, 4)       # 4: the general depth's instantiation
BT_MODES = ("cot_noaa", "cot_aa", "fused_noaa", "fused_aa", "fused_aa1")
BT_TREE_NS = (400, 1000)           # [bwd-tree]: the staged form's tree staged against in place
BT_TREE_ROUNDS = 8                 # A, B, B, A rounds of [bwd-tree]
BT_WALL_STEPS = 10                 # [bwd-step-walls]: steps timed one by one


def bwd_tables_phase(torch, rt, card: str, dev) -> list:
    """Phase 24 (``--phase 24`` alone): kernel 4 through the render's
    large-scene tables and the one-launch fused AA step. ``[bwd-tables]``:
    each backward mode (and ``fused_aa1``, the one-launch step) with its
    tables on against the same launch shape with every table off,
    ``torch.equal``, in the staged, global and device-rows forms at BT_NS
    spheres, in the device-rows form at BT_ROWS, for a slice, and the
    ``aa_shared`` frame of the two-launch step. ``[fused-aa1]``: the
    one-launch step against the two-launch step, bits and kernel-alone times,
    on AA1_SCENES at AA1_DEPTHS (256x256) and at FIT_RES d2 from shifted
    centers (both also in the device-rows form on the large scenes).
    ``[bwd-tables-time]``: the kernel alone and the whole ``fit_scene`` step
    (``train.cuda_value_and_grad`` + Adam) in the main path's forms at
    BT_TIME_NS spheres, FIT_RES d2, without and with AA, tables on and off,
    with the tables' build beside; the steps one by one
    (``[bwd-step-walls]``) and one trace (``[bwd-step-trace]``).
    ``[bwd-tree]``: the staged form's bounce tree staged against read in
    place at BT_TREE_NS. ``[main]``: ``fit_scene`` at 1000 spheres, without
    and with AA, counts set to 0 before and read after. Returns the two
    entries of the kernels line (``render_bwd_tables_fused_noaa``,
    ``render_bwd_tables_fused_aa1``)."""
    from python_ray_tracer_tpu_torch import cli, train
    from python_ray_tracer_tpu_torch.ops.cuda import render_bwd_cuda as rb, render_cuda
    from python_ray_tracer_tpu_torch.utils import timing
    from python_ray_tracer_tpu_torch.utils.config import RenderConfig
    cfg = RenderConfig()
    OFF = ALL_OFF

    def scene_n(n):
        if n == 2:
            return cli.fit_scene_two_spheres(cfg, dev)
        return scene_of(rt, cfg, n, dev)

    def camera(res):
        return rt.Camera.build(res, cfg.camera_position, cfg.camera_euler, cfg.fov, device=dev)

    def shifted(scene):
        """The scene with every center moved by the fit CLI's shift (a fit's
        first step: the cotangent is not 0 anywhere the spheres show)."""
        init = rt.Scene.from_leaves([t.clone() for t in scene.leaves()])
        init.spheres.center += torch.tensor(cli.FIT_SHIFT, device=dev)
        return init

    def prepare(cam, sc, mode, x, *, depth=2, culls=None, x_offset=0, lw=None, staged=None,
                device_rows=None, tree_smem=None, shape=None, may_not_fit=False):
        """Everything a launch needs, packed once: (run, shape); run() launches
        ``mode`` (``fused_aa1``: the one-launch step; ``fused_aa``: the
        aa_shared render, then the backward) and returns (flat, frame). With
        ``may_not_fit``, (None, None) where the planner refuses the form."""
        one = mode == "fused_aa1"
        m = "fused_aa" if one else mode
        aa, fused = m.endswith("_aa"), m.startswith("fused")
        Wg, H = cam.resolution
        W = Wg if lw is None else lw
        packed = render_cuda.packed_inputs(cam, sc, depth=depth, compat=True, x_offset=x_offset)
        params, tables, cnt = packed
        tabs = render_cuda.large_scene_tables(cam, sc, depth=depth, aliasing=aa, compat=True,
                                              packed=packed, x_offset=x_offset, local_width=W,
                                              **(culls or {}))
        if shape is None:
            try:
                shape = rb.launch_plan(cam, sc, m, W, staged=staged, device_rows=device_rows,
                                       tabs=tabs, tree_smem=tree_smem, one_launch=one)
            except ValueError:
                if not may_not_fit:
                    raise
                return None, None
        elif tabs[2] is None:   # another launch's shape, for the launch without the tree
            shape = shape._replace(tree_smem=False)
        cheap = render_cuda.shadow_cheap_ok(sc, True)
        n = rb.n_grads(*cnt, fused)
        out, partial = torch.empty(n, device=dev), torch.empty(n * shape.blocks, device=dev)
        img = torch.empty((W, H, 3), device=dev)
        rec = torch.empty(rb.rec_floats(shape, depth), device=dev) if one else None
        scratch = torch.empty(rb.scratch_floats(*cnt, shape), device=dev) \
            if shape.device_rows else None

        def run():
            frame = None
            if m == "fused_aa" and not one:
                frame = render_cuda.launch(img, params, tables, cnt, depth=depth,
                                           mode="aa_shared", compat=True, cheap_shadow=cheap,
                                           vis=tabs[0], shadow=tabs[1], tree=tabs[2],
                                           cells=tabs[3], W_global=Wg)
            rb.launch(out, partial, params, tables, cnt,
                      image=frame if frame is not None else (None if fused else x),
                      target=x if fused else None, W=W, H=H, depth=depth, mode=m, compat=True,
                      cheap_shadow=cheap, shape=shape, W_global=Wg, tabs=tabs,
                      one_launch=one, rec=rec, scratch=scratch)
            return out.clone(), None if frame is None else frame.clone()
        return run, shape

    def inputs(cam, sc, mode, seed=0):
        """A fit's target (fused) or its cotangent, from the scene with its
        centers moved back: the cotangent is not 0 where the spheres show."""
        W, H = cam.resolution
        aa = mode.endswith("_aa") or mode == "fused_aa1"
        tgt = rt.render_image_cuda(cam, sc, depth=2, aliasing=aa)
        if mode.startswith("fused"):
            return tgt.contiguous()
        img = rt.render_image_cuda(cam, shifted(sc), depth=2, aliasing=aa)
        return (2.0 * (img - tgt) / img.numel()).contiguous()

    # [bwd-tables]: tables on against off at one launch shape, every mode and form.
    t0 = time.perf_counter()
    cam = camera(BT_RES)
    cases = [(n, BT_RES, form) for n in BT_NS for form in ("staged", "global", "rows")]
    cases.append((BT_ROWS[0], BT_ROWS[1], "rows"))
    for n, res, form in cases:
        sc, c = scene_n(n), camera(res)
        init = shifted(sc)
        line = []
        for mode in BT_MODES:
            x = inputs(c, sc, mode)
            kw = dict(staged=form == "staged", device_rows=form == "rows")
            # the staged form may not fit a large scene: then it is not a form there
            run_on, shape = prepare(c, init, mode, x, may_not_fit=form == "staged", **kw)
            if run_on is None:
                line.append(f"{mode} (no staged plan)")
                continue
            run_off, _ = prepare(c, init, mode, x, culls=OFF, shape=shape)
            (a, fa), (b, fb) = run_on(), run_off()
            same = torch.equal(a, b) and (fa is None or torch.equal(fa, fb))
            check(bool(torch.isfinite(a).all()), f"{n} {form} {mode}: not finite")
            check(same, f"[bwd-tables] {n} spheres {form} {mode}: tables on differ from off "
                        f"(max {float((a - b).abs().max()):.3g})")
            line.append(f"{mode} {same}" + (f" (its aa_shared frame {torch.equal(fa, fb)})"
                                            if fa is not None else "")
                        + f" [{shape.nt}/{shape.blocks}]")
        print(f"[bwd-tables] {n} spheres {res[0]}x{res[1]} d2 {form}: tables on torch.equal "
              f"to off: " + ", ".join(line))
    # a slice of the frame, through the tables of its own tiles
    n, x0, lw = BT_SLICE
    sc = shifted(scene_n(n))
    for mode in BT_MODES:
        xf = inputs(cam, scene_n(n), mode)
        x = xf[x0:x0 + lw].contiguous()
        run_on, shape = prepare(cam, sc, mode, x, x_offset=x0, lw=lw)
        run_off, _ = prepare(cam, sc, mode, x, x_offset=x0, lw=lw, culls=OFF, shape=shape)
        (a, fa), (b, fb) = run_on(), run_off()
        same = torch.equal(a, b) and (fa is None or torch.equal(fa, fb))
        print(f"[bwd-tables] {n} spheres slice [{x0}, {x0 + lw}) of {BT_RES[0]}x{BT_RES[1]} d2 "
              f"{mode}: tables on torch.equal to off {same}")
        check(same, f"[bwd-tables] slice {mode}: tables on differ from off")
    t0 = phase_time("phase 24 [bwd-tables]", t0)

    def step_flat(cam, scene, tgt, depth, form):
        """The AA step's flat gradient, camera slots and loss included."""
        loss, g, cg = rb.loss_and_scene_grads_cuda(cam, scene, tgt, depth=depth, aliasing=True,
                                                   return_camera=True, aa_form=form)
        return rb.flatten_grads(g, cg, loss)

    # [fused-aa1]: the one-launch step against the two-launch step.
    for n in AA1_SCENES:
        sc = scene_n(n)
        init = shifted(sc)
        c = camera(BT_RES)
        tgt = inputs(c, sc, "fused_aa")
        worst = {}
        for d in AA1_DEPTHS:
            two, one = (step_flat(c, init, tgt, d, f) for f in ("two", "one"))
            if torch.equal(one, two):
                worst[d] = "bits"
                continue
            rule = rb.grad_rule(one, two, *counts(init))
            bad = [k for k, (_, ok) in rule.items() if not ok]
            lrel = abs(float(one[-1] - two[-1])) / abs(float(two[-1]))
            check(not bad and lrel <= 1e-6, f"[fused-aa1] {n} spheres d{d}: {bad}, loss {lrel}")
            worst[d] = f"grad_rule {max(v for v, _ in rule.values()):.2e}, loss rel {lrel:.1e}"
        why = "" if all(v == "bits" for v in worst.values()) else (
            " (the loss's bits; the gradient within grad_rule, not its bits: the small scenes' "
            "contracted source, where nvcc contracts the replay's rebuilt rays otherwise than "
            "the retrace)")
        print(f"[fused-aa1] {n} spheres {BT_RES[0]}x{BT_RES[1]} one launch against two, by "
              f"depth: {worst}{why}")
        # times at the fit's size, depth 2, from shifted centers
        c = camera(FIT_RES)
        tgt = inputs(c, sc, "fused_aa")
        runs = {f: prepare(c, init, m, tgt)[0] for f, m in (("two", "fused_aa"),
                                                            ("one", "fused_aa1"))}
        if n > render_cuda.CULL_MIN_SPHERES:   # and both in the device-rows form's plan
            runs.update({f"{f} rows": prepare(c, init, m, tgt, device_rows=True)[0]
                         for f, m in (("two", "fused_aa"), ("one", "fused_aa1"))})
        ms = _alternate(rt, runs, 10 if n != BT_MAIN_NS else 5)
        print(f"[fused-aa1] {n} spheres {FIT_RES[0]}x{FIT_RES[1]} d2 kernel alone (A, B, B, A "
              f"minima): " + ", ".join(f"{k} {v:.4f} ms" for k, v in ms.items())
              + f"; the wrappers take one launch | {card}")
    t0 = phase_time("phase 24 [fused-aa1]", t0)

    # [bwd-tables-time]: kernel alone and the whole step, tables on and off
    # (the main path's forms: fused_noaa and the one-launch AA step); each
    # step also timed one by one ([bwd-step-walls]) and traced once at the
    # smallest scene with AA ([bwd-step-trace]).
    entries = []
    c = camera(FIT_RES)
    for n in BT_TIME_NS:
        sc = scene_n(n)
        init = shifted(sc)
        for aa in (False, True):
            key = "fused_aa1" if aa else "fused_noaa"
            tgt = rt.render_image_cuda(c, sc, depth=2, aliasing=aa).contiguous()
            kernel = {}
            for label, culls in (("on", None), ("off", OFF)):
                run, shape = prepare(c, init, key, tgt, culls=culls)
                kernel[label] = 1e3 * rt.time_fn(run, warmup=1, iters=3 if label == "off" else 10)
            cot = {}
            if n == BT_MAIN_NS:   # the cotangent mode's kernel alone, tables on and off
                cm = "cot_aa" if aa else "cot_noaa"
                x = (2.0 * (rt.render_image_cuda(c, init, depth=2, aliasing=aa) - tgt) /
                     tgt.numel()).contiguous()
                for label, culls in (("on", None), ("off", OFF)):
                    run, _ = prepare(c, init, cm, x, culls=culls)
                    cot[label] = 1e3 * rt.time_fn(run, warmup=1,
                                                  iters=3 if label == "off" else 10)
            dev_ms, host_ms = host_and_device_ms(lambda: render_cuda.large_scene_tables(
                c, init, depth=2, aliasing=aa, compat=True), iters=5)
            steps, walls = {}, {}
            for label, culls in (("on", {}), ("off", OFF)):
                s = rt.Scene.from_leaves([t.clone() for t in init.leaves()])
                step = train.make_train_step(
                    s, train.cuda_value_and_grad(c, tgt, depth=2, aliasing=aa, **culls),
                    lr=1e-2, trainable=("spheres.center",))
                steps[label] = 1e3 * rt.time_fn(step, warmup=1, iters=3 if culls else 10)
                if label == "on":
                    walls = step_walls(torch, step, BT_WALL_STEPS)
                    if aa and n == BT_TIME_NS[0]:
                        step_trace(torch, step, f"{n} spheres {FIT_RES[0]}x{FIT_RES[1]} d2 "
                                   f"{key}, tables on", card)
            print(f"[bwd-tables-time] {n} spheres {FIT_RES[0]}x{FIT_RES[1]} d2 {key}: kernel "
                  f"alone tables on / off {kernel['on']:.4f} / {kernel['off']:.4f} ms; the whole "
                  f"step (train.cuda_value_and_grad) on / off {steps['on']:.4f} / "
                  f"{steps['off']:.4f} ms; the tables' build {dev_ms:.4f} ms device, "
                  f"{host_ms:.4f} ms host"
                  + (f"; {cm} kernel alone on / off {cot['on']:.4f} / {cot['off']:.4f} ms"
                     if cot else "") + f" | {card}")
            print(f"[bwd-step-walls] {n} spheres {key} tables on: {BT_WALL_STEPS} steps one by "
                  f"one (host clock, synchronised each): min {min(walls):.4f}, median "
                  f"{statistics.median(walls):.4f}, max {max(walls):.4f} ms; "
                  + " ".join(f"{w:.3f}" for w in walls))
            if n == BT_MAIN_NS:
                entries.append((key, kernel["on"], steps["on"], tgt, init))
    t0 = phase_time("phase 24 [bwd-tables-time]", t0)

    # [bwd-tree]: the staged form with the bounce tree staged against read in
    # place, kernel alone, BT_TREE_ROUNDS rounds of A, B, B, A at BT_TREE_NS.
    for n in BT_TREE_NS:
        sc = scene_n(n)
        init = shifted(sc)
        for key in ("fused_noaa", "fused_aa1"):
            tgt = rt.render_image_cuda(c, sc, depth=2, aliasing=key != "fused_noaa")
            preps = {ts: prepare(c, init, key, tgt, staged=True, tree_smem=ts)
                     for ts in (False, True)}
            shapes = {ts: p[1] for ts, p in preps.items()}
            check(shapes[True].tree_smem and not shapes[False].tree_smem,
                  f"[bwd-tree] {n} {key}: plans {shapes}")
            check(torch.equal(preps[True][0]()[0], preps[False][0]()[0]),
                  f"[bwd-tree] {n} {key}: the two forms' gradients differ")
            ms = {False: [], True: []}
            for _ in range(BT_TREE_ROUNDS):
                for ts in (False, True, True, False):
                    ms[ts].append(1e3 * rt.time_fn(preps[ts][0], warmup=1, iters=5))
            med = {ts: statistics.median(v) for ts, v in ms.items()}
            spread = {ts: (max(v) - min(v)) / med[ts] for ts, v in ms.items()}
            gain = (med[False] - med[True]) / med[False]
            print(f"[bwd-tree] {n} spheres {FIT_RES[0]}x{FIT_RES[1]} d2 {key} staged form, "
                  f"{2 * BT_TREE_ROUNDS} runs each: tree staged min / median / max "
                  f"{min(ms[True]):.4f} / {med[True]:.4f} / {max(ms[True]):.4f} ms "
                  f"({shapes[True].nt}/{shapes[True].blocks}), in place "
                  f"{min(ms[False]):.4f} / {med[False]:.4f} / {max(ms[False]):.4f} ms "
                  f"({shapes[False].nt}/{shapes[False].blocks}); staged faster by "
                  f"{100 * gain:.2f}% of the median, spreads (max - min) / median "
                  f"{100 * spread[True]:.2f}% / {100 * spread[False]:.2f}%; gain above both "
                  f"spreads {gain > max(spread.values())} | {card}")
    t0 = phase_time("phase 24 [bwd-tree]", t0)

    # [main]: the large-scene training path through its entry point.
    sc = scene_n(BT_MAIN_NS)
    init = shifted(sc)
    tables_main = {}
    for aa in (False, True):
        key = "fused_aa1" if aa else "fused_noaa"
        tgt = rt.render_image_cuda(c, sc, depth=2, aliasing=aa)
        rb.reset_launch_counts()
        render_cuda.reset_launch_counts()
        _, losses = train.fit_scene(init, c, tgt, steps=BT_STEPS, lr=1e-2, depth=2, aliasing=aa,
                                    backend="cuda", trainable=("spheres.center",))
        torch.cuda.synchronize()
        got = {m: v for m, v in rb.LAUNCHES.items() if v}
        print(f"[main] fit_scene(aliasing={aa}) {BT_MAIN_NS} spheres {FIT_RES[0]}x{FIT_RES[1]} d2 "
              f"{BT_STEPS} steps: backward launches {got}, through the tables "
              f"{ {m: v for m, v in rb.TABLE_LAUNCHES.items() if v} }; render launches "
              f"{dict(render_cuda.LAUNCHES)}; losses {[round(v, 6) for v in losses]}")
        check(got == {key: BT_STEPS} and rb.TABLE_LAUNCHES[key] == BT_STEPS and
              not any(rb.PLAIN_CALLS.values()),
              f"fit_scene at {BT_MAIN_NS} spheres: {got}, {dict(rb.TABLE_LAUNCHES)}")
        check(all(v == v and v < float("inf") for v in losses),
              f"fit_scene at {BT_MAIN_NS} spheres: losses {losses}")
        tables_main[key] = rb.TABLE_LAUNCHES[key]

    # [bound] and the kernels line: the tables' forms at 1000 spheres.
    out = []
    pc = camera(BT_PLAIN_RES)
    for key, k_ms, step_ms, tgt, init in entries:
        aa = key == "fused_aa1"
        mode = "fused_aa" if aa else key
        pos = timing.bwd_positions(*FIT_RES, aa)
        live = timing.hard_chain_counts(c, init, pos, depth=2)
        hits0 = timing.level0_hits_by_tile(c, init, pos)
        vis, shadow, tree, _ = render_cuda.large_scene_tables(c, init, depth=2, aliasing=aa,
                                                              compat=True)
        bound, by = timing.bound_ms(*timing.hard_bwd_work_culled(
            *FIT_RES, *counts(init), mode, live, pos, hits0, vis, shadow, tree))
        full = timing.bound_ms(*timing.hard_bwd_work(*FIT_RES, *counts(init), mode, live))[0]
        ptgt = rt.render_image_cuda(pc, scene_n(BT_MAIN_NS), depth=2, aliasing=aa).contiguous()
        flat, ref, ref_all, held = rb.kernel_and_plain(mode, pc, init, ptgt, depth=2,
                                                       aa_form="one")
        rule = rb.grad_rule(flat, ref, *counts(init), ref_all)
        bad = [k for k, (_, ok) in rule.items() if not ok]
        check(not bad, f"[bwd-tables] {key} against the plain version: {bad}")
        plain_ms = 1e3 * rt.time_fn(rb.loss_and_scene_grads_plain, pc, init, ptgt, depth=2,
                                    aliasing=aa, warmup=0, iters=1)
        print(f"[bound] render_bwd_tables {key} {BT_MAIN_NS} spheres {FIT_RES[0]}x{FIT_RES[1]} d2: "
              f"{bound:.4f} ms ({by}; timing.hard_bwd_work_culled: the listed primary sweeps, "
              f"the empty occluder lists, the tree's floor), unculled {full:.4f} ms, vs kernel "
              f"alone {k_ms:.4f} ms ({k_ms / bound:.1f}x); against the plain version at "
              f"{BT_PLAIN_RES[0]}x{BT_PLAIN_RES[1]} ({int(held.sum())} pixels held out): "
              + " ".join(f"{k}={v:.2e}" for k, (v, _) in rule.items()) + f" | {card}")
        out.append({"name": f"render_bwd_tables_{key}", "route": "cuda", "source": BWD_SOURCE,
                    "replaces": BWD_REPLACES, "launches": tables_main[key],
                    "max_abs_err": float((flat - ref).abs().max()),
                    "max_rel_err": max(v for v, _ in rule.values()), "ms": step_ms,
                    "plain_ms": plain_ms, "kernel_only_ms": k_ms, "bound_ms": bound,
                    "bound_by": by, "library_ms": None, "shape": f"{BT_MAIN_NS}sph_{FIT_RES[0]}x"
                    f"{FIT_RES[1]}_d2", "plain_shape": "x".join(map(str, BT_PLAIN_RES))})
    phase_time("phase 24 [main] and [bound]", t0)
    return out


def step_walls(torch, step, n: int) -> list:
    """Host-clock ms of each of ``n`` calls of ``step``, each synchronised."""
    out = []
    for _ in range(n):
        t0 = time.perf_counter()
        step()
        torch.cuda.synchronize()
        out.append(1e3 * (time.perf_counter() - t0))
    return out


def step_trace(torch, step, label: str, card: str, calls: int = 5) -> None:
    """[bwd-step-trace]: ``calls`` steps under torch.profiler (host and
    device): the host clock a step, the device's busy time a step (its
    kernels and copies), and the host ops and kernels that take most."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(calls):
            step()
        torch.cuda.synchronize()
        wall = 1e3 * (time.perf_counter() - t0) / calls
    ka = prof.key_averages()

    def dev_us(e):
        return getattr(e, "self_device_time_total", getattr(e, "self_cuda_time_total", 0.0))
    busy = sum(dev_us(e) for e in ka) / 1e3 / calls
    host = sorted(ka, key=lambda e: e.self_cpu_time_total, reverse=True)[:6]
    kern = sorted((e for e in ka if dev_us(e) > 0), key=dev_us, reverse=True)[:4]
    print(f"[bwd-step-trace] {label}: {calls} steps, host clock {wall:.4f} ms a step, device "
          f"busy {busy:.4f} ms a step ({'not measured' if busy == 0 else f'{100 * (1 - busy / wall):.1f}% idle'}); "
          f"host self time a step: " + ", ".join(
              f"{e.key} {e.self_cpu_time_total / 1e3 / calls:.3f} ms x{e.count // calls}"
              for e in host)
          + "; device a step: " + ", ".join(f"{e.key[:40]} {dev_us(e) / 1e3 / calls:.3f} ms"
                                            for e in kern) + f" | {card}")


# --- phase 25: shadow lists at the bounce levels; shadow_cull ------------------

LV_LEVELS = (1, 2, 3)               # [levels], [levels-time]: shadow_list_levels
LV_FORM = (5000, (256, 256))        # [levels]: staged and global forms, compat and clean
LV_BITS = (1000, (256, 256))        # [levels]: compat and clean, the slice, depth 4
LV_SLICE = (96, 64)                 # x_offset, local_width of the LV_BITS frame
LV_TIME_NS = (100, 1000)            # [levels-time], [capsule] at LARGE_RES, depth 2


def levels_capsule_phase(torch, rt, card: str, dev) -> None:
    """Phase 25 (``--phase 25`` alone): the last two modes of TPU kernels 1-3.
    ``[levels]``: frames with the shadow lists of the first L trace levels
    (``render_image_cuda(shadow_list_levels=L)``) ``torch.equal`` to every
    table off, at L in LV_LEVELS and L = 5 at depth 4, in the staged and the
    global form (LV_FORM and LV_BITS, compat and clean), for a slice, every
    mode; the list kernel's rows of L levels integer for integer the plain
    function's. ``[levels-time]``: at each L, the hit-extent kernel, the list
    kernel and the render kernel alone and the whole wrapper at LV_TIME_NS
    spheres, 1920x1080 depth 2, with the list kernel's bound (``[bound]``).
    ``[capsule]``: ``shadow_cull=True`` (the JAX wrapper's capsule cull)
    makes the default's launches and frames (``torch.equal``) at LV_TIME_NS
    spheres, 1920x1080 depth 2, without and with AA."""
    from python_ray_tracer_tpu_torch.ops.cuda import cull_tables as ct
    from python_ray_tracer_tpu_torch.ops.cuda import hit_extents_cuda as hx
    from python_ray_tracer_tpu_torch.ops.cuda import render_cuda
    from python_ray_tracer_tpu_torch.ops.cuda import shadow_lists_cuda as sl
    from python_ray_tracer_tpu_torch.utils import timing
    from python_ray_tracer_tpu_torch.utils.config import RenderConfig
    cfg = RenderConfig()
    modes = render_cuda.MODES

    def camera(res, pose=None):
        pos, euler = pose or (cfg.camera_position, cfg.camera_euler)
        return rt.Camera.build(res, pos, euler, cfg.fov, device=dev)

    def launch(cam, scene, mode, compat, tabs, packed, depth=2, **kw):
        W, H = cam.resolution
        return render_cuda.launch(
            torch.empty((W, H, 3), device=dev), *packed, depth=depth, mode=mode, compat=compat,
            cheap_shadow=render_cuda.shadow_cheap_ok(scene, compat), vis=tabs[0],
            shadow=tabs[1], tree=tabs[2], cells=tabs[3], **kw)

    def kw_of(mode, compat=True, depth=2):
        return dict(depth=depth, compat=compat, aliasing=mode != "aa_none",
                    aa_share=mode == "aa_shared")

    def level0(shadow, n_tiles):
        """The level-0 rows of shadow lists of L levels, as a one-level table."""
        idx, cnt, k, L = shadow
        nl = cnt.numel() // (n_tiles * L)
        return (idx.reshape(n_tiles, L, nl * k)[:, 0].reshape(-1),
                cnt.reshape(n_tiles, L, nl)[:, 0].reshape(-1), k, 1)

    render_cuda.reset_launch_counts()
    hx.reset_launch_counts()
    sl.reset_launch_counts()

    # [levels]: bits
    n_cases = 0
    for (n, res), pose, compats in ((LV_FORM, BENCH_POSE, (True, False)),
                                    (LV_BITS, None, (True, False))):
        scene, cam = scene_of(rt, cfg, n, dev), camera(res, pose)
        for compat in compats:
            packed = render_cuda.packed_inputs(cam, scene, depth=2, compat=compat)
            for mode in modes:
                off = rt.render_image_cuda(cam, scene, **kw_of(mode, compat), **ALL_OFF)
                for L in LV_LEVELS:
                    tabs = render_cuda.large_scene_tables(
                        cam, scene, depth=2, aliasing=mode != "aa_none", compat=compat,
                        packed=packed, shadow_list_levels=L)
                    for form in (0, 1):
                        img = launch(cam, scene, mode, compat, tabs, packed, form=form)
                        check(torch.equal(img, off), f"[levels] {n} spheres {mode} compat="
                              f"{compat} L={L} form {form}: differs from every table off")
                        n_cases += 1
    scene, cam = scene_of(rt, cfg, LV_BITS[0], dev), camera(LV_BITS[1])
    x0, lw = LV_SLICE
    for mode in modes:
        off4 = rt.render_image_cuda(cam, scene, **kw_of(mode, depth=4), **ALL_OFF)
        on4 = rt.render_image_cuda(cam, scene, **kw_of(mode, depth=4), shadow_list_levels=5)
        whole = rt.render_image_cuda(cam, scene, **kw_of(mode), **ALL_OFF)
        part = rt.render_image_cuda(cam, scene, **kw_of(mode), shadow_list_levels=3,
                                    x_offset=x0, local_width=lw)
        check(torch.equal(on4, off4), f"[levels] depth 4 L=5 {mode}: differs")
        check(torch.equal(part, whole[x0:x0 + lw]), f"[levels] slice {mode}: differs")
        n_cases += 2
    vis = render_cuda.large_scene_tables(cam, scene, depth=2, aliasing=True, compat=True)[0]
    tree = ct.bounce_tree(scene.spheres.center, scene.spheres.radius)
    Lp, C, R = scene.lights.position, scene.spheres.center, scene.spheres.radius
    for L in (*LV_LEVELS, 5):
        scale = torch.empty(1, device=dev)
        ext = hx.hit_extents_cuda(cam, scene, aliasing=True, n_levels=L, vis=vis, tree=tree,
                                  scale=scale)
        for K in (vis[2], 4):
            got = sl.shadow_lists_cuda(ext, scale, Lp, C, R, K=K, compat=True)
            want = ct.shadow_visibility_lists(ext, Lp, C, R, K=K, compat=True)
            check(torch.equal(got[0], want[0]) and torch.equal(got[1], want[1]),
                  f"[levels] list rows of {L} levels, K={K}: differ from the plain function")
    print(f"[levels] {n_cases} frames torch.equal to every table off (L in {LV_LEVELS}, "
          f"staged and global forms at {LV_FORM[0]} spheres {LV_FORM[1][0]}x{LV_FORM[1][1]}, "
          f"compat and clean at {LV_BITS[0]} spheres, depth 4 at L=5, the slice "
          f"[{x0}, {x0 + lw})); list kernel rows of L = 1, 2, 3, 5 levels at K = "
          f"{vis[2]} and 4 integer for integer the plain function's")

    # [levels-time]
    for n in LV_TIME_NS:
        scene, cam = scene_of(rt, cfg, n, dev), camera(LARGE_RES)
        W, H = LARGE_RES
        packed = render_cuda.packed_inputs(cam, scene, depth=2, compat=True)
        tree = ct.bounce_tree(scene.spheres.center, scene.spheres.radius) \
            if render_cuda.uses_tree(n, 2) else None
        Lp, C, R = scene.lights.position, scene.spheres.center, scene.spheres.radius
        order = ct.light_order(Lp, C, R).to(torch.int32)
        k = ct.list_capacity(n)
        reps = 20 if n <= 100 else 5
        for aa in (False, True):
            mode = "aa_shared" if aa else "aa_none"
            parts = []
            # the live counts of every trace level, for the render's bound
            ext3 = hx.hit_extents_cuda(cam, scene, aliasing=aa, n_levels=3, tree=tree,
                                       vis=render_cuda.large_scene_tables(
                                           cam, scene, depth=2, aliasing=aa, compat=True,
                                           packed=packed)[0])
            for L in LV_LEVELS:
                tabs = render_cuda.large_scene_tables(cam, scene, depth=2, aliasing=aa,
                                                      compat=True, packed=packed,
                                                      shadow_list_levels=L)
                vis = tabs[0]
                n_tiles = vis[1].numel()
                ext = torch.empty((n_tiles * L, 8), device=dev)
                scale = torch.empty(1, device=dev)
                hx_ms = 1e3 * rt.time_fn(hx.launch, ext, *packed, W=W, H=H, aliasing=aa,
                                         compat=True, n_levels=L, vis=vis,
                                         tree=tree if L > 1 else None, scale=scale,
                                         warmup=2, iters=reps)
                rows = (torch.empty(n_tiles * L * 3 * k, dtype=torch.int32, device=dev),
                        torch.empty(n_tiles * L * 3, dtype=torch.int32, device=dev))
                sl_ms = 1e3 * rt.time_fn(sl.launch, *rows, ext, scale, Lp, C, R, order, k=k,
                                         compat=True, warmup=2, iters=reps)
                bound = timing.bound_ms(*timing.shadow_lists_work(ext, Lp, C, R, K=k,
                                                                  compat=True))
                hx_bound = timing.bound_ms(*timing.hit_extents_work(
                    W, H, n, 1, aa, vis, ext.reshape(n_tiles, L, 8)[:, 0], scale=True))
                r_bound = timing.bound_ms(*timing.large_scene_work(
                    W, H, n, 1, 3, mode, vis, level0(tabs[1], n_tiles), ext3))
                r_ms = 1e3 * rt.time_fn(launch, cam, scene, mode, True, tabs, packed,
                                        warmup=2, iters=reps)
                w_ms = 1e3 * rt.time_fn(rt.render_image_cuda, cam, scene, depth=2,
                                        aliasing=aa, shadow_list_levels=L, warmup=2,
                                        iters=reps)
                listed = float((tabs[1][1] >= 0).float().mean())
                cnt = tabs[1][1].float()
                mean = float(cnt[cnt >= 0].mean()) if bool((cnt >= 0).any()) else 0.0
                parts.append(f"L={L}: hit_extents alone {hx_ms:.4f} ms, list kernel alone "
                             f"{sl_ms:.4f} ms (bound {bound[0]:.4f} ms, {bound[1]}), render "
                             f"kernel alone {r_ms:.4f} ms, wrapper {w_ms:.4f} ms, rows mean "
                             f"{mean:.2f} spheres, listed share {listed:.4f}")
                print(f"[bound] {n} spheres {W}x{H} {'aa' if aa else 'noaa'} L={L}: "
                      f"shadow_lists {bound[0]:.4f} ms ({bound[1]}) vs kernel alone "
                      f"{sl_ms:.4f} ms; hit_extents {hx_bound[0]:.4f} ms ({hx_bound[1]}, "
                      f"level 0's work: a lower bound) vs {hx_ms:.4f} ms; render "
                      f"{r_bound[0]:.4f} ms ({r_bound[1]}, large_scene_work on the level-0 "
                      f"rows: a lower bound) vs {r_ms:.4f} ms | {card}")
            print(f"[levels-time] {n} spheres {W}x{H} d2 {mode}: " + "; ".join(parts) +
                  f" | {card}")

    # [capsule]: shadow_cull takes the default launches and gives their bits
    def counts():
        return (dict(render_cuda.LAUNCHES), dict(render_cuda.GLOBAL_LAUNCHES),
                dict(hx.LAUNCHES), dict(sl.LAUNCHES))

    def launches_of(fn):
        """fn's result and the launches it made (the counters read before and
        after, left as they are)."""
        a = counts()
        out = fn()
        b = counts()
        return out, tuple({k: y[k] - x[k] for k in y} for x, y in zip(a, b))

    cam = camera(LARGE_RES)
    made = []
    for n in LV_TIME_NS:
        scene = scene_of(rt, cfg, n, dev)
        for aa in (False, True):
            (a, used_a), (b, used_b) = (launches_of(
                lambda kw=kw: rt.render_image_cuda(cam, scene, depth=2, aliasing=aa, **kw))
                for kw in ({}, dict(shadow_cull=True)))
            check(torch.equal(a, b), f"[capsule] {n} spheres aa={aa}: shadow_cull=True "
                  f"differs from the default")
            check(used_a == used_b, f"[capsule] {n} spheres aa={aa}: shadow_cull changes "
                  f"the launches {used_a} -> {used_b}")
            made.append(f"{n} spheres {'AA' if aa else 'no AA'} "
                        f"{sum(used_a[0].values())} render launches")
    print(f"[capsule] shadow_cull=True at {LARGE_RES[0]}x{LARGE_RES[1]} d2: the default's "
          f"frames (torch.equal) and launches ({', '.join(made)}, and the same hit_extents "
          f"and shadow_lists launches)")
    print(f"[levels] launches in phase 25: render {dict(render_cuda.LAUNCHES)}, of them "
          f"global {dict(render_cuda.GLOBAL_LAUNCHES)}; hit_extents "
          f"{hx.LAUNCHES['hit_extents']}; shadow_lists {sl.LAUNCHES['shadow_lists']}")


# --- phase 26: objects made with no device argument; the per-sample AA cotangent ---

DEF_RES = (64, 64)                 # [defaults]: every entry point's frame
DEF_SPHERES = 100                  # [defaults]: the random scene (the large-scene tables)
PS_PARITY = ((0, (64, 64)), (1000, (64, 64)))   # [bwd-per-sample] against the plain version
PS_BITS = (1000, (256, 256))       # [bwd-per-sample]: tables on against off, every form
PS_SLICE = (96, 64)                # x_offset, local_width of the PS_BITS frame
PS_TIME_RES = (1000, 1000)         # [bwd-per-sample] times: the demo scene, depth 2
PS_PLAIN_RES = (128, 128)          # the plain version's time (its memory at 1000x1000)


def _all_counts():
    """Every launch and plain-call counter of the port's kernel wrappers, by
    name, and a function that resets them all."""
    from python_ray_tracer_tpu_torch.ops.cuda import (adaptive_cuda, hit_extents_cuda,
                                                      light_cells_cuda, render_bwd_cuda,
                                                      render_cuda, shadow_lists_cuda,
                                                      soft_bwd_cuda, soft_cuda)
    mods = {"render": render_cuda, "bwd": render_bwd_cuda, "soft": soft_cuda,
            "soft_bwd": soft_bwd_cuda, "adaptive": adaptive_cuda,
            "hit_extents": hit_extents_cuda, "light_cells": light_cells_cuda,
            "shadow_lists": shadow_lists_cuda}

    def read():
        out = {}
        for name, m in mods.items():
            out.update({f"{name}.{k}": v for k, v in m.LAUNCHES.items()})
            out.update({f"{name}.plain.{k}": v for k, v in getattr(m, "PLAIN_CALLS", {}).items()})
        return out

    def reset():
        for m in mods.values():
            m.reset_launch_counts()
    return read, reset


def defaults_phase(torch, rt, card: str) -> None:
    """``[defaults]``: the demo scene, ``default_camera``, a
    DEF_SPHERES-sphere ``random_scene`` and ``orbit_cameras``, made with no
    device argument, lie on the card; ``render_image_cuda``,
    ``render_image_fast`` and its backward, ``fit_scene`` (2 steps, the
    default backend), ``fit_scene_soft`` (1 step a tau), ``fit_camera`` (2
    steps), ``render_frames`` and ``render_image_adaptive_cuda`` on them, at
    DEF_RES, launch their kernels (each counter it reaches moves) and call no
    plain version. Then every kernel wrapper, and ``fit_scene`` on
    ``backend="cuda"``, raises ``ValueError`` on CPU copies of the same
    inputs, and no counter moves."""
    from python_ray_tracer_tpu_torch import animation, cli, train
    from python_ray_tracer_tpu_torch.ops.cuda import (hit_extents_cuda as hx,
                                                      light_cells_cuda as lc,
                                                      render_bwd_cuda as rb, render_cuda,
                                                      shadow_lists_cuda as sl,
                                                      soft_bwd_cuda as sb)
    t0 = time.perf_counter()
    read, reset = _all_counts()
    scene = rt.default_scene()
    cam = rt.default_camera(DEF_RES)
    big = rt.random_scene(DEF_SPHERES, generator=torch.Generator().manual_seed(0))
    cams = animation.orbit_cameras((32, 32), center=[1.0, 0.0, 1.0], radius=4.0,
                                   height=1.5, n_frames=3)
    init_cam = rt.Camera.build(DEF_RES, [-2.1, 0.08, 1.92], [1.5, -27.5, 2.0])
    made = {"default_scene": scene.device, "default_camera": cam.device,
            "random_scene": big.device, "orbit_cameras": cams.device,
            "Camera.build": init_cam.device,
            "every scene leaf": {t.device.type for t in scene.leaves() + big.leaves()}}
    print(f"[defaults] made with no device argument: {made}")
    check(all(v == {"cuda"} if isinstance(v, set) else v.type == "cuda"
              for v in made.values()), f"[defaults] not on the card: {made}")
    init = rt.Scene.from_leaves([t.clone() for t in scene.leaves()])
    init.spheres.center += torch.tensor(cli.FIT_SHIFT, device=init.device)
    runs = []

    def run(label, fn, want):
        reset()
        fn()
        torch.cuda.synchronize()
        got = read()
        plain = {k: v for k, v in got.items() if ".plain." in k and v}
        moved = {k: v for k, v in got.items() if v and ".plain." not in k}
        runs.append(label)
        print(f"[defaults] {label}: launches {moved}, plain calls {plain or 0}")
        check(all(got[k] > 0 for k in want), f"[defaults] {label}: {want} not all launched "
              f"({moved})")
        check(not plain, f"[defaults] {label} called a plain version: {plain}")

    run("render_image_cuda", lambda: rt.render_image_cuda(cam, scene), ["render.aa_shared"])
    run("render_image_cuda 100 spheres", lambda: rt.render_image_cuda(cam, big),
        ["render.aa_shared", "hit_extents.hit_extents", "shadow_lists.shadow_lists",
         "light_cells.light_cells"])

    def fast():
        leaves = [t.clone().requires_grad_(True) for t in init.leaves()]
        img = rt.render_image_fast(cam, rt.Scene.from_leaves(leaves))
        img.sum().backward()
        check(all(t.grad is not None for t in leaves[:3]), "render_image_fast: no gradient")
    run("render_image_fast + backward", fast, ["render.aa_shared", "bwd.cot_aa"])
    target = rt.render_image_cuda(cam, scene, aliasing=False)
    run("fit_scene (2 steps)", lambda: train.fit_scene(init, cam, target, steps=2),
        ["bwd.fused_noaa"])
    run("fit_scene_soft (1 step a tau)", lambda: train.fit_scene_soft(init, cam, scene, steps=3),
        ["soft.soft_fwd", "soft_bwd.fused"])
    run("fit_camera (2 steps)", lambda: train.fit_camera(init_cam, scene, target, steps=2),
        ["bwd.fused_noaa"])
    run("render_frames", lambda: animation.render_frames(cams, scene), ["render.aa_shared"])
    run("render_image_adaptive_cuda 100 spheres",
        lambda: rt.render_image_adaptive_cuda(cam, big, eps=ADAPTIVE_EPS),
        ["render.aa_none", "adaptive.render_list", "hit_extents.hit_extents"])

    # CPU copies of the same inputs: every kernel wrapper refuses them
    cpu_scene = rt.Scene.from_leaves([t.cpu() for t in scene.leaves()])
    cpu_big = rt.Scene.from_leaves([t.cpu() for t in big.leaves()])
    cpu_cam = cam.to("cpu")
    g = torch.zeros((*DEF_RES, 3))
    sph, _, lts = render_cuda.scene_tables(cpu_big)
    ext = torch.zeros((16, 8))
    wrappers = {
        "render_image_cuda": lambda: rt.render_image_cuda(cpu_cam, cpu_scene),
        "render_image_fast": lambda: rt.render_image_fast(cpu_cam, cpu_scene),
        "scene_grads_cuda": lambda: rb.scene_grads_cuda(cpu_cam, cpu_scene, g, aliasing=True),
        "scene_grads_cuda per-sample": lambda: rb.scene_grads_cuda(
            cpu_cam, cpu_scene, g, aliasing=True, aa_share=False),
        "loss_and_scene_grads_cuda": lambda: rb.loss_and_scene_grads_cuda(cpu_cam, cpu_scene, g),
        "render_image_soft_cuda": lambda: rt.render_image_soft_cuda(cpu_cam, cpu_scene),
        "render_image_soft_fast": lambda: rt.render_image_soft_fast(cpu_cam, cpu_scene),
        "soft_scene_grads_cuda": lambda: sb.soft_scene_grads_cuda(cpu_cam, cpu_scene, g),
        "soft_loss_and_grads_cuda": lambda: sb.soft_loss_and_grads_cuda(cpu_cam, cpu_scene, g),
        "render_image_adaptive_cuda": lambda: rt.render_image_adaptive_cuda(cpu_cam, cpu_big),
        "hit_extents_cuda": lambda: hx.hit_extents_cuda(cpu_cam, cpu_big, aliasing=True),
        "light_cells_cuda": lambda: lc.light_cells_cuda(sph, lts, DEF_SPHERES, 3),
        "shadow_lists_cuda": lambda: sl.shadow_lists_cuda(
            ext, torch.ones(1), cpu_big.lights.position, cpu_big.spheres.center,
            cpu_big.spheres.radius, K=8, compat=True),
        "fit_scene(backend='cuda')": lambda: train.fit_scene(cpu_scene, cpu_cam, g, steps=1),
        "render_frames(backend='cuda')": lambda: animation.render_frames(
            cams.to("cpu"), cpu_scene),
    }
    reset()
    refused = []
    for name, fn in wrappers.items():
        try:
            fn()
        except ValueError as e:
            check("cpu" in str(e), f"[defaults] {name}: {e!r} does not name the device")
            refused.append(name)
            continue
        check(False, f"[defaults] {name} took CPU tensors")
    moved = {k: v for k, v in read().items() if v}
    check(not moved, f"[defaults] a refused call counted {moved}")
    print(f"[defaults] {len(refused)} kernel wrappers and entry points refuse CPU tensors "
          f"with ValueError, no launch and no plain call counted: {', '.join(refused)}")
    phase_time("[defaults]", t0)


def per_sample_phase(torch, rt, card: str, dev) -> list:
    """``[bwd-per-sample]``: the per-sample AA cotangent
    (``scene_grads_cuda(aliasing=True, aa_share=False)``, the adjoint of the
    ``aa_per_sample`` render), which launches ``cot_aa``, the lattice: the AA
    offsets are 0 and +-0.5, so the per-sample render's rays are the
    lattice's. Against its plain version (``scene_grads_plain(aliasing=True)``)
    under ``grad_rule`` with the held-out pixels of the per-sample frame
    (``kernel_and_plain``) at PS_PARITY, compat and clean, depth 2; the same
    bits as ``aa_share=True``; two runs bit-identical; with the large-scene
    tables on against every table off at one launch shape, ``torch.equal``, in
    the staged, global and device-rows forms, and the partials of 3 slices
    summing to the frame's at PS_BITS. ``[bwd-per-sample-time]``: the kernel
    alone (inputs packed once), the wrapper with ``aa_share`` False and True
    and the plain version at PS_TIME_RES, with the bound (``timing.hard_bwd_work``
    at the distinct sample positions). Returns its kernels-line entry, its
    launches the ``cot_aa`` launches of the parity run's ``aa_share=False``
    calls (counts set to 0 before them and read after)."""
    from python_ray_tracer_tpu_torch.ops.cuda import render_bwd_cuda as rb, render_cuda
    from python_ray_tracer_tpu_torch.utils import timing
    from python_ray_tracer_tpu_torch.utils.config import RenderConfig
    cfg = RenderConfig()
    t0 = time.perf_counter()

    def camera(res):
        return rt.Camera.build(res, cfg.camera_position, cfg.camera_euler, cfg.fov, device=dev)

    def shifted(sc):
        init = rt.Scene.from_leaves([t.clone() for t in sc.leaves()])
        init.spheres.center += torch.tensor([0.2, -0.15, 0.1], device=dev)
        return init

    def cotangent(cam, sc):
        """A fit's first cotangent: the shifted scene's per-sample frame
        against the scene's."""
        tgt = rt.render_image_cuda(cam, sc, aliasing=True, aa_share=False)
        img = rt.render_image_cuda(cam, shifted(sc), aliasing=True, aa_share=False)
        return (2.0 * (img - tgt) / img.numel()).contiguous()

    worst, errs, launches = {}, [], 0
    for n, res in PS_PARITY:
        sc, cam = scene_of(rt, cfg, n, dev), camera(res)
        init = shifted(sc)
        for compat in (True, False):
            x = cotangent(cam, sc)
            rb.reset_launch_counts()
            k, p, p_all, held = rb.kernel_and_plain("cot_aa", cam, init, x, depth=2,
                                                    compat=compat, aa_share=False)
            kw = dict(depth=2, compat=compat, aliasing=True, return_camera=True)
            keep = (x * ~held[..., None]).contiguous()
            again = rb.flatten_grads(*rb.scene_grads_cuda(cam, init, keep, aa_share=False, **kw))
            check(set(m for m, v in rb.LAUNCHES.items() if v) == {"cot_aa"},
                  f"[bwd-per-sample] launches {dict(rb.LAUNCHES)}")
            launches += rb.LAUNCHES["cot_aa"]
            lat = rb.flatten_grads(*rb.scene_grads_cuda(cam, init, keep, aa_share=True, **kw))
            rule = rb.grad_rule(k, p, *counts(sc), scale_ref=p_all)
            bad = [g for g, (_, ok) in rule.items() if not ok]
            top = max(rule.items(), key=lambda kv: kv[1][0])
            err = float((k - p).abs().max())
            errs.append((err, top[1][0]))
            print(f"[bwd-per-sample] {n or 'demo'} spheres {res[0]}x{res[1]} d2 compat={compat}: "
                  f"against the plain version worst {top[0]} {top[1][0]:.3g}, max_abs_err "
                  f"{err:.3g}; aa_share=True the same bits {torch.equal(k, lat)}; two runs "
                  f"equal {torch.equal(k, again)}")
            check(not bad, f"[bwd-per-sample] {n} spheres compat={compat}: {bad} off the "
                  f"plain version")
            check(torch.equal(k, lat), "[bwd-per-sample] aa_share False and True differ")
            check(torch.equal(k, again), "[bwd-per-sample] two runs differ")
    check(launches > 0, "[bwd-per-sample] no cot_aa launch")
    t0 = phase_time("[bwd-per-sample] parity", t0)

    # tables on against every table off, one launch shape a form
    n, res = PS_BITS
    sc, cam = scene_of(rt, cfg, n, dev), camera(res)
    init, x = shifted(sc), cotangent(cam, sc)
    cases = 0
    for compat in (True, False):
        for form, kw in (("staged", dict(staged=True)), ("global", dict(staged=False)),
                         ("device rows", dict(device_rows=True))):
            packed = render_cuda.packed_inputs(cam, init, depth=2, compat=compat)
            tabs = render_cuda.large_scene_tables(cam, init, depth=2, aliasing=True,
                                                  compat=compat, packed=packed)
            shape = rb.launch_plan(cam, init, "cot_aa", tabs=tabs, **kw)
            outs = []
            for t, shp in ((tabs, shape), (None, shape._replace(tree_smem=False))):
                o = torch.empty(rb.n_grads(*counts(sc)), device=dev)
                rb.launch(o, torch.empty(o.numel() * shp.blocks, device=dev), *packed,
                          image=x, target=None, W=res[0], H=res[1], depth=2, mode="cot_aa",
                          compat=compat, cheap_shadow=render_cuda.shadow_cheap_ok(init, compat),
                          shape=shp, tabs=t)
                outs.append(o)
            check(torch.equal(*outs), f"[bwd-per-sample] {n} spheres {form} compat={compat}: "
                  f"tables on differ from off")
            cases += 1
    x0, lw = PS_SLICE
    whole = rb.flatten_grads(*rb.scene_grads_cuda(cam, init, x, aliasing=True, aa_share=False,
                                                  return_camera=True))
    parts = [rb.flatten_grads(*rb.scene_grads_cuda(
        cam, init, x[a:a + w].contiguous(), aliasing=True, aa_share=False, return_camera=True,
        x_offset=a, local_width=w)) for a, w in ((0, x0), (x0, lw), (x0 + lw, res[0] - x0 - lw))]
    rule = rb.grad_rule(parts[0] + parts[1] + parts[2], whole, *counts(sc))
    bad = [g for g, (_, ok) in rule.items() if not ok]
    check(not bad, f"[bwd-per-sample] slice partials off the frame's: {bad}")
    print(f"[bwd-per-sample] {n} spheres {res[0]}x{res[1]}: {cases} launches with the tables "
          f"torch.equal to every table off (staged, global, device rows; compat and clean); "
          f"3 slices' partials sum to the frame's within grad_rule")

    t0 = phase_time("[bwd-per-sample] tables and slices", t0)
    # times at the demo scene 1000x1000 d2
    sc, cam = scene_of(rt, cfg, 0, dev), camera(PS_TIME_RES)
    init, x = shifted(sc), cotangent(cam, sc)
    W, H = PS_TIME_RES
    packed = render_cuda.packed_inputs(cam, init, depth=2, compat=True)
    cheap = render_cuda.shadow_cheap_ok(init, True)
    shape = rb.launch_plan(cam, init, "cot_aa")
    o = torch.empty(rb.n_grads(*counts(sc)), device=dev)
    part = torch.empty(o.numel() * shape.blocks, device=dev)
    kernel = 1e3 * rt.time_fn(lambda: rb.launch(o, part, *packed, image=x, target=None, W=W,
                                                H=H, depth=2, mode="cot_aa", compat=True,
                                                cheap_shadow=cheap, shape=shape),
                              warmup=2, iters=20)
    wrapper = {}
    for share in (False, True, True, False):
        ms = 1e3 * rt.time_fn(lambda: rb.flatten_grads(rb.scene_grads_cuda(
            cam, init, x, aliasing=True, aa_share=share)), warmup=2, iters=10)
        wrapper[share] = min(wrapper.get(share, ms), ms)
    cam_p = camera(PS_PLAIN_RES)
    x_p = cotangent(cam_p, sc)
    plain = 1e3 * rt.time_fn(rb.scene_grads_plain, cam_p, init, x_p, depth=2, aliasing=True,
                             warmup=1, iters=1)
    live = timing.hard_chain_counts(cam, init, timing.bwd_positions(W, H, True, x), depth=2)
    bound, bound_by = timing.bound_ms(*timing.hard_bwd_work(W, H, *counts(sc), "cot_aa", live))
    print(f"[bwd-per-sample-time] demo {W}x{H} d2: kernel alone (cot_aa) {kernel:.4f} ms; "
          f"wrapper aa_share=False {wrapper[False]:.4f} ms, aa_share=True {wrapper[True]:.4f} ms "
          f"(A, B, B, A minima); plain {plain:.4f} ms at {PS_PLAIN_RES[0]}x{PS_PLAIN_RES[1]}; "
          f"cot_aa launches on the parity run {launches} | {card}")
    print(f"[bound] render_bwd per-sample cotangent {W}x{H} d2: {bound:.4f} ms ({bound_by}; "
          f"timing.hard_bwd_work at the distinct sample positions, rays / sphere hits / plane "
          f"hits by level {live.int().tolist()}) vs kernel alone {kernel:.4f} ms "
          f"({kernel / bound:.1f}x) | {card}")
    phase_time("[bwd-per-sample] times and bound", t0)
    return [{"name": "render_bwd_per_sample_cotangent", "route": "cuda", "source": BWD_SOURCE,
             "replaces": BWD_REPLACES, "mode": "cot_aa", "launches": launches,
             "max_abs_err": max(e for e, _ in errs), "max_rel_err": max(r for _, r in errs),
             "ms": wrapper[False], "plain_ms": plain, "kernel_only_ms": kernel,
             "bound_ms": bound, "bound_by": bound_by, "library_ms": None,
             "shape": f"{W}x{H}_d2", "plain_shape": "x".join(map(str, PS_PLAIN_RES))}]


def main() -> int:
    t_start = time.perf_counter()
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is False)",
              file=sys.stderr)
        return 1
    if len(sys.argv) == 3 and sys.argv[1] in ("--entry-times", "--ab-times"):
        # phase 20 or the A/B times on another checkout's package
        root = os.path.abspath(sys.argv[2])
        sys.path.insert(0, root)
        import python_ray_tracer_tpu_torch as rt
        check(os.path.dirname(os.path.abspath(rt.__file__)) ==
              os.path.join(root, "python_ray_tracer_tpu_torch"), f"imported {rt.__file__}")
        card = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, check=True, timeout=60).stdout.strip()
        print(card)
        fn = {"--entry-times": entry_times, "--ab-times": ab_times}[sys.argv[1]]
        fn(torch, rt, card, torch.device("cuda", 0), os.path.relpath(root, ROOT))
        print(f"[smoke] {sys.argv[1]} {root} in {time.perf_counter() - t_start:.1f} s")
        return 0
    sys.path.insert(0, ROOT)
    import numpy as np
    import python_ray_tracer_tpu_torch as rt
    from python_ray_tracer_tpu_torch import cli
    from python_ray_tracer_tpu_torch.ops.cuda import _build, hit_extents_cuda, render_cuda
    from python_ray_tracer_tpu_torch.utils import timing
    from python_ray_tracer_tpu_torch.utils.image import framebuffer_to_array

    # Phase 1: the card.
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    print(card)
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"python {sys.version.split()[0]}, device {torch.cuda.get_device_name(0)}")
    dev = torch.device("cuda", 0)

    # Phase 2: build the kernels from the checkout's sources.
    t0 = time.perf_counter()
    so = _build.build()
    _build.load_library()
    print(f"[build] {os.path.relpath(so, ROOT)} in {time.perf_counter() - t0:.1f} s; nvcc "
          f"seconds a source (from the build's start to its end): " + ", ".join(
              f"{k} {v:.1f}" for k, v in sorted(_build.BUILD_SECONDS.items(),
                                                key=lambda kv: -kv[1])))
    cli_scene_phase(rt, dev)
    native_phase(rt, card, dev)
    if sys.argv[1:] == ["--phase", "22"]:   # the ray-parallel phase alone
        parallel_phase(torch, rt, card, dev)
        print(f"[smoke] phase 22 in {time.perf_counter() - t_start:.1f} s")
        return 0
    if sys.argv[1:] == ["--phase", "24"]:   # kernel 4's tables and one-launch AA step alone
        kernels = bwd_tables_phase(torch, rt, card, dev)
        print(f"[smoke] phase 24 in {time.perf_counter() - t_start:.1f} s")
        print(json.dumps({"kernels": kernels}))
        return 0
    if sys.argv[1:] == ["--phase", "25"]:   # shadow lists at the bounce levels, shadow_cull
        levels_capsule_phase(torch, rt, card, dev)
        print(f"[smoke] phase 25 in {time.perf_counter() - t_start:.1f} s")
        return 0
    if sys.argv[1:] == ["--phase", "26"]:   # default devices, the per-sample AA cotangent
        defaults_phase(torch, rt, card)
        kernels = per_sample_phase(torch, rt, card, dev)
        print(f"[smoke] phase 26 in {time.perf_counter() - t_start:.1f} s")
        print(json.dumps({"kernels": kernels}))
        return 0
    if sys.argv[1:] == ["--phase", "23"]:   # scenes of any size, faults, profiling alone
        faults_phase(torch, rt, card, dev)
        t0 = phase_time("phase 23 faults", t_start)
        print(json.dumps({"kernels": scene_size_phase(torch, rt, card, dev)}))
        phase_time("phase 23 sizes", t0)
        print(f"[smoke] phase 23 in {time.perf_counter() - t_start:.1f} s")
        return 0

    def kernel(cam, scene, mode, depth, compat):
        return rt.render_image_cuda(cam, scene, depth=depth, compat=compat,
                                    aliasing=mode != "aa_none",
                                    aa_share=mode == "aa_shared")

    # Phase 3: each kernel mode against the plain version, on the card.
    scene = rt.default_scene(device=dev)
    for compat in (True, False):
        cam = rt.default_camera((256, 256), device=dev)
        fbs = {}
        for mode in render_cuda.MODES:
            aa = mode != "aa_none"
            plain = rt.to_framebuffer(rt.render_image(cam, scene, depth=2,
                                                      aliasing=aa, compat=compat))
            fbs[mode] = rt.to_framebuffer(kernel(cam, scene, mode, 2, compat))
            torch.cuda.synchronize()
            flips, changed, dmax = frame_diff(fbs[mode], plain)
            print(f"[parity] {mode:13s} compat={compat!s:5s} 256x256 d2: "
                  f"flipped {flips}/{256 * 256}, changed {changed}, max {dmax}")
            check(flips <= FLIP_FRAC * 256 * 256, f"{mode} compat={compat}: "
                  f"{flips} flipped pixels vs the plain version")
        d = (fbs["aa_shared"].int() - fbs["aa_per_sample"].int()).abs().amax(dim=0)
        agree = float((d <= 1).float().mean())
        print(f"[parity] aa_shared vs aa_per_sample compat={compat}: "
              f"{agree:.6f} of pixels within 1 level")
        check(agree >= SHARED_AGREE, f"shared AA agrees on only {agree:.4%}")

    # Phase 4: the JAX package's frozen framebuffers through the kernel.
    goldens = {}
    for fname in ("demo_frames.npz", "kernel_frames.npz"):
        with np.load(os.path.join(ROOT, "tests", "goldens", fname)) as z:
            goldens.update({k: z[k] for k in z.files if k != "_meta"})
    check(set(goldens) == set(GOLDEN_CONFIGS), f"golden keys {sorted(goldens)}")
    for name, ((w, h), depth, aa, compat) in GOLDEN_CONFIGS.items():
        img = rt.render_image_cuda(rt.default_camera((w, h), device=dev), scene,
                                   depth=depth, aliasing=aa, compat=compat)
        fb = rt.to_framebuffer(img).cpu().numpy().astype(np.int32)
        want = goldens[name].astype(np.int32)
        d = np.abs(fb - want).max(axis=0)
        changed, dmax = int((d > 0).sum()), int(d.max())
        tie = ""
        if name in NEAR_TIE_GOLDENS:
            tie = (f", near tie {NEAR_TIE}: kernel {fb[(slice(None),) + NEAR_TIE].tolist()}"
                   f" golden {want[(slice(None),) + NEAR_TIE].tolist()}")
            d[NEAR_TIE] = 0
        bad = [tuple(int(i) for i in p) for p in np.argwhere(d > 1)]
        print(f"[golden] {name}: max {dmax}, changed {changed}/{w * h}, "
              f"off by > 1 elsewhere {bad}{tie}")
        check(not bad and changed < GOLDEN_CHANGED * w * h,
              f"golden {name}: pixels {bad} off by > 1 level, changed {changed}")

    # Phase 5: the main path through the entry point.
    os.makedirs(OUT_DIR, exist_ok=True)
    pngs = {label: os.path.join(OUT_DIR, f"{label}.png") for label, _, _ in MAIN_PATH}
    render_cuda.reset_launch_counts()
    hit_extents_cuda.reset_launch_counts()
    for label, args, mode in MAIN_PATH:
        before = render_cuda.LAUNCHES[mode]
        check(cli.main(["render", "--backend", "cuda", *args, "--out",
                        pngs[label]]) == 0, f"cli render {label} failed")
        check(render_cuda.LAUNCHES[mode] > before,
              f"cli render {label} did not launch {mode}")
    launches = dict(render_cuda.LAUNCHES)
    print(f"[main] kernel launches on the main path: {launches}; hit_extents "
          f"{hit_extents_cuda.LAUNCHES['hit_extents']} (the demo scene takes no "
          f"large-scene table)")
    check(all(launches[m] > 0 for m in REPLACES), f"main path launches {launches}")
    check(hit_extents_cuda.LAUNCHES["hit_extents"] == 0,
          "the demo scene launched the hit-extent kernel")
    for label, args, mode in MAIN_PATH:
        w, h, png = read_png(pngs[label])
        want = (int(args[1]), int(args[3]))
        check((w, h) == want, f"{pngs[label]}: IHDR {w}x{h}, expected {want}")
        ref = framebuffer_to_array(rt.to_framebuffer(
            kernel(rt.default_camera(want, device=dev), scene, mode, 2, True)))
        check(np.array_equal(png, ref),
              f"{pngs[label]}: pixels differ from the kernel's frame")
        print(f"[main] {label}: {os.path.relpath(pngs[label], ROOT)} {w}x{h} "
              f"decodes to the kernel's frame")

    # Phase 6: kernel against plain version at the main path's shapes.
    rows = {}
    for label, args, mode in MAIN_PATH:
        w, h, aa = int(args[1]), int(args[3]), mode != "aa_none"
        cam = rt.default_camera((w, h), device=dev)
        img_k = kernel(cam, scene, mode, 2, True)
        img_p = rt.render_image(cam, scene, depth=2, aliasing=aa, compat=True)
        check(img_k.shape == (w, h, 3) and bool(torch.isfinite(img_k).all()),
              f"{label}: kernel image {tuple(img_k.shape)} not finite")
        flips, changed, dmax = frame_diff(rt.to_framebuffer(img_k),
                                          rt.to_framebuffer(img_p))
        check(flips <= FLIP_FRAC * w * h, f"{label}: {flips} flipped pixels")
        err = float((img_k - img_p).abs().max())
        # wrapper, per frame: host packing (five device->host syncs and one
        # host->device copy of the parameters) + launch
        ms = 1e3 * rt.time_fn(kernel, cam, scene, mode, 2, True, warmup=2, iters=20)
        # kernel alone: launches back to back on inputs packed once
        packed = (torch.empty((w, h, 3), device=dev),
                  render_cuda.pack_params(cam, scene, True).to(dev),
                  render_cuda.scene_tables(scene), counts(scene))
        kernel_ms = 1e3 * rt.time_fn(
            render_cuda.launch, *packed, depth=2, mode=mode, compat=True,
            cheap_shadow=render_cuda.shadow_cheap_ok(scene, True), warmup=2, iters=50)
        plain_ms = 1e3 * rt.time_fn(rt.render_image, cam, scene, depth=2,
                                    aliasing=aa, compat=True, warmup=1, iters=3)
        rows[label] = dict(mode=mode, ms=ms, kernel_ms=kernel_ms, plain_ms=plain_ms,
                           err=err)
        print(f"[time] {label} ({mode}): wrapper {ms:.4f} ms, kernel alone "
              f"{kernel_ms:.4f} ms, plain {plain_ms:.4f} ms, flipped {flips}/{w * h}, "
              f"max_abs_err {err:.6g} | {card}")

    kernels = []
    for mode, label in (("aa_none", "1920x1080_noaa"), ("aa_shared", "1000x1000_aa")):
        r = rows[label]
        w, h = (int(v) for v in label.split("_")[0].split("x"))
        bound, bound_by = timing.bound_ms(*timing.hard_work(w, h, *counts(scene), mode))
        print(f"[bound] render_fwd_{mode} {label}: {bound:.4f} ms ({bound_by}, a lower "
              f"bound: the primary sweep only) vs kernel alone {r['kernel_ms']:.4f} ms")
        kernels.append({
            "name": f"render_fwd_{mode}", "route": "cuda",
            "source": "python_ray_tracer_tpu_torch/csrc/render_fwd_small.cu",
            "replaces": REPLACES[mode], "launches": launches[mode],
            "max_abs_err": r["err"], "ms": r["ms"], "plain_ms": r["plain_ms"],
            "kernel_only_ms": r["kernel_ms"], "bound_ms": bound, "bound_by": bound_by,
            "library_ms": None, "shape": label})
    t0 = phase_time("phases 1-6", t_start)
    # The trace first: later in this process, after the timing phases' many
    # profiler sessions, the card host's profiler loses kernel records.
    faults_phase(torch, rt, card, dev)
    t0 = phase_time("phase 23 faults", t0)
    kernels += backward_phases(torch, rt, card, dev)
    t0 = phase_time("phases 7-9", t0)
    kernels += soft_phases(torch, rt, card, dev)
    t0 = phase_time("phases 10-12", t0)
    kernels += large_scene_phases(torch, rt, card, dev)
    t0 = phase_time("phases 13-15", t0)
    kernels += adaptive_phases(torch, rt, card, dev)
    t0 = phase_time("phases 16-18", t0)
    builds = start_sweep_builds()
    fwd_regs = bounce_phase(torch, rt, card, dev, builds)
    t0 = phase_time("phase 19", t0)
    kernels += lightbuf_phase(torch, rt, card, dev, builds, fwd_regs)
    t0 = phase_time("phase 21", t0)
    entry_times(torch, rt, card, dev, "this tree")
    t0 = phase_time("phase 20", t0)
    parallel_phase(torch, rt, card, dev)
    t0 = phase_time("phase 22", t0)
    kernels += scene_size_phase(torch, rt, card, dev)
    t0 = phase_time("phase 23 sizes", t0)
    kernels += bwd_tables_phase(torch, rt, card, dev)
    t0 = phase_time("phase 24", t0)
    levels_capsule_phase(torch, rt, card, dev)
    t0 = phase_time("phase 25", t0)
    defaults_phase(torch, rt, card)
    kernels += per_sample_phase(torch, rt, card, dev)
    phase_time("phase 26", t0)
    print(f"[smoke] all phases passed in {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
