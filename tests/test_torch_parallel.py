"""The port's ray-parallel path (python_ray_tracer_tpu_torch/parallel and the
sharded steps of train.py) on the CPU, against the JAX package's
(tests/test_parallel.py:20-150 and :213-233).

Plain slices (the plain renderer's, and the wrappers' slice glue with the
launches standing in for the card, tests/torch_plain_launch.py) stitch to the
whole plain frame bit for bit. The port's sharded render, loss and gradients on a 2- or 4-rank mesh
match the JAX package's ``render_image_sharded(backend="jnp")`` and
``make_loss_fn`` (soft too) on the same mesh of virtual CPU devices, at the
JAX tests' tolerances (tests/test_torch_parallel_pallas.py holds the slices'
fused-step partials against one JAX ``pallas_value_and_grad_sharded`` run in
interpret mode). Two processes over
gloo, launched from this file, assemble the frame with ``gather_framebuffer``
and take sharded ``fit_scene`` steps with one all-reduce a step. JAX is
imported inside the tests, so a spawned worker imports this module without it.
"""
import socket

import numpy as np
import pytest
import torch

import python_ray_tracer_tpu_torch as trt
from python_ray_tracer_tpu_torch import bridge, train
from python_ray_tracer_tpu_torch.ops.cuda import render_bwd_cuda as rb
from python_ray_tracer_tpu_torch.ops.cuda import soft_bwd_cuda as sb
from python_ray_tracer_tpu_torch.parallel import (distributed, gather_framebuffer,
                                                  initialize, make_loss_fn, make_mesh,
                                                  render_image_sharded)
from python_ray_tracer_tpu_torch.parallel.mesh import column_slice

from .torch_plain_launch import plain_launches

torch.set_num_threads(1)

RES = (32, 16)
SHIFT = (0.05, 0.05, 0.05)


def _stitch(n, fn):
    return torch.cat([fn(make_mesh(size=n, rank=i)) for i in range(n)])


def _shifted(scene, d=SHIFT):
    s = trt.Scene.from_leaves(scene.leaves())
    s.spheres = trt.Spheres(scene.spheres.center + torch.tensor(d), scene.spheres.radius,
                            scene.spheres.albedo)
    return s


def _to_torch(scene_j):
    import jax
    return bridge.scene_from_leaves([np.asarray(x) for x in jax.tree_util.tree_leaves(scene_j)],
                                    device="cpu")


def test_column_slice_and_mesh():
    assert column_slice(1000, 3, 8) == (375, 125)
    assert column_slice(1920, 7, 8) == (1680, 240)
    with pytest.raises(AssertionError):
        column_slice(1000, 0, 3)
    m = make_mesh(size=4, rank=2)
    assert (m.rank, m.size, m.group, m.axis) == (2, 4, None, "rays")
    assert m.slice(32) == (16, 8) and make_mesh().size == 1


@pytest.mark.parametrize("aliasing,compat", [(True, True), (False, True), (True, False),
                                             (False, False)])
def test_plain_slices_stitch_to_the_whole_frame(aliasing, compat, monkeypatch):
    plain_launches(monkeypatch.setattr)
    cam, scene = trt.default_camera(RES, device="cpu"), trt.default_scene(device="cpu")
    whole = trt.render_image(cam, scene, depth=2, aliasing=aliasing, compat=compat)
    for n in (2, 4, 8):
        for backend in ("cuda", "torch"):
            st = _stitch(n, lambda m: render_image_sharded(
                cam, scene, m, depth=2, aliasing=aliasing, compat=compat, backend=backend))
            assert torch.equal(st, whole), (n, backend)


def test_plain_soft_slices_stitch_to_the_whole_frame():
    cam, scene = trt.default_camera(RES, device="cpu"), trt.default_scene(device="cpu")
    whole = trt.render_image_soft(cam, scene, tau=0.05)
    for n in (2, 4, 8):
        x = [column_slice(RES[0], i, n) for i in range(n)]
        st = torch.cat([trt.render_image_soft(cam, scene, tau=0.05, x_offset=x0,
                                              local_width=lw) for x0, lw in x])
        assert torch.equal(st, whole), n


def test_slice_arguments_are_checked():
    cam, scene = trt.default_camera(RES, device="cpu"), trt.default_scene(device="cpu")
    for x0, lw in ((-1, 4), (30, 4), (0, 0), (1.5, 4)):
        with pytest.raises(ValueError, match="slice"):
            trt.render_image_cuda(cam, scene, x_offset=x0, local_width=lw)


@pytest.mark.parametrize("n_dev", [2, 4])
def test_sharded_render_matches_jax(n_dev):
    import jax
    import python_ray_tracer_tpu as jrt
    from python_ray_tracer_tpu.parallel.mesh import make_mesh as jmesh
    from python_ray_tracer_tpu.parallel.render_sharded import render_image_sharded as jrs
    jm = jmesh(jax.devices()[:n_dev])
    cam_j, scene_j = jrt.default_camera(RES), jrt.default_scene()
    ref = np.asarray(jrs(cam_j, scene_j, jm, depth=1, aliasing=True, backend="jnp"))
    cam, scene = trt.default_camera(RES, device="cpu"), _to_torch(scene_j)
    for i in range(n_dev):
        m = make_mesh(size=n_dev, rank=i)
        x0, lw = m.slice(RES[0])
        out = render_image_sharded(cam, scene, m, depth=1, aliasing=True,
                                   backend="torch").numpy()
        np.testing.assert_allclose(out, ref[x0:x0 + lw], atol=1e-4)


def _jax_value_and_grad(loss_fn, scene_j):
    import jax
    loss, g = jax.jit(jax.value_and_grad(loss_fn))(scene_j)
    return float(loss), rb.flatten_grads(_to_torch(g))


def _port_sharded(n, loss_of_mesh, scene):
    """The sum over n ranks of each rank's loss part and gradient: what the
    sharded step's one all-reduce forms."""
    loss, flat = 0.0, 0
    for i in range(n):
        lo, g = train.autograd_value_and_grad(loss_of_mesh(make_mesh(size=n, rank=i)))(scene)
        loss, flat = loss + float(lo), flat + rb.flatten_grads(g)
    return loss, flat


def test_sharded_loss_and_grads_match_jax():
    """test_parallel.py::test_sharded_loss_and_grads_match_single on the
    port: the ranks' loss parts and gradients summed against the JAX
    make_loss_fn's psum'd values on a 2-device mesh."""
    import jax
    import python_ray_tracer_tpu as jrt
    from python_ray_tracer_tpu.parallel.mesh import image_sharding
    from python_ray_tracer_tpu.parallel.mesh import make_mesh as jmesh
    from python_ray_tracer_tpu.parallel.render_sharded import make_loss_fn as jloss
    jm = jmesh(jax.devices()[:2])
    cam_j, scene_j = jrt.default_camera(RES), jrt.default_scene()
    target_j = jrt.render_image(cam_j, scene_j, depth=1, aliasing=False)
    import dataclasses
    pert_j = dataclasses.replace(scene_j, spheres=dataclasses.replace(
        scene_j.spheres, center=scene_j.spheres.center + 0.05))
    l1, g1 = _jax_value_and_grad(jloss(cam_j, jax.device_put(target_j, image_sharding(jm)),
                                       jm, depth=1, aliasing=False), pert_j)
    cam, target = trt.default_camera(RES, device="cpu"), torch.from_numpy(np.array(target_j))
    l2, g2 = _port_sharded(2, lambda m: make_loss_fn(cam, target, m, depth=1,
                                                     aliasing=False), _to_torch(pert_j))
    assert l2 == pytest.approx(l1, rel=1e-5)
    np.testing.assert_allclose(g2.numpy(), g1.numpy(), rtol=1e-2, atol=1e-5)


def test_sharded_soft_loss_matches_jax():
    """test_parallel.py::test_sharded_soft_loss_matches_single on the port."""
    import jax
    import python_ray_tracer_tpu as jrt
    from python_ray_tracer_tpu.parallel.mesh import image_sharding
    from python_ray_tracer_tpu.parallel.mesh import make_mesh as jmesh
    from python_ray_tracer_tpu.parallel.render_sharded import make_loss_fn as jloss
    jm = jmesh(jax.devices()[:2])
    res = (16, 16)
    cam_j, scene_j = jrt.default_camera(res), jrt.default_scene()
    target_j = jrt.render_image_soft(cam_j, scene_j, tau=0.05)
    import dataclasses
    pert_j = dataclasses.replace(scene_j, spheres=dataclasses.replace(
        scene_j.spheres, center=scene_j.spheres.center + 0.03))
    l1, g1 = _jax_value_and_grad(jloss(cam_j, jax.device_put(target_j, image_sharding(jm)),
                                       jm, soft=True, tau=0.05), pert_j)
    cam, target = trt.default_camera(res, device="cpu"), torch.from_numpy(np.array(target_j))
    l2, g2 = _port_sharded(2, lambda m: make_loss_fn(cam, target, m, soft=True, tau=0.05),
                           _to_torch(pert_j))
    assert l2 == pytest.approx(l1, rel=1e-5)
    ns = 6
    np.testing.assert_allclose(g2[:7 * ns].reshape(ns, 7)[:, :3].numpy(),
                               g1[:7 * ns].reshape(ns, 7)[:, :3].numpy(), rtol=1e-3,
                               atol=1e-7)


@pytest.mark.parametrize("mode", ["fused_noaa", "fused_aa", "cot_noaa", "cot_aa"])
def test_slice_partials_sum_to_the_frame(mode, monkeypatch):
    """The hard wrappers' slice form on the CPU (their glue, each launch the
    plain version: tests/torch_plain_launch.py): the partials of 4 slices sum
    to the whole frame's, the loss within rel 1e-6."""
    plain_launches(monkeypatch.setattr)
    cam, scene = trt.default_camera(RES, device="cpu"), _shifted(trt.default_scene(device="cpu"))
    aa = mode.endswith("_aa")
    x = torch.from_numpy(np.random.default_rng(0).uniform(0.0, 1.0, RES + (3,))
                         .astype(np.float32))
    if mode.startswith("fused"):
        def run(**kw):
            lo, g = rb.loss_and_scene_grads_cuda(cam, scene, x[kw["sl"]], depth=1,
                                                 aliasing=aa, x_offset=kw["x0"],
                                                 local_width=kw["lw"])
            return rb.flatten_grads(g, None, lo)
    else:
        def run(**kw):
            g = rb.scene_grads_cuda(cam, scene, x[kw["sl"]] * 1e-2, depth=1, aliasing=aa,
                                    x_offset=kw["x0"], local_width=kw["lw"])
            return rb.flatten_grads(g)
    whole = run(sl=slice(None), x0=0, lw=RES[0])
    parts = 0
    for i in range(4):
        x0, lw = column_slice(RES[0], i, 4)
        parts = parts + run(sl=slice(x0, x0 + lw), x0=x0, lw=lw)
    assert all(ok for _, ok in rb.grad_rule(parts, whole, 6, 1, 3).values())
    if mode.startswith("fused"):
        assert float(parts[-1]) == pytest.approx(float(whole[-1]), rel=1e-6)


def test_soft_slice_partials_sum_to_the_frame(monkeypatch):
    plain_launches(monkeypatch.setattr)
    cam = trt.default_camera((16, 16), device="cpu")
    scene = _shifted(trt.default_scene(device="cpu"), (0.03,) * 3)
    target = trt.render_image_soft(cam, trt.default_scene(device="cpu"), tau=0.05)
    lo, g = sb.soft_loss_and_grads_cuda(cam, scene, target, tau=0.05)
    whole = rb.flatten_grads(g, None, lo)
    parts = 0
    for i in range(2):
        x0, lw = column_slice(16, i, 2)
        lo, g = sb.soft_loss_and_grads_cuda(cam, scene, target[x0:x0 + lw], tau=0.05,
                                            x_offset=x0, local_width=lw)
        parts = parts + rb.flatten_grads(g, None, lo)
    assert all(ok for _, ok in sb.soft_grad_rule(parts, whole, 6, 1, 3).values())
    assert float(parts[-1]) == pytest.approx(float(whole[-1]), rel=1e-6)


def test_lattice_helpers_take_the_slice():
    """The plain AA lattice's slice form: the slices' cotangents are the
    frame's lattice cotangents of those columns, and the combine of a slice's
    lattice samples is the frame's combine of those columns."""
    W, H, compat = 48, 16, True
    g = torch.from_numpy(np.random.default_rng(1).normal(size=(W, H, 3)).astype(np.float32))
    whole = rb.lattice_cotangents(g, W, H, compat)
    pos = rb.lattice_positions(W, H)
    samples = torch.from_numpy(np.random.default_rng(2).normal(
        size=whole.shape).astype(np.float32))
    img = rb.lattice_combine(samples, W, H, compat)
    n_ty = H // 16
    for x0, lw in ((16, 16), (32, 16)):
        t = slice(x0 // 16 * n_ty, (x0 + lw) // 16 * n_ty)
        assert torch.equal(rb.lattice_positions(lw, H, x_offset=x0), pos[t])
        assert torch.equal(rb.lattice_cotangents(g[x0:x0 + lw], lw, H, compat, x0, W),
                           whole[t])
        assert torch.equal(rb.lattice_combine(samples[t], lw, H, compat, x0, W),
                           img[x0:x0 + lw])


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


FIT_STEPS = 3


def _fits(mesh=None):
    """The fits the 2-process run shards: fit_scene on both backends
    (``"cuda"``: the wrappers' glue with the launches standing in for the
    card, the plain fused step's slices;
    ``"torch"``: autograd of make_loss_fn) and fit_scene_soft, one step a tau."""
    cam, scene = trt.default_camera(RES, device="cpu"), trt.default_scene(device="cpu")
    target = trt.render_image(cam, scene, depth=1, aliasing=False)
    kw = dict(steps=FIT_STEPS, lr=1e-2, depth=1, trainable=("spheres.center",), mesh=mesh)
    return [train.fit_scene(_shifted(scene), cam, target, backend=b, **kw)[1]
            for b in ("cuda", "torch")] + [
        train.fit_scene_soft(_shifted(scene), cam, scene, steps=3, mesh=mesh)[1]]


def gloo_worker(rank, port, out):
    """One rank of the 2-process gloo run: the frame from the ranks' slices,
    then the sharded fits, with the collectives counted."""
    torch.set_num_threads(1)
    plain_launches(setattr)   # this process ends with the run
    try:
        initialize(f"tcp://127.0.0.1:{port}", world_size=2, rank=rank, backend="gloo")
        mesh = make_mesh()
        cam, scene = trt.default_camera(RES, device="cpu"), trt.default_scene(device="cpu")
        frame = gather_framebuffer(render_image_sharded(cam, scene, mesh, depth=1), mesh)
        distributed.reset_counts()
        losses = _fits(mesh)
        # numpy, not a tensor: a tensor would go through shared memory, which
        # this process may release before the parent reads it
        out.put((rank, frame.numpy(), losses, dict(distributed.COLLECTIVES), mesh.size))
    except Exception as e:   # reported to the parent, which fails the test
        out.put((rank, repr(e), None, None, None))
    finally:
        if torch.distributed.is_initialized():
            torch.distributed.destroy_process_group()


def test_two_processes_over_gloo(monkeypatch):
    """Two OS processes (gloo over loopback): the gathered frame is
    torch.equal to the whole frame on both ranks, and the sharded fits'
    losses (fit_scene on both backends, fit_scene_soft) match the
    single-process fits', one all-reduce a step (the "cuda" backend's glue
    with the launches standing in for the card, tests/torch_plain_launch.py,
    here and in the workers)."""
    plain_launches(monkeypatch.setattr)
    ctx = torch.multiprocessing.get_context("spawn")
    out = ctx.Queue()
    port = _free_port()
    procs = [ctx.Process(target=gloo_worker, args=(r, port, out)) for r in (0, 1)]
    for p in procs:
        p.start()
    try:
        got = sorted((out.get(timeout=150) for _ in procs), key=lambda r: r[0])
        for p in procs:
            p.join(timeout=30)
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join()
    cam, scene = trt.default_camera(RES, device="cpu"), trt.default_scene(device="cpu")
    whole = trt.render_image(cam, scene, depth=1)
    single = _fits()
    for rank, frame, losses, counts, size in got:
        assert isinstance(frame, np.ndarray), frame
        assert size == 2 and torch.equal(torch.from_numpy(frame), whole)
        assert counts == {"all_reduce": 2 * FIT_STEPS + 3, "all_gather": 0}
        for a, b in zip(losses, single):
            np.testing.assert_allclose(a, b, rtol=1e-5)
    assert got[0][2] == got[1][2]
