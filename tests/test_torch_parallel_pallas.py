"""The slice form of the port's fused hard step against the JAX package's
sharded fused step, ``train.pallas_value_and_grad_sharded``, whose backward
kernel runs in interpret mode on each of 2 virtual CPU devices (one Pallas
trace, ~35 s; a file of its own to keep tests/test_torch_parallel.py short).
"""
import numpy as np
import torch

import python_ray_tracer_tpu_torch as trt
from python_ray_tracer_tpu_torch import bridge
from python_ray_tracer_tpu_torch.ops.cuda import render_bwd_cuda as rb
from python_ray_tracer_tpu_torch.parallel.mesh import column_slice

torch.set_num_threads(1)


def test_sharded_fused_step_matches_jax_pallas():
    """The port's slices (the plain fused step, loss_and_scene_grads_plain, over
    the frame's denominator) summed against the JAX sharded fused step at 32x16,
    depth 1, no AA, target 0.9 of the render (tests/test_parallel.py::
    test_sharded_fused_value_and_grad's case): the loss and the gradients
    under the kernel rule (render_bwd_cuda.grad_rule)."""
    import jax
    import python_ray_tracer_tpu as jrt
    from python_ray_tracer_tpu import train as jtrain
    from python_ray_tracer_tpu.parallel.mesh import make_mesh as jmesh
    jm = jmesh(jax.devices()[:2])
    res = (32, 16)
    cam_j, scene_j = jrt.default_camera(res), jrt.default_scene()
    target_j = jrt.render_image(cam_j, scene_j, depth=1, aliasing=False) * 0.9
    loss_j, g_j = jax.jit(jtrain.pallas_value_and_grad_sharded(
        cam_j, jm, depth=1, pallas_interpret=True))(scene_j, target_j)
    scene = bridge.scene_from_leaves([np.asarray(x) for x in
                                      jax.tree_util.tree_leaves(scene_j)], device="cpu")
    want = torch.cat([rb.flatten_grads(bridge.scene_from_leaves(
        [np.asarray(x) for x in jax.tree_util.tree_leaves(g_j)], device="cpu")),
        torch.tensor([float(loss_j)])])
    cam, target = trt.default_camera(res, device="cpu"), torch.from_numpy(np.array(target_j))
    got = 0
    for i in range(2):
        x0, lw = column_slice(res[0], i, 2)
        flat = rb.loss_and_scene_grads_plain(cam, scene, target[x0:x0 + lw], depth=1,
                                             x_offset=x0, local_width=lw)
        got = got + torch.cat([flat[:-14], torch.zeros(13), flat[-1:]])
    rule = rb.grad_rule(got, want, 6, 1, 3)
    assert all(ok for _, ok in rule.values()), rule
