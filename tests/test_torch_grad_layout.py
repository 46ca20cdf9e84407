"""The flat gradient layout of the port's backward kernel (ops/cuda/render_bwd_cuda.py)
against the JAX package's ``render_bwd.grad_layout`` / ``unflatten_grads``, and
the flat <-> pytree round trip through ``bridge.grads_from_flat``."""
import jax
import numpy as np
import pytest
import torch

import python_ray_tracer_tpu as jrt
from python_ray_tracer_tpu.ops.pallas import render_bwd as jbwd
from python_ray_tracer_tpu_torch import bridge
from python_ray_tracer_tpu_torch.ops.cuda import render_bwd_cuda as rb

COUNTS = [(6, 1, 3), (2, 1, 2), (24, 2, 5), (0, 1, 1)]


@pytest.mark.parametrize("ns,npl,nl", COUNTS)
def test_grad_layout_matches_jax(ns, npl, nl):
    slots, n = rb.grad_layout(ns, npl, nl)
    want_slots, want_n = jbwd.grad_layout(ns, npl, nl)
    assert slots == want_slots and n == want_n
    assert rb.n_grads(ns, npl, nl) == n and rb.n_grads(ns, npl, nl, True) == n + 1


@pytest.mark.parametrize("fused", [False, True])
@pytest.mark.parametrize("ns,npl,nl", COUNTS)
def test_flat_to_pytree_matches_jax_unflatten(ns, npl, nl, fused):
    """A JAX flat vector -> the port's Scene/Camera gradients leaf for leaf
    equal to the JAX package's unflatten_grads, and back to the same bits."""
    n = rb.n_grads(ns, npl, nl, fused)
    flat = np.random.default_rng(ns + npl + nl).standard_normal(n).astype(np.float32)
    cam_j = jrt.default_camera((12, 10))
    want = jbwd.unflatten_grads(jax.numpy.asarray(flat), ns, npl, nl, cam_j,
                                return_camera=True, fused_loss=fused)
    want_loss = want[0] if fused else None
    want_scene, want_cam = want[-2], want[-1]
    scene_g, cam_g, loss = bridge.grads_from_flat(flat, ns, npl, nl, resolution=(12, 10))
    for got, ref in zip(scene_g.leaves(), jax.tree_util.tree_leaves(want_scene)):
        np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    for got, ref in zip((cam_g.position, cam_g.rotation, cam_g.fov),
                        jax.tree_util.tree_leaves(want_cam)):
        np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    assert cam_g.resolution == (12, 10)
    if fused:
        assert float(loss) == float(want_loss)
    else:
        assert loss is None
    np.testing.assert_array_equal(bridge.flat_from_grads(scene_g, cam_g, loss), flat)


def test_unflatten_forms_and_shape_check():
    flat = torch.arange(rb.n_grads(2, 1, 2, True), dtype=torch.float32)
    loss, scene_g = rb.unflatten_grads(flat, 2, 1, 2, (4, 4), return_camera=False,
                                       fused_loss=True)
    assert float(loss) == flat[-1] and scene_g.spheres.center.shape == (2, 3)
    scene_only = rb.unflatten_grads(flat[:-1], 2, 1, 2, (4, 4), return_camera=False,
                                    fused_loss=False)
    assert float(scene_only.materials.shininess) == 7 * 2 + 9 + 3 * 2 + 4
    # without camera gradients the camera slots flatten to 0
    assert bridge.flat_from_grads(scene_only)[-13:].tolist() == [0.0] * 13
    with pytest.raises(ValueError, match="expected"):
        rb.unflatten_grads(flat, 2, 1, 2, (4, 4), return_camera=True, fused_loss=False)
