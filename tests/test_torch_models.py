"""PyTorch port's scene and camera models against the JAX package's.

Inputs are made with numpy from a seed, or taken from the JAX side through
python_ray_tracer_tpu_torch.bridge. Tolerance atol 1e-6: both sides compute in
float32 and may differ by an ulp in trig (XLA's vs PyTorch's cos/sin/tan).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import python_ray_tracer_tpu as jrt
import python_ray_tracer_tpu_torch as trt
from python_ray_tracer_tpu_torch import bridge
from python_ray_tracer_tpu_torch.models.scene import LEAF_PATHS

torch.set_num_threads(1)


def _scene_leaves(scene):
    return [np.asarray(x) for x in jax.tree_util.tree_leaves(scene)]


@pytest.mark.parametrize("angles", [(0.0, -30.0, 0.0), (10.0, 20.0, 30.0),
                                    (1.5, -27.5, 2.0), (-45.0, 60.0, -120.0)])
def test_euler_rotation_matches_jax(angles):
    want = np.asarray(jrt.euler_rotation(*angles))
    got = trt.euler_rotation(*angles, device="cpu").numpy()
    np.testing.assert_allclose(got, want, atol=1e-6, rtol=0)
    # orthonormal, det +1
    np.testing.assert_allclose(got @ got.T, np.eye(3), atol=1e-6)
    assert np.linalg.det(got) == pytest.approx(1.0, abs=1e-6)


def test_default_camera_bit_identical_to_jax():
    """The demo pose (0, -30, 0) must carry the same bits on both sides, or
    every ray drifts and silhouettes flip."""
    cj, ct = jrt.default_camera((1000, 1000)), trt.default_camera((1000, 1000), device="cpu")
    np.testing.assert_array_equal(ct.rotation.numpy(), np.asarray(cj.rotation))
    np.testing.assert_array_equal(ct.position.numpy(), np.asarray(cj.position))
    assert float(ct.fov) == float(cj.fov)


@pytest.mark.parametrize("res", [(1920, 1080), (40, 24)])
@pytest.mark.parametrize("compat", [True, False])
def test_grid_params_matches_jax(res, compat):
    cj = jrt.default_camera(res)
    ct = trt.default_camera(res, device="cpu")
    want = [float(v) for v in cj.grid_params(compat)]
    got = [float(v) for v in ct.grid_params(compat)]
    np.testing.assert_allclose(got, want, atol=1e-6, rtol=0)
    # compat keeps the reference's int(w/h) aspect ratio: 1 at 1920x1080
    ar = float(int(res[0] / res[1])) if compat else res[0] / res[1]
    assert got[1] == float(np.float32(ar))


@pytest.mark.parametrize("compat", [True, False])
def test_ray_directions_fractional_matches_jax(compat):
    rng = np.random.default_rng(0)
    cj = jrt.Camera.build((40, 24), [-2.0, 0.5, 2.0], [3.0, -25.0, 7.0])
    ct = bridge.camera_from_arrays(cj.position, cj.rotation, cj.fov, cj.resolution, device="cpu")
    xy = (rng.uniform(-1.0, 41.0, (200, 2)) * 2).round() / 2     # half offsets
    xy = np.concatenate([xy, rng.uniform(0, 40, (200, 2))]).astype(np.float32)
    want = np.asarray(cj.ray_directions(jnp.asarray(xy), compat=compat))
    got = ct.ray_directions(torch.from_numpy(xy), compat=compat).numpy()
    np.testing.assert_allclose(got, want, atol=1e-6, rtol=0)
    np.testing.assert_allclose(np.linalg.norm(got, axis=-1), 1.0, atol=1e-6)


def test_to_soa_matches_jax_and_round_trips():
    sj, st = jrt.default_scene(), trt.default_scene(device="cpu")
    for a, b in zip(st.to_soa(), sj.to_soa()):
        np.testing.assert_array_equal(a, b)
    # from_soa(to_soa) agrees with the JAX package's own round trip
    back_t = trt.Scene.from_soa(*st.to_soa(), device="cpu")
    back_j = jrt.Scene.from_soa(*sj.to_soa())
    for a, b in zip(_scene_leaves(back_j),
                    [getattr(getattr(back_t, g), f).numpy() for g, f in
                     (k.split(".") for k in LEAF_PATHS)]):
        np.testing.assert_array_equal(b, a)


def test_plane_normals_normalized_like_jax():
    items = [([0, 0, 0], [0, 3, 4], (10, 20, 30)), ([1, 2, 3], [1, 1, 1], (1, 2, 3))]
    pj, pt = jrt.Planes.build(items), trt.Planes.build(items, device="cpu")
    np.testing.assert_allclose(pt.normal.numpy(), np.asarray(pj.normal), atol=1e-7)
    np.testing.assert_array_equal(pt.albedo.numpy(), np.asarray(pj.albedo))


def test_random_scene_from_jax_through_bridge():
    sj = jrt.random_scene(jax.random.key(3), n_spheres=24)
    st = bridge.scene_from_leaves(_scene_leaves(sj), device="cpu")
    assert (st.spheres.count, st.planes.count, st.lights.count) == (24, 1, 3)
    for a, b in zip(st.to_soa(), sj.to_soa()):
        np.testing.assert_array_equal(a, b)
    # and through the SoA route with the material scalars
    st2 = bridge.scene_from_soa(*sj.to_soa(), materials=(0.0, 0.6, 0.3, 0.0, 32.0), device="cpu")
    np.testing.assert_allclose(st2.spheres.albedo.numpy(),
                               np.asarray(sj.spheres.albedo), atol=1e-7)


def test_random_scene_generator_is_seeded_and_capped():
    a = trt.random_scene(50, n_lights=5, generator=torch.Generator().manual_seed(9), device="cpu")
    b = trt.random_scene(50, n_lights=5, generator=torch.Generator().manual_seed(9), device="cpu")
    for x, y in zip(a.to_soa(), b.to_soa()):
        np.testing.assert_array_equal(x, y)
    assert a.lights.count == 3                       # the JAX package's 3-light cap
    c = a.spheres.center.numpy()
    assert c[:, :2].min() >= -8 and c[:, :2].max() <= 8
    assert c[:, 2].min() >= 0.2 and c[:, 2].max() <= 4.0
    r = a.spheres.radius.numpy()
    assert r.min() >= 0.15 and r.max() <= 0.8
