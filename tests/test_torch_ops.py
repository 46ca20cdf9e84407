"""PyTorch port's intersection and shading ops against the JAX package's, on
seeded rays.

Tolerances: distances within rtol 1e-5 (float32 with a different reduction
order); boolean masks equal except for near ties, whose share is counted and
held to <= 0.5% (a ray grazing a silhouette or a shadow edge can flip on an
ulp).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import python_ray_tracer_tpu as jrt
import python_ray_tracer_tpu_torch as trt
from python_ray_tracer_tpu_torch import bridge

torch.set_num_threads(1)
TIE_SHARE = 0.005


def _scenes():
    sj = jrt.default_scene()
    sr = jrt.random_scene(jax.random.key(1), n_spheres=24)
    return {"demo": sj, "random24": sr}


def _pair(name):
    sj = _scenes()[name]
    return sj, bridge.scene_from_leaves(
        [np.asarray(x) for x in jax.tree_util.tree_leaves(sj)], device="cpu")


def _rays(n=4000, seed=0):
    """Origins around the camera and in the scene, unit directions spread over
    the sphere but biased toward the scene."""
    rng = np.random.default_rng(seed)
    o = rng.uniform([-4, -3, 0.05], [3, 3, 3], (n, 3)).astype(np.float32)
    d = rng.normal(size=(n, 3)) + np.array([1.0, 0.0, -0.3])
    d = (d / np.linalg.norm(d, axis=-1, keepdims=True)).astype(np.float32)
    return o, d


def _masks_close(a, b):
    a, b = np.asarray(a), np.asarray(b)
    assert a.shape == b.shape
    share = (a != b).mean()
    assert share <= TIE_SHARE, f"{share:.3%} of mask entries differ"
    return a == b


@pytest.mark.parametrize("scene_name", ["demo", "random24"])
@pytest.mark.parametrize("compat", [True, False])
def test_intersect_spheres_matches_jax(scene_name, compat):
    sj, st = _pair(scene_name)
    o, d = _rays()
    tj, vj = jrt.intersect_spheres(jnp.asarray(o), jnp.asarray(d), sj.spheres.center,
                                   sj.spheres.radius, compat=compat)
    tt, vt = trt.intersect_spheres(torch.from_numpy(o), torch.from_numpy(d),
                                   st.spheres.center, st.spheres.radius, compat=compat)
    same = _masks_close(vt.numpy(), vj) & np.asarray(vj)
    assert same.sum() > 100      # the rays do hit spheres
    np.testing.assert_allclose(tt.numpy()[same], np.asarray(tj)[same], rtol=1e-5)


@pytest.mark.parametrize("compat", [True, False])
def test_intersect_planes_matches_jax(compat):
    sj, st = _pair("demo")
    o, d = _rays(seed=1)
    d[:50, 2] = 1e-4       # near-parallel rays exercise the threshold
    tj, vj = jrt.intersect_planes(jnp.asarray(o), jnp.asarray(d), sj.planes.origin,
                                  sj.planes.normal, compat=compat)
    tt, vt = trt.intersect_planes(torch.from_numpy(o), torch.from_numpy(d),
                                  st.planes.origin, st.planes.normal, compat=compat)
    same = _masks_close(vt.numpy(), vj) & np.asarray(vj)
    np.testing.assert_allclose(tt.numpy()[same], np.asarray(tj)[same], rtol=1e-5)


@pytest.mark.parametrize("scene_name", ["demo", "random24"])
@pytest.mark.parametrize("compat", [True, False])
def test_closest_hit_matches_jax(scene_name, compat):
    sj, st = _pair(scene_name)
    o, d = _rays(seed=2)
    hj = jrt.closest_hit(jnp.asarray(o), jnp.asarray(d), sj, compat=compat)
    ht = trt.closest_hit(torch.from_numpy(o), torch.from_numpy(d), st, compat=compat)
    ok = _masks_close(ht["hit"].numpy(), hj["hit"])
    ok &= _masks_close(ht["obj"].numpy(), hj["obj"])
    ok &= _masks_close(ht["is_plane"].numpy(), hj["is_plane"])
    sel = ok & np.asarray(hj["hit"])
    assert sel.sum() > 100
    np.testing.assert_allclose(ht["t"].numpy()[sel], np.asarray(hj["t"])[sel],
                               rtol=1e-5)


@pytest.mark.parametrize("compat", [True, False])
def test_any_hit_matches_jax(compat):
    sj, st = _pair("random24")
    o, d = _rays(seed=3)
    oj = np.asarray(jrt.any_hit(jnp.asarray(o), jnp.asarray(d), sj, compat=compat))
    ot = trt.any_hit(torch.from_numpy(o), torch.from_numpy(d), st, compat=compat).numpy()
    _masks_close(ot, oj)
    assert 0.05 < oj.mean() < 0.95     # both outcomes occur


def test_far_clip_and_tie_break():
    """Compat: a hit at t >= 999 is a miss; clean mode keeps it. Coincident
    spheres resolve to the lower index, as the reference's strict `<` does."""
    st = trt.Scene(trt.Spheres.build([([2000.0, 0, 0], 1.0, (255, 0, 0)),
                                      ([5.0, 0, 0], 1.0, (0, 255, 0)),
                                      ([5.0, 0, 0], 1.0, (0, 0, 255))], device="cpu"),
                   trt.Planes.build([], device="cpu"), trt.Lights.build([], device="cpu"),
                   trt.Materials.build(device="cpu"))
    o = torch.zeros((2, 3))
    d = torch.tensor([[1.0, 0, 0], [0, 0, 1.0]])
    far = trt.Scene(trt.Spheres(st.spheres.center[:1], st.spheres.radius[:1],
                                st.spheres.albedo[:1]), st.planes, st.lights, st.materials)
    assert not trt.closest_hit(o, d, far, compat=True)["hit"].any()
    assert trt.closest_hit(o, d, far, compat=False)["hit"][0]
    h = trt.closest_hit(o, d, st, compat=True)
    assert h["obj"][0] == 1 and float(h["t"][0]) == pytest.approx(4.0)


@pytest.mark.parametrize("scene_name", ["demo", "random24"])
@pytest.mark.parametrize("compat", [True, False])
def test_trace_once_matches_jax(scene_name, compat):
    sj, st = _pair(scene_name)
    if not compat:
        mats = jrt.Materials.build(0.1, 0.6, 0.3, specular=0.5, shininess=16.0)
        sj = jrt.Scene(sj.spheres, sj.planes, sj.lights, mats)
        st = trt.Scene(st.spheres, st.planes, st.lights,
                       trt.Materials.build(0.1, 0.6, 0.3, 0.5, 16.0, device="cpu"))
    o, d = _rays(seed=4)
    rj = jrt.trace_once(jnp.asarray(o), jnp.asarray(d), sj, compat=compat)
    rt = trt.trace_once(torch.from_numpy(o), torch.from_numpy(d), st, compat=compat)
    alive = _masks_close(rt.alive.numpy(), rj.alive) & np.asarray(rj.alive)
    # shading flips (a shadow edge on an ulp) are discrete: count them
    diff = np.abs(rt.rgb.numpy() - np.asarray(rj.rgb)).max(-1)
    assert (diff > 1e-4).mean() <= TIE_SHARE
    np.testing.assert_allclose(rt.point.numpy()[alive], np.asarray(rj.point)[alive],
                               atol=1e-4, rtol=1e-5)
    np.testing.assert_allclose(rt.direction.numpy()[alive],
                               np.asarray(rj.direction)[alive], atol=1e-5)


def test_sample_depth2_matches_jax():
    sj, st = _pair("demo")
    o, d = _rays(seed=5)
    cj = np.asarray(jrt.sample(jnp.asarray(o), jnp.asarray(d), sj, depth=2))
    ct = trt.sample(torch.from_numpy(o), torch.from_numpy(d), st, depth=2).numpy()
    diff = np.abs(ct - cj).max(-1)
    assert (diff > 1e-4).mean() <= TIE_SHARE
    assert ct.max() > 0.1
