"""The frozen copies agree with the port at this commit: the 1000-sphere draw,
the work arithmetic, and the plain renderers the reference is made of."""
import numpy as np
import pytest
import torch

import python_ray_tracer_tpu_torch as rt
from python_ray_tracer_tpu_torch.utils import timing as T
from port_bench import core, scenes
from port_bench.frozen import work as W
from port_bench.reference import camera as rcam
from port_bench.reference import fit as rfit
from port_bench.reference import render as rrender
from port_bench.reference import scene as rscene
from port_bench.reference import soft as rsoft


@pytest.fixture(scope="module")
def manifest():
    return core.Manifest()


def _port_scene(arrays):
    return rt.Scene.from_leaves([torch.from_numpy(np.array(arrays[p]))
                                 for p in rscene.LEAF_PATHS])


def test_frozen_prng_draws_the_ports_1000_sphere_scene(manifest):
    arrays = scenes.scene_arrays(manifest.config("spheres1000"))
    port = rt.random_scene(1000, key=0, device="cpu")
    for path, t in zip(rscene.LEAF_PATHS, port.leaves()):
        assert np.array_equal(arrays[path], t.numpy()), path


def test_demo_arrays_are_the_ports_default_scene(manifest):
    arrays = scenes.scene_arrays(manifest.config("demo"))
    for path, t in zip(rscene.LEAF_PATHS, rt.default_scene(device="cpu").leaves()):
        assert np.array_equal(arrays[path], t.numpy()), path


def _cams(n_spheres, W_px=24, H_px=16, yaws=(-3.0, 0.0, 5.0)):
    rot = scenes.euler_rotation(0.0, -30.0, np.asarray(yaws, np.float32))
    pos = np.tile(np.float32([-2.0, 0.0, 2.0]), (len(yaws), 1))
    ref = rcam.Camera(torch.from_numpy(pos), torch.from_numpy(rot),
                      torch.full((len(yaws),), 45.0), (W_px, H_px))
    port = [rt.Camera(torch.from_numpy(pos[i]), torch.from_numpy(rot[i]),
                      torch.tensor(45.0), (W_px, H_px)) for i in range(len(yaws))]
    return ref, port


@pytest.mark.parametrize("config,aliasing", [("demo", True), ("demo", False),
                                             ("spheres1000", True)])
def test_reference_pixels_are_the_ports_plain_frames(manifest, config, aliasing):
    arrays = scenes.scene_arrays(manifest.config(config))
    if config == "spheres1000":      # its first 40 spheres keep the CPU run short
        arrays = dict(arrays, **{k: arrays[k][:40] for k in arrays if k.startswith("spheres")})
    ref_cam, port_cams = _cams(0)
    Wp, Hp = ref_cam.resolution
    xs, ys = np.meshgrid(np.arange(Wp), np.arange(Hp), indexing="ij")
    pix = torch.from_numpy(np.stack([xs, ys], -1).reshape(1, -1, 2)).repeat(3, 1, 1)
    got = rrender.render_pixels(ref_cam, rscene.from_arrays(arrays, "cpu"), pix, depth=2,
                                aliasing=aliasing, compat=True)
    scene = _port_scene(arrays)
    for f, cam in enumerate(port_cams):
        fb = rt.to_framebuffer(rt.render_image(cam, scene, depth=2, aliasing=aliasing,
                                               compat=True))
        want = fb.permute(1, 2, 0).reshape(-1, 3)
        assert torch.equal(got[f], want), f


def test_reference_soft_render_and_adam_are_the_ports(manifest):
    arrays = scenes.scene_arrays(manifest.config("demo"))
    ref_cam, port_cams = _cams(0, 20, 20, yaws=(0.0,))
    one = rcam.Camera(ref_cam.position[0], ref_cam.rotation[0], ref_cam.fov[0], (20, 20))
    got = rsoft.render_image_soft(one, rscene.from_arrays(arrays, "cpu"), tau=0.05)
    want = rt.render_image_soft(port_cams[0], _port_scene(arrays), tau=0.05)
    assert torch.equal(got, want)
    p = torch.tensor([[0.3, -0.2, 1.0]])
    q = p.clone()
    opt = torch.optim.Adam([q], lr=0.01)
    mine = rfit.Adam({"c": p}, lr=0.01)
    for k in range(3):
        g = torch.tensor([[0.5, -1e-3, 2.0]]) * (k + 1)
        q.grad = g.clone()
        opt.step()
        mine.step({"c": g})
    torch.testing.assert_close(p, q, rtol=1e-6, atol=1e-7)


def test_work_arithmetic_is_the_ports(manifest):
    assert W.bound_ms(1e9, 1e6) == T.bound_ms(1e9, 1e6)
    assert W.bound_ms(1e6, 1e9) == T.bound_ms(1e6, 1e9)
    assert W._scene_bytes(12, 1, 3) == T._scene_bytes(12, 1, 3)
    for name in ("RAYGEN", "HIT_SETUP", "HIT_SPHERE", "HIT_PLANE", "SURFACE", "SPHERE_NORMAL",
                 "LIGHT", "SHADOW_SETUP", "H100_FP32_FLOPS", "H100_HBM_BYTES_PER_S"):
        assert getattr(W, name) == getattr(T, name), name
    for aa in (False, True):
        assert torch.equal(W.bwd_positions(40, 24, aa), T.bwd_positions(40, 24, aa))


def test_work_counts_of_a_scene_are_the_ports(manifest):
    arrays = scenes.scene_arrays(manifest.config("demo"))
    ref_cam, port_cams = _cams(0, 16, 12, yaws=(2.0,))
    one = rcam.Camera(ref_cam.position[0], ref_cam.rotation[0], ref_cam.fov[0], (16, 12))
    ref, port = rscene.from_arrays(arrays, "cpu"), _port_scene(arrays)
    assert W.soft_live_counts(one, ref, 0.05) == T.soft_live_counts(port_cams[0], port, 0.05)
    assert W.soft_work(one, ref, 0.05, "fused") == T.soft_work(port_cams[0], port, 0.05, "fused")
    pos = W.bwd_positions(16, 12, True)
    assert torch.equal(W.hard_chain_counts(one, ref, pos, depth=2),
                       T.hard_chain_counts(port_cams[0], port, pos, depth=2))
