"""The port's ``jax.random`` stream (``utils/prng.py``) and ``random_scene``
held bit for bit against JAX's and the JAX package's on the CPU, and
``chip_smoke.py``'s ``[cli-scene]`` digests against the JAX package's scenes."""
import hashlib
import importlib.util
import os

import jax
import numpy as np
import pytest
import torch

import python_ray_tracer_tpu as jrt
import python_ray_tracer_tpu_torch as trt
from python_ray_tracer_tpu_torch.utils import prng

torch.set_num_threads(1)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SEEDS = (0, 1, 11, 2 ** 31 - 1, -1, 2 ** 32 + 3)
# random_scene's ranges (centers x and y share the first), and one where the
# float64 sum is inexact: a float64 product and sum rounded to float32 rounds
# twice there and misses JAX's fused multiply-add on about 1 draw in 8
RANGES = ((-8.0, 8.0), (0.2, 4.0), (0.15, 0.8), (0.2, 1.0), (-3e-20, 7.0))


def _jax_scene(n, n_lights, seed, materials=None):
    return jrt.random_scene(jax.random.key(seed), n, n_lights, materials)


@pytest.mark.parametrize("seed", SEEDS)
def test_key_is_jax_key_data(seed):
    got = prng.key(seed)
    assert got.dtype == np.uint32
    np.testing.assert_array_equal(got, np.asarray(jax.random.key_data(jax.random.key(seed))))
    np.testing.assert_array_equal(prng.key(got), got)      # key data passes through


@pytest.mark.parametrize("seed", (0, 11, -1))
def test_split_and_bits_match_jax(seed):
    k = jax.random.key(seed)
    np.testing.assert_array_equal(prng.split(seed, 5),
                                  np.asarray(jax.random.key_data(jax.random.split(k, 5))))
    sub = prng.split(seed, 3)[2]
    np.testing.assert_array_equal(
        prng.split(sub, 2), np.asarray(jax.random.key_data(
            jax.random.split(jax.random.split(k, 3)[2], 2))))
    np.testing.assert_array_equal(prng.bits(seed, (7, 3)),
                                  np.asarray(jax.random.bits(k, (7, 3))))


@pytest.mark.parametrize("seed", (0, 123))
@pytest.mark.parametrize("lo,hi", RANGES)
def test_uniform_matches_jax(seed, lo, hi):
    """2^20 draws, every one the same float32 bits as ``jax.random.uniform``."""
    got = prng.uniform(seed, (1 << 20,), lo, hi)
    want = np.asarray(jax.random.uniform(jax.random.key(seed), (1 << 20,), minval=lo,
                                         maxval=hi))
    assert got.dtype == np.float32
    np.testing.assert_array_equal(got, want)


def test_key_rejects_other_shapes():
    with pytest.raises(ValueError, match="key"):
        prng.key(np.zeros(3, np.uint32))


@pytest.mark.parametrize("n", (1, 7, 100, 1000, 4096))
@pytest.mark.parametrize("n_lights", (1, 2, 3))
def test_random_scene_is_the_jax_packages(n, n_lights):
    seed = {1: 0, 7: 5, 100: 1, 1000: 11, 4096: 123}[n] + n_lights
    mats = (0.1, 0.5, 0.4, 0.2, 16.0)
    got = trt.random_scene(n, n_lights, trt.Materials.build(*mats, device="cpu"), key=seed,
                           device="cpu")
    want = _jax_scene(n, n_lights, seed, jrt.Materials.build(*mats))
    for group, fields in (("spheres", ("center", "radius", "albedo")),
                          ("planes", ("origin", "normal", "albedo")), ("lights", ("position",)),
                          ("materials", ("ambient", "lambert", "reflection", "specular",
                                         "shininess"))):
        for f in fields:
            a = getattr(getattr(got, group), f)
            b = np.asarray(getattr(getattr(want, group), f))
            assert a.dtype == torch.float32 and a.device.type == "cpu"
            assert np.array_equal(a.numpy(), b), f"{group}.{f}"


def test_random_scene_takes_key_data():
    k = jax.random.split(jax.random.key(7), 2)[1]
    got = trt.random_scene(12, key=np.asarray(jax.random.key_data(k)), device="cpu")
    want = jrt.random_scene(k, 12)
    for f in ("center", "radius", "albedo"):
        np.testing.assert_array_equal(getattr(got.spheres, f).numpy(),
                                      np.asarray(getattr(want.spheres, f)))


def test_random_scene_reads_no_global_state():
    torch.manual_seed(1)
    np.random.seed(1)
    a = trt.random_scene(50, device="cpu")
    torch.manual_seed(2)
    np.random.seed(2)
    b = trt.random_scene(50, key=0, device="cpu")
    for x, y in zip(a.leaves(), b.leaves()):
        assert torch.equal(x, y)


def test_random_scene_generator_keeps_its_stream():
    """An explicit generator draws ``torch.rand`` in the JAX function's order:
    centers x, y, z, radii, albedo."""
    got = trt.random_scene(30, generator=torch.Generator().manual_seed(4), device="cpu")
    g = torch.Generator().manual_seed(4)

    def u(shape, lo, hi):
        return lo + (hi - lo) * torch.rand(shape, generator=g)
    center = torch.stack([u((30,), -8.0, 8.0), u((30,), -8.0, 8.0), u((30,), 0.2, 4.0)], dim=-1)
    assert torch.equal(got.spheres.center, center)
    assert torch.equal(got.spheres.radius, u((30,), 0.15, 0.8))
    assert torch.equal(got.spheres.albedo, u((30, 3), 0.2, 1.0))


def test_chip_smoke_cli_scene_digests_are_the_jax_packages():
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  os.path.join(REPO, "chip_smoke.py"))
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    assert set(smoke.CLI_SCENE_SHA256) == {100, 1000}
    for n, digest in smoke.CLI_SCENE_SHA256.items():
        sj = jrt.random_scene(jax.random.key(0), n)
        h = hashlib.sha256()
        for a in (sj.spheres.center, sj.spheres.radius, sj.spheres.albedo):
            h.update(np.ascontiguousarray(np.asarray(a, np.float32)).tobytes())
        assert h.hexdigest() == digest
        assert smoke.scene_digest(trt.random_scene(n, device="cpu")) == digest
