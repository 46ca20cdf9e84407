"""The port's small public helpers against the JAX package's, on the CPU:
``MetricsLogger.dump_jsonl`` / ``.last`` (tests/test_cli_utils.py:70-79),
``Camera.pixel_locations``, ``RenderConfig.reference_defaults`` and
``row_chunk`` (as the JAX CLI passes it to the plain render, cli.py:122),
``time_fn(best_of=)`` and ``train.pixel_loss(row_chunk=)``."""
import json
import os

import numpy as np
import pytest
import torch

import python_ray_tracer_tpu_torch as trt
from python_ray_tracer_tpu_torch import bridge, cli, train
from python_ray_tracer_tpu_torch.models.scene import LEAF_PATHS
from python_ray_tracer_tpu_torch.utils.config import RenderConfig
from python_ray_tracer_tpu_torch.utils.metrics import MetricsLogger
from python_ray_tracer_tpu_torch.utils.timing import time_fn

torch.set_num_threads(1)


def test_metrics_logger_jsonl_and_last_equal_jax(tmp_path):
    from python_ray_tracer_tpu.utils.metrics import MetricsLogger as JaxLogger
    logs = {"port": MetricsLogger("t", echo=False), "jax": JaxLogger("t", echo=False)}
    recs = {}
    for name, log in logs.items():
        log.log(0, loss=1.5, mrays=2.0)
        log.log(1, loss=0.5)
        path = os.path.join(tmp_path, f"{name}.jsonl")
        log.dump_jsonl(path)
        recs[name] = [json.loads(line) for line in open(path)]
        assert len(recs[name]) == 2 and recs[name][0]["loss"] == 1.5
        assert log.last("loss") == 0.5 and log.last("mrays") == 2.0
        assert log.last("missing") is None

    def strip(rs):
        return [{k: v for k, v in r.items() if k != "t"} for r in rs]
    assert strip(recs["port"]) == strip(recs["jax"])


@pytest.mark.parametrize("res", [(7, 5), (16, 9)])
@pytest.mark.parametrize("compat", [True, False])
def test_pixel_locations_equal_jax(res, compat):
    """Tolerance atol 1e-6, as the camera tests (tests/test_torch_models.py)."""
    import python_ray_tracer_tpu as jrt
    ct = trt.Camera.build(res, [-2.0, 0.0, 2.0], [0.0, -30.0, 0.0], fov=50.0, device="cpu")
    cj = jrt.Camera.build(res, [-2.0, 0.0, 2.0], [0.0, -30.0, 0.0], fov=50.0)
    got = ct.pixel_locations(compat)
    assert got.shape == (3,) + tuple(res) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(cj.pixel_locations(compat)),
                               atol=1e-6, rtol=0)


def test_reference_defaults_and_row_chunk_equal_jax():
    from python_ray_tracer_tpu.utils.config import RenderConfig as JaxConfig
    got, want = RenderConfig.reference_defaults(), JaxConfig.reference_defaults()
    keys = ("width", "height", "ambient", "lambert", "reflection", "depth", "aliasing",
            "fov", "camera_position", "camera_euler", "compat", "row_chunk", "specular",
            "shininess")
    assert {k: getattr(got, k) for k in keys} == {k: getattr(want, k) for k in keys}
    assert got.row_chunk is None and RenderConfig(row_chunk=4).row_chunk == 4


def test_cli_plain_render_takes_the_row_chunk(monkeypatch):
    """The plain backend's render call passes ``cfg.row_chunk`` on (JAX
    cli.py:122), and the chunked frame equals the whole one."""
    seen = []
    real = cli.render_image

    def spy(cam, scene, **kw):
        seen.append(kw.get("row_chunk"))
        return real(cam, scene, **kw)
    monkeypatch.setattr(cli, "render_image", spy)
    cfg = RenderConfig(width=12, height=8, depth=1, aliasing=False, backend="torch",
                       row_chunk=5)
    fn, _ = cli._render_fn(cfg)
    cam = trt.Camera.build((12, 8), cfg.camera_position, cfg.camera_euler, device="cpu")
    scene = trt.default_scene(device="cpu")
    img = fn(cam, scene)
    assert seen == [5]
    assert torch.equal(img, real(cam, scene, depth=1, aliasing=False))


def test_time_fn_best_of_as_jax():
    """``best_of`` repeats the timed block (tests/test_cli_utils.py:80-90)."""
    calls = []

    def fn():
        calls.append(1)
        return torch.ones(4)
    assert time_fn(fn, warmup=1, iters=3, best_of=2) >= 0.0
    assert len(calls) == 1 + 3 * 2


@pytest.mark.parametrize("row_chunk", [None, 5])
def test_pixel_loss_row_chunk_equals_jax(row_chunk):
    """The loss and its gradient through ``row_chunk`` blocks against the JAX
    ``pixel_loss`` (rel 1e-5; the JAX package needs the width divisible)."""
    import jax
    import python_ray_tracer_tpu as jrt
    from python_ray_tracer_tpu import train as jtrain
    res = (10, 6)
    jscene = jrt.default_scene()
    scene = bridge.scene_from_leaves([np.asarray(x) for x in jax.tree_util.tree_leaves(jscene)],
                                     device="cpu")
    cam = trt.Camera.build(res, [-2.0, 0.0, 2.0], [0.0, -30.0, 0.0], device="cpu")
    target = torch.full((10, 6, 3), 0.25)
    loss = train.pixel_loss(cam, target, depth=1, row_chunk=row_chunk)
    leaves = [t.clone().requires_grad_(True) for t in scene.leaves()]
    value = loss(trt.Scene.from_leaves(leaves))
    value.backward()
    jloss = jtrain.pixel_loss(jrt.Camera.build(res, [-2.0, 0.0, 2.0], [0.0, -30.0, 0.0]),
                              target.numpy(), depth=1, row_chunk=row_chunk)
    jvalue, jgrads = jax.value_and_grad(jloss)(jscene)
    assert float(value.detach()) == pytest.approx(float(jvalue), rel=1e-5)
    assert LEAF_PATHS[0] == "spheres.center"
    np.testing.assert_allclose(leaves[0].grad.numpy(), np.asarray(jgrads.spheres.center),
                               rtol=1e-4, atol=1e-6)
    whole = train.pixel_loss(cam, target, depth=1)(scene)
    assert float(whole) == pytest.approx(float(value.detach()), rel=1e-6)
