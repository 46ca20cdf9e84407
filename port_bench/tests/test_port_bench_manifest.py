"""The manifest resolves every name to its file, and a configuration, a
traffic mix, a cell and a per-layer metric are added as new files alone."""
import hashlib
import json
import os
import re
import shutil
import time

import pytest

from port_bench import core, harness

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


@pytest.fixture(scope="module")
def manifest():
    return core.Manifest()


def test_every_cell_resolves(manifest):
    for w in manifest.data["workloads"]:
        cell = manifest.cell(w["name"])
        assert cell.traffic["kind"] and cell.config["scene"] and "limits" in cell.params
        e2e = {m["name"] for m in cell.end_to_end}
        assert "setup_s" in e2e and len(e2e) >= 2
        assert cell.per_layer, w["name"]
        for m in cell.per_layer:
            assert callable(manifest.reader(m["name"]))
            assert m["moves"] in e2e
        for m in cell.end_to_end:
            if m["name"] != "setup_s":
                assert m["name"] in cell.traffic["metrics"]
        kind = manifest.kind(cell.traffic["kind"])
        assert set(cell.traffic) <= set(kind.KEYS) | {"kind", "about", "metrics"}


def test_manifest_follows_the_contract(manifest):
    d = manifest.data
    assert set(d) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end",
                      "per_layer"}
    assert d["command"][:3] == ["python3", "-m", "port_bench.run"]
    for c in d["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"} and NAME.match(c["name"])
        assert c["file"].startswith("port_bench/") and os.path.isfile(
            os.path.join(core.ROOT, c["file"]))
    names = [w["name"] for w in d["workloads"]]
    assert len(names) == len(set(names))
    for w in d["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"} and w["chips"] == 1
        assert NAME.match(w["name"]) and len(w["why"]) <= 200
    for m in d["end_to_end"] + d["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"]) and m["better"] in ("lower",
                                                                                   "higher")
    for m in d["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
    for m in d["per_layer"]:
        assert set(m) == {"name", "unit", "better", "source", "layer", "moves", "workloads"}


def _digest(root):
    out = {}
    for dirpath, _, files in os.walk(root):
        for f in files:
            if "__pycache__" not in dirpath:
                p = os.path.join(dirpath, f)
                with open(p, "rb") as fh:
                    out[os.path.relpath(p, root)] = hashlib.sha256(fh.read()).hexdigest()
    return out


def _checkout(tmp_path):
    root = tmp_path / "checkout"
    pkg = root / "port_bench"
    shutil.copytree(core.PKG, pkg, ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(os.path.join(core.ROOT, "BENCHMARK.json"), root / "BENCHMARK.json")
    return root, pkg


def test_new_cell_config_and_metric_are_new_files_alone(tmp_path):
    root, pkg = _checkout(tmp_path)
    before = _digest(pkg)
    cfg = json.loads((pkg / "configs" / "demo.json").read_text())
    cfg["scene"]["spheres"] = cfg["scene"]["spheres"][:2]
    (pkg / "configs" / "pair.json").write_text(json.dumps(cfg))
    traffic = json.loads((pkg / "traffic" / "render_pan.json").read_text())
    traffic["width"], traffic["height"] = 1280, 720
    (pkg / "traffic" / "render_720p.json").write_text(json.dumps(traffic))
    (pkg / "cells" / "pair.render_720p.json").write_text(
        (pkg / "cells" / "demo.render_pan.json").read_text())
    (pkg / "metrics" / "batch_frames.py").write_text(
        "def read(ctx):\n    return float(ctx.units)\n")
    bench = json.loads((root / "BENCHMARK.json").read_text())
    bench["configs"].append({"name": "pair", "source": "https://example.org/pair",
                             "file": "port_bench/configs/pair.json", "reduced": [],
                             "why": "two spheres"})
    bench["workloads"].append({"name": "pair.render_720p", "config": "pair",
                               "traffic": "render_720p", "chips": 1, "why": "720p"})
    for m in bench["end_to_end"]:
        if m["name"] in ("frame_ms", "frame_p95_ms"):
            m["workloads"].append("pair.render_720p")
    bench["per_layer"].append({"name": "batch_frames", "unit": "frames", "better": "higher",
                               "source": "program_counter", "layer": "batch and host packing",
                               "moves": "frame_ms", "workloads": ["pair.render_720p"]})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    m = core.Manifest(str(root), str(pkg))
    cell = m.cell("pair.render_720p")
    assert len(cell.config["scene"]["spheres"]) == 2 and cell.traffic["width"] == 1280
    assert [e["name"] for e in cell.per_layer][-1] == "batch_frames"

    class Ctx:
        units = 12
    assert m.reader("batch_frames")(Ctx()) == 12.0
    after = _digest(pkg)
    assert {k: v for k, v in after.items() if k in before} == before


# A traffic kind of its own: every batch is one start's, the camera standing still.
STILL = """
import numpy as np
from port_bench import core
Base = core.Manifest().kind("render_batches")


class Traffic(Base):
    def _order(self, stream, cycle):
        return np.zeros(self.yaws.shape[0], dtype=np.int64)
"""


def test_new_traffic_kind_is_new_files_alone(tmp_path):
    root, pkg = _checkout(tmp_path)
    before = _digest(pkg)
    (pkg / "kinds" / "still_batches.py").write_text(STILL)
    traffic = json.loads((pkg / "traffic" / "render_pan.json").read_text())
    traffic.update(kind="still_batches", width=24, height=16, batch=2, warmup_batches=1)
    (pkg / "traffic" / "render_still.json").write_text(json.dumps(traffic))
    (pkg / "cells" / "demo.render_still.json").write_text(
        (pkg / "cells" / "demo.render_pan.json").read_text())
    bench = json.loads((root / "BENCHMARK.json").read_text())
    bench["workloads"].append({"name": "demo.render_still", "config": "demo",
                               "traffic": "render_still", "chips": 1, "why": "still"})
    for m in bench["end_to_end"] + bench["per_layer"]:
        if "demo.render_pan" in m.get("workloads", []):
            m["workloads"].append("demo.render_still")
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    m = core.Manifest(str(root), str(pkg))
    assert m.kind("still_batches").__name__ == "Traffic"
    out = harness.run_cell("demo.render_still", 5, 0.5, False, t_start=time.perf_counter(),
                           backend="torch", manifest=m)
    assert out["correct"] and out["attempted"] > 0, out["checks"]
    assert set(out["metrics"]) == {"frame_ms", "frame_p95_ms", "setup_s"}
    after = _digest(pkg)
    assert {k: v for k, v in after.items() if k in before} == before


def test_a_traffic_parameter_the_kind_does_not_run_is_refused(manifest):
    cell = manifest.cell("demo.fit_soft")
    with pytest.raises(ValueError, match="mode"):
        harness.run_cell("demo.fit_soft", 1, 0.1, False, t_start=time.perf_counter(),
                         backend="torch", overrides={"mode": "hard"}, manifest=manifest)
    assert "mode" not in cell.traffic
