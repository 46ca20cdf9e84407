"""The harness's core: the manifest and the files it names, and the window's
arithmetic (a rate over the whole window, a percentile over every request,
the device's busy time as a union of intervals)."""
from __future__ import annotations

import dataclasses
import importlib.util
import json
import math
import os
from typing import List, Optional, Sequence, Tuple

PKG = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(PKG)


def read_json(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


@dataclasses.dataclass
class Cell:
    """One entry of ``workloads`` with everything it names, read from the files
    that carry those names."""

    name: str
    config: dict
    traffic: dict
    params: dict
    chips: int
    end_to_end: List[dict]
    per_layer: List[dict]


def load_file(path: str, name: str):
    """The module of the Python file ``path``, loaded under ``name``."""
    if not os.path.isfile(path):
        raise FileNotFoundError(path)
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


class Manifest:
    """``BENCHMARK.json`` and the files it names. Names resolve to files:
    a configuration to its ``file``, a traffic mix to ``traffic/<name>.json``,
    the traffic's ``kind`` (its generator and the port's entry points it
    drives) to ``kinds/<kind>.py``, a cell's parameters to
    ``cells/<name>.json``, a per-layer metric to the reader
    ``metrics/<name>.py``."""

    def __init__(self, root: str = ROOT, pkg: str = PKG):
        self.root, self.pkg = root, pkg
        self.data = read_json(os.path.join(root, "BENCHMARK.json"))

    def config(self, name: str) -> dict:
        entry = next(c for c in self.data["configs"] if c["name"] == name)
        return read_json(os.path.join(self.root, entry["file"]))

    def traffic(self, name: str) -> dict:
        return read_json(os.path.join(self.pkg, "traffic", f"{name}.json"))

    def cell_params(self, name: str) -> dict:
        return read_json(os.path.join(self.pkg, "cells", f"{name}.json"))

    def cell(self, name: str) -> Cell:
        entry = next((w for w in self.data["workloads"] if w["name"] == name), None)
        if entry is None:
            raise KeyError(f"no workload {name!r} in BENCHMARK.json")
        e2e = [m for m in self.data["end_to_end"]
               if m["name"] == "setup_s" or name in m.get("workloads", [name])]
        names = {m["name"] for m in e2e}
        layer = [m for m in self.data["per_layer"]
                 if (name in m["workloads"] if "workloads" in m else m["moves"] in names)]
        return Cell(name, self.config(entry["config"]), self.traffic(entry["traffic"]),
                    self.cell_params(name), int(entry["chips"]), e2e, layer)

    def reader(self, metric: str):
        """The per-layer metric's reader: ``metrics/<name>.py``'s ``read``."""
        return load_file(os.path.join(self.pkg, "metrics", f"{metric}.py"),
                         f"port_bench_metric_{metric}").read

    def kind(self, kind: str):
        """The traffic kind's generator: ``kinds/<kind>.py``'s ``Traffic``."""
        return load_file(os.path.join(self.pkg, "kinds", f"{kind}.py"),
                         f"port_bench_kind_{kind}").Traffic


def p95(values: Sequence[float]) -> float:
    """The 95th percentile by nearest rank: the smallest observed value with
    at least 95% of all values at or below it."""
    v = sorted(values)
    if not v:
        raise ValueError("no values")
    return v[max(0, math.ceil(0.95 * len(v)) - 1)]


@dataclasses.dataclass
class Window:
    """What a measured window delivered: its start and end (host seconds),
    and for every unit (a frame, a step) its latency in seconds."""

    start: float
    end: float
    latencies: List[float]

    @property
    def seconds(self) -> float:
        return self.end - self.start

    def stat(self, kind: str) -> float:
        """``ms_per_unit``: the window's whole length over every unit it
        delivered; ``p95_latency_ms``: the 95th percentile over every unit."""
        if kind == "ms_per_unit":
            return 1e3 * self.seconds / len(self.latencies)
        if kind == "p95_latency_ms":
            return 1e3 * p95(self.latencies)
        raise ValueError(f"unknown window statistic {kind!r}")


def union_seconds(intervals: Sequence[Tuple[float, float]],
                  window: Optional[Tuple[float, float]] = None) -> float:
    """Length of the union of ``(start, end)`` intervals, clipped to
    ``window`` where one is given."""
    total, cur_s, cur_e = 0.0, None, None
    for s, e in sorted(intervals):
        if window is not None:
            s, e = max(s, window[0]), min(e, window[1])
        if e <= s:
            continue
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                total += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        total += cur_e - cur_s
    return total


def gaps(intervals: Sequence[Tuple[float, float]],
         window: Tuple[float, float]) -> List[Tuple[float, float]]:
    """The stretches of ``window`` that no interval covers."""
    out, t = [], window[0]
    for s, e in sorted(intervals):
        s, e = max(s, window[0]), min(e, window[1])
        if e <= s:
            continue
        if s > t:
            out.append((t, s))
        t = max(t, e)
    if t < window[1]:
        out.append((t, window[1]))
    return out


def idle_share(intervals, window) -> float:
    """Percent of ``window`` in which no interval is active."""
    return 100.0 * (1.0 - union_seconds(intervals, window) / (window[1] - window[0]))

