"""One run of one cell: set-up, the measured window, the traced stretch
(``--trace 1``), the correctness check against the plain reference, and the
result line."""
from __future__ import annotations

import sys
import time
from typing import Optional

import torch

from . import core, drive, trace
from .reference import strict_float32

FORBIDDEN = ("jax", "jaxlib", "flax", "python_ray_tracer_tpu")


def forbidden_modules(names=None) -> list:
    """Loaded modules (or ``names``) whose top-level name, compared whole, is
    JAX's or the JAX package's."""
    names = list(sys.modules) if names is None else names
    return sorted({m.split(".")[0] for m in names} & set(FORBIDDEN))


class Context:
    """What a per-layer metric's reader (``metrics/<name>.py``) reads: the
    traffic's kind, the harness's spans (seconds a call) and the window's
    units, and the traced stretch's trace with the work bounds of its units."""

    def __init__(self, kind: drive.Kind, spans, units: int, tr: Optional[trace.Trace],
                 traced):
        self.kind, self.spans, self.units, self.trace = kind, spans, units, tr
        self._traced, self._bound = traced, {}

    def bound_seconds(self, kernel: str):
        """Seconds an H100 needs at least for ``kernel``'s work in the traced
        stretch (None where the traffic's kind has no such bound)."""
        if kernel not in self._bound:
            self._bound[kernel] = self.kind.bound_seconds(kernel, self._traced)
        return self._bound[kernel]


def run_cell(name: str, seed: int, seconds: float, trace_on: bool, *, t_start: float,
             backend: str = "cuda", overrides: Optional[dict] = None,
             cell_overrides: Optional[dict] = None,
             manifest: Optional[core.Manifest] = None) -> dict:
    """Run cell ``name`` once; the result line's object. ``backend="torch"``
    (the port's plain path on the CPU, for the harness's own tests) skips the
    device's numbers. ``overrides`` and ``cell_overrides`` replace traffic and
    cell parameters, for those tests' small sizes."""
    from .system import Port, launch_counts
    t_port = time.perf_counter()
    strict_float32()
    m = manifest or core.Manifest()
    cell = m.cell(name)
    traffic = dict(cell.traffic, **(overrides or {}))
    params = dict(cell.params, **(cell_overrides or {}))
    port = Port(backend)
    cuda = backend == "cuda"
    kind = m.kind(traffic["kind"])(port, cell.config, traffic, params, seed)
    kind.setup(seconds)
    setup_s = time.perf_counter() - t_start
    window = kind.window(seconds)
    spans = list(kind.spans)
    dev = {"platform": "gpu" if cuda else "cpu",
           "kind": torch.cuda.get_device_name(0) if cuda else "cpu",
           "count": 1,
           "memory_peak_bytes": int(torch.cuda.max_memory_allocated()) if cuda else 0}
    tr, traced, captures = None, None, 0
    if trace_on and cuda:
        tr, traced, captures = trace.capture(kind.stretch, launch_counts)
    kind.release()
    if cuda:
        torch.cuda.empty_cache()
    readings = kind.readings()
    limits = params["limits"]
    checks = {k: {"value": readings[k], "limit": limits[k]} for k in limits}
    correct = all(c["value"] <= c["limit"] for c in checks.values())
    metrics = {}
    if not trace_on:
        for e in cell.end_to_end:
            v = setup_s if e["name"] == "setup_s" else window.stat(traffic["metrics"][e["name"]])
            metrics[e["name"]] = {"value": v, "unit": e["unit"]}
    else:
        ctx = Context(kind, spans, len(window.latencies), tr, traced)
        for e in cell.per_layer:
            v = m.reader(e["name"])(ctx)
            if v is not None:
                metrics[e["name"]] = {"value": v, "unit": e["unit"]}
    out = {"correct": correct, "attempted": len(window.latencies), "failed": 0,
           "metrics": metrics, "device": dev}
    if tr is not None:
        dev["busy_s"], dev["window_s"] = tr.busy_s, tr.window_s
        out["breakdown"] = tr.breakdown()
    out["captures"] = captures
    out["setup_phases"] = [["port imported", t_port - t_start]] + [
        [w, t - t_start] for w, t in kind.marks]
    out["checks"] = checks
    return out
