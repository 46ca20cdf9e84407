"""The device trace of a stretch of traffic, by ``torch.profiler``, reduced to
what the per-layer metrics read: device time by kernel, the device's busy
time in the traced window, and the longest idle gaps named by what the host
was doing.

A profiler session can lose kernel records (seen on the card's host late in a
long process): :func:`capture` counts each counted kernel's records against
the port's launch counters and captures again while any are missing. A
capture that never comes whole gives no device number at all."""
from __future__ import annotations

import dataclasses
import json
import os
import re
import tempfile
from typing import Callable, Dict, List, Optional, Tuple

import torch

from . import core

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "user_annotation", "cuda_runtime", "cuda_driver")
WINDOW = "port_bench.traced"


def short_name(name: str) -> str:
    """A kernel's name without its return type, template arguments or
    parameter list."""
    name = re.sub(r"^void ", "", name.replace("(anonymous namespace)::", "")).split("(")[0]
    return name.split("<")[0] or name


@dataclasses.dataclass
class Trace:
    window: Tuple[float, float]                 # seconds, trace clock
    device: List[Tuple[float, float, str]]      # device intervals and names
    host: List[Tuple[float, float, str]]

    @property
    def window_s(self) -> float:
        return self.window[1] - self.window[0]

    @property
    def busy_s(self) -> float:
        return core.union_seconds([(s, e) for s, e, _ in self.device], self.window)

    def idle_share(self) -> float:
        return core.idle_share([(s, e) for s, e, _ in self.device], self.window)

    def kernel_seconds(self, kernel: str) -> float:
        return sum(e - s for s, e, n in self.device if short_name(n) == kernel)

    def kernel_count(self, kernel: str) -> int:
        return sum(1 for _, _, n in self.device if short_name(n) == kernel)

    def breakdown(self, top: int = 10) -> dict:
        ops: Dict[str, float] = {}
        for s, e, n in self.device:
            ops[short_name(n)] = ops.get(short_name(n), 0.0) + (e - s)
        idle = sorted(core.gaps([(s, e) for s, e, _ in self.device], self.window),
                      key=lambda g: g[0] - g[1])[:top]
        return {"device_ops": sorted(([n, t] for n, t in ops.items()),
                                     key=lambda x: -x[1])[:top],
                "idle_gaps": [[self.host_at(0.5 * (s + e)), e - s] for s, e in idle]}

    def host_at(self, t: float) -> str:
        """The innermost host event running at ``t``."""
        inside = [(e - s, n) for s, e, n in self.host if s <= t <= e and n != WINDOW]
        return min(inside)[1] if inside else "host: no traced call"


def parse(path: str) -> Trace:
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    dev, host, window = [], [], None
    for ev in events:
        if ev.get("ph") != "X":
            continue
        s = float(ev["ts"]) * 1e-6
        e = s + float(ev.get("dur", 0.0)) * 1e-6
        cat = ev.get("cat", "")
        if cat in DEVICE_CATS:
            dev.append((s, e, ev.get("name", "")))
        elif cat in HOST_CATS:
            host.append((s, e, ev.get("name", "")))
            if ev.get("name") == WINDOW and cat == "user_annotation":
                window = (s, e)
    if window is None:
        raise RuntimeError(f"the trace has no {WINDOW!r} window")
    return Trace(window, dev, host)


def capture(stretch: Callable[[], object], counts: Callable[[], Dict[str, int]],
            tries: int = 3) -> Tuple[Optional[Trace], object, int]:
    """Run ``stretch()`` under the profiler, inside the :data:`WINDOW`
    annotation, until the trace holds one record for every launch the
    counters ``counts()`` saw (at most ``tries`` times). Returns the trace
    (None if none came whole), the last stretch's result and the captures
    made."""
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    result = None
    for attempt in range(1, tries + 1):
        before = counts()
        prof = torch.profiler.profile(activities=acts)
        with prof:
            with torch.profiler.record_function(WINDOW):
                result = stretch()
                torch.cuda.synchronize()
        launched = {k: v - before[k] for k, v in counts().items()}
        with tempfile.TemporaryDirectory(prefix="port_bench_trace_") as tmp:
            path = os.path.join(tmp, "trace.json")
            prof.export_chrome_trace(path)
            tr = parse(path)
        if all(tr.kernel_count(k) == n for k, n in launched.items()):
            return tr, result, attempt
    return None, result, tries
