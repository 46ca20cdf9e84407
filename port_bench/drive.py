"""What every traffic kind shares. A kind is a file of its own,
``kinds/<kind>.py``, found by the ``kind`` of a traffic file
(``traffic/<name>.json``); its class ``Traffic`` is a :class:`Kind`, driven
only by the parameters of that traffic file, the configuration
(``configs/<name>.json``) and the cell's own parameters
(``cells/<name>.json``), and it calls the port's entry points itself.

Every kind sets up and warms up (``setup(seconds)``), runs a window
(``window(seconds) -> core.Window``), runs a traced stretch (``stretch()``),
frees the port's state (``release()``) and gives the numbers of its
correctness check against the plain reference (``readings()``), or, for the
control, ``{name: readings}`` of the reference in another dtype and of any
fault it plants put in the port's place (``control_readings(dtype)``).
"""
from __future__ import annotations

import time
from typing import List, Optional

import torch

from . import scenes
from .reference import scene as ref_scene

# Keys every traffic file may carry besides its kind's own.
COMMON_KEYS = {"kind", "about", "metrics"}


def now() -> float:
    return time.perf_counter()


class Kind:
    """The scene's arrays, the harness's spans and the set-up's marks, and
    the reference's device. ``KEYS``: the traffic parameters the kind runs;
    a traffic file with any other key is refused, so that no parameter is
    silently ignored. ``UNIT``: what one latency of the window is."""

    KEYS: frozenset = frozenset()
    UNIT = ""

    def __init__(self, port, config: dict, traffic: dict, params: dict, seed: int):
        unknown = set(traffic) - set(self.KEYS) - COMMON_KEYS
        if unknown:
            raise ValueError(f"traffic kind {traffic.get('kind')!r} does not run "
                             f"{sorted(unknown)}")
        self.port, self.config, self.traffic, self.params = port, config, traffic, params
        self.seed = seed
        self.cuda = port.device.type == "cuda"
        self.arrays = scenes.scene_arrays(config)
        self.spans: List[float] = []
        self.marks: List[tuple] = []

    def mark(self, what: str) -> None:
        """Note the end of a phase of the set-up (host clock)."""
        self.sync()
        self.marks.append((what, now()))

    def sync(self) -> None:
        if self.cuda:
            torch.cuda.synchronize()

    def ref_device(self) -> torch.device:
        return self.port.device

    def ref_scene(self, dtype=torch.float32, arrays: Optional[dict] = None):
        return ref_scene.from_arrays(arrays or self.arrays, self.ref_device(), dtype)

    def bound_seconds(self, kernel: str, traced: list) -> Optional[float]:
        """Seconds an H100 needs at least for ``kernel``'s work in the traced
        stretch, or None where this kind has no such bound."""
        return None
