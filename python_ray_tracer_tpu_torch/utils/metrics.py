"""Step-metrics logging for the fits, as ``python_ray_tracer_tpu/utils/metrics.py``:
a structured in-memory history, mirrored to stdout, and its JSONL export."""
from __future__ import annotations

import json
import time
from typing import Any, Dict, List, Optional


class MetricsLogger:
    def __init__(self, name: str = "render", echo: bool = True):
        self.name = name
        self.echo = echo
        self.history: List[Dict[str, Any]] = []
        self._t0 = time.perf_counter()

    def log(self, step: int, **metrics) -> None:
        rec = dict(step=step, t=round(time.perf_counter() - self._t0, 4), **metrics)
        self.history.append(rec)
        if self.echo:
            body = " ".join(f"{k}={v:.6g}" if isinstance(v, float) else f"{k}={v}"
                            for k, v in metrics.items())
            print(f"[{self.name}] step {step}: {body}")

    def dump_jsonl(self, path: str) -> None:
        """Write the history to ``path``, one JSON object a line."""
        with open(path, "w") as f:
            for rec in self.history:
                f.write(json.dumps(rec) + "\n")

    def last(self, key: str) -> Optional[Any]:
        """The newest logged value of ``key``, or None."""
        for rec in reversed(self.history):
            if key in rec:
                return rec[key]
        return None
