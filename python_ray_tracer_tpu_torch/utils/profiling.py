"""Profiling helpers: named trace scopes and on-demand device traces.

PyTorch counterpart of ``python_ray_tracer_tpu/utils/profiling.py``:
:func:`annotate` is a named range in the profiler's timeline
(``torch.profiler.record_function``), :func:`capture_trace` records
``torch.profiler.profile`` around a block (the CUDA kernels too when a card is
there) and writes a Chrome trace (``chrome://tracing``, Perfetto) into a
directory, and :func:`device_memory_stats` reads the CUDA allocator's numbers.
"""
from __future__ import annotations

import contextlib
import os
import time
from typing import Iterator, Optional

import torch


@contextlib.contextmanager
def annotate(name: str) -> Iterator[None]:
    """A named scope in profiler timelines (host, and the kernels it launches)."""
    with torch.profiler.record_function(name):
        yield


@contextlib.contextmanager
def capture_trace(log_dir: str) -> Iterator[torch.profiler.profile]:
    """Record a profiler trace around a block and write it to
    ``log_dir/<pid>.<ns>.pt.trace.json`` when the block ends. CUDA activity
    (every kernel with its device time) is recorded where a card is there.
    Yields the ``torch.profiler.profile`` (its ``key_averages()`` after the
    block); the written file's path is then its ``trace_path``."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    prof = torch.profiler.profile(activities=activities)
    with prof:
        yield prof
    prof.trace_path = os.path.join(log_dir, f"{os.getpid()}.{time.time_ns()}.pt.trace.json")
    prof.export_chrome_trace(prof.trace_path)


def device_memory_stats(device: Optional[torch.device] = None) -> dict:
    """The CUDA caching allocator's live and peak numbers for ``device``
    (``torch.cuda.memory_stats``; default the current CUDA device), and an
    empty dict for the CPU or where there is no card."""
    if device is None:
        if not torch.cuda.is_available():
            return {}
        device = torch.device("cuda", torch.cuda.current_device())
    device = torch.device(device)
    if device.type != "cuda":
        return {}
    return dict(torch.cuda.memory_stats(device))
