"""Make a compiled library once, whatever the number of processes asking.

Both builders of the port name each library by a hash of its sources and
flags (``ops/cuda/_build.py`` for the CUDA kernels, ``utils/native.py`` for
the host helpers), so a library that exists is the current one; this module
holds the step they share: the ``flock`` on ``<library>.lock``, the second
look once the lock is held, and the atomic rename of a finished file.
"""
from __future__ import annotations

import fcntl
import os
from typing import Callable


def build_once(so: str, make: Callable[[str], None]) -> str:
    """Return ``so``, making it first if it is missing: under an exclusive
    ``flock`` on ``<so>.lock``, and only if no other process made it while
    this one waited, ``make(tmp)`` writes the library to ``tmp``, which then
    replaces ``so`` in one rename. Whatever ``make`` raises propagates, and
    its partial file is removed."""
    if os.path.isfile(so):
        return so
    os.makedirs(os.path.dirname(so), exist_ok=True)
    with open(f"{so}.lock", "w") as lockf:
        fcntl.flock(lockf, fcntl.LOCK_EX)
        if os.path.isfile(so):       # made by another process while we waited
            return so
        tmp = f"{so}.{os.getpid()}.tmp"
        try:
            make(tmp)
            os.replace(tmp, so)
        finally:
            if os.path.exists(tmp):
                os.remove(tmp)
    return so
