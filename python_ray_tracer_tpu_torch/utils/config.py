"""Render configuration: the reference's hard-coded knobs (main.py:10-12,
24; fov camera.py:8) as a dataclass, plus compat mode and backend selection."""
from __future__ import annotations

import dataclasses
from typing import Tuple

import torch

BACKENDS = ("cuda", "torch")


@dataclasses.dataclass
class RenderConfig:
    width: int = 1000
    height: int = 1000
    ambient: float = 0.0
    lambert: float = 0.6
    reflection: float = 0.3
    depth: int = 2
    aliasing: bool = True
    fov: float = 45.0
    camera_position: Tuple[float, float, float] = (-2.0, 0.0, 2.0)
    camera_euler: Tuple[float, float, float] = (0.0, -30.0, 0.0)
    compat: bool = True            # reproduce the reference's quirks
    backend: str = "cuda"          # "cuda" | "torch"
    specular: float = 0.0          # Phong highlight (clean mode only)
    shininess: float = 32.0


def resolve_backend(backend: str) -> str:
    """``"cuda"`` (the default): the hand-written kernels on the card;
    ``"torch"``: the plain PyTorch version on the CPU, only when asked for.
    ``cuda`` without a card raises: no backend falls back to the CPU."""
    if backend not in BACKENDS:
        raise ValueError(f"unknown backend {backend!r}; choose from {BACKENDS}")
    if backend == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("backend 'cuda' needs a CUDA device, and "
                           "torch.cuda.is_available() is False")
    return backend
