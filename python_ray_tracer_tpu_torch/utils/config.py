"""Render configuration: the reference's hard-coded knobs (main.py:10-12,
24; fov camera.py:8) as a dataclass, plus compat mode and backend selection."""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

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
    row_chunk: Optional[int] = None  # the plain render's column blocks
    specular: float = 0.0          # Phong highlight (clean mode only)
    shininess: float = 32.0

    @staticmethod
    def reference_defaults() -> "RenderConfig":
        """The reference driver's exact settings (main.py:10-12, 24)."""
        return RenderConfig()


def _no_card(what: str) -> RuntimeError:
    return RuntimeError(f"{what} needs a CUDA device, and torch.cuda.is_available() "
                        f"is False")


def resolve_backend(backend: str) -> str:
    """``"cuda"`` (the default): the hand-written kernels on the card;
    ``"torch"``: the plain PyTorch version on the tensors' own device, only
    when asked for. ``cuda`` without a card raises: no backend falls back to
    the CPU."""
    if backend not in BACKENDS:
        raise ValueError(f"unknown backend {backend!r}; choose from {BACKENDS}")
    if backend == "cuda" and not torch.cuda.is_available():
        raise _no_card("backend 'cuda'")
    return backend


def resolve_device(device=None) -> torch.device:
    """The device of the tensors a port function makes: ``None`` (every
    constructor's default) is the CUDA device, the current one, and raises
    as :func:`resolve_backend` does without a card; any other value is taken
    as given. There is no "cuda if available": a caller who wants the CPU
    says ``device="cpu"``."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise _no_card("the default device (None: the card)")
    return torch.device("cuda")


def require_cuda(what: str, *tensors: torch.Tensor) -> torch.device:
    """The device of ``tensors``, which must all lie on a CUDA device: every
    wrapper named for a kernel, and every entry point on ``backend="cuda"``,
    raises ``ValueError`` naming the device it was given otherwise, before it
    launches or computes anything. The plain versions are reached by their
    own names or through ``backend="torch"``."""
    for t in tensors:
        if t.device.type != "cuda":
            raise ValueError(f"{what} takes CUDA tensors, got {t.device}")
    return tensors[0].device
