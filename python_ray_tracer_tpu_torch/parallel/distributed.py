"""Process start-up and the collectives of the ray-parallel path
(``parallel/distributed.py`` of the JAX package).

:func:`initialize` joins the process group (``torch.distributed``), given its
address, size and rank: nothing on a host tells a program of a cluster.
:func:`gather_framebuffer` assembles the frame from the ranks' slices with
one all-gather, and :func:`all_reduce_sum` is the training step's one
collective. The backend defaults from the device: NCCL for CUDA, gloo on the
CPU. NCCL takes one card a rank; two ranks on one card need
``backend="gloo"`` from the caller (gloo then moves CUDA tensors through
host memory). Nothing chooses gloo on its own.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.distributed as dist

from .mesh import Mesh

# Collectives issued, by kind; a plain counter, reset with reset_counts().
COLLECTIVES = {"all_reduce": 0, "all_gather": 0}


def reset_counts() -> None:
    for k in COLLECTIVES:
        COLLECTIVES[k] = 0


def default_backend() -> str:
    """``"nccl"`` where the process has a CUDA device, else ``"gloo"``."""
    return "nccl" if torch.cuda.is_available() else "gloo"


def initialize(init_method: Optional[str] = None, world_size: Optional[int] = None,
               rank: Optional[int] = None, backend: Optional[str] = None) -> None:
    """Join the process group: ``init_method`` (``tcp://host:port``, or None
    for the ``MASTER_ADDR`` / ``MASTER_PORT`` environment that ``torchrun``
    sets), ``world_size`` and ``rank``. A no-op for a world of one (or
    none given), as the JAX package's for one process."""
    if world_size is None or world_size <= 1:
        return
    dist.init_process_group(backend or default_backend(), init_method=init_method,
                            world_size=world_size, rank=rank)


def _check_group(mesh: Mesh) -> None:
    if mesh.size > 1 and mesh.group is None:
        raise ValueError(f"a mesh of {mesh.size} ranks without a process group has no "
                         f"collectives (make_mesh() after initialize())")


def all_reduce_sum(t: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """Sum ``t`` over the mesh's ranks in place (one all-reduce; none on a
    mesh of one rank, counted all the same) and return it."""
    _check_group(mesh)
    COLLECTIVES["all_reduce"] += 1
    if mesh.size > 1:
        dist.all_reduce(t, op=dist.ReduceOp.SUM, group=mesh.group)
    return t


def gather_framebuffer(image_slice: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """The frame ``(W, H, 3)`` on every rank from each rank's ``(W / n, H,
    3)`` slice, in rank order: one all-gather."""
    _check_group(mesh)
    COLLECTIVES["all_gather"] += 1
    if mesh.size == 1:
        return image_slice
    parts = [torch.empty_like(image_slice) for _ in range(mesh.size)]
    dist.all_gather(parts, image_slice.contiguous(), group=mesh.group)
    return torch.cat(parts)
