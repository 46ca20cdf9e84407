"""A 1-D mesh of ranks along the ray axis (``parallel/mesh.py`` of the JAX
package).

The frame's width is split into one vertical slice of columns a rank; scene
and camera are small and every rank holds them whole. Ray generation is
analytic in the frame's pixel indices, so a rank renders its slice, AA samples
on the slice's edges included, with no communication: the kernels' slice form
(``x_offset`` / ``local_width``) does it. A mesh with a process group is a
``torch.distributed`` group; one without (``make_mesh(size=n, rank=i)``) lets
one process render slice ``i`` of ``n``, as the tests and ``chip_smoke.py``
do on one card.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Optional, Tuple

import torch.distributed as dist

RAY_AXIS = "rays"


@dataclasses.dataclass(frozen=True)
class Mesh:
    """``rank`` of ``size`` ranks along ``axis``; ``group`` the process group
    of its collectives (None: no collective, one process's view of slice
    ``rank``)."""
    rank: int
    size: int
    group: Optional[Any] = None
    axis: str = RAY_AXIS

    def slice(self, width: int) -> Tuple[int, int]:
        """``(x_offset, local_width)`` of this rank's columns of a frame
        ``width`` wide (:func:`column_slice`)."""
        return column_slice(width, self.rank, self.size)


def column_slice(width: int, rank: int, size: int) -> Tuple[int, int]:
    """``(x_offset, local_width)`` of slice ``rank`` of ``size`` equal slices
    of a frame ``width`` columns wide (the width must divide, as
    ``render_sharded._shard_rows`` asserts)."""
    assert width % size == 0, f"width {width} must be divisible by mesh axis size {size}"
    assert 0 <= rank < size, f"rank {rank} outside a mesh of {size}"
    lw = width // size
    return rank * lw, lw


def make_mesh(group=None, *, size: Optional[int] = None,
              rank: Optional[int] = None) -> Mesh:
    """The mesh of ``group``'s ranks (default the world group where
    ``torch.distributed`` is initialized); with ``size`` (and ``rank``,
    default 0), a mesh without a process group; with neither, one rank."""
    if size is not None:
        return Mesh(0 if rank is None else rank, size)
    if group is None and not (dist.is_available() and dist.is_initialized()):
        return Mesh(0, 1)
    group = dist.group.WORLD if group is None else group
    return Mesh(dist.get_rank(group), dist.get_world_size(group), group)
