"""Adaptive 256-colour palettes for GIF frames, in numpy.

The JAX package writes its animations with Pillow, whose GIF writer turns
each RGB frame into a palette image with ``convert("P",
palette=Image.Palette.ADAPTIVE)``: Pillow's median cut (``libImaging/Quant.c``,
``quantize`` with ``kmeans=0``). :func:`adaptive_palette` computes the same
palette and the same pixel indices without Pillow, so that the port's GIF
decodes to the JAX package's pixels on a host that has no image library:

1. A histogram of the frame's colours. While it holds more than 65536 colours,
   every channel is shifted right one more bit (Pillow's pixel hash: ``scale``
   grows until the table fits), and the buckets are the shifted colours.
2. Median cut over the buckets into at most 256 boxes. Boxes wait in a binary
   max-heap on their pixel count; a box whose buckets are all one colour is
   dropped from the heap unsplit. A box is cut along the channel with the
   widest range weighted 77 / 150 / 29 (the first on a tie), after the first
   value, from the top, at which the running pixel count passes half the box;
   if that is the lowest value, the lowest value alone goes right.
3. Palette entry ``i`` is the ``i``-th leaf, left (high) box first, and its
   colour the rounded mean ``int(0.5 + sum / count)`` of the frame's own
   pixels in that box.
4. Each colour maps to the nearest entry by squared RGB distance. A tie keeps
   the colour's own box; failing that, the entry nearest that box's colour,
   then the lowest index (Pillow's search over its sorted distance table).

Frames must hold fewer than ``2**24`` pixels (Pillow sums the channels in
32-bit counters).
"""
from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np

MAX_COLORS = 256
MAX_HASH_ENTRIES = 65536
AXIS_WEIGHTS = np.array([77, 150, 29])
MAP_CHUNK = 1 << 15


class _Box:
    __slots__ = ("members", "count", "left", "right")

    def __init__(self, members: np.ndarray, count: int):
        self.members = members            # indices of the box's buckets
        self.count = count                # pixels in the box
        self.left: Optional["_Box"] = None
        self.right: Optional["_Box"] = None


class _Heap:
    """Pillow's ``QuantHeap``: a 1-based binary max-heap on the box's pixel
    count, with its exact sift rules (they decide which of two boxes of equal
    count is cut first)."""

    def __init__(self):
        self.a: List[Optional[_Box]] = [None]

    def add(self, box: _Box) -> None:
        a = self.a
        a.append(None)
        k = len(a) - 1
        while k != 1 and box.count - a[k // 2].count > 0:
            a[k] = a[k // 2]
            k //= 2
        a[k] = box

    def remove(self) -> Optional[_Box]:
        a = self.a
        if len(a) == 1:
            return None
        top, v = a[1], a.pop()
        n = len(a) - 1
        k = 1
        while k * 2 <= n:
            child = k * 2
            if child < n and a[child].count - a[child + 1].count < 0:
                child += 1
            if v.count - a[child].count > 0:
                break
            a[k] = a[child]
            k = child
        if n:
            a[k] = v
        return top


def _histogram(keys: np.ndarray):
    """A frame's packed 24-bit pixels -> its distinct colours (m, 3), each
    pixel's colour, each colour's pixel count, and Pillow's buckets: their
    values at the final scale (b, 3) and each colour's bucket (m,)."""
    colors, inverse, counts = np.unique(keys, return_inverse=True, return_counts=True)
    rgb = np.stack([colors >> 16, (colors >> 8) & 255, colors & 255], axis=1)
    scale = 0
    while True:
        scaled = rgb >> scale
        bkeys = (scaled[:, 0] << 16) | (scaled[:, 1] << 8) | scaled[:, 2]
        buckets, of_color = np.unique(bkeys, return_inverse=True)
        if buckets.size <= MAX_HASH_ENTRIES:
            break
        scale += 1
    bvals = np.stack([buckets >> 16, (buckets >> 8) & 255, buckets & 255], axis=1)
    return rgb, inverse, counts, bvals, of_color


def _split(box: _Box, vals: np.ndarray, weights: np.ndarray) -> bool:
    """Cut ``box`` into ``box.left`` and ``box.right``; False, and no cut,
    where all its buckets are one colour."""
    m = box.members
    v = vals[m]
    extent = v.max(axis=0) - v.min(axis=0)
    if not extent.any():
        return False
    axis = int(np.argmax(extent * AXIS_WEIGHTS))
    col = v[:, axis]
    levels, at = np.unique(col, return_inverse=True)           # ascending
    per_level = np.bincount(at, weights=weights[m], minlength=levels.size)
    running = np.cumsum(per_level[::-1])                       # from the top
    cut = int(np.argmax(running * 2 > box.count))              # levels from the top
    split_level = levels[::-1][cut]
    if split_level == levels[0]:                               # nothing left below
        split_level = levels[1]
    go_left = col >= split_level
    lw = int(weights[m[go_left]].sum())
    box.left = _Box(m[go_left], lw)
    box.right = _Box(m[~go_left], box.count - lw)
    return True


def _median_cut(vals: np.ndarray, weights: np.ndarray, n_pixels: int) -> List[np.ndarray]:
    """The leaves' bucket indices, in palette order."""
    root = _Box(np.arange(len(vals)), n_pixels)
    heap = _Heap()
    heap.add(root)
    for _ in range(MAX_COLORS - 1):
        box = heap.remove()
        while box is not None and not _split(box, vals, weights):
            box = heap.remove()                # a one-colour box leaves the heap
        if box is None:
            break
        heap.add(box.left)
        heap.add(box.right)
    leaves, stack = [], [root]
    while stack:
        box = stack.pop()
        if box.left is None:
            leaves.append(box.members)
        else:
            stack += [box.right, box.left]
    return leaves


def _nearest(rgb: np.ndarray, own: np.ndarray, palette: np.ndarray) -> np.ndarray:
    """Pillow's nearest entry for each colour ``rgb`` (m, 3) whose box is
    ``own`` (m,). Pillow scans box ``b``'s entries in the order of their
    distance to entry ``b`` (then index), from ``b`` itself, while that
    distance is at most 4 d0 (d0: the colour's distance to entry ``b``; no
    entry further out can be nearer, by the triangle inequality), and keeps
    the first strictly nearer one: the first least distance in that order,
    which is ``argmin`` over the order. Colours are taken box by box, in
    groups of about the same number of such candidates."""
    rgb = rgb.astype(np.int32)
    pal = palette.astype(np.int32)
    k = len(pal)
    pal_d = ((pal[:, None, :] - pal[None, :, :]) ** 2).sum(-1)
    scan = np.lexsort((np.broadcast_to(np.arange(k), pal_d.shape), pal_d), axis=1)
    scan_d = np.take_along_axis(pal_d, scan, axis=1)
    d0 = ((rgb - pal[own]) ** 2).sum(-1)
    # rows of scan_d offset apart, so that one search serves every box
    rows = (np.arange(k)[:, None] << 20) + scan_d
    n_cand = np.searchsorted(rows.ravel(), (own << 20) + 4 * d0, side="right") - own * k
    # |p|^2 - 2 x.p as one product: the distance less |x|^2, the same for
    # every entry. Each term and partial sum is an integer below 2**24 in
    # magnitude, so float32 holds it exactly and the ties are the true ties.
    x_aug = np.concatenate([rgb, np.ones((len(rgb), 1), np.int32)], axis=1).astype(np.float32)
    p_aug = np.concatenate([-2 * pal, (pal ** 2).sum(1, keepdims=True)], axis=1).T
    p_aug = p_aug.astype(np.float32)
    order = np.lexsort((n_cand, own))
    starts = np.searchsorted(own[order], np.arange(k + 1))
    out = np.empty(len(rgb), dtype=np.int64)
    for b in range(k):
        lo, hi = starts[b], starts[b + 1]
        while lo < hi:
            # candidates the group's colours need: at most twice its first's
            first = n_cand[order[lo]]
            end = min(hi, lo + MAP_CHUNK,
                      lo + int(np.searchsorted(n_cand[order[lo:hi]], 2 * first, side="right")))
            idx = order[lo:end]
            cand = scan[b, :int(n_cand[order[end - 1]])]
            out[idx] = cand[np.argmin(x_aug[idx] @ p_aug[:, cand], axis=1)]
            lo = end
    return out


def adaptive_palette(rgb: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """``(h, w, 3)`` uint8 -> ``(palette (k, 3) uint8, indices (h, w) uint8)``,
    k <= 256: Pillow's ``Image.fromarray(rgb).convert("P",
    palette=Image.Palette.ADAPTIVE)``, the same entries in the same order and
    the same index at every pixel."""
    arr = np.asarray(rgb)
    if arr.ndim != 3 or arr.shape[2] != 3 or arr.dtype != np.uint8 or arr.size == 0:
        raise ValueError(f"expected a non-empty (h, w, 3) uint8 array, got "
                         f"{arr.dtype} {arr.shape}")
    h, w = arr.shape[:2]
    flat = arr.reshape(-1, 3).astype(np.int64)
    colors, inverse, counts, bvals, of_color = _histogram(
        (flat[:, 0] << 16) | (flat[:, 1] << 8) | flat[:, 2])
    bucket_pixels = np.bincount(of_color, weights=counts).astype(np.int64)
    leaves = _median_cut(bvals, bucket_pixels, h * w)
    box_of_bucket = np.empty(len(bvals), dtype=np.int64)
    for i, members in enumerate(leaves):
        box_of_bucket[members] = i
    own = box_of_bucket[of_color]
    n_box = np.bincount(own, weights=counts, minlength=len(leaves))
    sums = np.stack([np.bincount(own, weights=counts * colors_c, minlength=len(leaves))
                     for colors_c in colors.T], axis=1)
    palette = np.floor(0.5 + sums / n_box[:, None]).astype(np.uint8)
    index_of_color = _nearest(colors, own, palette)
    return palette, index_of_color[inverse].reshape(h, w).astype(np.uint8)
