"""Framebuffer -> PNG or GIF, in the reference's output orientation.

The reference viewer (viewer/image.py:7-19) transposes the uint8 ``(3, w, h)``
framebuffer to ``(w, h, 3)`` and applies ``ImageOps.mirror(im.rotate(270))``;
the net transform is a pure transpose to ``(h, w, 3)``.
"""
from __future__ import annotations

import struct
import zlib
from typing import Optional, Tuple

import numpy as np
import torch

from .native import gif_lzw
from .quantize import adaptive_palette

def framebuffer_to_array(fb) -> np.ndarray:
    """uint8 ``(3, w, h)`` framebuffer (numpy or tensor) -> display-oriented
    ``(h, w, 3)`` numpy array."""
    if isinstance(fb, torch.Tensor):
        fb = fb.detach().cpu().numpy()
    return np.transpose(np.moveaxis(np.asarray(fb), 0, -1), (1, 0, 2))


def encode_png(img: np.ndarray, *, level: int = 6) -> bytes:
    """Encode an ``(h, w, 3)`` uint8 RGB array as PNG bytes with the standard
    library, in the layout of the JAX package's compiled PNG encoder:
    signature, IHDR, one IDAT (every scanline with filter 1, "Sub", deflated
    at ``level`` as zlib's ``compress2`` does), IEND. Where the standard
    library's zlib is the one that encoder links, the bytes are its bytes."""
    arr = np.ascontiguousarray(img, dtype=np.uint8)
    if arr.ndim != 3 or arr.shape[2] != 3:
        raise ValueError(f"expected (h, w, 3) RGB8 array, got {arr.shape}")
    h, w = arr.shape[:2]
    rows = arr.reshape(h, 3 * w)
    sub = rows.copy()
    sub[:, 3:] -= rows[:, :-3]
    raw = np.concatenate([np.ones((h, 1), np.uint8), sub], axis=1)

    def chunk(kind: bytes, data: bytes) -> bytes:
        return (struct.pack(">I", len(data)) + kind + data +
                struct.pack(">I", zlib.crc32(kind + data) & 0xFFFFFFFF))
    ihdr = struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0)   # 8-bit truecolor RGB
    return (b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", ihdr) +
            chunk(b"IDAT", zlib.compress(raw.tobytes(), level)) + chunk(b"IEND", b""))


def _color_table(palette: np.ndarray) -> Tuple[int, bytes]:
    """A GIF colour table of ``palette`` (k, 3): its size field ``n`` (2 ** (n
    + 1) entries: 4 up to 4 colours, else the next power of two) and its
    bytes, black padded (Pillow's ``_get_color_table_size`` and
    ``_get_header_palette``)."""
    n = max(1, (len(palette) - 1).bit_length() - 1)
    table = np.zeros((2 << n, 3), np.uint8)
    table[:len(palette)] = palette
    return n, table.tobytes()


def _optimized(palette: np.ndarray, idx: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """Pillow's palette compaction (``_get_optimize`` and ``remap_palette``):
    below 512 x 512 pixels, a palette whose used entries leave a hole, or fit
    a table half the size, is cut to the used entries in their order and the
    indices renumbered."""
    if idx.size >= 512 * 512:
        return palette, idx
    used = np.flatnonzero(np.bincount(idx.reshape(-1), minlength=256))
    size = 1 << (len(palette) - 1).bit_length()
    if used[-1] >= len(used) or (len(used) <= size // 2 and size > 2):
        renumber = np.zeros(256, np.uint8)
        renumber[used] = np.arange(len(used))
        return palette[used], renumber[idx]
    return palette, idx


def _transparent_index(palette: np.ndarray, idx: np.ndarray) -> Optional[int]:
    """Pillow's ``ImagePalette._new_color_index``: the index after the
    palette's last entry (no entry is added for it), or with a full palette
    the highest index the frame leaves unused; None if it uses all 256."""
    if len(palette) < 256:
        return len(palette)
    free = np.flatnonzero(np.bincount(idx.reshape(-1), minlength=256) == 0)
    return int(free[-1]) if len(free) else None


def _control(delay: int, transparent: Optional[int]) -> bytes:
    """The graphic control block Pillow writes (none when it would say
    nothing): the transparency flag and index, the delay in hundredths."""
    if transparent is None and delay == 0:
        return b""
    return (b"\x21\xf9\x04" + bytes([transparent is not None]) + struct.pack("<H", delay) +
            bytes([transparent or 0, 0]))


def encode_gif(frames: np.ndarray, *, duration: int = 80) -> bytes:
    """Encode ``(n, h, w, 3)`` uint8 RGB frames as the GIF89a that Pillow's
    ``save(save_all=True, duration=duration, loop=0)`` writes, byte for byte
    (Pillow 12.1's ``GifImagePlugin``), with numpy and the compiled LZW of
    ``utils.native.gif_lzw``:

    * each frame gets its own adaptive palette
      (``utils.quantize.adaptive_palette``, Pillow's median cut), compacted
      below 512 x 512 pixels as :func:`_optimized` says;
    * a frame that equals the last written one (its indices where the two
      palettes are equal, else its colours) is merged into it, which gains
      its ``duration`` milliseconds;
    * the first frame is whole, under the global colour table. A later frame
      is the box of the pixels that changed, with its own palette as a local
      table; unchanged pixels in the box take the transparent index of
      :func:`_transparent_index`, which its control block names;
    * each frame waits ``int(merged ms / 10)`` hundredths of a second;
    * one frame left after merging is written as a still image, interlaced
      where both sides are at least 16 pixels."""
    arr = np.asarray(frames, dtype=np.uint8)
    if arr.ndim != 4 or arr.shape[3] != 3 or arr.shape[0] < 1:
        raise ValueError(f"expected (n, h, w, 3) RGB8 frames, got {arr.shape}")
    h, w = arr.shape[1:3]
    kept = []                     # [palette, indices written, (x, y), transparent, ms]
    last = None                   # the last written frame's (palette, indices)
    for frame in arr:
        palette, idx = _optimized(*adaptive_palette(frame))
        if last is None:
            kept.append([palette, idx, (0, 0), None, duration])
        else:
            if np.array_equal(palette, last[0]):
                changed = idx != last[1]
            else:
                changed = (palette[idx] != last[0][last[1]]).any(axis=-1)
            rows, cols = np.flatnonzero(changed.any(axis=1)), np.flatnonzero(changed.any(axis=0))
            if not len(rows):
                kept[-1][4] += duration
                continue
            t = _transparent_index(palette, idx)
            data = idx if t is None else np.where(changed, idx, np.uint8(t))
            box = (slice(rows[0], rows[-1] + 1), slice(cols[0], cols[-1] + 1))
            kept.append([palette, data[box], (int(cols[0]), int(rows[0])), t, duration])
        last = (palette, idx)
    size, global_table = _color_table(kept[0][0])
    out = [b"GIF89a", struct.pack("<HHBBB", w, h, 0x80 | size, 0, 0), global_table,
           b"\x21\xff\x0bNETSCAPE2.0\x03\x01\x00\x00\x00"]
    if len(kept) == 1:
        interlace = min(w, h) >= 16
        out += [_control(kept[0][4] // 10, None),
                b"\x2c" + struct.pack("<HHHHB", 0, 0, w, h, 0x40 if interlace else 0),
                gif_lzw(kept[0][1], interlace=interlace)]
        return b"".join(out) + b"\x3b"
    for k, (palette, data, (x, y), t, ms) in enumerate(kept):
        size, table = _color_table(palette)
        flags, table = (0, b"") if k == 0 else (0x80 | size, table)
        out += [_control(ms // 10, t),
                b"\x2c" + struct.pack("<HHHHB", x, y, data.shape[1], data.shape[0], flags),
                table, gif_lzw(data)]
    return b"".join(out) + b"\x3b"


def save_png(fb, path: str) -> None:
    """Save a uint8 ``(3, w, h)`` framebuffer as a PNG (reference main.py:51-53),
    :func:`encode_png`'s bytes."""
    with open(path, "wb") as f:
        f.write(encode_png(framebuffer_to_array(fb)))
