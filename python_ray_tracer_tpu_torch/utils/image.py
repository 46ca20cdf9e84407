"""Framebuffer -> PNG or GIF, in the reference's output orientation.

The reference viewer (viewer/image.py:7-19) transposes the uint8 ``(3, w, h)``
framebuffer to ``(w, h, 3)`` and applies ``ImageOps.mirror(im.rotate(270))``;
the net transform is a pure transpose to ``(h, w, 3)``.
"""
from __future__ import annotations

import struct
import zlib
from typing import Tuple

import numpy as np
import torch

from .quantize import adaptive_palette


def framebuffer_to_array(fb) -> np.ndarray:
    """uint8 ``(3, w, h)`` framebuffer (numpy or tensor) -> display-oriented
    ``(h, w, 3)`` numpy array."""
    if isinstance(fb, torch.Tensor):
        fb = fb.detach().cpu().numpy()
    return np.transpose(np.moveaxis(np.asarray(fb), 0, -1), (1, 0, 2))


def encode_png(img: np.ndarray, *, level: int = 6) -> bytes:
    """Encode an ``(h, w, 3)`` uint8 RGB array as PNG bytes with the standard
    library: signature, IHDR, one IDAT (scanline filter 0), IEND."""
    arr = np.ascontiguousarray(img, dtype=np.uint8)
    if arr.ndim != 3 or arr.shape[2] != 3:
        raise ValueError(f"expected (h, w, 3) RGB8 array, got {arr.shape}")
    h, w = arr.shape[:2]
    raw = np.concatenate([np.zeros((h, 1), np.uint8), arr.reshape(h, 3 * w)], axis=1)

    def chunk(kind: bytes, data: bytes) -> bytes:
        return (struct.pack(">I", len(data)) + kind + data +
                struct.pack(">I", zlib.crc32(kind + data) & 0xFFFFFFFF))
    ihdr = struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0)   # 8-bit truecolor RGB
    return (b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", ihdr) +
            chunk(b"IDAT", zlib.compress(raw.tobytes(), level)) + chunk(b"IEND", b""))


def _lzw_literal_codes(idx: np.ndarray) -> bytes:
    """GIF image data of 8-bit palette indices: LZW with a code size of 8,
    written as literals only, a clear code before every 254 of them, so that
    every code stays 9 bits wide (a decoder's table grows to 511 entries and
    is cleared before it needs a tenth bit). Valid GIF, ~9/8 of the raw
    size."""
    n = idx.size
    chunks = [np.concatenate([[256], c]) for c in np.array_split(
        idx.astype(np.int64), max(1, -(-n // 254)))]
    codes = np.concatenate(chunks + [np.array([257])])
    bits = ((codes[:, None] >> np.arange(9)) & 1).astype(np.uint8).reshape(-1)
    data = np.packbits(bits, bitorder="little").tobytes()
    blocks = b"".join(bytes([len(data[i:i + 255])]) + data[i:i + 255]
                      for i in range(0, len(data), 255))
    return bytes([8]) + blocks + b"\x00"


def _color_table(palette: np.ndarray) -> Tuple[int, bytes]:
    """A GIF colour table of ``palette`` (k, 3): its size field ``n`` (2 ** (n
    + 1) entries, at least 4, as Pillow writes them) and its bytes, black
    padded."""
    n = max(1, (len(palette) - 1).bit_length() - 1)
    table = np.zeros((2 << n, 3), np.uint8)
    table[:len(palette)] = palette
    return n, table.tobytes()


def encode_gif(frames: np.ndarray, *, duration: int = 80) -> bytes:
    """Encode ``(n, h, w, 3)`` uint8 RGB frames as an animated GIF89a that
    loops forever, as Pillow's ``save(save_all=True, duration=duration,
    loop=0)`` writes them, with numpy and the standard library:

    * each frame gets its own adaptive palette
      (``utils.quantize.adaptive_palette``, Pillow's median cut). The first
      frame's is the global colour table; a later frame carries its own as a
      local table unless the two are equal;
    * a frame whose quantised pixels equal the previous written frame's is
      merged into it, which gains its ``duration`` milliseconds;
    * each frame waits ``duration * merged // 10`` hundredths of a second (no
      graphic control block where that is 0).

    The image data is literal-code LZW (:func:`_lzw_literal_codes`)."""
    arr = np.asarray(frames, dtype=np.uint8)
    if arr.ndim != 4 or arr.shape[3] != 3 or arr.shape[0] < 1:
        raise ValueError(f"expected (n, h, w, 3) RGB8 frames, got {arr.shape}")
    h, w = arr.shape[1:3]
    kept = []                     # [palette, indices, frames merged]
    for frame in arr:
        palette, idx = adaptive_palette(frame)
        if kept and np.array_equal(palette[idx], kept[-1][0][kept[-1][1]]):
            kept[-1][2] += 1
        else:
            kept.append([palette, idx, 1])
    size, global_table = _color_table(kept[0][0])
    out = [b"GIF89a", struct.pack("<HHBBB", w, h, 0x80 | size, 0, 0), global_table,
           b"\x21\xff\x0bNETSCAPE2.0\x03\x01\x00\x00\x00"]
    for palette, idx, merged in kept:
        delay = duration * merged // 10
        if delay:
            out.append(b"\x21\xf9\x04\x00" + struct.pack("<H", delay) + b"\x00\x00")
        size, table = _color_table(palette)
        local = table != global_table
        out += [b"\x2c" + struct.pack("<HHHHB", 0, 0, w, h, (0x80 | size) if local else 0),
                table if local else b"", _lzw_literal_codes(idx.reshape(-1))]
    return b"".join(out) + b"\x3b"


def save_png(fb, path: str) -> None:
    """Save a uint8 ``(3, w, h)`` framebuffer as a PNG (reference main.py:51-53).

    Encodes with the native C++ encoder (``native/png_writer.cpp``) when it
    builds here, else with :func:`encode_png`; both are pinned pixel-exact
    against PIL in the tests."""
    arr = framebuffer_to_array(fb).astype(np.uint8)
    from . import native

    if native.available():
        native.write_png(path, arr)
        return
    with open(path, "wb") as f:
        f.write(encode_png(arr))
