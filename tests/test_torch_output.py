"""The port's output files against the JAX package's, byte for byte, on the CPU.

* The GIF image data of the port's compiled LZW (``utils.native.gif_lzw``,
  ``csrc/host/gif_lzw.cpp``) against Pillow's for the same palette indices:
  a palette image saved with ``optimize=False`` keeps its indices, so its
  first image's data is Pillow's LZW of exactly those indices. Both are
  decoded into codes (:func:`_codes`, a plain GIF decoder) before the bytes
  are compared, so that a difference is reported as the first code where the
  two policies part.
* ``save_png`` against the JAX package's ``save_png`` (its compiled
  encoder): the same file bytes, from ``encode_png`` (the standard library's
  zlib, the compiled encoder's layout), at every deflate level.
* The port's host helper is its own: no source of the port, and not
  ``chip_smoke.py``, names the repository's ``native/`` directory.
"""
import io
import os
import re

import numpy as np
import pytest
from PIL import Image

from python_ray_tracer_tpu_torch.utils import image, native

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT = os.path.join(ROOT, "python_ray_tracer_tpu_torch")


def _pillow_image_data(idx, *, interlace=False):
    """Pillow's GIF image data (minimum code size, sub-blocks, terminator) of
    the ``(h, w)`` uint8 indices ``idx``."""
    im = Image.fromarray(idx, "P")
    im.putpalette(bytes(np.repeat(np.arange(256, dtype=np.uint8), 3)))
    f = io.BytesIO()
    im.save(f, "GIF", optimize=False, interlace=interlace)
    data = f.getvalue()
    pos = 13 + 3 * (2 << (data[10] & 7))
    while data[pos] == 0x21:                     # extensions before the image
        pos += 2
        while data[pos]:
            pos += data[pos] + 1
        pos += 1
    assert data[pos] == 0x2C and not data[pos + 9] & 0x80
    start = pos = pos + 10
    pos += 1
    while data[pos]:
        pos += data[pos] + 1
    return data[start:pos + 1]


def _codes(data):
    """Decode GIF image data into its ``(code, width)`` list, checking the
    sub-block layout on the way: every block 255 bytes but the last, the bits
    after the end code zero."""
    assert data[0] == 8 and data[-1] == 0
    body, lens, pos = bytearray(), [], 1
    while data[pos]:
        lens.append(data[pos])
        body += data[pos + 1:pos + 1 + data[pos]]
        pos += data[pos] + 1
    assert pos == len(data) - 1 and all(n == 255 for n in lens[:-1])
    bits = np.unpackbits(np.frombuffer(bytes(body), np.uint8), bitorder="little")
    out, pos, width, nxt, first = [], 0, 9, 258, True
    while True:
        code = int(bits[pos:pos + width] @ (1 << np.arange(width)))
        pos += width
        out.append((code, width))
        if code == 257:
            break
        if code == 256:
            width, nxt, first = 9, 258, True
            continue
        if first:
            first = False
        elif nxt < 4096:
            nxt += 1
            if nxt == 1 << width and width < 12:
                width += 1
    assert len(bits) - pos < 8 and not bits[pos:].any()
    return out


def _indices(case):
    rng = np.random.default_rng(31)
    if case == "one_index_run":
        return np.full((200, 300), 7, np.uint8)
    if case == "noise":
        return rng.integers(0, 256, (240, 250), dtype=np.uint8)
    if case == "fills_the_table":                # a few colours: long strings, many clears
        return rng.integers(0, 4, (700, 900), dtype=np.uint8)
    if case == "interlaced":
        return (np.arange(37)[:, None] // 3 + np.arange(41)[None] // 5).astype(np.uint8)
    if case == "one_pixel":
        return np.array([[200]], np.uint8)
    assert case == "one_column"
    return rng.integers(0, 3, (50, 1), dtype=np.uint8)


@pytest.mark.parametrize("case", ["one_index_run", "noise", "fills_the_table", "interlaced",
                                  "one_pixel", "one_column"])
def test_lzw_equals_pillow(case):
    idx = _indices(case)
    interlace = case == "interlaced"
    want = _pillow_image_data(idx, interlace=interlace)
    got = native.gif_lzw(idx, interlace=interlace)
    want_codes, got_codes = _codes(want), _codes(got)
    k = next((i for i, (a, b) in enumerate(zip(got_codes, want_codes)) if a != b),
             min(len(got_codes), len(want_codes)))
    assert got_codes == want_codes, (k, got_codes[k - 2:k + 3], want_codes[k - 2:k + 3])
    assert got == want
    if case == "fills_the_table":                # the table filled, and a clear followed
        assert (256, 12) in want_codes[1:]
    if case == "one_index_run":
        assert len(want_codes) < 400            # strings that grow by one index a code


def test_lzw_checks_its_input():
    with pytest.raises(ValueError, match="uint8 indices"):
        native.gif_lzw(np.zeros((0, 4), np.uint8))
    with pytest.raises(ValueError, match="uint8 indices"):
        native.gif_lzw(np.zeros((2, 3, 4), np.uint8))


@pytest.mark.parametrize("shape", [(48, 40), (256, 256)])
def test_save_png_bytes_equal_jax(shape, tmp_path):
    """``(w, h)``: a rendered-looking frame (smooth ramps and a noisy patch)
    saved by both packages (the JAX package's through its compiled encoder):
    the same bytes."""
    from python_ray_tracer_tpu.utils import image as jimage
    from python_ray_tracer_tpu.utils import native as jnative
    assert jnative.available()
    w, h = shape
    x, y = np.meshgrid(np.arange(w), np.arange(h), indexing="ij")
    fb = np.stack([x * 255 // max(w - 1, 1), y * 255 // max(h - 1, 1),
                   (x + y) % 256]).astype(np.uint8)
    fb[:, w // 4:w // 2, h // 4:h // 2] = np.random.default_rng(w).integers(
        0, 256, (3, w // 2 - w // 4, h // 2 - h // 4), dtype=np.uint8)
    image.save_png(fb, str(tmp_path / "port.png"))
    jimage.save_png(fb, str(tmp_path / "jax.png"))
    assert (tmp_path / "port.png").read_bytes() == (tmp_path / "jax.png").read_bytes()
    assert np.array_equal(np.asarray(Image.open(tmp_path / "port.png")),
                          image.framebuffer_to_array(fb))


@pytest.mark.parametrize("level", [0, 1, 6, 9])
def test_encode_png_equals_the_jax_compiled_encoder(level):
    """``encode_png`` at every kind of deflate level (stored, fastest, the
    default, best) against the JAX package's compiled encoder on noise and on
    a smooth ramp, the same bytes; the file decodes to the pixels."""
    from python_ray_tracer_tpu.utils import native as jnative
    assert jnative.available()
    rng = np.random.default_rng(level)
    ramp = (np.arange(29 * 37 * 3) % 251).astype(np.uint8).reshape(29, 37, 3)
    for arr in (rng.integers(0, 256, (29, 37, 3), dtype=np.uint8), ramp):
        data = image.encode_png(arr, level=level)
        assert data == jnative.encode_png(arr, level=level)
        assert np.array_equal(np.asarray(Image.open(io.BytesIO(data))), arr)


def test_a_failed_gif_build_raises_with_the_compilers_output(tmp_path, monkeypatch):
    """The GIF writer has no other route: a source that does not compile
    raises with g++'s message, on the first call and on every later one."""
    (tmp_path / "gif_lzw.cpp").write_text('extern "C" int rt_gif_lzw() { return }\n')
    monkeypatch.setattr(native, "HOST_DIR", str(tmp_path))
    monkeypatch.setattr(native, "BUILD_DIR", str(tmp_path / "build"))
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "_error", None)
    for _ in range(2):
        with pytest.raises(RuntimeError, match=r"g\+\+ failed[\s\S]*gif_lzw\.cpp"):
            image.encode_gif(np.zeros((1, 4, 4, 3), np.uint8))
    assert not os.path.isdir(tmp_path / "build") or not any(
        f.endswith(".so") for f in os.listdir(tmp_path / "build"))


def test_host_helpers_build_into_the_ports_build_directory():
    so = native.build()
    assert os.path.dirname(so) == os.path.join(PORT, "build")
    assert os.path.basename(so).startswith("librt_host_gif_")
    assert native.library_path() == so


def test_no_source_of_the_port_names_the_native_directory():
    """The port builds and loads its host helpers from ``csrc/host/`` only:
    no file of the port, nor ``chip_smoke.py``, names ``native/`` (or joins
    a path with ``"native"``)."""
    pattern = re.compile(r"""(?<![\w.])native/|join\([^)]*["']native["']""")
    files = [os.path.join(d, f) for d, _, fs in os.walk(PORT) if "build" not in
             os.path.relpath(d, PORT).split(os.sep) for f in fs
             if f.endswith((".py", ".cpp", ".cu", ".cuh", ".h"))]
    assert any(f.endswith("gif_lzw.cpp") for f in files)
    for path in files + [os.path.join(ROOT, "chip_smoke.py")]:
        with open(path) as f:
            hits = [n for n, line in enumerate(f, 1) if pattern.search(line)]
        assert not hits, (path, hits)
