"""The port's GIF writer against the JAX package's, on the CPU.

The JAX package's ``save_animation`` writes its GIF with Pillow. The port's
writes it with ``utils.quantize.adaptive_palette`` (Pillow's adaptive median
cut, in numpy), ``utils.image.encode_gif`` (Pillow's frame pipeline, in numpy)
and the compiled LZW of ``utils.native.gif_lzw``. Each case gives both the
same float frames, decodes both files with Pillow (``seek(k)``,
``convert("RGB")``), asserts the same frame count, the same
``info["duration"]`` on every frame and ``np.array_equal`` frames, and then
the same bytes. Pillow is also the oracle of ``adaptive_palette`` itself: the
same entries in the same order, and the same index at every pixel.
"""
import ast
import os
import struct
import subprocess
import sys

import numpy as np
import pytest
import torch
from PIL import Image

import python_ray_tracer_tpu_torch as trt
from python_ray_tracer_tpu_torch import animation
from python_ray_tracer_tpu_torch.utils.quantize import MAX_HASH_ENTRIES, adaptive_palette

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT = os.path.join(ROOT, "python_ray_tracer_tpu_torch")


def _decode(path):
    im = Image.open(path)
    frames, durations = [], []
    for k in range(im.n_frames):
        im.seek(k)
        frames.append(np.asarray(im.convert("RGB")))
        durations.append(im.info.get("duration"))
    return frames, durations


def _assert_same_gif(frames, tmp_path, fps=12):
    """``frames``: float ``(n, w, h, 3)`` numpy. Both packages' GIFs decode to
    the same frames with the same durations, and are the same bytes; returns
    the decoded count."""
    from python_ray_tracer_tpu import animation as janim
    jpath, tpath = str(tmp_path / "jax.gif"), str(tmp_path / "port.gif")
    janim.save_animation(frames, jpath, fps=fps)
    animation.save_animation(torch.from_numpy(np.ascontiguousarray(frames)), tpath, fps=fps)
    want, want_ms = _decode(jpath)
    got, got_ms = _decode(tpath)
    assert len(got) == len(want)
    assert got_ms == want_ms
    for k, (g, w) in enumerate(zip(got, want)):
        assert np.array_equal(g, w), (k, int((g != w).any(-1).sum()))
    data, want_data = (tmp_path / "port.gif").read_bytes(), (tmp_path / "jax.gif").read_bytes()
    assert len(data) == len(want_data) and data == want_data, _first_difference(data,
                                                                                want_data)
    return len(got)


def _images(data):
    """The images of a GIF file, in order: ``(x, y, w, h, flags, local table
    entries or 0, transparent index or None, delay)``, found by walking its
    blocks."""
    pos = 13 + (3 * (2 << (data[10] & 7)) if data[10] & 0x80 else 0)
    images, control = [], (None, None)
    while data[pos] != 0x3B:
        if data[pos] == 0x21:
            if data[pos + 1] == 0xF9:
                packed, delay, t = data[pos + 3], data[pos + 4] | data[pos + 5] << 8, data[pos + 6]
                control = (t if packed & 1 else None, delay)
            pos += 2
        else:
            x, y, w, h, flags = struct.unpack("<HHHHB", data[pos + 1:pos + 10])
            entries = 2 << (flags & 7) if flags & 0x80 else 0
            images.append((x, y, w, h, flags, entries, *control))
            control = (None, None)
            pos += 10 + 3 * entries + 1
        while data[pos]:
            pos += data[pos] + 1
        pos += 1
    return images


def _first_difference(data, want):
    k = next((i for i, (a, b) in enumerate(zip(data, want)) if a != b), min(len(data),
                                                                           len(want)))
    return (f"{len(data)} B against {len(want)} B, first difference at byte {k}; images "
            f"{_images(data)} against {_images(want)}")


def _float_frames(u8):
    """Display-oriented uint8 ``(n, h, w, 3)`` -> float ``(n, w, h, 3)`` frames
    whose ``to_framebuffer`` gives back ``u8``."""
    return np.transpose(u8, (0, 2, 1, 3)).astype(np.float32) / 255.0


def _pillow_palette(rgb):
    im = Image.fromarray(rgb, "RGB").convert("P", palette=Image.Palette.ADAPTIVE)
    return np.asarray(im.getpalette("RGB"), np.uint8).reshape(-1, 3), np.asarray(im)


def _colours(n_colours, shape, seed):
    rng = np.random.default_rng(seed)
    table = rng.integers(0, 256, (n_colours, 3), dtype=np.uint8)
    return table[rng.integers(0, n_colours, shape)]


def _many_colours(side, seed):
    """A ``side`` x ``side`` frame of distinct colours (more than the pixel
    hash holds at full precision when side * side > 65536)."""
    keys = np.random.default_rng(seed).choice(1 << 24, side * side, replace=False)
    return np.stack([keys >> 16, (keys >> 8) & 255, keys & 255],
                    axis=-1).reshape(side, side, 3).astype(np.uint8)


@pytest.mark.parametrize("res", [(48, 48), (96, 64), (128, 128)])
def test_gif_of_the_demo_orbit_equals_jax(res, tmp_path):
    """The demo scene's orbit as ``cli animate`` renders it, from the port's
    plain renderer at depth 2 with AA, 3 frames: delta frames cropped to
    the changed box, palettes compacted below 512 x 512."""
    cams = animation.orbit_cameras(res, center=[1.0, 0.0, 1.0], radius=4.0, height=1.5,
                                   n_frames=3, device="cpu")
    frames = animation.render_frames(cams, trt.default_scene(device="cpu"), depth=2,
                                     aliasing=True, backend="torch")
    assert _assert_same_gif(frames.numpy(), tmp_path) == 3


@pytest.mark.parametrize("case", ["256_colours", "4000_colours", "over_65536_colours"])
def test_gif_of_numpy_frames_equals_jax(case, tmp_path):
    if case == "256_colours":
        u8 = np.stack([_colours(256, (40, 56), seed) for seed in range(3)])
    elif case == "4000_colours":
        u8 = np.stack([_colours(4000, (80, 72), seed) for seed in range(2)])
    else:
        u8 = _many_colours(300, 3)[None]
        assert len(np.unique(u8.reshape(-1, 3), axis=0)) > MAX_HASH_ENTRIES
    assert _assert_same_gif(_float_frames(u8), tmp_path) == len(u8)


def test_gif_merges_identical_frames_as_jax(tmp_path):
    """Two identical frames between two distinct ones: the second is merged
    into the first, which gains its delay (fps 6: 160 ms, then 330)."""
    a, b, c = (_colours(4000, (30, 40), seed) for seed in (10, 11, 12))
    assert _assert_same_gif(_float_frames(np.stack([a, b, b, c])), tmp_path, fps=6) == 3
    assert _decode(str(tmp_path / "port.gif"))[1] == [160, 330, 160]


def test_gif_merges_frames_whose_quantised_pixels_agree(tmp_path):
    """Two uint8 frames that differ in one low bit of one pixel, past the
    pixel hash's full precision: both quantise to the same pixels, and both
    writers merge them."""
    a = _many_colours(300, 4)
    b = a.copy()
    b[5, 5, 0] ^= 1
    pa, ia = adaptive_palette(a)
    pb, ib = adaptive_palette(b)
    assert not np.array_equal(a, b) and np.array_equal(pa[ia], pb[ib])
    assert _assert_same_gif(_float_frames(np.stack([a, b])), tmp_path) == 1


def _branch_frames(case):
    """Display-oriented uint8 frames that take one branch of Pillow's GIF
    writer each, and the images the file must hold for it."""
    if case == "noise_600x520":                  # no compaction; every index used
        rng = np.random.default_rng(20)
        return rng.integers(0, 256, (2, 520, 600, 3), dtype=np.uint8)
    if case == "moving_patch":                   # static background, a cropped box a frame
        bg = _colours(200, (90, 120), 21)
        frames = np.stack([bg] * 4)
        for k in range(4):
            frames[k, 10 + 5 * k:30 + 5 * k, 20 + 7 * k:50 + 7 * k] = (255, 0, 0)
        return frames
    if case == "same_palette":                   # equal palettes: indices compared
        a = _colours(100, (40, 50), 22)
        b = a.copy()
        b[3, 4], b[20, 30] = a[20, 30], a[3, 4]
        return np.stack([a, b])
    if case == "power_of_two_palette":           # 128 entries: index 128 is past the table
        table = np.random.default_rng(23).integers(0, 256, (128, 3), dtype=np.uint8)
        rng = np.random.default_rng(24)
        return np.stack([table[rng.permutation(np.arange(64 * 128) % 128).reshape(64, 128)]
                         for _ in range(2)])
    if case in ("full_palette_with_holes", "holes_below_512x512"):
        # noise whose 256 entries leave 182, 245 and 254 unused: at 600x600 the
        # palette stays whole and the highest unused index is the transparent
        # one; at 320x320 it is compacted to 253 entries
        reps = 15 if case == "full_palette_with_holes" else 8
        tiles = [np.random.default_rng(s).integers(0, 256, (40, 40, 3), dtype=np.uint8)
                 for s in (1009, 1008)]
        return np.stack([np.repeat(np.repeat(t, reps, axis=0), reps, axis=1) for t in tiles])
    if case == "repeated_then_back":
        a, b = _colours(4000, (30, 40), 25), _colours(4000, (30, 40), 26)
        return np.stack([a, b, b, a])
    if case == "identical_32x32":                # one image, interlaced
        return np.stack([_colours(50, (32, 32), 27)] * 3)
    if case == "identical_40x12":                # one image, too small to interlace
        return np.stack([_colours(50, (12, 40), 28)] * 3)
    assert case == "one_frame_64x48"
    return _colours(4000, (48, 64), 29)[None]


@pytest.mark.parametrize("case", ["noise_600x520", "moving_patch", "same_palette",
                                  "power_of_two_palette", "full_palette_with_holes",
                                  "holes_below_512x512",
                                  "repeated_then_back", "identical_32x32", "identical_40x12",
                                  "one_frame_64x48"])
def test_gif_bytes_of_every_branch_equal_jax(case, tmp_path):
    """The port's file is the JAX package's, byte for byte, on frames that
    take each branch of Pillow's writer; the images it holds show that the
    branch was taken."""
    u8 = _branch_frames(case)
    _assert_same_gif(_float_frames(u8), tmp_path)
    images = _images((tmp_path / "port.gif").read_bytes())
    h, w = u8.shape[1:3]
    later = images[1:]
    if case == "noise_600x520":
        assert [im[5:7] for im in later] == [(256, None)]
    elif case == "moving_patch":
        assert len(later) == 3 and all(0 < im[0] and 0 < im[1] and im[2] < w and im[3] < h
                                       and im[6] is not None for im in later)
    elif case == "same_palette":
        assert [im[:4] for im in later] == [(4, 3, 27, 18)]
    elif case == "power_of_two_palette":
        assert [im[5:7] for im in later] == [(128, 128)]
    elif case == "full_palette_with_holes":
        assert [im[5:7] for im in later] == [(256, 254)]
    elif case == "holes_below_512x512":
        assert [im[5:7] for im in later] == [(256, 253)]
    elif case == "repeated_then_back":
        assert [im[7] for im in images] == [8, 16, 8]
    else:
        interlace = min(w, h) >= 16
        assert images == [(0, 0, w, h, 0x40 if interlace else 0, 0, None,
                           int(1000 / 12) * len(u8) // 10)]


@pytest.mark.parametrize("fps", [6, 7, 12, 30, 40])
def test_gif_delays_equal_jax(fps, tmp_path):
    u8 = np.stack([_colours(300, (24, 20), fps + k) for k in range(3)])
    assert _assert_same_gif(_float_frames(u8), tmp_path, fps=fps) == 3
    assert _decode(str(tmp_path / "port.gif"))[1] == [int(1000 / fps) // 10 * 10] * 3


@pytest.mark.parametrize("case", ["random", "gradient", "few_levels", "equal_counts",
                                  "65536_colours", "over_65536_colours", "one_colour"])
def test_adaptive_palette_equals_pillow(case):
    rng = np.random.default_rng(7)
    if case == "random":
        rgb = rng.integers(0, 256, (50, 70, 3), dtype=np.uint8)
    elif case == "gradient":
        x = np.linspace(0, 255, 120)
        yy, xx = np.meshgrid(x, x[::-1], indexing="ij")
        rgb = np.stack([yy, xx, (yy + xx) / 2], axis=-1).astype(np.uint8)
    elif case == "few_levels":
        rgb = (rng.integers(0, 12, (90, 90, 3)) * 23).astype(np.uint8)
    elif case == "equal_counts":
        rgb = np.repeat(rng.integers(0, 256, (600, 3), dtype=np.uint8), 4,
                        axis=0).reshape(60, 40, 3)
    elif case == "65536_colours":           # the most the full-precision hash holds
        rgb = _many_colours(256, 6)
    elif case == "over_65536_colours":
        rgb = _many_colours(260, 5)
    else:
        rgb = np.full((3, 5, 3), 77, np.uint8)
    want_palette, want_idx = _pillow_palette(rgb)
    palette, idx = adaptive_palette(rgb)
    assert idx.dtype == np.uint8 and idx.shape == rgb.shape[:2]
    assert np.array_equal(palette, want_palette)
    assert np.array_equal(idx, want_idx)


@pytest.mark.parametrize("n_colours", [1, 2, 37, 256])
def test_adaptive_palette_is_exact_for_at_most_256_colours(n_colours):
    rgb = _colours(n_colours, (33, 31), n_colours)
    palette, idx = adaptive_palette(rgb)
    assert len(palette) == len(np.unique(rgb.reshape(-1, 3), axis=0))
    assert np.array_equal(palette[idx], rgb)


def test_no_module_of_the_port_imports_pillow():
    """Every module of the port imports without PIL reaching ``sys.modules``,
    and no module of the port, nor ``chip_smoke.py``, names PIL in an import."""
    code = ("import pkgutil, importlib, sys\n"
            "import python_ray_tracer_tpu_torch as p\n"
            "names = [m.name for m in pkgutil.walk_packages(p.__path__, p.__name__ + '.')]\n"
            "for n in names: importlib.import_module(n)\n"
            "print(len(names), 'PIL' in sys.modules)\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                         text=True, timeout=120, check=True).stdout.split()
    assert int(out[0]) > 20 and out[1] == "False"
    files = [os.path.join(d, f) for d, _, fs in os.walk(PORT) for f in fs if f.endswith(".py")]
    for path in files + [os.path.join(ROOT, "chip_smoke.py")]:
        for node in ast.walk(ast.parse(open(path).read())):
            names = ([a.name for a in node.names] if isinstance(node, ast.Import) else
                     [node.module or ""] if isinstance(node, ast.ImportFrom) else [])
            assert not any(n.split(".")[0] == "PIL" for n in names), path


def test_encode_gif_checks_its_input():
    from python_ray_tracer_tpu_torch.utils.image import encode_gif
    with pytest.raises(ValueError, match="RGB8 frames"):
        encode_gif(np.zeros((4, 4, 3), np.uint8))
    with pytest.raises(ValueError, match="uint8"):
        adaptive_palette(np.zeros((4, 4, 3), np.float32))
