# Frozen copy of python_ray_tracer_tpu_torch/utils/prng.py at commit
# fa8828e2546d4fbea5df42a59f967d164dc1f66a, unchanged below these lines. The benchmark draws
# the 1000-sphere scene with it, so that a later change to the port cannot move the yardstick.
"""The ``jax.random`` stream that the JAX package's ``random_scene`` draws from,
reproduced bit for bit in numpy ``uint32`` arithmetic.

The mode reproduced is JAX's default PRNG: ``threefry2x32`` (20 rounds) with
``jax_threefry_partitionable=True`` and 32-bit seeds (``jax_enable_x64``
off). In that mode

- ``key(seed)`` is the key data ``[0, seed mod 2**32]``;
- ``split(key, n)`` and ``bits(key, shape)`` hash the row-major flat index
  ``i`` of each output as the counter pair ``(i >> 32, i & 0xffffffff)``;
  a split key is the hash's two words, a 32-bit draw their XOR;
- ``uniform`` puts the draw's top 23 bits in the mantissa of a float in
  ``[1, 2)``, subtracts 1, and returns ``max(lo, u * (hi - lo) + lo)`` in
  float32, the product and sum rounded once (XLA on the CPU fuses them).

Nothing here reads global random state: every draw is a function of its key.
"""
from __future__ import annotations

import numpy as np

_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_PARITY = np.uint32(0x1BD11BDA)


def _rotl(x: np.ndarray, r: int) -> np.ndarray:
    return (x << np.uint32(r)) | (x >> np.uint32(32 - r))


def threefry2x32(key, x0: np.ndarray, x1: np.ndarray):
    """Threefry-2x32 with 20 rounds of the counters ``(x0, x1)`` under the
    ``(2,)`` uint32 ``key``: the two ``uint32`` output words."""
    k0, k1 = (np.uint32(k) for k in np.asarray(key, np.uint32))
    ks = (k0, k1, k0 ^ k1 ^ _PARITY)
    x0 = np.asarray(x0, np.uint32) + ks[0]
    x1 = np.asarray(x1, np.uint32) + ks[1]
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0 = x0 + x1
            x1 = _rotl(x1, r) ^ x0
        x0 = x0 + ks[(i + 1) % 3]
        x1 = x1 + ks[(i + 2) % 3] + np.uint32(i + 1)
    return x0, x1


def key(seed) -> np.ndarray:
    """Key data of ``jax.random.key(seed)`` for an int seed; ``(2,)`` key
    data is returned as it is (as uint32)."""
    if isinstance(seed, (int, np.integer)):
        return np.array([0, int(seed) % 2 ** 32], np.uint32)
    data = np.asarray(seed)
    if data.shape != (2,) or not np.issubdtype(data.dtype, np.integer):
        raise ValueError(f"a key is an int seed or (2,) key data, got {seed!r}")
    return data.astype(np.uint32)


def _counters(n: int):
    i = np.arange(n, dtype=np.uint64)
    return (i >> np.uint64(32)).astype(np.uint32), (i & np.uint64(0xFFFFFFFF)).astype(np.uint32)


def split(k, n: int = 2) -> np.ndarray:
    """``jax.random.split(k, n)`` as ``(n, 2)`` uint32 key data."""
    w0, w1 = threefry2x32(key(k), *_counters(n))
    return np.stack([w0, w1], axis=-1)


def bits(k, shape) -> np.ndarray:
    """``jax.random.bits(k, shape)``: uint32 draws of the given shape."""
    shape = tuple(shape) if isinstance(shape, (tuple, list)) else (int(shape),)
    w0, w1 = threefry2x32(key(k), *_counters(int(np.prod(shape, dtype=np.int64))))
    return (w0 ^ w1).reshape(shape)


def _fma_f32(a: np.ndarray, b: np.float32, c: np.float32) -> np.ndarray:
    """``a * b + c`` of float32 operands rounded once to float32.

    The product is exact in float64; the sum is made exact by a two-sum and
    rounded to odd, so the final rounding to float32 is the only one."""
    p = a.astype(np.float64) * np.float64(b)
    c = np.float64(c)
    s = p + c
    bp = s - c
    err = (p - bp) + (c - (s - bp))
    odd = s.view(np.uint64) & np.uint64(1)
    nudge = (err != 0) & (odd == 0)
    s = np.where(nudge, np.nextafter(s, np.where(err > 0, np.inf, -np.inf)), s)
    return s.astype(np.float32)


def uniform(k, shape, lo: float = 0.0, hi: float = 1.0) -> np.ndarray:
    """``jax.random.uniform(k, shape, minval=lo, maxval=hi)`` in float32."""
    lo, hi = np.float32(lo), np.float32(hi)
    u = bits(k, shape)
    f = ((u >> np.uint32(9)) | np.float32(1.0).view(np.uint32)).view(np.float32)
    f = f - np.float32(1.0)
    return np.maximum(lo, _fma_f32(f, hi - lo, lo))
