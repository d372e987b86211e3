"""Counter-based sample clock: JAX's threefry2x32 in torch integer ops.

The device pipeline's sample times are a pure function of ``(seed, k)``
(:func:`repro_torch.core.device_pipeline.chunk_sample_times`). They must
be the *same* times the reference draws with ``jax.random`` — same bits,
same float64 values — or per-region counts cannot be held equal to it.
This module reproduces, bit for bit:

* ``jax.random.PRNGKey(seed)`` under x64 (``threefry_seed``: the 64-bit
  seed split into two 32-bit words, high word first);
* ``jax.random.fold_in(key, data)`` (``threefry_2x32(key, [0, data])``);
* ``jax.random.uniform(key, shape, float64, lo, hi)`` under
  ``jax_threefry_partitionable=True`` (the installed default): counter
  ``i`` of a flat shape is the 64-bit pair ``(i >> 32, i & 0xFFFFFFFF)``,
  the 64 random bits are ``hi << 32 | lo`` of the two threefry outputs,
  and the float is the mantissa trick ``(bits >> 12) | bits(1.0)`` − 1.

torch's ``uint32`` support is partial, so 32-bit words live in int64
tensors masked to 32 bits after every add and shift; rotations are
written as shift/or/mask. The same functions take Python ints (the
per-chunk keys are derived on the host, so no per-chunk device work or
synchronisation is spent on them) and int64 tensors (the per-sample
counters), on the CPU and the GPU alike.
"""

from __future__ import annotations

import torch

__all__ = ["PRNGKey", "fold_in", "threefry2x32", "uniform",
           "uniform_scalar"]

_MASK = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_PARITY = 0x1BD11BDA
_ONE_BITS = 0x3FF0000000000000      # float64 1.0


def _rotl(v, r: int):
    return ((v << r) & _MASK) | (v >> (32 - r))


def threefry2x32(k1: int, k2: int, x0, x1):
    """Threefry-2x32 (20 rounds) of counter words ``(x0, x1)`` under key
    ``(k1, k2)``. Words are Python ints or int64 tensors in [0, 2^32)."""
    ks = (k1 & _MASK, k2 & _MASK, (k1 ^ k2 ^ _PARITY) & _MASK)
    x0 = (x0 + ks[0]) & _MASK
    x1 = (x1 + ks[1]) & _MASK
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0 = (x0 + x1) & _MASK
            x1 = _rotl(x1, r) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & _MASK
        x1 = (x1 + ks[(i + 2) % 3] + i + 1) & _MASK
    return x0, x1


def PRNGKey(seed: int) -> tuple[int, int]:
    """``jax.random.PRNGKey(seed)`` with a 64-bit seed (x64 mode)."""
    seed &= (1 << 64) - 1
    return (seed >> 32) & _MASK, seed & _MASK


def fold_in(key: tuple[int, int], data: int) -> tuple[int, int]:
    """``jax.random.fold_in(key, data)`` for a 32-bit ``data``."""
    return threefry2x32(key[0], key[1], 0, data & _MASK)


def _mantissa(key: tuple[int, int], hi, lo):
    """52 random mantissa bits of counter ``(hi, lo)``: the logical
    ``bits64 >> 12`` of JAX's 64-bit draw, assembled from the two words
    so that no intermediate leaves the non-negative int64 range."""
    b1, b2 = threefry2x32(key[0], key[1], hi, lo)
    return (b1 << 20) | (b2 >> 12)


def uniform(key: tuple[int, int], n: int, minval: float, maxval: float, *,
            device) -> torch.Tensor:
    """``jax.random.uniform(key, (n,), float64, minval, maxval)``."""
    i = torch.arange(n, dtype=torch.int64, device=device)
    m = _mantissa(key, i >> 32, i & _MASK)
    floats = (m | _ONE_BITS).view(torch.float64) - 1.0
    return torch.clamp_min(floats * (maxval - minval) + minval, minval)


def uniform_scalar(key: tuple[int, int], minval: float,
                   maxval: float) -> float:
    """``jax.random.uniform(key, (), float64, minval, maxval)`` on the host
    (a scalar draw uses counter 0). Python floats are IEEE doubles, so
    every step rounds exactly as the device's does."""
    m = _mantissa(key, 0, 0)
    floats = (m * 2.0 ** -52)          # exact: m < 2^52
    return max(minval, floats * (maxval - minval) + minval)
