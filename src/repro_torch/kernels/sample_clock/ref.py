"""Plain PyTorch version of the sample clock.

Chunk ``k``'s sample times ``t_i = u0 + (k·c + i)·T + u_i`` on an
integer-nanosecond clock, with ``u_i ~ U(0, jitter)`` drawn by
:func:`repro_torch.core.threefry.uniform` (JAX's threefry2x32 bits in
int64 torch operations). Every product and sum is its own torch
operation, and the two fused multiply-adds the reference's XLA build puts
in the clock are emulated exactly (:func:`_fma`), so the times are JAX's
bit for bit on any device. This is the arithmetic the CUDA kernel
(``sample_clock.cu``) must reproduce: the CPU path of
:mod:`repro_torch.kernels.sample_clock.ops` runs it, the tests hold it to
JAX, and ``chip_smoke.py`` holds the kernel to it.
"""

from __future__ import annotations

import math

import torch

from repro_torch.core import threefry

__all__ = ["sample_clock_ref"]

_VELTKAMP = 134217729.0      # 2^27 + 1: splits a float64 into 26+27 bits


def _split(x):
    t = x * _VELTKAMP
    hi = t - (t - x)
    return hi, x - hi


def _fma(a: torch.Tensor, b: float, c: float) -> torch.Tensor:
    """``a·b + c`` rounded once, from plain float64 operations only.

    The reference's XLA CPU build contracts ``u0 + i·T`` and
    ``t·1e9 + 0.5`` into fused multiply-adds, so the clock needs one
    rounding in each, not two (at large sample indices the two differ in
    a sizeable share of the nanosecond-quantized times); torch
    promises no FMA on every device, so it is built from separate
    roundings, each its own torch operation (bit-identical on the CPU and
    the GPU): the exact product ``p + e`` (Dekker), the exact sum
    ``p + c = s + r`` (Knuth), and the tail ``r + e`` rounded to odd, so
    that the final ``s + tail`` rounds exactly as one FMA would.
    """
    p = a * b
    ah, al = _split(a)
    bh, bl = _split(b)
    e = al * bl - (((p - ah * bh) - al * bh) - ah * bl)
    s = p + c
    z = s - p
    r = (p - (s - z)) + (c - z)
    v = r + e
    z = v - r
    w = (r - (v - z)) + (e - z)
    even = (v.view(torch.int64) & 1) == 0
    toward = torch.where(w > 0, math.inf, -math.inf).to(v.dtype)
    v = torch.where((w != 0) & even, torch.nextafter(v, toward), v)
    return s + v


def sample_clock_ref(root: tuple[int, int], k: int, c: int, period: float,
                     u0: float, jitter: float, t_end: float | None = None, *,
                     device):
    """Chunk ``k``'s sample times: pure function of (key, k), [c] float64;
    with ``t_end``, ``(t clamped to t_end, t < t_end)``.

    ``t_i = u0 + i·T + u_i`` on an integer-nanosecond clock, ``u_i`` drawn
    under ``fold_in(root, k + 1)``. ``k·c`` is a Python int, so sample
    indices past 2^31 do not wrap. ``u0 + i·T`` and the quantization's
    ``t·1e9 + 0.5`` are each one fused multiply-add (:func:`_fma`), as
    XLA compiles the reference on the CPU; every other step is one
    rounding, as there.
    """
    u = threefry.uniform(threefry.fold_in(root, k + 1), c, 0.0, jitter,
                         device=device)
    i = torch.arange(c, dtype=torch.int64, device=device) + k * c
    t = _fma(i.to(torch.float64), period, u0) + u
    t_raw = torch.floor(_fma(t, 1e9, 0.5)) * 1e-9
    if t_end is None:
        return t_raw
    valid = t_raw < t_end
    return torch.clamp_max(t_raw, t_end), valid
