"""Public wrapper of the sample-clock kernel.

:func:`sample_clock` is the one place the CUDA kernel
(``sample_clock.cu``) is launched: on a CUDA device it launches the
kernel or raises; on the CPU it runs the plain PyTorch version
(:mod:`.ref`, the path the tests hold bit-equal to JAX). The two routes
share no arithmetic. ``sample_clock.launches`` counts the kernel's
launches, so a run can show that its path went through the kernel.
"""

from __future__ import annotations

import ctypes
import functools
import math

import torch

from repro_torch.core import threefry
from repro_torch.kernels.sample_clock.ref import sample_clock_ref

__all__ = ["clock_args", "sample_clock"]

_INT64_MAX = 2 ** 63 - 1

# sample_clock's C signature (sample_clock.cu): k0, k1, base, c; period,
# u0, lo, span, t_end; t, valid; stream, device.
_P, _D = ctypes.c_void_p, ctypes.c_double
_ARGTYPES = ((ctypes.c_uint32, ctypes.c_uint32, ctypes.c_int64,
              ctypes.c_int64) + (_D,) * 5 + (_P, _P, _P, ctypes.c_int))


class _Lib:
    """The built library with its C signatures declared, read once at
    load."""

    def __init__(self, lib):
        lib.sample_clock.argtypes = list(_ARGTYPES)
        lib.sample_clock.restype = ctypes.c_int
        lib.sample_clock_error_string.argtypes = [ctypes.c_int]
        lib.sample_clock_error_string.restype = ctypes.c_char_p
        self.clock = lib.sample_clock
        self.error_string = lib.sample_clock_error_string


@functools.cache
def _kernel() -> _Lib:
    """The built kernel library (built and loaded on first use, never at
    import)."""
    from repro_torch.kernels import _build
    return _Lib(_build.load("sample_clock"))


def clock_args(root: tuple[int, int], k: int, c: int, period: float,
               u0: float, jitter: float, t_end: float | None = None) -> tuple:
    """The kernel's scalar arguments for chunk ``k``, in its C order: the
    chunk's key ``fold_in(root, k + 1)`` as two words, the global index
    ``k·c`` of lane 0 (an int64: past 2^31 it does not wrap), the lane
    count, then ``period``, ``u0``, the jitter draw's offset ``lo`` and
    width ``span`` (``ref``'s ``threefry.uniform(key, c, 0.0, jitter)``:
    ``0.0`` and ``jitter - 0.0``) and ``t_end`` (+inf when the stage's
    tail is not fused)."""
    k0, k1 = threefry.fold_in(root, k + 1)
    base = k * c
    if c < 0 or base < 0 or base + c > _INT64_MAX:
        raise ValueError(f"sample_clock: indices [{base}, {base} + {c}) "
                         f"outside int64")
    lo, hi = 0.0, float(jitter)
    return (k0, k1, base, c, float(period), float(u0), lo, hi - lo,
            math.inf if t_end is None else float(t_end))


def sample_clock(root: tuple[int, int], k: int, c: int, period: float,
                 u0: float, jitter: float, t_end: float | None = None, *,
                 device):
    """Chunk ``k``'s ``c`` sample times under the run's key ``root`` and
    phase ``u0``: [c] float64 on ``device``; with ``t_end``, ``(t clamped
    to t_end, t < t_end)``, the clock stage's tail in the same launch. On
    a CUDA device one kernel launch on the current stream (no
    synchronisation) or a raise; on the CPU
    :func:`~.ref.sample_clock_ref`. Both give the same bits."""
    dev = torch.device(device)
    if dev.type == "cpu":
        return sample_clock_ref(root, k, c, period, u0, jitter, t_end,
                                device=dev)
    if dev.type != "cuda":
        raise ValueError(f"sample_clock: unsupported device {dev}")
    args = clock_args(root, k, c, period, u0, jitter, t_end)
    if dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    t = torch.empty(c, dtype=torch.float64, device=dev)
    valid = None if t_end is None else torch.empty(c, dtype=torch.bool,
                                                   device=dev)
    if c:
        lib = _kernel()
        err = lib.clock(*args, t.data_ptr(),
                        None if valid is None else valid.data_ptr(),
                        torch.cuda.current_stream(dev).cuda_stream, dev.index)
        if err != 0:
            raise RuntimeError("sample_clock kernel launch failed: "
                               + lib.error_string(err).decode())
        sample_clock.launches += 1
    return t if valid is None else (t, valid)


sample_clock.launches = 0
