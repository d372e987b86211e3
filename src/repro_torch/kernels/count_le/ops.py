"""Public wrapper of the interval-lookup kernel.

:func:`count_le` is the one place the CUDA kernel (``count_le.cu``) is
launched: on a CUDA device the grid route launches the kernel or raises;
on the CPU it runs the plain PyTorch version (:mod:`.ref`, the grid
route's torch operations). A timeline without a bounded grid window
(``k_max = 0``) takes ``torch.searchsorted`` on either device. All give
``searchsorted(side="right")``'s counts.
``count_le.launches`` counts the kernel's launches, so a run can show
that its path went through the kernel.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels.count_le.ref import count_le_ref

__all__ = ["count_le"]

# count_le's C signature (count_le.cu): ends, grid, cell, t, out; W, M, G, n,
# k_max; stream, device.
_P, _I64 = ctypes.c_void_p, ctypes.c_int64
_ARGTYPES = (_P,) * 5 + (_I64,) * 5 + (_P, ctypes.c_int)


class _Lib:
    """The built library with its C signatures declared, read once at
    load."""

    def __init__(self, lib):
        lib.count_le.argtypes = list(_ARGTYPES)
        lib.count_le.restype = ctypes.c_int
        lib.count_le_error_string.argtypes = [ctypes.c_int]
        lib.count_le_error_string.restype = ctypes.c_char_p
        self.count_le = lib.count_le
        self.error_string = lib.count_le_error_string


@functools.cache
def _kernel() -> _Lib:
    """The built kernel library (built and loaded on first use, never at
    import)."""
    from repro_torch.kernels import _build
    return _Lib(_build.load("count_le"))


def _check(ends, grid, cell, t, k_max: int):
    """Refuse what the kernel does not take: its dtypes, one device,
    contiguous rows and matching shapes."""
    want = ((ends, torch.float64, 2), (grid, torch.int32, 2),
            (cell, torch.float64, 1), (t, torch.float64, 1))
    for name, (a, dtype, ndim) in zip(("ends", "grid", "cell", "t"), want):
        if a.dtype != dtype or a.ndim != ndim or a.device != t.device:
            raise ValueError(f"count_le: {name} must be {ndim}-D {dtype} on "
                             f"{t.device}; got {a.ndim}-D {a.dtype} on "
                             f"{a.device}")
        if not a.is_contiguous():
            raise ValueError(f"count_le: {name} must be contiguous")
    W, M = ends.shape
    if grid.shape[0] != W or cell.shape[0] != W or M < 1 \
            or grid.shape[1] < 2:
        raise ValueError(f"count_le: ends {tuple(ends.shape)}, grid "
                         f"{tuple(grid.shape)} and cell {tuple(cell.shape)} "
                         f"do not describe one set of workers")
    if k_max < 1:
        raise ValueError(f"count_le: k_max must be >= 1; got {k_max}")


def count_le(ends, grid, cell, t, k_max: int):
    """``#(ends ≤ t)`` per worker and sample, [W, n] int64, through the
    grid accelerator: ``ends`` [W, M] float64, ``grid`` [W, G+2] int32 and
    ``cell`` [W] float64 of every worker against the times ``t`` [n]
    float64 they share, at most ``k_max`` ≥ 1 ends a grid cell. On a CUDA
    device one kernel launch on the current stream (no synchronisation)
    or a raise; on the CPU :func:`~.ref.count_le_ref`. Both give the same
    counts. ``k_max = 0`` (no bounded window) is the binary search of
    :func:`~.ref.count_le_ref` on either device, with no launch."""
    dev = t.device
    if dev.type == "cpu" or k_max == 0:
        return count_le_ref(ends, grid, cell, t, k_max)
    if dev.type != "cuda":
        raise ValueError(f"count_le: unsupported device {dev}")
    _check(ends, grid, cell, t, k_max)
    W, M = ends.shape
    n = t.shape[0]
    out = torch.empty((W, n), dtype=torch.int64, device=dev)
    if n:
        lib = _kernel()
        index = dev.index if dev.index is not None \
            else torch.cuda.current_device()
        err = lib.count_le(ends.data_ptr(), grid.data_ptr(), cell.data_ptr(),
                           t.data_ptr(), out.data_ptr(), W, M,
                           grid.shape[1] - 2, n, int(k_max),
                           torch.cuda.current_stream(dev).cuda_stream, index)
        if err != 0:
            raise RuntimeError("count_le kernel launch failed: "
                               + lib.error_string(err).decode())
        count_le.launches += 1
    return out


count_le.launches = 0
