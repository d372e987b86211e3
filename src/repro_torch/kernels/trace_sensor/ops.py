"""Public wrapper of the trace-sensor kernel.

:func:`trace_sensor` is the one place the CUDA kernel
(``trace_sensor.cu``) is launched: on a CUDA device it launches the
kernel or raises; on the CPU it runs the plain PyTorch version
(:mod:`.ref`, the torch operations of the RAPL and INA231 sensors). Both
give the same bits. ``trace_sensor.launches`` counts the kernel's
launches, so a run can show that its path went through the kernel.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels.trace_sensor.ref import trace_sensor_ref

__all__ = ["trace_sensor"]

_KINDS = {"rapl": 0, "ina231": 1}
_INT64_MIN = -2 ** 63

# trace_sensor's C signature (trace_sensor.cu): kind; t, cnt, valid, prev,
# ends, bounds, eint, powers, m_true, grid, cell, out, new_prev, scratch;
# W, D, M, G, c, k_max; param, inv_param; stream, device.
_P, _I64, _D = ctypes.c_void_p, ctypes.c_int64, ctypes.c_double
_ARGTYPES = ((ctypes.c_int,) + (_P,) * 14 + (_I64,) * 6 + (_D, _D)
             + (_P, ctypes.c_int))


class _Lib:
    """The built library with its C signatures declared, read once at
    load."""

    def __init__(self, lib):
        lib.trace_sensor.argtypes = list(_ARGTYPES)
        lib.trace_sensor.restype = ctypes.c_int
        lib.trace_sensor_error_string.argtypes = [ctypes.c_int]
        lib.trace_sensor_error_string.restype = ctypes.c_char_p
        self.trace_sensor = lib.trace_sensor
        self.error_string = lib.trace_sensor_error_string


@functools.cache
def _kernel() -> _Lib:
    """The built kernel library (built and loaded on first use, never at
    import)."""
    from repro_torch.kernels import _build
    return _Lib(_build.load("trace_sensor"))


_SCRATCH: dict[tuple, torch.Tensor] = {}


def _scratch(device, stream: int) -> torch.Tensor:
    """RAPL's two-word scratch of (device, stream): the running maximum's
    key and the finished blocks, ``{INT64_MIN, 0}`` between launches (the
    last block of each launch resets it). Kernels on one stream run in
    order, so one scratch serves every launch there."""
    key = (device, stream)
    s = _SCRATCH.get(key)
    if s is None:
        s = _SCRATCH[key] = torch.tensor([_INT64_MIN, 0], dtype=torch.int64,
                                         device=device)
    return s


def _check(kind: str, t, cnt, valid, prev, ends, bounds, eint, powers,
           m_true, grid, cell, k_max: int):
    """Refuse what the kernel does not take: another sensor, dtypes, more
    than one device, non-contiguous arrays and shapes that do not describe
    one chunk of one timeline. Returns (W, D, M, c)."""
    if kind not in _KINDS:
        raise ValueError(f"trace_sensor: unknown trace sensor kind {kind!r}")
    W, M = ends.shape if ends.ndim == 2 else (0, 0)
    D = 1 if eint.ndim == 2 else eint.shape[1]
    c = t.shape[0] if t.ndim == 1 else 0
    want = (("t", t, torch.float64, (c,)),
            ("cnt", cnt, torch.int64, (W, c)),
            ("valid", valid, torch.bool, (c,)),
            ("prev", prev, torch.float64, ()),
            ("ends", ends, torch.float64, (W, M)),
            ("bounds", bounds, torch.float64, (W, M + 1)),
            ("eint", eint, torch.float64,
             (W, M + 1) if eint.ndim == 2 else (W, D, M + 1)),
            ("powers", powers, torch.float64,
             (W, M) if eint.ndim == 2 else (W, D, M)),
            ("m_true", m_true, torch.int32, (W,)),
            ("grid", grid, torch.int32, (W, grid.shape[-1])),
            ("cell", cell, torch.float64, (W,)))
    for name, a, dtype, shape in want:
        if a.dtype != dtype or a.device != t.device:
            raise ValueError(f"trace_sensor: {name} must be {dtype} on "
                             f"{t.device}; got {a.dtype} on {a.device}")
        if tuple(a.shape) != shape:
            raise ValueError(f"trace_sensor: {name} must have shape "
                             f"{shape}; got {tuple(a.shape)}")
        if not a.is_contiguous():
            raise ValueError(f"trace_sensor: {name} must be contiguous")
    if W < 1 or M < 1 or c < 1 or grid.shape[-1] < 2 \
            or eint.ndim not in (2, 3) or D < 1:
        raise ValueError(f"trace_sensor: an empty chunk or timeline: "
                         f"W={W}, M={M}, D={D}, c={c}, grid "
                         f"{tuple(grid.shape)}")
    if k_max < 0:
        raise ValueError(f"trace_sensor: k_max must be >= 0; got {k_max}")
    return W, D, M, c


def trace_sensor(kind: str, param: float, t, cnt, valid, prev, ends,
                 bounds, eint, powers, m_true, grid, cell, k_max: int):
    """``(readings, prev)`` of one chunk of every worker and rail:
    readings [W, c] for a scalar timeline, [W, D, c] for a multi-rail one;
    RAPL's new carry as a new 0-d tensor (``prev`` is never written),
    INA231's ``prev`` as it came. The arguments are
    :func:`~.ref.trace_sensor_ref`'s. On a CUDA device one kernel launch
    on the current stream (no synchronisation) or a raise; on the CPU
    :func:`~.ref.trace_sensor_ref`. Both give the same bits."""
    dev = t.device
    if dev.type == "cpu":
        return trace_sensor_ref(kind, param, t, cnt, valid, prev, ends,
                                bounds, eint, powers, m_true, grid, cell,
                                k_max)
    if dev.type != "cuda":
        raise ValueError(f"trace_sensor: unsupported device {dev}")
    W, D, M, c = _check(kind, t, cnt, valid, prev, ends, bounds, eint,
                        powers, m_true, grid, cell, k_max)
    if dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    out = torch.empty((W, c) if eint.ndim == 2 else (W, D, c),
                      dtype=torch.float64, device=dev)
    rapl = kind == "rapl"
    new_prev = torch.empty((), dtype=torch.float64, device=dev) if rapl \
        else prev
    stream = torch.cuda.current_stream(dev).cuda_stream
    lib = _kernel()
    err = lib.trace_sensor(
        _KINDS[kind], t.data_ptr(), cnt.data_ptr(), valid.data_ptr(),
        prev.data_ptr(), ends.data_ptr(), bounds.data_ptr(), eint.data_ptr(),
        powers.data_ptr(), m_true.data_ptr(), grid.data_ptr(),
        cell.data_ptr(), out.data_ptr(),
        new_prev.data_ptr() if rapl else None,
        _scratch(dev, stream).data_ptr() if rapl else None,
        W, D, M, grid.shape[1] - 2, c, int(k_max), float(param),
        1.0 / float(param), stream, dev.index)
    if err != 0:
        raise RuntimeError("trace_sensor kernel launch failed: "
                           + lib.error_string(err).decode())
    trace_sensor.launches += 1
    return out, new_prev


trace_sensor.launches = 0
