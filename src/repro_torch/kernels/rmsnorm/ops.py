"""Public wrapper for the fused RMSNorm kernel.

:func:`rmsnorm` is the one place the CUDA kernel (``rmsnorm.cu``) is
launched: for a tensor on the GPU it launches the kernel or raises; for a
tensor on the CPU it runs the plain PyTorch version (:mod:`.ref`).
``rmsnorm.launches`` counts the kernel's launches.

The models do not call it: like the reference's, they normalise with
:func:`repro_torch.models.layers.rmsnorm` (plain PyTorch). There is no
backward kernel, as the reference's Pallas kernel has none: the wrapper
raises when autograd would record it, on the GPU and the CPU alike.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels.rmsnorm.ref import rmsnorm_ref

__all__ = ["rmsnorm"]

_DTYPES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
_ESIZE = {torch.float32: 4, torch.bfloat16: 2, torch.float16: 2}
# rmsnorm_fwd's C signature (rmsnorm.cu): x, scale, out; n, d, eps, dtype;
# the plan (vec, lanes, rows, per_lane); stream, device.
_P, _I32, _I64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
_ARGTYPES = ((_P,) * 3 + (_I64, _I64, ctypes.c_float, _I32)
             + (_I32,) * 4 + (_P, _I32))
# Register-resident plans compiled in rmsnorm.cu: vectors per lane, at most
# 64 row elements per lane.
_PER_LANE = (1, 2, 4, 8, 16)
_LANE_ELEMS = 64


def _plan(d: int, dtype: torch.dtype, aligned: bool
          ) -> tuple[int, int, int, int]:
    """The kernel's launch plan for rows of ``d`` elements of ``dtype``:
    ``(vec, lanes_per_row, rows_per_warp, per_lane)``.

    ``vec`` elements per access: 16 bytes' worth when ``d`` is a multiple
    of it and every pointer is 16-byte ``aligned``, else 1 (the scalar
    path). ``lanes_per_row``: the power of two >= d / vec, at most 32, so
    a warp holds ``rows_per_warp`` = 32 / lanes rows. ``per_lane``: the
    vectors each lane keeps in registers, the least compiled count that
    covers the row, or 0 (looped: the row is read twice) for the scalar
    path and for rows of more than 64 elements per lane."""
    vec = 16 // _ESIZE[dtype]
    if not aligned or d % vec:
        vec = 1
    nvec = d // vec
    lanes = min(32, 1 << (nvec - 1).bit_length())
    need = -(-nvec // lanes)
    per_lane = 0
    if vec > 1:
        per_lane = next((p for p in _PER_LANE
                         if p >= need and p * vec <= _LANE_ELEMS), 0)
    return vec, lanes, 32 // lanes, per_lane


@functools.cache
def _kernel():
    """The built kernel library with its C signature declared (built and
    loaded on first use, never at import)."""
    from repro_torch.kernels import _build
    lib = _build.load("rmsnorm")
    lib.rmsnorm_fwd.argtypes = list(_ARGTYPES)
    lib.rmsnorm_fwd.restype = ctypes.c_int
    lib.rmsnorm_error_string.argtypes = [ctypes.c_int]
    lib.rmsnorm_error_string.restype = ctypes.c_char_p
    return lib


def rmsnorm(x, scale, *, eps: float = 1e-5):
    """x: [..., d]; scale: [d] → [..., d] in x's dtype (float32, bfloat16
    or float16), accumulated in float32. On a CUDA tensor this launches
    the kernel with the plan of :func:`_plan` or raises. Raises
    ``RuntimeError`` when autograd would record the call (no gradient, as
    in the reference)."""
    if torch.is_grad_enabled() and (x.requires_grad or scale.requires_grad):
        raise RuntimeError(
            "rmsnorm kernel has no gradient (nor has the reference's Pallas "
            "kernel); normalise with models.layers.rmsnorm to train, or "
            "call it under torch.no_grad()")
    if x.device.type == "cpu":
        return rmsnorm_ref(x, scale, eps=eps)
    if x.device.type != "cuda":
        raise ValueError(f"rmsnorm: unsupported device {x.device}")
    if x.dtype not in _DTYPES:
        raise TypeError(f"rmsnorm: x must be float32, bfloat16 or float16, "
                        f"got {x.dtype}")
    d = x.shape[-1]
    if scale.shape != (d,):
        raise ValueError(f"rmsnorm: scale must be ({d},), got "
                         f"{tuple(scale.shape)}")
    if scale.device != x.device:
        raise ValueError(f"rmsnorm: scale is on {scale.device}, x on "
                         f"{x.device}")
    x2 = x.reshape(-1, d).contiguous()
    s = scale.to(torch.float32).contiguous()
    out = torch.empty_like(x2)
    if out.numel() == 0:
        return out.reshape(x.shape)
    lib = _kernel()
    stream = torch.cuda.current_stream(x.device).cuda_stream
    aligned = (x2.data_ptr() | s.data_ptr() | out.data_ptr()) % 16 == 0
    err = lib.rmsnorm_fwd(x2.data_ptr(), s.data_ptr(), out.data_ptr(),
                          x2.shape[0], d, float(eps), _DTYPES[x.dtype],
                          *_plan(d, x.dtype, aligned), stream, x.device.index)
    if err != 0:
        raise RuntimeError("rmsnorm kernel launch failed: "
                           + lib.rmsnorm_error_string(err).decode())
    rmsnorm.launches += 1
    return out.reshape(x.shape)


rmsnorm.launches = 0
