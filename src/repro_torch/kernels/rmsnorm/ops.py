"""Public wrapper for the fused RMSNorm kernel.

:func:`rmsnorm` is the one place the CUDA kernel (``rmsnorm.cu``) is
launched: for a tensor on the GPU it launches the kernel or raises; for a
tensor on the CPU it runs the plain PyTorch version (:mod:`.ref`).
``rmsnorm.launches`` counts the kernel's launches.

The models do not call it: like the reference's, they normalise with
:func:`repro_torch.models.layers.rmsnorm` (plain PyTorch).
"""

from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels.rmsnorm.ref import rmsnorm_ref

__all__ = ["rmsnorm"]

_DTYPES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}


@functools.cache
def _kernel():
    """The built kernel library with its C signature declared (built and
    loaded on first use, never at import)."""
    from repro_torch.kernels import _build
    lib = _build.load("rmsnorm")
    p = ctypes.c_void_p
    lib.rmsnorm_fwd.argtypes = [p, p, p, ctypes.c_int64, ctypes.c_int64,
                                ctypes.c_float, ctypes.c_int, p, ctypes.c_int]
    lib.rmsnorm_fwd.restype = ctypes.c_int
    lib.rmsnorm_error_string.argtypes = [ctypes.c_int]
    lib.rmsnorm_error_string.restype = ctypes.c_char_p
    return lib


def rmsnorm(x, scale, *, eps: float = 1e-5):
    """x: [..., d]; scale: [d] → [..., d] in x's dtype (float32, bfloat16
    or float16), accumulated in float32."""
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
    err = lib.rmsnorm_fwd(x2.data_ptr(), s.data_ptr(), out.data_ptr(),
                          x2.shape[0], d, float(eps), _DTYPES[x.dtype],
                          stream, x.device.index)
    if err != 0:
        raise RuntimeError("rmsnorm kernel launch failed: "
                           + lib.rmsnorm_error_string(err).decode())
    rmsnorm.launches += 1
    return out.reshape(x.shape)


rmsnorm.launches = 0
