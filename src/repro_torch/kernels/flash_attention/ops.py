"""Public wrapper for the flash-attention kernel.

:func:`flash_attention` is the one place the CUDA kernel
(``flash_attention.cu``) is launched: for tensors on the GPU it launches
the kernel or raises; for tensors on the CPU it runs the plain PyTorch
version (:mod:`.ref`). ``flash_attention.launches`` counts the kernel's
launches, so a run can show that its path went through the kernel.

The model's attention reaches it with ``impl="flash"`` (the reference's
``impl="pallas"``), passing K/V with their own KV heads: the kernel reads
key/value head ``h // (H // KV)`` for query head ``h`` instead of taking
K/V repeated to H heads, which computes the same function.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels.flash_attention.ref import attention_ref

__all__ = ["HEAD_DIMS", "flash_attention"]

HEAD_DIMS = (32, 64, 80, 128)
_DTYPES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}


@functools.cache
def _kernel():
    """The built kernel library with its C signature declared (built and
    loaded on first use, never at import)."""
    from repro_torch.kernels import _build
    lib = _build.load("flash_attention")
    p, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
    lib.flash_attention_fwd.argtypes = (
        [p, p, p, p, i32, i32, i32, i64, i64, i32] + [i64] * 12
        + [ctypes.c_float, i32, i32, p, i32])
    lib.flash_attention_fwd.restype = ctypes.c_int
    lib.flash_attention_error_string.argtypes = [ctypes.c_int]
    lib.flash_attention_error_string.restype = ctypes.c_char_p
    return lib


def _check(q, k, v):
    if q.ndim != 4 or k.ndim != 4 or v.ndim != 4:
        raise ValueError("flash_attention: q, k and v must be [B, H, S, dh]")
    B, H, S, dh = q.shape
    if k.shape != v.shape or k.shape[0] != B or k.shape[3] != dh:
        raise ValueError(f"flash_attention: k/v {tuple(k.shape)}/"
                         f"{tuple(v.shape)} do not match q {tuple(q.shape)}")
    KV = k.shape[1]
    if KV == 0 or H % KV:
        raise ValueError(f"flash_attention: {KV} kv heads do not divide "
                         f"{H} query heads")
    if dh not in HEAD_DIMS:
        raise ValueError(f"flash_attention: head dim {dh} not supported "
                         f"(supported: {HEAD_DIMS})")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.dtype != q.dtype:
            raise TypeError(f"flash_attention: {name} is {t.dtype}, q is "
                            f"{q.dtype}")
        if t.device != q.device:
            raise ValueError(f"flash_attention: {name} is on {t.device}, q "
                             f"on {q.device}")
    if q.dtype not in _DTYPES:
        raise TypeError(f"flash_attention: dtype must be float32, bfloat16 "
                        f"or float16, got {q.dtype}")


def flash_attention(q, k, v, *, causal: bool = True):
    """q: [B, H, S, dh]; k/v: [B, KV, T, dh] with KV dividing H →
    [B, H, S, dh] in q's dtype.

    Causal masks by index (key ``col`` is seen by query ``row`` iff
    ``col <= row``). On a CUDA tensor this launches the kernel (dh in
    :data:`HEAD_DIMS`; float32, bfloat16 or float16; any S and T) or
    raises. Strided inputs are read in place as long as the last axis is
    contiguous.
    """
    if q.device.type == "cpu":
        return attention_ref(q, k, v, causal=causal)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention: unsupported device {q.device}")
    _check(q, k, v)
    q, k, v = (t if t.stride(-1) == 1 else t.contiguous() for t in (q, k, v))
    B, H, S, dh = q.shape
    KV, T = k.shape[1], k.shape[2]
    out = torch.empty((B, H, S, dh), dtype=q.dtype, device=q.device)
    if out.numel() == 0:
        return out
    if T == 0:
        raise ValueError("flash_attention: no keys (T = 0)")
    lib = _kernel()
    stream = torch.cuda.current_stream(q.device).cuda_stream
    strides = [s for t in (q, k, v, out) for s in t.stride()[:3]]
    err = lib.flash_attention_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        B, H, KV, S, T, dh, *strides, float(dh ** -0.5), int(causal),
        _DTYPES[q.dtype], stream, q.device.index)
    if err != 0:
        raise RuntimeError("flash_attention kernel launch failed: "
                           + lib.flash_attention_error_string(err).decode())
    flash_attention.launches += 1
    return out


flash_attention.launches = 0
