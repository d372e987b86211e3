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

The source holds two kernels; :func:`_route` picks one from the dtype and
the head dim alone: ``"wgmma"`` (tensor cores, TMA loads) for bfloat16
and float16 at dh 64, 80 and 128, ``"simt"`` (CUDA cores, float32
arithmetic) for float32 and dh 32. A failed build or launch raises;
nothing falls back from one route to the other.

There is no backward kernel, as the reference's Pallas kernel has none:
the wrapper raises when autograd would record it (grad mode on and an
input that requires grad), on the GPU and the CPU alike, instead of
returning a tensor whose gradient is silently dropped. Training uses
``attn_impl="full"``, as the reference's does.
"""

from __future__ import annotations

import ctypes
import functools
import math

import torch

from repro_torch.kernels.flash_attention.ref import attention_ref

__all__ = ["HEAD_DIMS", "flash_attention"]

HEAD_DIMS = (32, 64, 80, 128)
_DTYPES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
_ROUTES = {"simt": 0, "wgmma": 1}
_WGMMA_DTYPES = (torch.bfloat16, torch.float16)
_WGMMA_HEAD_DIMS = (64, 80, 128)
_INT32_MAX = 2 ** 31 - 1
# flash_attention_fwd's C signature (flash_attention.cu): q, k, v, o; B, H,
# KV, S, T, dh; the (batch, head, row) strides of q, k, v, o; scale,
# causal, dtype, route, stream, device.
_P, _I32, _I64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
_ARGTYPES = ((_P,) * 4 + (_I32, _I32, _I32, _I64, _I64, _I32) + (_I64,) * 12
             + (ctypes.c_float, _I32, _I32, _I32, _P, _I32))


def _route(dtype: torch.dtype, dh: int) -> str:
    """Which kernel runs: ``"wgmma"`` (tensor cores) for bfloat16/float16
    at dh 64, 80 and 128; ``"simt"`` (CUDA cores, float32 arithmetic)
    otherwise: float32, whose limit TF32 would break, and dh 32, which only
    reduced configs use."""
    if dtype in _WGMMA_DTYPES and dh in _WGMMA_HEAD_DIMS:
        return "wgmma"
    return "simt"


def _tma_operand(t: torch.Tensor) -> torch.Tensor:
    """``t`` itself when TMA can read it in place (16-byte aligned base,
    contiguous last axis, every other axis of size > 1 strided by a
    positive multiple of 16 bytes), else a contiguous copy, which is."""
    es = t.element_size()
    ok = (t.stride(-1) == 1 and t.data_ptr() % 16 == 0
          and all(n == 1 or (st > 0 and st * es % 16 == 0)
                  for n, st in zip(t.shape[:-1], t.stride()[:-1])))
    return t if ok else t.clone(memory_format=torch.contiguous_format)


def _strides(t: torch.Tensor) -> list[int]:
    """Element strides of (batch, head, row). An axis of size 1 is never
    stepped along, so its stride is given as a contiguous tensor's (a
    multiple of the row, which TMA accepts) whatever torch reports."""
    return [st if n > 1 else math.prod(t.shape[i + 1:])
            for i, (n, st) in enumerate(zip(t.shape[:3], t.stride()[:3]))]


@functools.cache
def _kernel():
    """The built kernel library with its C signature declared (built and
    loaded on first use, never at import)."""
    from repro_torch.kernels import _build
    lib = _build.load("flash_attention")
    lib.flash_attention_fwd.argtypes = list(_ARGTYPES)
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
    ``col <= row``). On a CUDA tensor this launches the kernel of
    :func:`_route` (dh in :data:`HEAD_DIMS`; float32, bfloat16 or float16;
    any S and T) or raises. Strided inputs are read in place as long as
    the last axis is contiguous and, on the ``"wgmma"`` route, the base
    and the other strides are multiples of 16 bytes; otherwise they are
    copied to a contiguous tensor first. Raises ``RuntimeError`` when
    autograd would record the call (no gradient, as in the reference).
    """
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        raise RuntimeError(
            "flash_attention has no gradient (nor has the reference's "
            "Pallas kernel); train with attn_impl='full', or call it "
            "under torch.no_grad()")
    if q.device.type == "cpu":
        return attention_ref(q, k, v, causal=causal)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention: unsupported device {q.device}")
    _check(q, k, v)
    B, H, S, dh = q.shape
    KV, T = k.shape[1], k.shape[2]
    route = _route(q.dtype, dh)
    if route == "wgmma":
        if max(S, T) > _INT32_MAX:
            raise ValueError(f"flash_attention: S={S}, T={T}: TMA "
                             f"coordinates are 32-bit")
        q, k, v = (_tma_operand(t) for t in (q, k, v))
    else:
        q, k, v = (t if t.stride(-1) == 1 else t.contiguous()
                   for t in (q, k, v))
    out = torch.empty((B, H, S, dh), dtype=q.dtype, device=q.device)
    if out.numel() == 0:
        return out
    if T == 0:
        raise ValueError("flash_attention: no keys (T = 0)")
    lib = _kernel()
    stream = torch.cuda.current_stream(q.device).cuda_stream
    strides = [st for t in (q, k, v, out) for st in _strides(t)]
    err = lib.flash_attention_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        B, H, KV, S, T, dh, *strides, float(dh ** -0.5), int(causal),
        _DTYPES[q.dtype], _ROUTES[route], stream, q.device.index)
    if err != 0:
        raise RuntimeError("flash_attention kernel launch failed: "
                           + lib.flash_attention_error_string(err).decode())
    flash_attention.launches += 1
    return out


flash_attention.launches = 0
