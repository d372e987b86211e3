"""Public wrappers for the sample-attribution kernel.

:func:`sample_attr_fold` is the one place the CUDA kernel
(``sample_attr.cu``) is launched: for tensors on the GPU it launches the
kernel or raises; for tensors on the CPU it runs the plain PyTorch
version (:mod:`.ref`). ``sample_attr_fold.launches`` counts the kernel's
launches, so a run can show that its path went through the kernel.

* :func:`make_carry_update` — the reduction seam of
  :mod:`repro_torch.core.device_pipeline`: folds one masked fixed-shape
  chunk into the pipeline's (counts, Σpow, Σpow²) carry, in place, all
  channels in one launch.
* :func:`sample_attr` and :func:`as_aggregate_fn` — the one-shot form and
  its adapter to the estimator's ``AggregateFn`` interface; both go
  through the same kernel with a fresh zero carry.
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from repro_torch.convert import resolve_device
from repro_torch.kernels.sample_attr.ref import sample_attr_fold_ref

__all__ = ["as_aggregate_fn", "make_carry_update", "sample_attr",
           "sample_attr_fold"]


@functools.cache
def _kernel():
    """The built kernel library with its C signatures declared (built
    and loaded on first use, never at import)."""
    from repro_torch.kernels import _build
    lib = _build.load("sample_attr")
    p = ctypes.c_void_p
    lib.sample_attr_fold.argtypes = [
        p, p, p, ctypes.c_int64, ctypes.c_int, ctypes.c_int64,
        p, p, p, p, p, p, p, ctypes.c_int]
    lib.sample_attr_fold.restype = ctypes.c_int
    lib.sample_attr_block.restype = ctypes.c_int
    lib.sample_attr_max_channels.restype = ctypes.c_int
    lib.sample_attr_error_string.argtypes = [ctypes.c_int]
    lib.sample_attr_error_string.restype = ctypes.c_char_p
    return lib


def _check(counts, psum, psumsq, ids, pows, valid):
    dev = ids.device
    named = {"counts": counts, "psum": psum, "psumsq": psumsq, "ids": ids,
             "pows": pows, "valid": valid}
    for name, t in named.items():
        if t is None:
            continue
        if t.device != dev:
            raise ValueError(f"sample_attr: {name} is on {t.device}, ids on "
                             f"{dev}")
        if not t.is_contiguous():
            raise ValueError(f"sample_attr: {name} must be contiguous")
    want = {"counts": torch.int64, "psum": torch.float64,
            "psumsq": torch.float64, "ids": torch.int32,
            "pows": torch.float64, "valid": torch.bool}
    for name, dtype in want.items():
        t = named[name]
        if t is not None and t.dtype != dtype:
            raise TypeError(f"sample_attr: {name} must be {dtype}, got "
                            f"{t.dtype}")
    if ids.ndim != 1 or counts.ndim != 1:
        raise ValueError("sample_attr: ids and counts must be 1-D")
    R, c = counts.shape[0], ids.shape[0]
    C = 1 if psum.ndim == 1 else psum.shape[1]
    stat = (R,) if psum.ndim == 1 else (R, C)
    if tuple(psum.shape) != stat or tuple(psumsq.shape) != stat:
        raise ValueError(f"sample_attr: psum/psumsq must be {stat}, got "
                         f"{tuple(psum.shape)}/{tuple(psumsq.shape)}")
    pw = (c,) if psum.ndim == 1 else (C, c)
    if tuple(pows.shape) != pw:
        raise ValueError(f"sample_attr: pows must be {pw}, got "
                         f"{tuple(pows.shape)}")
    if valid is not None and tuple(valid.shape) != (c,):
        raise ValueError(f"sample_attr: valid must be ({c},)")
    if R >= 2 ** 31 - 1:
        raise ValueError("sample_attr: num_regions must be < 2^31 - 1")
    return R, c, C


def sample_attr_fold(counts, psum, psumsq, ids, pows, valid=None):
    """Fold one chunk into the carry in place; returns the carry.

    ``counts`` [R] int64; ``psum``/``psumsq`` [R] float64 with ``pows``
    [c], or [R, C] with ``pows`` [C, c]; ``ids`` [c] int32; ``valid`` [c]
    bool or ``None`` (all lanes valid). Masked lanes and ids outside
    [0, R) contribute nothing. On a CUDA tensor this launches the kernel
    (bitwise repeatable: no floating-point atomics) or raises.
    """
    if ids.device.type == "cpu":
        return sample_attr_fold_ref(counts, psum, psumsq, ids, pows, valid)
    if ids.device.type != "cuda":
        raise ValueError(f"sample_attr: unsupported device {ids.device}")
    R, c, C = _check(counts, psum, psumsq, ids, pows, valid)
    lib = _kernel()
    if C > lib.sample_attr_max_channels():
        raise ValueError(f"sample_attr: at most "
                         f"{lib.sample_attr_max_channels()} channels, got {C}")
    if c == 0:
        return counts, psum, psumsq
    block = lib.sample_attr_block()
    slots = -(-c // block) * block
    dev = ids.device
    part_id = torch.empty(slots, dtype=torch.int32, device=dev)
    part_cnt = torch.empty(slots, dtype=torch.int32, device=dev)
    part_val = torch.empty(slots * 2 * C, dtype=torch.float64, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = lib.sample_attr_fold(
        ids.data_ptr(), pows.data_ptr(),
        None if valid is None else valid.data_ptr(), c, C, R,
        counts.data_ptr(), psum.data_ptr(), psumsq.data_ptr(),
        part_id.data_ptr(), part_cnt.data_ptr(), part_val.data_ptr(),
        stream, dev.index)
    if err != 0:
        raise RuntimeError("sample_attr kernel launch failed: "
                           + lib.sample_attr_error_string(err).decode())
    sample_attr_fold.launches += 1
    return counts, psum, psumsq


sample_attr_fold.launches = 0


def sample_attr(region_ids, powers, num_regions: int):
    """``(counts i64 [R], psum f64 [R], psumsq f64 [R])`` of one sample
    stream (``-1`` pads match no region), through the same kernel."""
    dev = region_ids.device
    carry = (torch.zeros(num_regions, dtype=torch.int64, device=dev),
             torch.zeros(num_regions, dtype=torch.float64, device=dev),
             torch.zeros(num_regions, dtype=torch.float64, device=dev))
    return sample_attr_fold(*carry, region_ids.to(torch.int32).contiguous(),
                            powers.to(torch.float64).contiguous())


def as_aggregate_fn(device="cuda"):
    """Adapter matching ``estimator.AggregateFn`` (numpy in, numpy out),
    reducing on ``device``."""
    dev = resolve_device(device)

    def agg(region_ids, powers, num_regions):
        ids = torch.as_tensor(np.asarray(region_ids, np.int32), device=dev)
        pw = torch.as_tensor(np.asarray(powers, np.float64), device=dev)
        c, s, sq = sample_attr(ids, pw, int(num_regions))
        return c.cpu().numpy(), s.cpu().numpy(), sq.cpu().numpy()
    return agg


def make_carry_update(num_regions: int):
    """Masked chunk→carry reduction for the device pipeline.

    Returns ``update(counts, psum, psumsq, ids, pows, valid)``, folding
    one chunk into the carry in place (the carry tensors are updated and
    returned — the port's counterpart of the reference's donated carry).
    Two carry layouts, as in the reference: scalar — ``psum``/``psumsq``
    [R], ``pows`` [c]; channels — [R, C] with ``pows`` [C, c]. ``counts``
    stays [R] either way (every rail shares the sample clock).
    """
    def update(counts, psum, psumsq, ids, pows, valid):
        if counts.shape[0] != num_regions:
            raise ValueError(f"carry has {counts.shape[0]} regions, "
                             f"update built for {num_regions}")
        return sample_attr_fold(counts, psum, psumsq, ids, pows, valid)
    return update
