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
* :func:`chunked_aggregate_fn` and :func:`sample_attr_chunk` — the host
  chunk seam of ``StreamingAggregator``: fixed-capacity chunks staged
  into device buffers and folded into a preallocated device carry.
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from repro_torch.convert import resolve_device
from repro_torch.kernels.sample_attr.ref import sample_attr_fold_ref

__all__ = ["as_aggregate_fn", "chunked_aggregate_fn", "make_carry_update",
           "sample_attr", "sample_attr_chunk", "sample_attr_fold"]

# The reference's default chunk capacity (16 blocks of 1024 samples).
DEFAULT_CHUNK_CAPACITY = 16 * 1024


# sample_attr_fold's C signature (sample_attr.cu): ids, pows, valid; c, C,
# R; counts, psum, psumsq; the scratch tbl_id, tbl_cnt, tbl_val, tbl_head;
# stream, device.
_P, _I32, _I64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
_ARGTYPES = ((_P,) * 3 + (_I64, _I32, _I64) + (_P,) * 3 + (_P,) * 4
             + (_P, _I32))
_INT32_MAX = 2 ** 31 - 1


class _Lib:
    """The built library, its fold function with the C signature declared,
    and the constants the wrapper needs, each read once at load."""

    def __init__(self, lib):
        lib.sample_attr_fold.argtypes = list(_ARGTYPES)
        lib.sample_attr_fold.restype = ctypes.c_int
        lib.sample_attr_tile.restype = ctypes.c_int
        lib.sample_attr_max_channels.restype = ctypes.c_int
        lib.sample_attr_error_string.argtypes = [ctypes.c_int]
        lib.sample_attr_error_string.restype = ctypes.c_char_p
        self.fold = lib.sample_attr_fold
        self.error_string = lib.sample_attr_error_string
        self.tile = lib.sample_attr_tile()
        self.max_channels = lib.sample_attr_max_channels()


@functools.cache
def _kernel() -> _Lib:
    """The built kernel library (built and loaded on first use, never at
    import)."""
    from repro_torch.kernels import _build
    return _Lib(_build.load("sample_attr"))


def _scratch_sizes(c: int, C: int, tile: int) -> tuple[int, int]:
    """(tables, value slots) pass 1 needs for ``c`` samples and ``C``
    channels: one table of ``tile`` records per tile of samples, each
    record with 2C float64 sums."""
    tables = -(-c // tile)
    return tables, tables * tile * 2 * C


class _Scratch:
    """Pass 1's tables (``tbl_id``, ``tbl_cnt`` [tables·tile] int32,
    ``tbl_val`` [tables·tile·2C] float64, ``tbl_head`` [tables·4] int32:
    each table's length, first and last id), grown to the largest (c, C)
    seen and never shrunk."""

    def __init__(self, device, tables: int, vals: int, tile: int):
        i32 = dict(dtype=torch.int32, device=device)
        self.tables, self.vals = tables, vals
        self.tbl_id = torch.empty(tables * tile, **i32)
        self.tbl_cnt = torch.empty(tables * tile, **i32)
        self.tbl_val = torch.empty(vals, dtype=torch.float64, device=device)
        self.tbl_head = torch.empty(tables * 4, **i32)


_SCRATCH: dict[tuple, _Scratch] = {}


def _scratch(device, stream: int, c: int, C: int, tile: int) -> _Scratch:
    """The scratch of (device, stream), grown when ``c`` or ``C`` needs
    more than it holds; otherwise the same tensors as the last call.

    Reuse is safe because kernels on one stream run in order: the next
    fold's pass 1 starts only after this fold's pass 2 has read the
    tables. A fold on another stream gets scratch of its own."""
    tables, vals = _scratch_sizes(c, C, tile)
    key = (device, stream)
    s = _SCRATCH.get(key)
    if s is None or s.tables < tables or s.vals < vals:
        if s is not None:
            tables, vals = max(tables, s.tables), max(vals, s.vals)
        s = _SCRATCH[key] = _Scratch(device, tables, vals, tile)
    return s


def _check(counts, psum, psumsq, ids, pows, valid):
    """Device, dtype, shape and contiguity of every argument; returns
    (R, c, C)."""
    dev = ids.device
    for name, t, dtype in (("counts", counts, torch.int64),
                           ("psum", psum, torch.float64),
                           ("psumsq", psumsq, torch.float64),
                           ("ids", ids, torch.int32),
                           ("pows", pows, torch.float64),
                           ("valid", valid, torch.bool)):
        if t is None:
            continue
        if t.device != dev:
            raise ValueError(f"sample_attr: {name} is on {t.device}, ids on "
                             f"{dev}")
        if not t.is_contiguous():
            raise ValueError(f"sample_attr: {name} must be contiguous")
        if t.dtype != dtype:
            raise TypeError(f"sample_attr: {name} must be {dtype}, got "
                            f"{t.dtype}")
    if ids.ndim != 1 or counts.ndim != 1:
        raise ValueError("sample_attr: ids and counts must be 1-D")
    R, c = counts.shape[0], ids.shape[0]
    C = 1 if psum.ndim == 1 else psum.shape[1]
    stat = (R,) if psum.ndim == 1 else (R, C)
    if psum.shape != stat or psumsq.shape != stat:
        raise ValueError(f"sample_attr: psum/psumsq must be {stat}, got "
                         f"{tuple(psum.shape)}/{tuple(psumsq.shape)}")
    pw = (c,) if psum.ndim == 1 else (C, c)
    if pows.shape != pw:
        raise ValueError(f"sample_attr: pows must be {pw}, got "
                         f"{tuple(pows.shape)}")
    if valid is not None and valid.shape != (c,):
        raise ValueError(f"sample_attr: valid must be ({c},)")
    if R >= _INT32_MAX:
        raise ValueError("sample_attr: num_regions must be < 2^31 - 1")
    if c >= _INT32_MAX - 1024:
        raise ValueError("sample_attr: a chunk must hold < 2^31 - 1024 "
                         "samples")
    return R, c, C


def sample_attr_fold(counts, psum, psumsq, ids, pows, valid=None):
    """Fold one chunk into the carry in place; returns the carry.

    ``counts`` [R] int64; ``psum``/``psumsq`` [R] float64 with ``pows``
    [c], or [R, C] with ``pows`` [C, c]; ``ids`` [c] int32; ``valid`` [c]
    bool or ``None`` (all lanes valid). Masked lanes and ids outside
    [0, R) contribute nothing. On a CUDA tensor this launches the kernel
    (bitwise repeatable: no floating-point atomics) or raises; its scratch
    is kept per (device, stream) and reused from call to call.
    """
    if ids.device.type == "cpu":
        return sample_attr_fold_ref(counts, psum, psumsq, ids, pows, valid)
    if ids.device.type != "cuda":
        raise ValueError(f"sample_attr: unsupported device {ids.device}")
    R, c, C = _check(counts, psum, psumsq, ids, pows, valid)
    lib = _kernel()
    if C > lib.max_channels:
        raise ValueError(f"sample_attr: at most {lib.max_channels} "
                         f"channels, got {C}")
    if c == 0:
        return counts, psum, psumsq
    dev = ids.device
    stream = torch.cuda.current_stream(dev).cuda_stream
    s = _scratch(dev, stream, c, C, lib.tile)
    err = lib.fold(
        ids.data_ptr(), pows.data_ptr(),
        None if valid is None else valid.data_ptr(), c, C, R,
        counts.data_ptr(), psum.data_ptr(), psumsq.data_ptr(),
        s.tbl_id.data_ptr(), s.tbl_cnt.data_ptr(), s.tbl_val.data_ptr(),
        s.tbl_head.data_ptr(), stream, dev.index)
    if err != 0:
        raise RuntimeError("sample_attr kernel launch failed: "
                           + lib.error_string(err).decode())
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


def sample_attr_chunk(num_regions: int, device="cuda"):
    """Chunk reducer over a preallocated carry: returns ``fold(ids,
    powers)``, which adds one chunk (``ids`` int32, ``-1`` = padding;
    ``powers`` float64) into a zeroed ``(counts, psum, psumsq)`` carry of
    ``num_regions`` rows on ``device`` through :func:`sample_attr_fold`
    and returns it. ``fold.carry`` is that carry; ``fold.reset()`` zeroes
    it in place. The counterpart of the reference's compiled reducer,
    which is cached per (block_n, block_r, num_regions): here nothing is
    compiled per configuration, and the carry is allocated once per
    reducer, not per chunk."""
    dev = resolve_device(device)
    carry = (torch.zeros(num_regions, dtype=torch.int64, device=dev),
             torch.zeros(num_regions, dtype=torch.float64, device=dev),
             torch.zeros(num_regions, dtype=torch.float64, device=dev))

    def fold(region_ids, powers):
        sample_attr_fold(*carry, region_ids, powers)
        return carry

    def reset():
        for t in carry:
            t.zero_()
    fold.carry = carry
    fold.reset = reset
    return fold


def chunked_aggregate_fn(chunk_capacity: int = DEFAULT_CHUNK_CAPACITY, *,
                         device="cuda"):
    """AggregateFn for ``StreamingAggregator``: fixed-capacity chunks
    folded by the kernel on ``device``.

    Each call stages its samples into two preallocated device buffers of
    ``chunk_capacity`` lanes, a slice at a time (oversized chunks are
    folded in capacity-sized slices; a short slice is topped up with id
    ``-1``, which matches no region), folds every slice into one device
    carry and reads the carry back once. The region axis is rounded up
    to a power of two (at least 64), so a growing region space
    (streaming combination interning) allocates O(log R) carries, not
    one per distinct R. The reference's ``block_n``/``block_r`` tile the
    TPU's VMEM, which the CUDA kernel does not use: they are not taken.
    The closure owns its buffers, so one aggregate fn is not to be shared
    across threads (each ``StreamingAggregator`` gets its own).
    """
    dev = resolve_device(device)
    scratch_ids = torch.full((chunk_capacity,), -1, dtype=torch.int32,
                             device=dev)
    scratch_pw = torch.zeros(chunk_capacity, dtype=torch.float64,
                             device=dev)
    reducers: dict[int, object] = {}

    def agg(region_ids, powers, num_regions):
        num_regions = int(num_regions)
        r_quant = max(64, 1 << (num_regions - 1).bit_length())
        fold = reducers.get(r_quant)
        if fold is None:
            fold = reducers[r_quant] = sample_attr_chunk(r_quant, dev)
        fold.reset()
        ids = np.ascontiguousarray(region_ids, dtype=np.int32)
        pw = np.ascontiguousarray(powers, dtype=np.float64)
        for lo in range(0, len(ids), chunk_capacity):
            n_c = min(chunk_capacity, len(ids) - lo)
            # Copies and folds run in stream order, so the next slice's
            # copy cannot overwrite the buffers before this fold read them.
            scratch_ids[:n_c].copy_(torch.from_numpy(ids[lo:lo + n_c]))
            scratch_pw[:n_c].copy_(torch.from_numpy(pw[lo:lo + n_c]))
            if n_c < chunk_capacity:
                scratch_ids[n_c:].fill_(-1)
                scratch_pw[n_c:].zero_()
            fold(scratch_ids, scratch_pw)
        # A copy even on the CPU: the carry is reset by the next call.
        return tuple(t[:num_regions].to("cpu", copy=True).numpy()
                     for t in fold.carry)
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
