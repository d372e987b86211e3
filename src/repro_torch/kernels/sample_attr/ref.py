"""Plain PyTorch version of the sample-attribution reduction.

Given a stream of (region_id, power) samples, fold per-region counts,
Σpower and Σpower² — the sufficient statistics for Eqs. 4/6/14 — into a
carry, in float64 through ``index_add_``. This is the arithmetic the CUDA
kernel (``sample_attr.cu``) must reproduce: the CPU path of
:mod:`repro_torch.kernels.sample_attr.ops` runs it, and ``chip_smoke.py``
holds the kernel against it on the GPU.
"""

from __future__ import annotations

import torch

__all__ = ["sample_attr_fold_ref", "sample_attr_ref"]


def sample_attr_fold_ref(counts, psum, psumsq, ids, pows, valid=None):
    """Fold one chunk into ``(counts [R] i64, psum, psumsq)`` in place.

    ``pows`` is [c] with ``psum``/``psumsq`` [R], or [C, c] with [R, C].
    Lanes with ``valid`` false (``None``: all valid) or an id outside
    [0, R) contribute nothing. Returns the carry.
    """
    R = counts.shape[0]
    ok = (ids >= 0) & (ids < R)
    if valid is not None:
        ok = ok & valid
    idx = ids[ok].to(torch.int64)
    counts.index_add_(0, idx, torch.ones_like(idx))
    pw = (pows[ok] if psum.ndim == 1 else pows[:, ok].T).to(psum.dtype)
    psum.index_add_(0, idx, pw)
    psumsq.index_add_(0, idx, pw * pw)
    return counts, psum, psumsq


def sample_attr_ref(ids, powers, num_regions: int):
    """One-shot form: ``(counts i64 [R], psum f64 [R], psumsq f64 [R])``;
    ids outside [0, R) (the ``-1`` padding) match no region."""
    dev = ids.device
    carry = (torch.zeros(num_regions, dtype=torch.int64, device=dev),
             torch.zeros(num_regions, dtype=torch.float64, device=dev),
             torch.zeros(num_regions, dtype=torch.float64, device=dev))
    return sample_attr_fold_ref(*carry, ids, powers)
