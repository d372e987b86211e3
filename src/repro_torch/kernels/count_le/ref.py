"""Plain PyTorch version of the interval lookup.

``#(ends ≤ t)`` per worker and sample through the timeline's grid
accelerator (:class:`repro_torch.core.device_pipeline.DeviceTimeline`):
locate the sample's grid cell with exact-comparison guards against the
division's rounding, start from the cell's prefix count, and add at most
``k_max`` consecutive compares, all in one gather. Every comparison is
exact, so the counts are ``searchsorted(side="right")``'s. Each step is
one torch operation over all workers, so launches do not grow with W;
the compare window is materialised, [W, n, k_max]. This is the
arithmetic the CUDA kernel (``count_le.cu``) must reproduce: the CPU path
of :mod:`repro_torch.kernels.count_le.ops` runs it, the tests hold it to
``torch.searchsorted``, and ``chip_smoke.py`` holds the kernel to it.
A timeline whose grid window could not be bounded (``k_max = 0``) is
looked up by ``torch.searchsorted`` itself, on either device.
"""

from __future__ import annotations

import torch

__all__ = ["count_le_ref"]


def count_le_ref(ends, grid, cell, t, k_max: int):
    """``#(ends ≤ t)``, [W, n] int64, for ``ends`` [W, M], ``grid``
    [W, G+2] and ``cell`` [W] of every worker against the times ``t`` [n]
    they share; ``k_max`` ≥ 1 bounds the ends of one grid cell, and
    ``k_max = 0`` takes the binary search."""
    W, M = ends.shape
    if k_max == 0:
        return torch.searchsorted(ends, t.expand(W, -1).contiguous(),
                                  right=True)
    G = grid.shape[1] - 2
    cw = cell[:, None]
    g = torch.floor(t / cw).to(torch.int64)
    g = g - (g.to(torch.float64) * cw > t).to(torch.int64)
    g = g + ((g + 1).to(torch.float64) * cw <= t).to(torch.int64)
    lo = torch.gather(grid, 1, g.clamp(0, G)).to(torch.int64)
    pos = lo[:, :, None] + torch.arange(k_max, device=t.device)
    e = torch.gather(ends, 1, pos.clamp(max=M - 1).reshape(W, -1))
    hit = (pos < M) & (e.reshape(pos.shape) <= t[:, None])
    return lo + hit.sum(dim=2)
