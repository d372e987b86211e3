"""Plain PyTorch version of the trace-sensor stage.

Every worker's sensor readings for one chunk of shared sample times, as
pure functions of the timeline's energy integral (ALEA §4.5): the RAPL
energy counter differenced against the sample before (a one-scalar
``prev`` carry chains the chunks) and the INA231 meter's mean power over
the window that ends at the sample. Each step is one torch operation over
all workers and rails, so launches do not grow with W or D. This is the
arithmetic the CUDA kernel (``trace_sensor.cu``) must reproduce: the CPU
path of :mod:`repro_torch.kernels.trace_sensor.ops` runs it, and the tests
and ``chip_smoke.py`` hold the kernel to it bit for bit.

The RAPL quotient ``t / up`` is written ``t * (1.0 / up)``: that is how
PyTorch's CUDA kernels divide a tensor by a Python scalar, so the CPU, the
card's torch operations and the kernel give the same bits. A true
division differs for a time one nanosecond before a counter update at
some magnitudes of ``t`` (~2% of the updates of a 10^5-s horizon), and
there moves the sample's ``tq`` by one update period.
"""

from __future__ import annotations

import torch

from repro_torch.kernels.count_le.ref import count_le_ref

__all__ = ["energy_at_cnt", "interval", "take", "trace_sensor_ref"]


def interval(cnt, m_true):
    """Interval index ``clip(cnt, 0, m - 1)`` per worker (``cnt`` [W, n],
    ``m_true`` [W])."""
    return torch.minimum(cnt.clamp(min=0),
                         (m_true - 1).to(torch.int64)[:, None])


def take(a, idx):
    """``a[w, ..., idx[w, i]]``: a per-worker gather along the interval
    axis of ``a`` [W, M] or [W, D, M] (``idx`` [W, n]) → [W, n] or
    [W, D, n]; the rails of a worker share its indices."""
    if a.ndim == 2:
        return torch.gather(a, 1, idx)
    return torch.gather(a, 2, idx[:, None, :].expand(-1, a.shape[1], -1))


def energy_at_cnt(bounds, eint, powers, m_true, x, cnt):
    """Exact E(x) for piecewise-constant power (device twin of
    ``sensors._TraceSensorBase._energy_at``) given ``cnt = #(ends ≤ x)``
    [W, n]; ``bounds = [0, ends...]`` makes the bounds index
    ``clip(cnt)``. Scalar substrates give [W, n], multi-rail ones
    [W, D, n]."""
    idx = interval(cnt, m_true)
    dx = x - torch.gather(bounds, 1, idx)
    if eint.ndim == 3:
        dx = dx[:, None, :]
    return take(eint, idx) + dx * take(powers, idx)


def trace_sensor_ref(kind: str, param: float, t, cnt, valid, prev, ends,
                     bounds, eint, powers, m_true, grid, cell, k_max: int):
    """``(readings, prev)`` of one chunk: readings [W, c] for a scalar
    substrate, [W, D, c] for a multi-rail one.

    ``kind`` is ``"rapl"`` (``param`` the counter's update period) or
    ``"ina231"`` (``param`` the meter's window). ``t`` [c] are the times
    every worker shares, ``cnt`` [W, c] their interval counts, ``valid``
    [c] the lanes inside the horizon, ``prev`` the 0-d RAPL carry (< 0: no
    sample taken yet); the rest are the timeline's arrays
    (:meth:`repro_torch.core.device_pipeline.DeviceTimeline.arrays`) and
    its grid window. RAPL returns the new carry, a new tensor; INA231
    returns ``prev`` itself."""
    def e_at(x, cnt_x=None):
        if cnt_x is None:
            cnt_x = count_le_ref(ends, grid, cell, x, k_max)
        return energy_at_cnt(bounds, eint, powers, m_true, x, cnt_x)

    if kind == "rapl":
        up = param
        tq = torch.floor(t * (1.0 / up) + 1e-6) * up
        # The prev chain is tq shifted by one sample, so E(prev) is e_q
        # shifted by one lane — one energy pass instead of two; only the
        # chain head (carry prev, or tq[0] - up on the very first sample)
        # needs its own tiny lookup.
        prev0 = torch.where(prev < 0.0, torch.clamp_min(tq[0] - up, 0.0),
                            prev).reshape(1)
        e_q = e_at(tq)
        e_prev = torch.cat([e_at(prev0), e_q[..., :-1]], dim=-1)
        dt = torch.clamp_min(tq - torch.cat([prev0, tq[:-1]]), up)
        new_prev = torch.where(valid, tq, -torch.inf).max()
        new_prev = torch.where(valid.any(), new_prev, prev)
        return (e_q - e_prev) / dt, new_prev
    if kind == "ina231":
        lo = torch.clamp_min(t - param, 0.0)
        span = torch.clamp_min(t - lo, 1e-12)
        return (e_at(t, cnt) - e_at(lo)) / span, prev
    raise ValueError(f"unknown trace sensor kind: {kind!r}")
