"""Timelines and sample times for the interval lookup's tests: workers
whose grid window ``grid_k`` is set by construction, and times that land
on interval ends, next to them and on grid points. ``chip_smoke.py``'s
``count_le`` phase builds its timelines with :func:`burst_timelines`
too."""

import numpy as np
import torch

from repro_torch.core.device_pipeline import DeviceTimeline
from repro_torch.core.timeline import Timeline


def burst_timelines(workers: int, k: int, m: int = 600, seed: int = 0):
    """``workers`` ragged timelines of about ``m`` intervals whose
    durations (0.6–1.4 of their mean, at least 2.4 grid cells) leave one
    end a grid cell, except a few bursts of ``k`` ends inside one cell:
    their upload's ``grid_k`` is ``k``."""
    rng = np.random.default_rng(seed)
    out = []
    for w in range(workers):
        n = m - 7 * w
        dur = rng.uniform(0.6, 1.4, n) * 1e-3
        for p in rng.choice(n // (k + 2) - 1, size=3, replace=False):
            dur[p * (k + 2) + 1:p * (k + 2) + k] = 1e-10
        out.append(Timeline(rng.integers(0, 5, n), dur,
                            rng.uniform(50.0, 300.0, n),
                            tuple(f"r{i}" for i in range(5))))
    return out


def lookup_case(workers: int, k: int, *, n: int = 4096, seed: int = 0,
                device="cpu"):
    """A :class:`DeviceTimeline` of :func:`burst_timelines` and ``n``
    shared sample times [n] float64: every end of the first and the last
    worker, the float64 neighbours of some, grid points ``g · cell`` of
    the first worker, 0, the horizon, the longest worker's end and
    uniform draws."""
    dtl = DeviceTimeline.from_timelines(
        burst_timelines(workers, k, seed=seed), device="cpu")
    rng = np.random.default_rng(seed + 1)
    ends = [dtl.ends[w, :int(dtl.m_true[w])].numpy()
            for w in (0, workers - 1)]
    some = rng.choice(ends[0], 64)
    g = rng.integers(0, dtl.grid.shape[1], 128).astype(np.float64)
    cell0 = float(dtl.cell[0])
    t_max = max(float(e[-1]) for e in ends)
    picks = np.concatenate([
        *ends, np.nextafter(some, np.inf), np.nextafter(some, -np.inf),
        g * cell0, [0.0, dtl.t_end, t_max]])
    t = np.concatenate([picks, rng.uniform(0.0, t_max, n - len(picks))])
    return (dtl if torch.device(device).type == "cpu"
            else DeviceTimeline.from_timelines(
                burst_timelines(workers, k, seed=seed), device=device),
            torch.from_numpy(t).to(device))
