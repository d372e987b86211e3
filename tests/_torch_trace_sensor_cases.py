"""Chunks for the trace sensor's tests: timelines of W workers and D rails
on either lookup route, one chunk of sample times on the nanosecond clock
(with the times just before a counter update at which ``t / up`` and
``t * (1 / up)`` quantise apart), and a frozen copy of the torch
operations the sensor stage ran before it had a kernel.
``chip_smoke.py``'s ``trace_sensor`` phase builds its chunks with
:func:`clock_times` and :func:`sensor_args` too."""

import numpy as np
import torch

from repro_torch.core.device_pipeline import DeviceTimeline
from repro_torch.core.timeline import Timeline
from _torch_count_le_cases import burst_timelines

UP = 1e-3           # RAPL's update period (the sensors' default)
WINDOW = 280e-6     # INA231's window (the sensors' default)
KINDS = {"rapl": UP, "ina231": WINDOW}
DOMAINS = ("package", "hbm", "ici")


def scaled(tls, scale: float, rails: bool, seed: int = 0):
    """The timelines with every duration times ``scale`` and, with
    ``rails``, three rails each that split every interval's power by
    random shares."""
    rng = np.random.default_rng(seed)
    out = []
    for tl in tls:
        share = rng.uniform(0.1, 1.0, (len(tl.powers), len(DOMAINS)))
        share /= share.sum(axis=1, keepdims=True)
        out.append(Timeline(tl.region_ids, tl.durations * scale, tl.powers,
                            tl.names,
                            rail_powers=tl.powers[:, None] * share
                            if rails else None,
                            domains=DOMAINS if rails else None))
    return out


def sensor_timeline(workers: int, rails: bool, search: bool, *,
                    m: int = 400, scale: float = 250.0,
                    seed: int = 0) -> DeviceTimeline:
    """A CPU :class:`DeviceTimeline` of ``workers`` ragged workers of about
    ``m`` intervals of ~``scale`` ms (~0.1 s, as the benchmark's
    timelines): bursts of 3 ends in one grid cell (the grid route,
    ``grid_k`` 3) or of 40 (``grid_k`` 0: the binary search)."""
    tls = scaled(burst_timelines(workers, 40 if search else 3, m=m,
                                 seed=seed), scale, rails, seed)
    dtl = DeviceTimeline.from_timelines(tls, device="cpu")
    assert (dtl.grid_k == 0) == search and dtl.num_domains == (
        3 if rails else 1)
    return dtl


def edge_times(t0: float, t1: float, up: float = UP) -> np.ndarray:
    """The times ``k·up - 1 ns`` in [t0, t1) on the nanosecond clock at
    which ``floor(t / up + 1e-6)`` and ``floor(t * (1 / up) + 1e-6)``
    differ."""
    ns = np.arange(max(int(t0 / up), 1), int(t1 / up) + 1) * round(up * 1e9)
    t = (ns - 1).astype(np.float64) * 1e-9
    t = t[(t >= t0) & (t < t1)]
    apart = np.floor(t / up + 1e-6) != np.floor(t * (1.0 / up) + 1e-6)
    return t[apart]


def clock_times(c: int, t0: float, period: float, *, seed: int,
                jitter_share: float = 0.2, edges=()) -> np.ndarray:
    """``c`` sorted sample times from ``t0`` at ``period`` with uniform
    jitter, on the nanosecond clock, some lanes moved to ``edges``."""
    rng = np.random.default_rng(seed)
    t = t0 + np.arange(c) * period + rng.uniform(0.0, jitter_share * period,
                                                  c)
    t = np.floor(t * 1e9 + 0.5) * 1e-9
    edges = np.asarray(edges, np.float64)[:c // 4]
    if len(edges):
        t[rng.choice(c, len(edges), replace=False)] = edges
    return np.sort(t)


def sensor_args(kind: str, dtl: DeviceTimeline, t: np.ndarray, prev: float,
                device="cpu"):
    """The arguments of ``trace_sensor`` / ``trace_sensor_ref`` for the
    times ``t`` on ``dtl`` (moved to ``device``), as the chunk step makes
    them: times past the horizon clamped to it and flagged invalid, the
    counts of the clamped times from searchsorted."""
    raw = torch.from_numpy(t)
    valid = raw < dtl.t_end
    t = torch.clamp_max(raw, dtl.t_end)
    cnt = torch.searchsorted(dtl.ends, t.expand(dtl.num_workers, -1)
                             .contiguous(), right=True)
    prev = torch.tensor(prev, dtype=torch.float64)
    ends, bounds, eint, powers, _, m_true, grid, cell = dtl.arrays()
    args = (t, cnt, valid, prev, ends, bounds, eint, powers, m_true, grid,
            cell)
    return (kind, KINDS[kind], *(a.to(device) for a in args), dtl.grid_k)


# Where a chunk starts, as a share of the horizon: the run's first chunk
# (no sample before it), one in the middle, one that crosses the horizon
# and one wholly past it (no valid lane: RAPL keeps its carry).
STARTS = (0.0, 0.4, 0.9, 1.2)


def chunk_case(kind: str, dtl: DeviceTimeline, start: float, *, c: int,
               seed: int, device="cpu"):
    """``sensor_args`` of a chunk of ``c`` lanes that starts at ``start``
    of the horizon, with its RAPL carry (-1 at the start of the run, else
    the quantised time of a sample just before) and the edge times of its
    span."""
    period = 0.5 * dtl.t_end / c
    t0 = start * dtl.t_end
    edges = edge_times(t0, t0 + c * period)
    t = clock_times(c, t0, period, seed=seed, edges=edges)
    prev = -1.0 if start == 0.0 else \
        float(np.floor(max(t0 - period, 0.0) / UP + 1e-6) * UP)
    return sensor_args(kind, dtl, t, prev, device)


def bits(x):
    """The int64 view of a float64 tensor, on the CPU."""
    return x.detach().cpu().contiguous().view(torch.int64)


def parent_sensor_powers(kind, param, t, cnt, valid, prev, ends, bounds,
                         eint, powers, m_true, grid, cell, k_max, *,
                         quotient: str):
    """The torch operations of the sensor stage before its kernel, frozen
    (lookups by searchsorted: the grid route gives the same counts). RAPL
    takes ``t / up`` as ``quotient`` says: ``"cpu"``, a true division, as
    the CPU's torch kernels divide; ``"card"``, ``t * (1 / up)``, as
    torch's CUDA kernels divide a tensor by a Python scalar."""
    W = ends.shape[0]

    def interval(n):
        return torch.minimum(n.clamp(min=0),
                             (m_true - 1).to(torch.int64)[:, None])

    def take(a, idx):
        if a.ndim == 2:
            return torch.gather(a, 1, idx)
        return torch.gather(a, 2, idx[:, None, :].expand(-1, a.shape[1], -1))

    def e_at(x, n=None):
        if n is None:
            n = torch.searchsorted(ends, x.expand(W, -1).contiguous(),
                                   right=True)
        idx = interval(n)
        dx = x - torch.gather(bounds, 1, idx)
        if eint.ndim == 3:
            dx = dx[:, None, :]
        return take(eint, idx) + dx * take(powers, idx)

    if kind == "rapl":
        up = param
        q = t / up if quotient == "cpu" else t * (1.0 / up)
        tq = torch.floor(q + 1e-6) * up
        prev0 = torch.where(prev < 0.0, torch.clamp_min(tq[0] - up, 0.0),
                            prev).reshape(1)
        e_q = e_at(tq)
        e_prev = torch.cat([e_at(prev0), e_q[..., :-1]], dim=-1)
        dt = torch.clamp_min(tq - torch.cat([prev0, tq[:-1]]), up)
        new_prev = torch.where(valid, tq, -torch.inf).max()
        new_prev = torch.where(valid.any(), new_prev, prev)
        return (e_q - e_prev) / dt, new_prev
    lo = torch.clamp_min(t - param, 0.0)
    span = torch.clamp_min(t - lo, 1e-12)
    return (e_at(t, cnt) - e_at(lo)) / span, prev
