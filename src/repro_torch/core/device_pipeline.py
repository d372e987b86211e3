"""Device-resident sampling→attribution pipeline (ALEA hot path), region half.

PyTorch port of the single-worker half of
``src/repro/core/device_pipeline.py``. The whole per-chunk loop runs on
the tensors' device (the GPU unless the caller asks for the CPU):

* :class:`DeviceTimeline` — the sampling substrate as tensors: interval
  ``ends``, the cumulative energy integral, ``powers`` and ``region_ids``,
  batched ``[W, m]`` (ragged workers padded, per-worker valid length
  carried alongside), plus the grid accelerator for interval lookups.
  Built by the same numpy code as the reference, so the arrays are equal.

* **Counter-based sample times** — chunk ``k``'s times are a pure function
  of ``(seed, k)``: ``t_i = u0 + i·T + u_i`` with ``u0 ~ U(0, T)``,
  ``u_i ~ U(0, jitter)`` drawn from ``fold_in(key, k+1)``, quantized to an
  integer-nanosecond clock. :mod:`repro_torch.core.threefry` draws the
  same bits as the reference's ``jax.random``, so the times — and with
  them every region lookup and sample count — are equal to the
  reference's, on the CPU and the GPU alike.

* **Chunk step** — time generation, region lookup (``searchsorted(side=
  "right")`` semantics through the grid accelerator), trace-sensor
  emulation as pure functions of the energy integral (RAPL differencing
  with a one-scalar prev-sample carry, INA231 window semantics), and the
  ``sample_attr`` fold into the ``(counts, Σpow, Σpow²)`` carry
  (:func:`repro_torch.kernels.sample_attr.ops.make_carry_update`: the
  CUDA kernel on the GPU, ``index_add_`` on the CPU). Lanes past the
  profiled horizon are masked inside the step.

* :func:`run_region_pipeline` — the reference's ``fori_loop`` becomes a
  Python loop over chunks. The carry, the sample count and the RAPL prev
  sample stay on the device; the only synchronisation is the final read
  of ``n`` and the statistics.

Everything is float64/int64, so device lookups are bit-identical to the
numpy oracle :func:`reference_region_pipeline`, which consumes the same
:func:`chunk_sample_times`. Every product and sum of the clock is its own
torch operation, so the GPU's times equal the CPU's bit for bit; the two
fused multiply-adds the reference's XLA build puts in the clock are
emulated exactly (:func:`_fma`).

**Power-rail domain axis.** Multi-domain timelines carry per-rail energy
integrals ``[W, D, ·]``; each rail applies the sensor's semantics to its
own integral, sharing the worker's interval lookup, and the carry is a
``[R, C]`` channel matrix (the D rails plus a dedicated total channel,
see :func:`num_channels`). Scalar timelines keep the flat ``[W, ·]``
layout and 1-D statistics.

The multi-worker combination pipeline (``run_combo_pipeline``) is not
ported yet.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from repro_torch.convert import resolve_device
from repro_torch.core import threefry
from repro_torch.core.sensors import (DEFAULT_IDLE_POWER, SensorSpec,
                                      _TraceSensorBase, idle_channel)
from repro_torch.core.streaming import channels_for
from repro_torch.core.timeline import Timeline
from repro_torch.kernels.sample_attr.ops import make_carry_update

__all__ = [
    "DeviceTimeline", "PipelineResult", "chunk_sample_times",
    "num_chunks", "num_channels", "run_region_pipeline",
    "reference_region_pipeline",
]

DEFAULT_CHUNK = 65536


# ---------------------------------------------------------------------------
# Device timeline substrate.
# ---------------------------------------------------------------------------


_GRID_OVERSAMPLE = 4        # grid cells per interval (amortizes window K)
_GRID_MAX = 1 << 20
# Heavy-tailed durations (one long interval + many micro-intervals) can
# concentrate intervals in one grid cell; past this window the compare
# window loses to a plain O(log m) binary search, so grid_k = 0
# (sentinel) routes lookups to torch.searchsorted instead.
_GRID_K_MAX = 32


@dataclasses.dataclass(frozen=True)
class DeviceTimeline:
    """Piecewise-constant traces as tensors on one device, batched over
    workers.

    Ragged workers are padded to a common interval count ``M``: ``ends``
    and ``bounds`` pad with ``+inf``, value arrays pad with zeros, and
    ``m_true`` carries each worker's valid interval count so lookups clip
    per worker exactly like the host path clips to its own length.

    The power substrate is per-rail: multi-domain timelines carry
    ``powers``/``eint`` with a domain axis ``[W, D, ·]``; scalar (D=1)
    timelines keep the flat ``[W, ·]`` layout. Interval structure (ends,
    bounds, region ids and the grid accelerator) never has a domain axis:
    all rails of a worker share one clock.

    ``grid``/``cell``/``grid_k`` form the lookup accelerator: per worker,
    ``grid[g] = #(ends ≤ g·cell)`` on a uniform time grid, with ``grid_k``
    the maximum interval count of any cell. An interval lookup is then one
    grid gather plus ``grid_k`` consecutive compares — exactly
    ``searchsorted(side="right")``. Because ``bounds = [0, ends...]``, the
    energy-interpolation index derives from the same count.
    """

    ends: torch.Tensor        # f64 [W, M]   interval end times, +inf padded
    bounds: torch.Tensor      # f64 [W, M+1] [0, ends...], +inf padded
    eint: torch.Tensor        # f64 [W, M+1] (D=1) | [W, D, M+1]
    powers: torch.Tensor      # f64 [W, M] (D=1) | [W, D, M], 0 padded
    region_ids: torch.Tensor  # i32 [W, M]   region per interval, 0 padded
    m_true: torch.Tensor      # i32 [W]      valid interval count per worker
    grid: torch.Tensor        # i32 [W, G+2] #(ends ≤ g·cell) per grid point
    cell: torch.Tensor        # f64 [W]      grid cell width (span / G)
    grid_k: int               # max intervals per grid cell (0: search)
    t_end: float              # profiled horizon: min worker t_exec
    num_regions: int
    names: tuple[str, ...]
    domains: tuple[str, ...] = ("total",)   # rail axis names

    @property
    def num_workers(self) -> int:
        return self.ends.shape[0]

    @property
    def num_domains(self) -> int:
        return len(self.domains)

    @property
    def device(self) -> torch.device:
        return self.ends.device

    @classmethod
    def from_timelines(cls, timelines: list[Timeline],
                       device="cuda") -> "DeviceTimeline":
        dev = resolve_device(device)
        if not timelines:
            raise ValueError("need at least one timeline")
        names = timelines[0].names
        domains = timelines[0].domain_names
        for tl in timelines:
            if tl.names != names:
                raise ValueError("workers must share a region name space")
            if tl.domain_names != domains:
                raise ValueError(
                    f"workers must share a power-rail domain axis; got "
                    f"{tl.domain_names} vs {domains}")
            if len(tl.region_ids) == 0:
                raise ValueError("empty timeline")
            if tl.t_exec <= 0.0:
                raise ValueError("zero-length timeline")
        W = len(timelines)
        D = len(domains)
        M = max(len(tl.region_ids) for tl in timelines)
        G = int(min(_GRID_OVERSAMPLE * M, _GRID_MAX))
        ends = np.full((W, M), np.inf)
        bounds = np.full((W, M + 1), np.inf)
        eint = np.zeros((W, M + 1) if D == 1 else (W, D, M + 1))
        powers = np.zeros((W, M) if D == 1 else (W, D, M))
        rids = np.zeros((W, M), np.int32)
        m_true = np.array([len(tl.region_ids) for tl in timelines], np.int32)
        grid = np.zeros((W, G + 2), np.int32)
        cell = np.zeros(W)
        grid_k = 1
        for w, tl in enumerate(timelines):
            m = int(m_true[w])
            ends[w, :m] = tl.ends
            bounds[w, 0] = 0.0
            bounds[w, 1:m + 1] = tl.ends
            if D == 1:
                eint[w, 1:m + 1] = tl.energy_integral()
                powers[w, :m] = tl.powers
            else:
                eint[w, :, 1:m + 1] = tl.rail_energy_integral().T
                powers[w, :, :m] = tl.rails().T
            rids[w, :m] = tl.region_ids
            cell[w] = tl.t_exec / G
            # Same f64 products the lookup guard computes (g · cell), so
            # grid[g] is exact for the comparisons the lookup performs.
            pts = np.arange(G + 2, dtype=np.float64) * cell[w]
            grid[w] = np.searchsorted(tl.ends, pts, side="right")
            grid_k = max(grid_k, int(np.diff(grid[w]).max()))
        if grid_k > _GRID_K_MAX:
            grid_k = 0      # searchsorted route (see _count_le)

        def put(a):
            return torch.from_numpy(a).to(dev)
        return cls(ends=put(ends), bounds=put(bounds), eint=put(eint),
                   powers=put(powers), region_ids=put(rids),
                   m_true=put(m_true), grid=put(grid), cell=put(cell),
                   grid_k=grid_k,
                   t_end=float(min(tl.t_exec for tl in timelines)),
                   num_regions=len(names), names=names, domains=domains)

    def arrays(self):
        return (self.ends, self.bounds, self.eint, self.powers,
                self.region_ids, self.m_true, self.grid, self.cell)


@dataclasses.dataclass(frozen=True)
class PipelineResult:
    """Final sufficient statistics of one run (host numpy).

    ``psum``/``psumsq`` are the scalar (rail-summed) statistics — for
    D=1 runs the single rail itself. ``rail_psum``/``rail_psumsq`` carry
    the per-domain decomposition ``[R, D]`` aligned with ``domains``.
    """

    counts: np.ndarray     # int64 [R]
    psum: np.ndarray       # float64 [R]
    psumsq: np.ndarray     # float64 [R]
    n: int                 # total valid samples
    t_exec: float          # measured horizon incl. suspension overhead
    rail_psum: np.ndarray | None = None     # float64 [R, D]
    rail_psumsq: np.ndarray | None = None   # float64 [R, D]
    domains: tuple[str, ...] = ("total",)


def num_channels(num_domains: int) -> int:
    """Statistic channels for a D-rail run (:func:`channels_for`): the
    rails plus, when D > 1, a dedicated total-power channel (Σpow² of the
    total is not derivable from per-rail Σpow²)."""
    return channels_for(num_domains)


def _result_from_channels(counts, chan_psum, chan_psumsq, n, t_exec,
                          domains) -> PipelineResult:
    """Split a channel carry into (rail, scalar-total) statistics; the
    last channel is the total (at D = 1 also the only rail)."""
    chan_psum = np.asarray(chan_psum, np.float64)
    chan_psumsq = np.asarray(chan_psumsq, np.float64)
    if chan_psum.ndim == 1:
        chan_psum = chan_psum[:, None]
        chan_psumsq = chan_psumsq[:, None]
    d = len(domains)
    return PipelineResult(counts=np.asarray(counts, np.int64),
                          psum=chan_psum[:, -1], psumsq=chan_psumsq[:, -1],
                          n=n, t_exec=t_exec,
                          rail_psum=chan_psum[:, :d],
                          rail_psumsq=chan_psumsq[:, :d],
                          domains=tuple(domains))


# ---------------------------------------------------------------------------
# Counter-based sample times (the chunk-step contract's time source).
# ---------------------------------------------------------------------------


_VELTKAMP = 134217729.0      # 2^27 + 1: splits a float64 into 26+27 bits


def _split(x):
    t = x * _VELTKAMP
    hi = t - (t - x)
    return hi, x - hi


def _fma(a: torch.Tensor, b: float, c: float) -> torch.Tensor:
    """``a·b + c`` rounded once, from plain float64 operations only.

    The reference's XLA CPU build contracts ``u0 + i·T`` and
    ``t·1e9 + 0.5`` into fused multiply-adds, so the clock needs one
    rounding in each, not two (at large sample indices the two differ in
    a sizeable share of the nanosecond-quantized times); torch
    promises no FMA on every device, so it is built from separate
    roundings, each its own torch operation (bit-identical on the CPU and
    the GPU): the exact product ``p + e`` (Dekker), the exact sum
    ``p + c = s + r`` (Knuth), and the tail ``r + e`` rounded to odd, so
    that the final ``s + tail`` rounds exactly as one FMA would.
    """
    p = a * b
    ah, al = _split(a)
    bh, bl = _split(b)
    e = al * bl - (((p - ah * bh) - al * bh) - ah * bl)
    s = p + c
    z = s - p
    r = (p - (s - z)) + (c - z)
    v = r + e
    z = v - r
    w = (r - (v - z)) + (e - z)
    even = (v.view(torch.int64) & 1) == 0
    toward = torch.where(w > 0, math.inf, -math.inf).to(v.dtype)
    v = torch.where((w != 0) & even, torch.nextafter(v, toward), v)
    return s + v


def _raw_chunk_times(root, u0: float, k: int, c: int, period: float,
                     jitter: float, device) -> torch.Tensor:
    """Chunk ``k``'s sample times: pure function of (key, k).

    ``t_i = u0 + i·T + u_i`` on an integer-nanosecond clock; ``u0`` is the
    run's phase draw (:func:`_phase`). ``k·c`` is a Python int, so sample
    indices past 2^31 do not wrap. ``u0 + i·T`` and the quantization's
    ``t·1e9 + 0.5`` are each one fused multiply-add (:func:`_fma`), as
    XLA compiles the reference on the CPU; every other step is one
    rounding, as there.
    """
    u = threefry.uniform(threefry.fold_in(root, k + 1), c, 0.0, jitter,
                         device=device)
    i = torch.arange(c, dtype=torch.int64, device=device) + k * c
    t = _fma(i.to(torch.float64), period, u0) + u
    return torch.floor(_fma(t, 1e9, 0.5)) * 1e-9


def _phase(root, period: float) -> float:
    """``u0 ~ U(0, T)`` from ``fold_in(root, 0)`` — one host draw per run."""
    return threefry.uniform_scalar(threefry.fold_in(root, 0), 0.0, period)


def chunk_sample_times(root, k: int, period: float, jitter: float, *,
                       chunk_size: int, device="cuda") -> torch.Tensor:
    """Public form of the time contract — ``root`` is
    ``threefry.PRNGKey(seed)``. The numpy oracle consumes exactly these
    times, so time generation is shared between the device path and its
    mirror."""
    dev = resolve_device(device)
    return _raw_chunk_times(root, _phase(root, period), k, chunk_size,
                            period, jitter, dev)


def num_chunks(t_end: float, period: float, chunk_size: int) -> int:
    """Chunks needed to cover the horizon: ``t_i ≥ i·T`` guarantees every
    sample of chunk ``k ≥ ceil(t_end/(c·T))`` lands past ``t_end``."""
    return max(int(math.ceil(t_end / (chunk_size * period))), 1)


# ---------------------------------------------------------------------------
# Device lookups + trace-sensor emulation (pure functions of the integral).
# ---------------------------------------------------------------------------


def _count_le(ends_w, grid_w, cell_w, t, k_max: int):
    """``#(ends ≤ t)`` per sample (int64) — ``searchsorted(side="right")``,
    but through the precomputed grid: locate the cell (with
    exact-comparison guards against division rounding), start from its
    prefix count, and add at most ``k_max`` consecutive compares, all in
    one gather. All comparisons are exact, so this is bit-equal to the
    numpy reference's searchsorted. ``k_max = 0`` means the durations
    were too heavy-tailed for a bounded window — use the binary search."""
    if k_max == 0:
        return torch.searchsorted(ends_w, t, right=True)
    G = grid_w.shape[0] - 2
    M = ends_w.shape[0]
    g = torch.floor(t / cell_w).to(torch.int64)
    g = g - (g.to(torch.float64) * cell_w > t).to(torch.int64)
    g = g + ((g + 1).to(torch.float64) * cell_w <= t).to(torch.int64)
    lo = grid_w[g.clamp(0, G)].to(torch.int64)
    pos = lo[:, None] + torch.arange(k_max, device=t.device)
    hit = (pos < M) & (ends_w[pos.clamp(max=M - 1)] <= t[:, None])
    return lo + hit.sum(dim=1)


def _interval(cnt, m_w):
    """Interval index ``clip(cnt, 0, m_w - 1)`` (``m_w`` a 0-d tensor)."""
    return torch.minimum(cnt.clamp(min=0), (m_w - 1).to(torch.int64))


def _energy_at_cnt(bounds_w, eint_w, powers_w, m_w, x, cnt):
    """Exact E(x) for piecewise-constant power (device twin of
    ``sensors._TraceSensorBase._energy_at``) given ``cnt = #(ends ≤ x)``;
    ``bounds = [0, ends...]`` makes the bounds index ``clip(cnt)``.
    Multi-rail ``eint_w``/``powers_w`` [D, ·] give [D, n]."""
    idx = _interval(cnt, m_w)
    return eint_w[..., idx] + (x - bounds_w[idx]) * powers_w[..., idx]


def _sensor_powers(spec: SensorSpec, arrs, t, cnt, valid, prev,
                   k_max: int):
    """One worker's sensor readings + updated RAPL prev-sample carry.

    ``arrs`` is the worker's row of :meth:`DeviceTimeline.arrays`. Scalar
    substrates return [c]; multi-rail substrates [D, c] — every rail
    applies the same instrument semantics to its own energy integral,
    sharing the interval count ``cnt`` (rails share the clock). ``prev``
    is a 0-d f64 tensor (< 0: no sample taken yet).
    """
    ends, bounds, eint, powers, rids, m_true, grid, cell = arrs

    def e_at(x, cnt_x=None):
        if cnt_x is None:
            cnt_x = _count_le(ends, grid, cell, x, k_max)
        return _energy_at_cnt(bounds, eint, powers, m_true, x, cnt_x)

    if spec.kind == "instant":
        return powers[..., _interval(cnt, m_true)], prev
    if spec.kind == "rapl":
        up = spec.update_period
        tq = torch.floor(t / up + 1e-6) * up
        # The prev chain is tq shifted by one sample, so E(prev) is e_q
        # shifted by one lane — one energy pass instead of two; only the
        # chain head (carry prev, or tq[0] - up on the very first sample)
        # needs its own tiny lookup.
        prev0 = torch.where(prev < 0.0, torch.clamp_min(tq[0] - up, 0.0),
                            prev).reshape(1)
        e_q = e_at(tq)
        e_prev = torch.cat([e_at(prev0), e_q[..., :-1]], dim=-1)
        dt = torch.clamp_min(tq - torch.cat([prev0, tq[:-1]]), up)
        new_prev = torch.where(valid, tq, -math.inf).max()
        new_prev = torch.where(valid.any(), new_prev, prev)
        return (e_q - e_prev) / dt, new_prev
    if spec.kind == "ina231":
        lo = torch.clamp_min(t - spec.window, 0.0)
        span = torch.clamp_min(t - lo, 1e-12)
        return (e_at(t, cnt) - e_at(lo)) / span, prev
    raise ValueError(f"unknown trace sensor kind: {spec.kind!r}")


def _chunk_samples(dtl: DeviceTimeline, spec: SensorSpec, root, u0: float,
                   k: int, c: int, period: float, jitter: float, prev):
    """One chunk of the single worker: times → region ids [c] → channel
    powers.

    Scalar substrates produce the power [c]; multi-rail substrates the
    [C, c] channel matrix — the rails plus the total (see
    :func:`num_channels`). Lanes past the horizon are flagged invalid and
    their times clipped to ``t_end`` so the sensor math stays finite
    (they contribute nothing downstream).
    """
    arrs = tuple(a[0] for a in dtl.arrays())
    ends, bounds, eint, powers, rids, m_true, grid, cell = arrs
    t_raw = _raw_chunk_times(root, u0, k, c, period, jitter, dtl.device)
    valid = t_raw < dtl.t_end
    t = torch.clamp_max(t_raw, dtl.t_end)
    cnt = _count_le(ends, grid, cell, t, dtl.grid_k)
    rid = rids[_interval(cnt, m_true)]
    chan, prev = _sensor_powers(spec, arrs, t, cnt, valid, prev, dtl.grid_k)
    if chan.ndim == 2:
        chan = torch.cat([chan, chan.sum(dim=0, keepdim=True)])
    return rid, chan, valid, prev


def _check_sampling_args(spec: SensorSpec, period: float, jitter: float):
    if period < spec.effective_min_period():
        raise ValueError(f"sampling period {period} below sensor minimum "
                         f"{spec.effective_min_period()}")
    if jitter > period:
        raise ValueError(
            f"device pipeline requires jitter <= period for a monotone "
            f"sample clock (RAPL differencing); got jitter={jitter}, "
            f"period={period}")


def _check_spec_domains(spec: SensorSpec, dtl: DeviceTimeline):
    """The sensor bank must have one channel per timeline rail."""
    if spec.num_domains != dtl.num_domains:
        raise ValueError(
            f"sensor bank has {spec.num_domains} channel(s) "
            f"{spec.domains} but the timeline carries "
            f"{dtl.num_domains} power rail(s) {dtl.domains}")


# ---------------------------------------------------------------------------
# Single-worker region pipeline: a chunk loop with a device-resident carry.
# ---------------------------------------------------------------------------


def _blend_idle(chan, frac: float, idle_power: float, idle_ch: int):
    """§4.7 suspension overhead: blend toward idle proportionally to the
    per-period suspension fraction. On the channel matrix the idle power
    lands on the package rail (``idle_ch``, located by name via
    :func:`repro_torch.core.sensors.idle_channel`) and on the total
    channel, so the scalar statistics see the same blend."""
    if chan.ndim == 1:
        return (1.0 - frac) * chan + frac * idle_power
    chan = (1.0 - frac) * chan
    chan[idle_ch] += frac * idle_power
    chan[-1] += frac * idle_power
    return chan


def run_region_pipeline(dtl: DeviceTimeline, spec: SensorSpec, *,
                        period: float, jitter: float = 200e-6, seed: int = 0,
                        chunk_size: int = DEFAULT_CHUNK,
                        overhead_per_sample: float = 0.0,
                        idle_power: float = DEFAULT_IDLE_POWER
                        ) -> PipelineResult:
    """Single-worker profiling run on ``dtl``'s device.

    Scans every chunk through the chunk step and folds into the
    device-resident (counts, Σpow, Σpow²) carry; only the final [R]
    statistics and the sample count are transferred back.
    :func:`reference_region_pipeline` is the exact numpy mirror.
    """
    _check_sampling_args(spec, period, jitter)
    _check_spec_domains(spec, dtl)
    if dtl.num_workers != 1:
        raise ValueError(f"region pipeline is single-worker; got "
                         f"W={dtl.num_workers} (the combination pipeline "
                         f"is not ported yet)")
    frac = min(overhead_per_sample / period, 1.0) \
        if overhead_per_sample > 0.0 else 0.0
    dev = dtl.device
    R = dtl.num_regions
    update = make_carry_update(R)
    n_chan = num_channels(spec.num_domains)
    idle_ch = idle_channel(spec.domains)
    stat_shape = (R,) if n_chan == 1 else (R, n_chan)
    counts = torch.zeros(R, dtype=torch.int64, device=dev)
    psum = torch.zeros(stat_shape, dtype=torch.float64, device=dev)
    psumsq = torch.zeros(stat_shape, dtype=torch.float64, device=dev)
    n = torch.zeros((), dtype=torch.int64, device=dev)
    prev = torch.full((), -1.0, dtype=torch.float64, device=dev)
    root = threefry.PRNGKey(seed)
    u0 = _phase(root, period)
    for k in range(num_chunks(dtl.t_end, period, chunk_size)):
        rid, chan, valid, prev = _chunk_samples(
            dtl, spec, root, u0, k, chunk_size, period, jitter, prev)
        if frac > 0.0:
            chan = _blend_idle(chan, frac, idle_power, idle_ch)
        update(counts, psum, psumsq, rid, chan, valid)
        n += valid.sum()
    n = int(n)
    if n == 0:
        raise ValueError("run too short for sampling period")
    return _result_from_channels(counts.cpu().numpy(), psum.cpu().numpy(),
                                 psumsq.cpu().numpy(), n,
                                 dtl.t_end + n * overhead_per_sample,
                                 dtl.domains)


# ---------------------------------------------------------------------------
# Numpy reference oracle (same sample clock, float64 host math).
# ---------------------------------------------------------------------------


def _ref_times(seed: int, k: int, period: float, jitter: float,
               chunk_size: int) -> np.ndarray:
    return chunk_sample_times(threefry.PRNGKey(seed), k, period, jitter,
                              chunk_size=chunk_size, device="cpu").numpy()


def _ref_reader(spec: SensorSpec, tl: Timeline):
    """Per-run chunk reader ``(t, valid, prev) -> (rails [n, D], new_prev)``.

    The instant/INA231 branches reuse the trace sensors' ``read_rails``
    (stateless semantics) so the oracle can't drift from the instrument
    model; the RAPL prev-sample state is carried by the caller because it
    crosses chunk boundaries.
    """
    if spec.kind == "instant":
        from repro_torch.core.sensors import InstantTraceSensor
        sens = InstantTraceSensor(tl)
        return lambda t, valid, prev: (sens.read_rails(t), prev)
    if spec.kind == "rapl":
        base = _TraceSensorBase(tl)
        up = spec.update_period

        def read(t, valid, prev):
            tq = np.floor(t / up + 1e-6) * up
            prev_vec = np.concatenate([[prev], tq[:-1]])
            prev_vec = np.where(prev_vec < 0.0, np.maximum(tq - up, 0.0),
                                prev_vec)
            dt = np.maximum(tq - prev_vec, up)
            p = (base._energy_rails_at(tq)
                 - base._energy_rails_at(prev_vec)) / dt[:, None]
            new_prev = float(tq[valid][-1]) if valid.any() else prev
            return p, new_prev
        return read
    if spec.kind == "ina231":
        from repro_torch.core.sensors import Ina231TraceSensor
        sens = Ina231TraceSensor(tl, window=spec.window)
        return lambda t, valid, prev: (sens.read_rails(t), prev)
    raise ValueError(f"unknown trace sensor kind: {spec.kind!r}")


def _ref_channels(rails: np.ndarray) -> np.ndarray:
    """[n, D] rails → [n, C] channels (total appended when D > 1)."""
    if rails.shape[1] == 1:
        return rails
    return np.concatenate([rails, rails.sum(axis=1, keepdims=True)], axis=1)


def reference_region_pipeline(tl: Timeline, spec: SensorSpec, *,
                              period: float, jitter: float = 200e-6,
                              seed: int = 0,
                              chunk_size: int = DEFAULT_CHUNK,
                              overhead_per_sample: float = 0.0,
                              idle_power: float = DEFAULT_IDLE_POWER
                              ) -> PipelineResult:
    """Numpy mirror of :func:`run_region_pipeline` (the oracle).

    Same counter-based times (shared :func:`chunk_sample_times`, drawn on
    the CPU), host ``searchsorted`` lookups, float64 sensor math,
    ``np.bincount`` reduction. Counts must match the device path exactly;
    sums agree to float64 rounding differences.
    """
    _check_sampling_args(spec, period, jitter)
    if spec.num_domains != tl.num_domains:
        raise ValueError(
            f"sensor bank has {spec.num_domains} channel(s) but the "
            f"timeline carries {tl.num_domains} power rail(s)")
    R = len(tl.names)
    C = num_channels(tl.num_domains)
    idle_ch = idle_channel(tl.domain_names)
    reader = _ref_reader(spec, tl)
    frac = min(overhead_per_sample / period, 1.0) \
        if overhead_per_sample > 0.0 else 0.0
    counts = np.zeros(R, np.int64)
    psum = np.zeros((R, C), np.float64)
    psumsq = np.zeros((R, C), np.float64)
    prev = -1.0
    t_end = tl.t_exec
    n = 0
    for k in range(num_chunks(t_end, period, chunk_size)):
        t_raw = _ref_times(seed, k, period, jitter, chunk_size)
        valid = t_raw < t_end
        t = np.minimum(t_raw, t_end)
        rids = tl.region_at(t)
        rails, prev = reader(t, valid, prev)
        chan = (1.0 - frac) * _ref_channels(rails)
        chan[:, idle_ch] += frac * idle_power
        if C > 1:
            chan[:, -1] += frac * idle_power
        rv, pv = rids[valid], chan[valid]
        counts += np.bincount(rv, minlength=R).astype(np.int64)
        for j in range(C):
            psum[:, j] += np.bincount(rv, weights=pv[:, j], minlength=R)
            psumsq[:, j] += np.bincount(rv, weights=pv[:, j] * pv[:, j],
                                        minlength=R)
        n += int(valid.sum())
    if n == 0:
        raise ValueError("run too short for sampling period")
    return _result_from_channels(counts, psum, psumsq, n,
                                 t_end + n * overhead_per_sample,
                                 tl.domain_names)
