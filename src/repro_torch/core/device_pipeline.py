"""Device-resident sampling→attribution pipeline (ALEA hot path).

PyTorch port of ``src/repro/core/device_pipeline.py``. The whole
per-chunk loop runs on the tensors' device (the GPU unless the caller
asks for the CPU):

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

* **Chunk step** — time generation, region lookup for every worker
  (``searchsorted(side="right")`` semantics through the grid
  accelerator; each step one torch operation over the [W, c] worker
  axis, so launches per chunk do not grow with W), trace-sensor
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
:func:`chunk_sample_times`. The clock has two routes that share no
arithmetic (:mod:`repro_torch.kernels.sample_clock`), chosen by the
device alone: on the CPU every product and sum is its own torch operation
and the two fused multiply-adds the reference's XLA build puts in the
clock are emulated exactly (``ref.py``); on a CUDA device one launch of
the ``sample_clock`` kernel draws the same threefry bits on ``uint32``
and takes the two products as hardware FMAs, with every other step one
explicit rounding, so a chunk's times on the GPU equal the CPU's bit for
bit. The interval lookup's grid route is likewise one launch of the
``count_le`` kernel on a CUDA device and its ``ref.py`` torch operations
on the CPU (:mod:`repro_torch.kernels.count_le`), equal counts either
way, and so is the RAPL and INA231 sensor stage: one launch of the
``trace_sensor`` kernel, which looks its own times up, or its ``ref.py``
(:mod:`repro_torch.kernels.trace_sensor`), equal readings either way.

**Power-rail domain axis.** Multi-domain timelines carry per-rail energy
integrals ``[W, D, ·]``; each rail applies the sensor's semantics to its
own integral, sharing the worker's interval lookup, and the carry is a
``[R, C]`` channel matrix (the D rails plus a dedicated total channel,
see :func:`num_channels`). Scalar timelines keep the flat ``[W, ·]``
layout and 1-D statistics.

* :func:`run_combo_pipeline` — multi-worker (§4.4) combination
  attribution: each sample's worker-region row is packed into int64 key
  words and found in a device-resident, lexicographically sorted
  combination table; chunks whose rows all hit fold through the same
  ``sample_attr`` kernel (ids = interner ids). A chunk holding an unseen
  combination raises a miss flag, read once per chunk; only then does
  the host replay that chunk, intern its rows
  (:class:`~repro_torch.core.streaming.CombinationInterner`), rebuild
  the table and fold the chunk through the kernel.
  :func:`reference_combo_pipeline` is its numpy oracle.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from repro_torch.convert import resolve_device
from repro_torch.core import spans, threefry
from repro_torch.core.faults import SketchConfigError
from repro_torch.core.sensors import (DEFAULT_IDLE_POWER, SensorSpec,
                                      _TraceSensorBase, idle_channel)
from repro_torch.core.sketch import other_row
from repro_torch.core.streaming import (CombinationInterner,
                                        StreamingCombinationAggregator,
                                        channels_for)
from repro_torch.core.timeline import Timeline
from repro_torch.kernels.count_le.ops import count_le
from repro_torch.kernels.sample_attr.ops import (make_carry_update,
                                                 sample_attr_fold)
from repro_torch.kernels.sample_clock.ops import sample_clock
from repro_torch.kernels.trace_sensor.ops import trace_sensor
from repro_torch.kernels.trace_sensor.ref import interval as _interval
from repro_torch.kernels.trace_sensor.ref import take as _take

__all__ = [
    "DeviceTimeline", "PipelineResult", "chunk_sample_times",
    "num_chunks", "num_channels", "run_region_pipeline",
    "run_combo_pipeline", "reference_region_pipeline",
    "reference_combo_pipeline",
]

DEFAULT_CHUNK = 65536
_TABLE_MIN = 64


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
        with spans.span("alea.upload"):
            return cls._upload(timelines, resolve_device(device))

    @classmethod
    def _upload(cls, timelines: list[Timeline], dev) -> "DeviceTimeline":
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
        with spans.span("alea.upload.build"):
            ends = np.full((W, M), np.inf)
            bounds = np.full((W, M + 1), np.inf)
            eint = np.zeros((W, M + 1) if D == 1 else (W, D, M + 1))
            powers = np.zeros((W, M) if D == 1 else (W, D, M))
            rids = np.zeros((W, M), np.int32)
            m_true = np.array([len(tl.region_ids) for tl in timelines],
                              np.int32)
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
                # Same f64 products the lookup guard computes (g · cell),
                # so grid[g] is exact for the comparisons the lookup
                # performs.
                pts = np.arange(G + 2, dtype=np.float64) * cell[w]
                grid[w] = np.searchsorted(tl.ends, pts, side="right")
                grid_k = max(grid_k, int(np.diff(grid[w]).max()))
            if grid_k > _GRID_K_MAX:
                grid_k = 0      # searchsorted route (see _count_le)

        host = dict(ends=ends, bounds=bounds, eint=eint, powers=powers,
                    region_ids=rids, m_true=m_true, grid=grid, cell=cell)
        with spans.span("alea.upload.copy"):
            spans.count("upload_bytes",
                        sum(a.nbytes for a in host.values()))
            put = {k: torch.from_numpy(a).to(dev) for k, a in host.items()}
        return cls(**put, grid_k=grid_k,
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


def _zero_carry(rows: int, n_chan: int, device):
    """A zero (counts [rows], Σpow, Σpow²) carry: statistics [rows] for
    one channel, [rows, n_chan] for more."""
    stat = (rows,) if n_chan == 1 else (rows, n_chan)
    return (torch.zeros(rows, dtype=torch.int64, device=device),
            torch.zeros(stat, dtype=torch.float64, device=device),
            torch.zeros(stat, dtype=torch.float64, device=device))


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


def _raw_chunk_times(root, u0: float, k: int, c: int, period: float,
                     jitter: float, device, t_end: float | None = None):
    """Chunk ``k``'s sample times: pure function of (key, k).

    ``t_i = u0 + i·T + u_i`` on an integer-nanosecond clock; ``u0`` is the
    run's phase draw (:func:`_phase`), ``u_i`` is drawn under
    ``fold_in(root, k + 1)``. ``k·c`` is a Python int, so sample indices
    past 2^31 do not wrap. With ``t_end``, returns ``(t clamped to t_end,
    t < t_end)``: the whole clock stage of a chunk. On a CUDA device this
    is one launch of the ``sample_clock`` kernel; on the CPU the plain
    torch operations of its ``ref.py``, which draw JAX's bits
    (:func:`repro_torch.kernels.sample_clock.ops.sample_clock`).
    """
    return sample_clock(root, k, c, period, u0, jitter, t_end, device=device)


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


def _count_le(ends, grid, cell, t, k_max: int):
    """``#(ends ≤ t)`` per worker and sample, [W, n] int64 — ``ends``
    [W, M], ``grid`` [W, G+2] and ``cell`` [W] of every worker against
    the times ``t`` [n] they share. ``searchsorted(side="right")``, but
    through the precomputed grid: locate the cell (with exact-comparison
    guards against division rounding), start from its prefix count, and
    add at most ``k_max`` consecutive compares
    (:func:`repro_torch.kernels.count_le.ops.count_le`: on a CUDA device
    one launch of the ``count_le`` kernel, whose working set is its
    output whatever ``k_max``; on the CPU the torch operations of its
    ``ref.py``, one per step over all workers). All comparisons are
    exact, so this is bit-equal to the numpy reference's searchsorted.
    ``k_max = 0`` means the durations were too heavy-tailed for a
    bounded window: ``count_le`` then takes the binary search. Counts the
    worker-lanes looked up (``lookup_lanes``) on the open record."""
    spans.count("lookup_lanes", ends.shape[0] * t.shape[0])
    return count_le(ends, grid, cell, t, k_max)


def _sensor_powers(spec: SensorSpec, arrs, t, cnt, valid, prev,
                   k_max: int):
    """Every worker's sensor readings + updated RAPL prev-sample carry.

    ``arrs`` is :meth:`DeviceTimeline.arrays`; ``t`` [c] is the clock
    all workers share and ``cnt`` [W, c] its interval counts. Scalar
    substrates return [W, c]; multi-rail substrates [W, D, c] — every
    rail applies the same instrument semantics to its own energy
    integral, sharing its worker's interval count (rails share the
    clock). ``prev`` is one 0-d f64 tensor for every worker and rail
    (< 0: no sample taken yet): they share the sample clock, so the RAPL
    differencing chain has one prev time whatever W or D. RAPL and
    INA231 go through :func:`repro_torch.kernels.trace_sensor.ops.
    trace_sensor` (on a CUDA device one launch of the ``trace_sensor``
    kernel, which looks its own times up; on the CPU the torch
    operations of its ``ref.py``); the record counts the worker-lanes
    read (``sensor_lanes``) and looked up (``lookup_lanes``: RAPL's
    quantised times and its chain head, INA231's window starts).
    """
    ends, bounds, eint, powers, rids, m_true, grid, cell = arrs
    if spec.kind == "instant":
        return _take(powers, _interval(cnt, m_true)), prev
    if spec.kind not in ("rapl", "ina231"):
        raise ValueError(f"unknown trace sensor kind: {spec.kind!r}")
    rapl = spec.kind == "rapl"
    W, c = cnt.shape
    spans.count("sensor_lanes", W * c)
    spans.count("lookup_lanes", W * c + (W if rapl else 0))
    return trace_sensor(spec.kind,
                        spec.update_period if rapl else spec.window, t, cnt,
                        valid, prev, ends, bounds, eint, powers, m_true, grid,
                        cell, k_max)


def _chunk_samples(dtl: DeviceTimeline, spec: SensorSpec, root, u0: float,
                   k: int, c: int, period: float, jitter: float, prev):
    """One chunk of every worker: times → region ids [W, c] → channel
    powers.

    Scalar substrates produce the worker-summed power [c]; multi-rail
    substrates the [C, c] channel matrix — the worker-summed rails plus
    the total (see :func:`num_channels`). At W = 1 the worker axis is
    dropped by a view, not summed, so the single-worker chunk is the same
    arithmetic and the same launches as before the worker axis existed.
    Lanes past the horizon are flagged invalid and their times clipped to
    ``t_end`` so the sensor math stays finite (they contribute nothing
    downstream).
    """
    arrs = dtl.arrays()
    ends, bounds, eint, powers, rids, m_true, grid, cell = arrs
    with spans.span("alea.clock"):
        t, valid = _raw_chunk_times(root, u0, k, c, period, jitter,
                                    dtl.device, dtl.t_end)
    with spans.span("alea.lookup"):
        cnt = _count_le(ends, grid, cell, t, dtl.grid_k)
        rid_mat = torch.gather(rids, 1, _interval(cnt, m_true))
    with spans.span("alea.sensor"):
        pows, prev = _sensor_powers(spec, arrs, t, cnt, valid, prev,
                                    dtl.grid_k)
        chan = pows[0] if pows.shape[0] == 1 else pows.sum(dim=0)
        if chan.ndim == 2:
            chan = torch.cat([chan, chan.sum(dim=0, keepdim=True)])
    return rid_mat, chan, valid, prev


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


def _region_step(carry, prev, dtl: DeviceTimeline, spec: SensorSpec,
                 update, root, u0: float, k: int, chunk_size: int,
                 period: float, jitter: float, frac: float,
                 idle_power: float, idle_ch: int):
    """One chunk of the region pipeline (the reference's ``fori_loop``
    body): chunk ``k``'s samples folded into ``carry`` = (counts, Σpow,
    Σpow², n), in place. Returns ``(carry, prev)``: the same four tensors
    and the RAPL prev sample after the chunk (a new tensor)."""
    counts, psum, psumsq, n = carry
    rid_mat, chan, valid, prev = _chunk_samples(
        dtl, spec, root, u0, k, chunk_size, period, jitter, prev)
    with spans.span("alea.fold"):
        if frac > 0.0:
            chan = _blend_idle(chan, frac, idle_power, idle_ch)
        update(counts, psum, psumsq, rid_mat[0], chan, valid)
        n += valid.sum()
    return carry, prev


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
                         f"W={dtl.num_workers} (use run_combo_pipeline)")
    frac = min(overhead_per_sample / period, 1.0) \
        if overhead_per_sample > 0.0 else 0.0
    with spans.record("region", seed=seed, workers=1,
                      chunk_size=chunk_size, lookup_window=dtl.grid_k), \
            spans.span("alea.pipeline", ranged=False):
        dev = dtl.device
        R = dtl.num_regions
        update = make_carry_update(R)
        idle_ch = idle_channel(spec.domains)
        carry = (*_zero_carry(R, num_channels(spec.num_domains), dev),
                 torch.zeros((), dtype=torch.int64, device=dev))
        prev = torch.full((), -1.0, dtype=torch.float64, device=dev)
        root = threefry.PRNGKey(seed)
        u0 = _phase(root, period)
        for k in range(num_chunks(dtl.t_end, period, chunk_size)):
            spans.count("chunks")
            carry, prev = _region_step(carry, prev, dtl, spec, update, root,
                                       u0, k, chunk_size, period, jitter,
                                       frac, idle_power, idle_ch)
        counts, psum, psumsq, n = carry
        with spans.span("alea.readback"):
            n = int(n)
            counts, psum, psumsq = (a.cpu().numpy()
                                    for a in (counts, psum, psumsq))
    if n == 0:
        raise ValueError("run too short for sampling period")
    return _result_from_channels(counts, psum, psumsq, n,
                                 dtl.t_end + n * overhead_per_sample,
                                 dtl.domains)


# ---------------------------------------------------------------------------
# Multi-worker combination pipeline: device table + host interner fallback.
# ---------------------------------------------------------------------------


def _word_weights(words: int, device):
    """``2^(words-1-j)`` for word j: the weights of :func:`_lex_less`."""
    return torch.tensor([1 << (words - 1 - j) for j in range(words)],
                        dtype=torch.int64, device=device)


def _lex_less(a, b, weight):
    """Row-wise lexicographic ``a < b`` for [n, words] int64 key matrices
    (keys below 2^62, the table padding int64-max, so ``a - b`` cannot
    overflow). One pass whatever the word count: the sign of each word's
    difference, weighted by :func:`_word_weights`, sums to a number whose
    sign is that of the first word that differs."""
    return (torch.sign(a - b) * weight).sum(dim=1) < 0


def _lex_search(table, n_rows: int, rows):
    """Lower-bound binary search of ``rows`` [c, words] in the lex-sorted
    ``table`` [cap, words] (first ``n_rows`` rows valid): ``bit_length(cap)``
    steps, each a handful of torch operations over all lanes. Returns
    (position [c] int64, found [c] bool)."""
    cap, words = table.shape
    c = rows.shape[0]
    weight = _word_weights(words, rows.device)
    lo = torch.zeros(c, dtype=torch.int64, device=rows.device)
    hi = torch.full((c,), n_rows, dtype=torch.int64, device=rows.device)
    for _ in range(int(cap).bit_length()):
        active = lo < hi
        mid = (lo + hi) >> 1
        # A full table (n_rows == cap) leaves finished lanes at mid == cap.
        less = active & _lex_less(table[mid.clamp(max=cap - 1)], rows,
                                  weight)
        lo = torch.where(less, mid + 1, lo)
        # A finished lane has lo == hi == mid, so it keeps its hi.
        hi = torch.where(less, hi, mid)
    pos = lo.clamp(0, cap - 1)
    found = (lo < n_rows) & (table[pos] == rows).all(dim=1)
    return pos, found


def _pack_spec(num_regions: int, width: int) -> tuple[int, int, int]:
    """(bits per region id, ids per word, words per row) for packing
    worker-region rows into int64 key words: always fewer columns than
    the raw [W] row, one scalar word whenever ``W·bits ≤ 62`` (≤ 62 so a
    real key never collides with the int64-max table padding)."""
    bits = max((num_regions - 1).bit_length(), 1)
    per = max(62 // bits, 1)
    n_words = -(-width // per)
    return bits, per, n_words


def _pack_rows_np(mat: np.ndarray, pack: tuple[int, int, int]) -> np.ndarray:
    """[n, W] host region-id rows → [n, n_words] int64 key words."""
    bits, per, n_words = pack
    w = mat.shape[1]
    out = np.zeros((len(mat), n_words), np.int64)
    for j in range(n_words):
        cols = mat[:, j * per:min((j + 1) * per, w)].astype(np.int64)
        shifts = np.arange(cols.shape[1], dtype=np.int64) * bits
        out[:, j] = (cols << shifts[None, :]).sum(axis=1)
    return out


def _pack_rows(rid_mat, pack: tuple[int, int, int]):
    """[W, c] device region-id matrix → [c, n_words] int64 key words, the
    words of :func:`_pack_rows_np`: the worker axis is zero-padded to
    ``n_words·per`` (a zero id shifted adds nothing) and every word is
    packed in the same few operations."""
    bits, per, n_words = pack
    w, c = rid_mat.shape
    per = min(per, w)
    cols = rid_mat.to(torch.int64)
    if n_words * per > w:
        cols = torch.cat([cols, cols.new_zeros(n_words * per - w, c)])
    shifts = torch.arange(0, per * bits, bits, dtype=torch.int64,
                          device=rid_mat.device)
    packed = (cols.reshape(n_words, per, c) << shifts[:, None]).sum(dim=1)
    return packed.T.contiguous()


@dataclasses.dataclass(frozen=True)
class _ComboTable:
    """The device-side combination table: lex-sorted packed keys
    ``keys`` [cap, n_words] int64 (int64-max padded), sorted position →
    interner id ``ids`` [cap] int32 (the ids the fold takes), the valid
    row count, and the packing of its keys."""

    keys: torch.Tensor
    ids: torch.Tensor
    n_rows: int
    pack: tuple[int, int, int]

    def lookup(self, rid_mat):
        """Interner ids [c] int32 and hit flags [c] of the worker-region
        rows of ``rid_mat`` [W, c]: one ``searchsorted`` for one-word
        keys, :func:`_lex_search` for more."""
        keys = _pack_rows(rid_mat, self.pack)
        cap = self.keys.shape[0]
        if self.pack[2] == 1:
            flat, col = keys[:, 0], self.keys[:, 0]
            pos = torch.searchsorted(col, flat).clamp_(max=cap - 1)
            found = (pos < self.n_rows) & (col[pos] == flat)
        else:
            pos, found = _lex_search(self.keys, self.n_rows, keys)
        return self.ids[pos], found


def _build_table(interner: CombinationInterner, cap: int,
                 pack: tuple[int, int, int], device) -> _ComboTable:
    """The table of ``interner``'s rows at capacity ``cap`` on
    ``device``."""
    mat = interner.combo_matrix()
    k = len(mat)
    ids = np.zeros(cap, np.int32)
    table = np.full((cap, pack[2]), np.iinfo(np.int64).max, np.int64)
    if k:
        keys = _pack_rows_np(mat, pack)
        order = np.lexsort(keys.T[::-1])
        table[:k] = keys[order]
        ids[:k] = order
    return _ComboTable(torch.from_numpy(table).to(device),
                       torch.from_numpy(ids).to(device), k, pack)


def _table_cap(rows: int) -> int:
    """Table and carry capacity for ``rows`` combinations: a power of
    two, at least ``_TABLE_MIN``."""
    return max(_TABLE_MIN, 1 << (rows - 1).bit_length())


def _admit_or_fold(rows: np.ndarray, interner: CombinationInterner,
                   other_by_region: dict, max_combinations: int,
                   width: int) -> tuple[np.ndarray, int]:
    """Bounded tier of the miss path: intern new rows while fewer than
    ``max_combinations`` identified rows exist; later arrivals fold into
    their region's ``other`` sentinel row, so the table and carry stop
    growing. Folded keys stay out of the device table — their traffic
    keeps re-missing — but each miss lands here and folds exactly once
    per sample, so nothing is lost. Returns (ids [n], samples folded)."""
    uniq, inverse = np.unique(rows, axis=0, return_inverse=True)
    inverse = inverse.reshape(-1)
    uids = np.empty(len(uniq), np.int64)
    folded = 0
    for i in range(len(uniq)):
        key = tuple(int(v) for v in uniq[i])
        cid = interner.find_row(uniq[i])
        if cid is None:
            if len(interner) - len(other_by_region) < max_combinations:
                cid = interner.intern(key)
            else:
                region = key[0]
                cid = other_by_region.get(region)
                if cid is None:
                    cid = interner.intern(other_row(region, width))
                    other_by_region[region] = cid
                folded += int(np.sum(inverse == i))
        uids[i] = cid
    return uids[inverse], folded


def _combo_step(carry, prev, table: _ComboTable, dtl: DeviceTimeline,
                spec: SensorSpec, root, u0: float, k: int, chunk_size: int,
                period: float, jitter: float):
    """The hit path of one combination-pipeline chunk (the reference's
    ``_combo_step_fn``): chunk ``k``'s worker-region rows looked up in
    ``table`` and, when every in-horizon row hits, folded into ``carry``
    = (counts, Σpow, Σpow², n) in place. Returns ``(carry, prev, miss)``:
    the same four tensors, the RAPL prev sample after the chunk (a new
    tensor; ``prev`` itself is not written, so a miss can replay the
    chunk from it) and the miss flag, read on the host (the chunk's one
    wait for the device)."""
    counts, psum, psumsq, n = carry
    rid_mat, chan, valid, prev = _chunk_samples(
        dtl, spec, root, u0, k, chunk_size, period, jitter, prev)
    with spans.span("alea.search"):
        ids, found = table.lookup(rid_mat)
        # Any in-horizon row missing from the table aborts the device
        # fold for the WHOLE chunk, so no sample is ever half-counted.
        any_miss = (valid & ~found).any()
        fold = valid & found & ~any_miss
    with spans.span("alea.fold"):
        sample_attr_fold(counts, psum, psumsq, ids, chan, fold)
        n += fold.sum()
    with spans.span("alea.miss_flag"):
        miss = bool(any_miss)
    return carry, prev, miss


def _combo_fold(carry, idx, pows, valid):
    """The miss path's fold (the reference's ``_combo_fold``): interner
    ids ``idx`` [c] int32 (``cap`` past the end for lanes out of the
    horizon) and channel powers ``pows`` folded into ``carry`` = (counts,
    Σpow, Σpow², n) in place; returns it."""
    counts, psum, psumsq, n = carry
    with spans.span("alea.fold"):
        sample_attr_fold(counts, psum, psumsq, idx, pows, valid)
        n += valid.sum()
    return carry


def run_combo_pipeline(dtl: DeviceTimeline, spec: SensorSpec, *,
                       period: float, jitter: float = 200e-6, seed: int = 0,
                       chunk_size: int = DEFAULT_CHUNK,
                       max_combinations: int | None = None,
                       stats: dict | None = None
                       ) -> tuple[StreamingCombinationAggregator, int]:
    """Multi-worker (§4.4) combination attribution on ``dtl``'s device.

    Each chunk's [W, c] worker-region rows are packed into int64 key
    words and looked up in the device-side lex-sorted combination table;
    every sample of a chunk whose rows all hit folds through the
    ``sample_attr`` kernel (ids = the rows' interner ids) into the
    device carry. One scalar miss flag is read back per chunk. A chunk
    that surfaces a new combination folds nothing on that pass: the host
    replays it (counter-based times make the replay exact, from the
    RAPL prev sample as it stood before the chunk), interns its rows
    (the id space is dynamic and first-appearance-ordered —
    host-authoritative), grows the carry to the next power of two,
    rebuilds and re-uploads the table, and folds the chunk through the
    same kernel. With a stable combination set that happens
    O(distinct combinations / chunk) times in all.

    ``max_combinations`` bounds the attribution state (heavy-hitters
    tier, :mod:`repro_torch.core.sketch`): the miss path admits new
    combinations while fewer than ``max_combinations`` identified rows
    exist and folds later arrivals into their region's ``other`` row;
    per-region sample counts stay exact, tail identity coarsens. With
    ``max_combinations >= distinct`` the result is the unbounded run's.

    Returns ``(aggregator, n_samples)``; ``stats``, if given, records
    ``chunks``, ``miss_chunks`` and ``miss_seconds`` (host wall time in
    the miss path, which queues the miss fold but does not wait for it:
    the ``alea.miss`` span of the profile's :mod:`~repro_torch.core.spans`
    record) plus, in bounded mode, ``tail_folds``: this call's share of
    the record, if one was open around it.
    :func:`reference_combo_pipeline` is the numpy mirror.
    """
    _check_sampling_args(spec, period, jitter)
    _check_spec_domains(spec, dtl)
    W = dtl.num_workers
    if max_combinations is not None:
        if max_combinations < 1:
            raise ValueError(f"max_combinations must be >= 1; "
                             f"got {max_combinations}")
        if W < 2:
            raise SketchConfigError(
                "bounded combination attribution needs >= 2 workers (the "
                "region axis plus at least one folded axis); at W=1 use "
                "the region pipeline")
    counted = ("chunks", "miss_chunks") + (
        () if max_combinations is None else ("tail_folds",))
    with spans.record("combination", seed=seed, workers=W,
                      chunk_size=chunk_size, lookup_window=dtl.grid_k), \
            spans.fill_stats(stats, counters=counted,
                             seconds=dict(miss_seconds="alea.miss")), \
            spans.span("alea.pipeline", ranged=False):
        agg, n = _combo_chunks(dtl, spec, period, jitter, seed, chunk_size,
                               max_combinations)
    if n == 0:
        raise ValueError("run too short for sampling period")
    return agg, n


def _combo_chunks(dtl: DeviceTimeline, spec: SensorSpec, period: float,
                  jitter: float, seed: int, chunk_size: int,
                  max_combinations: int | None):
    """The chunk loop, read-back and table of :func:`run_combo_pipeline`:
    ``(aggregator, n)``, the aggregator None when no sample was taken."""
    W = dtl.num_workers
    dev = dtl.device
    n_chan = num_channels(dtl.num_domains)
    pack = _pack_spec(dtl.num_regions, W)
    interner = CombinationInterner()
    other_by_region: dict[int, int] = {}
    tail_folds = 0
    cap = _TABLE_MIN
    table = _build_table(interner, cap, pack, dev)
    carry = (*_zero_carry(cap, n_chan, dev),
             torch.zeros((), dtype=torch.int64, device=dev))
    prev = torch.full((), -1.0, dtype=torch.float64, device=dev)
    root = threefry.PRNGKey(seed)
    u0 = _phase(root, period)
    for k in range(num_chunks(dtl.t_end, period, chunk_size)):
        spans.count("chunks")
        prev_in = prev      # never written in place: the replay's start
        carry, prev, miss = _combo_step(carry, prev, table, dtl, spec, root,
                                        u0, k, chunk_size, period, jitter)
        if not miss:
            continue
        spans.count("miss_chunks")
        with spans.span("alea.miss"):
            rid_mat, chan, valid, _ = _chunk_samples(
                dtl, spec, root, u0, k, chunk_size, period, jitter, prev_in)
            valid_h = valid.cpu().numpy()
            rows = rid_mat.cpu().numpy().T[valid_h].astype(np.int64)
            spans.count("miss_rows", len(rows))
            if max_combinations is None:
                cids = interner.encode(rows)
            else:
                cids, folded = _admit_or_fold(rows, interner,
                                              other_by_region,
                                              max_combinations, W)
                tail_folds += folded
                spans.count("tail_folds", folded)
            if len(interner) > cap:
                new_cap = _table_cap(len(interner))
                pad = _zero_carry(new_cap - cap, n_chan, dev)
                carry = (*(torch.cat([a, b]) for a, b in zip(carry, pad)),
                         carry[3])
                cap = new_cap
            table = _build_table(interner, cap, pack, dev)
            idx = np.full(chunk_size, cap, np.int32)
            idx[valid_h] = cids
            carry = _combo_fold(carry, torch.from_numpy(idx).to(dev), chan,
                                valid)
    counts, psum, psumsq, n = carry
    k_combos = len(interner)
    with spans.span("alea.readback"):
        n = int(n)
        counts, psum, psumsq = (a[:k_combos].cpu().numpy()
                                for a in (counts, psum, psumsq))
    if n == 0:
        return None, n
    with spans.span("alea.estimate"):
        agg = StreamingCombinationAggregator.from_table(
            interner.combo_matrix(), counts, psum, psumsq,
            domains=dtl.domains, k=max_combinations)
    if max_combinations is not None:
        # from_table re-counts nothing; carry the pipeline's fold
        # provenance so tail_info() discloses what happened on device.
        agg.tail_folds += tail_folds
    return agg, n


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


def reference_combo_pipeline(timelines: list[Timeline], spec_fn, *,
                             period: float, jitter: float = 200e-6,
                             seed: int = 0,
                             chunk_size: int = DEFAULT_CHUNK
                             ) -> tuple[StreamingCombinationAggregator, int]:
    """Numpy mirror of :func:`run_combo_pipeline` (the oracle).

    ``spec_fn`` maps a timeline to its :class:`SensorSpec` (matching the
    device path's one-spec-for-all, pass ``lambda tl: spec``). Chunks are
    interned through a host :class:`CombinationInterner` exactly as the
    device path's miss fallback does, so combination ids line up 1:1.
    """
    specs = [spec_fn(tl) for tl in timelines]
    for s, tl in zip(specs, timelines):
        _check_sampling_args(s, period, jitter)
        if s.num_domains != tl.num_domains:
            raise ValueError("sensor bank / timeline rail count mismatch")
    domains = timelines[0].domain_names
    if any(tl.domain_names != domains for tl in timelines):
        raise ValueError("workers must share a power-rail domain axis")
    readers = [_ref_reader(s, tl) for s, tl in zip(specs, timelines)]
    t_end = min(tl.t_exec for tl in timelines)
    agg = StreamingCombinationAggregator(domains=domains)
    prev = -1.0
    n = 0
    for k in range(num_chunks(t_end, period, chunk_size)):
        t_raw = _ref_times(seed, k, period, jitter, chunk_size)
        valid = t_raw < t_end
        t = np.minimum(t_raw, t_end)
        rid_mat = np.stack([tl.region_at(t) for tl in timelines], axis=1)
        rails = np.zeros((len(t), len(domains)), np.float64)
        new_prev = prev
        for reader in readers:
            p, new_prev = reader(t, valid, prev)
            rails += p
        prev = new_prev
        pv = rails[valid]
        agg.update(rid_mat[valid].astype(np.int64),
                   pv[:, 0] if len(domains) == 1 else pv)
        n += int(valid.sum())
    if n == 0:
        raise ValueError("run too short for sampling period")
    return agg, n
