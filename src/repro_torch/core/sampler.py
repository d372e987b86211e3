"""Systematic sampling (paper §4.6-§4.8).

Two samplers:

* :func:`sample_timeline` — vectorized systematic sampling of a synthesized
  :class:`Timeline`: sample times start at U(0, T) and advance by T plus a
  random timer-jitter term (the paper observes up to hundreds of µs of
  natural jitter, which is what makes systematic sampling safe against
  periodic aliasing — §4.6). Optional per-sample *suspension overhead*
  models ptrace-style stop-the-world reads (§4.7/§4.8): each sample
  stretches the interval it lands in by ``overhead_per_sample`` seconds of
  near-idle execution, biasing measured t_exec exactly as in Figures 4/5.

* :class:`HostSampler` — a real control thread (the §4.8 'separate control
  process'): the profiled program only updates a shared region marker; the
  thread samples (marker, sensor) pairs at the configured period without
  suspending the program.
"""

from __future__ import annotations

import dataclasses
import sys
import threading
import time
from typing import Callable

import numpy as np

from repro_torch.core.faults import declare_site
from repro_torch.core.sensors import DEFAULT_IDLE_POWER, idle_channel
from repro_torch.core.timeline import Timeline

__all__ = ["SampleStream", "sample_timeline", "iter_sample_chunks",
           "iter_multiworker_chunks", "sample_timeline_multiworker",
           "HostSampler", "RegionMarker", "SampleBuffer"]

# Injection seam this module owns (see faults.FAULT_SITES): the
# HostSampler control thread (sampler_fail_after thread death).
_SITE_SAMPLER_LOOP = declare_site("sampler.loop")


@dataclasses.dataclass
class SampleStream:
    """Output of one profiling pass."""

    region_ids: np.ndarray   # [n] (or [n, workers] for multi-worker runs)
    powers: np.ndarray       # [n]
    t_exec: float            # measured wall time of the profiled run
    n: int
    overhead_time: float = 0.0   # systematic-error component (for reporting)


def _sample_times(t_end: float, period: float, jitter: float,
                  rng: np.random.Generator) -> np.ndarray:
    """Systematic sample times with uniform timer jitter, first at U(0,T)."""
    n_max = int(t_end / period) + 2
    deltas = period + rng.uniform(0.0, jitter, size=n_max)
    t = rng.uniform(0.0, period) + np.cumsum(deltas) - deltas[0]
    return t[t < t_end]


def sample_timeline(tl: Timeline, sensor, *, period: float,
                    jitter: float = 200e-6, overhead_per_sample: float = 0.0,
                    idle_power: float = DEFAULT_IDLE_POWER, seed: int = 0,
                    deliberate_alias: bool = False) -> SampleStream:
    """One-pass systematic sampling of a synthesized timeline.

    Args:
      sensor: a trace sensor over ``tl`` (``read_many``/``read``).
      period: sampling period T [s] (paper default 10 ms).
      jitter: uniform upper bound of per-sample timer jitter [s]. Set to 0
        together with ``deliberate_alias`` in tests to *demonstrate* the
        aliasing pathology of exact systematic sampling.
      overhead_per_sample: suspension cost per sample [s]; models the
        ptrace-style control-process read. The profiled run's measured
        t_exec inflates by n·overhead and sampled power during suspension
        windows is near idle, producing the systematic error term of §4.7.
    """
    rng = np.random.default_rng(seed)
    if period < getattr(sensor, "min_period", 0.0):
        raise ValueError(
            f"sampling period {period} below sensor minimum "
            f"{sensor.min_period}")
    if deliberate_alias:
        jitter = 0.0
    times = _sample_times(tl.t_exec, period, jitter, rng)
    n = len(times)
    if n == 0:
        raise ValueError("run too short for sampling period")
    rids = tl.region_at(times)
    if hasattr(sensor, "read_many"):
        pows = np.asarray(sensor.read_many(times), dtype=np.float64)
    else:
        pows = np.asarray(sensor.read(times), dtype=np.float64)

    overhead_time = n * overhead_per_sample
    t_exec_measured = tl.t_exec + overhead_time
    if overhead_per_sample > 0.0:
        # During suspension the program makes no progress but the package
        # still burns near-idle power; RAPL-style differencing mixes that
        # into the sample. Blend proportionally to overhead per period.
        frac = min(overhead_per_sample / period, 1.0)
        pows = (1.0 - frac) * pows + frac * idle_power
    return SampleStream(region_ids=rids, powers=pows,
                        t_exec=t_exec_measured, n=n,
                        overhead_time=overhead_time)


class _ChunkedTimes:
    """Systematic sample-time generator emitting bounded chunks.

    Same process as :func:`_sample_times` (first sample at U(0, T), then
    advance by T + U(0, jitter)) but drawn ``chunk_size`` deltas at a time,
    so an arbitrarily long run needs O(chunk) memory for times.
    """

    def __init__(self, t_end: float, period: float, jitter: float,
                 rng: np.random.Generator, chunk_size: int):
        self._t_end = t_end
        self._period = period
        self._jitter = jitter
        self._rng = rng
        self._chunk = chunk_size
        self._next_t = float(rng.uniform(0.0, period))

    def __iter__(self):
        while self._next_t < self._t_end:
            deltas = self._period + self._rng.uniform(
                0.0, self._jitter, size=self._chunk)
            times = self._next_t + np.concatenate(
                [[0.0], np.cumsum(deltas[:-1])])
            self._next_t = float(times[-1] + deltas[-1])
            times = times[times < self._t_end]
            if len(times):
                yield times


def iter_sample_chunks(tl: Timeline, sensor, *, period: float,
                       jitter: float = 200e-6,
                       overhead_per_sample: float = 0.0,
                       idle_power: float = DEFAULT_IDLE_POWER, seed: int = 0,
                       chunk_size: int = 65536):
    """Streaming counterpart of :func:`sample_timeline`.

    Yields (region_ids, powers) chunks of ≤ ``chunk_size`` samples without
    ever materializing the full stream — feed to
    ``streaming.StreamingAggregator``. Draws a different (statistically
    equivalent) jitter sequence than the one-shot path for the same seed.
    """
    rng = np.random.default_rng(seed)
    if period < getattr(sensor, "min_period", 0.0):
        raise ValueError(f"sampling period {period} below sensor minimum "
                         f"{sensor.min_period}")
    frac = min(overhead_per_sample / period, 1.0) if overhead_per_sample > 0.0 \
        else 0.0
    # Multi-rail timelines read the sensor's whole channel bank — chunks
    # are then ([c], [c, D]) and the consuming aggregator keeps the
    # per-domain decomposition. Scalar timelines keep the 1-D contract.
    rails = tl.num_domains > 1 and hasattr(sensor, "read_rails")
    for times in _ChunkedTimes(tl.t_exec, period, jitter, rng, chunk_size):
        rids = tl.region_at(times)
        if rails:
            pows = np.asarray(sensor.read_rails(times), dtype=np.float64)
            bad = np.isnan(pows).any(axis=1)
            if bad.any():
                # A masked sensor channel (failover with no substitute,
                # cf. sensors.FailoverTraceBank) voids the whole sample:
                # dropping the row shrinks n — the CI widens honestly —
                # whereas imputing any value would bias that rail.
                keep = ~bad
                rids, pows = rids[keep], pows[keep]
                if not len(rids):
                    continue
        elif hasattr(sensor, "read_many"):
            pows = np.asarray(sensor.read_many(times), dtype=np.float64)
        else:
            pows = np.asarray(sensor.read(times), dtype=np.float64)
        if frac:
            pows = (1.0 - frac) * pows
            if pows.ndim == 2:
                # Suspension idle power lands on the package rail
                # (located by name), mirroring the device pipeline.
                pows[:, idle_channel(tl.domain_names)] += frac * idle_power
            else:
                pows = pows + frac * idle_power
        yield rids, pows


def iter_multiworker_chunks(timelines: list[Timeline], sensor_fn, *,
                            period: float, jitter: float = 200e-6,
                            seed: int = 0, chunk_size: int = 65536):
    """Streaming counterpart of :func:`sample_timeline_multiworker`.

    Yields ([c, workers] region-id matrices, [c] summed powers) chunks —
    feed to ``streaming.StreamingCombinationAggregator``.
    """
    rng = np.random.default_rng(seed)
    t_end = min(tl.t_exec for tl in timelines)
    sensors = [sensor_fn(tl) for tl in timelines]
    rails = (all(tl.num_domains > 1 for tl in timelines)
             and all(hasattr(s, "read_rails") for s in sensors))
    for times in _ChunkedTimes(t_end, period, jitter, rng, chunk_size):
        rid_mat = np.stack([tl.region_at(times) for tl in timelines], axis=1)
        if rails:
            total_power = sum(np.asarray(s.read_rails(times))
                              for s in sensors)
        else:
            total_power = sum(np.asarray(s.read_many(times)
                                         if hasattr(s, "read_many")
                                         else s.read(times))
                              for s in sensors)
        yield rid_mat, total_power


def sample_timeline_multiworker(timelines: list[Timeline], sensor_fn,
                                *, period: float, jitter: float = 200e-6,
                                seed: int = 0) -> SampleStream:
    """Sample W concurrent worker timelines simultaneously (§4.4).

    Each sample is a vector of region ids — one per worker — plus one shared
    package power reading (sum of per-worker powers + contention handled by
    the caller's power model when the timelines were synthesized).
    """
    rng = np.random.default_rng(seed)
    t_end = min(tl.t_exec for tl in timelines)
    times = _sample_times(t_end, period, jitter, rng)
    rid_mat = np.stack([tl.region_at(times) for tl in timelines], axis=1)
    total_power = sum(np.asarray(sensor_fn(tl).read_many(times)
                                 if hasattr(sensor_fn(tl), "read_many")
                                 else sensor_fn(tl).read(times))
                      for tl in timelines)
    return SampleStream(region_ids=rid_mat, powers=total_power,
                        t_exec=t_end, n=len(times))


# ---------------------------------------------------------------------------
# Host-mode control thread.
# ---------------------------------------------------------------------------


class RegionMarker:
    """Shared 'program counter' cell: region code writes, sampler reads.

    Reads/writes of a Python int are atomic under the GIL, so the profiled
    program's only instrumentation cost is one attribute store per region
    entry — the §4.8 design point (no sampling code on the critical path).
    """

    __slots__ = ("value",)

    def __init__(self):
        self.value = 0

    def set(self, region_id: int) -> None:
        self.value = region_id


class SampleBuffer:
    """Growable preallocated (region_id, power) buffer.

    The control thread's hot path is two array stores + an index bump —
    no per-sample Python object boxing or list resizing (paper's ~1%
    overhead budget, §4.8). Capacity doubles when full (amortized O(1)).
    ``drain()`` empties the buffer, so streaming consumers that drain
    periodically hold O(drain chunk) state — capacity is bounded by the
    largest inter-drain burst, not run length. The lock is uncontended
    except at drain points (≪ the ≥1 ms sampling period).

    ``channels > 1`` stores one power vector per sample (multi-rail host
    sensor banks, :class:`repro_torch.core.sensors.HostSensorBank`); drains
    then yield [n, channels] power matrices instead of [n] vectors.

    ``max_capacity`` bounds growth: once the buffer holds that many
    undrained samples, further appends are *dropped and counted*
    (:attr:`overruns`) instead of growing without bound — a consumer
    stalled for longer than the burst budget (e.g. a long prefill loop
    that never drains) loses the newest samples, never corrupts the
    stream, and the loss is observable. ``None`` (default) keeps the
    unbounded doubling behavior.
    """

    def __init__(self, capacity: int = 4096, channels: int = 1,
                 max_capacity: int | None = None):
        if channels < 1:
            raise ValueError(f"channels must be >= 1; got {channels}")
        if max_capacity is not None and max_capacity < 1:
            raise ValueError(
                f"max_capacity must be >= 1; got {max_capacity}")
        self.channels = channels
        cap = max(capacity, 16)
        if max_capacity is not None:
            cap = min(cap, max_capacity)
        self.max_capacity = max_capacity
        self._rids = np.empty(cap, dtype=np.int32)
        self._pows = np.empty((cap, channels), dtype=np.float64)
        self._n = 0
        self.overruns = 0
        self._lock = threading.Lock()

    def __len__(self) -> int:
        return self._n

    def append(self, rid: int, power) -> None:
        with self._lock:
            n = self._n
            if n == len(self._rids):
                if (self.max_capacity is not None
                        and n >= self.max_capacity):
                    self.overruns += 1
                    return
                grow = len(self._rids)
                if self.max_capacity is not None:
                    grow = min(grow, self.max_capacity - n)
                self._rids = np.concatenate(
                    [self._rids, np.empty(grow, dtype=self._rids.dtype)])
                self._pows = np.concatenate(
                    [self._pows,
                     np.empty((grow, self.channels),
                              dtype=self._pows.dtype)])
            self._rids[n] = rid
            self._pows[n] = power      # scalar broadcasts; vector stores
            self._n = n + 1

    def _pow_slice(self, n: int) -> np.ndarray:
        p = self._pows[:n]
        return p[:, 0].copy() if self.channels == 1 else p.copy()

    def view(self) -> tuple[np.ndarray, np.ndarray]:
        """All undrained samples (copies); does not advance the cursor."""
        with self._lock:
            return self._rids[:self._n].copy(), self._pow_slice(self._n)

    def drain(self) -> tuple[np.ndarray, np.ndarray]:
        """All undrained samples (copies); empties the buffer."""
        with self._lock:
            n = self._n
            out = self._rids[:n].copy(), self._pow_slice(n)
            self._n = 0
            return out


class HostSampler:
    """Control thread sampling (marker, sensor) at a jittered period.

    Failure semantics: the control thread runs as a daemon, so an
    exception inside it (a sensor read blowing up mid-session) would
    otherwise kill the thread silently and every later ``drain()`` would
    return empty forever — zero-sample estimates indistinguishable from
    a genuinely idle program. The loop therefore captures the exception
    and re-raises it on the *caller's* thread at the next ``drain()`` /
    ``stream()`` / session exit. Non-finite readings (a masked channel
    of a failing :class:`~repro_torch.core.sensors.HostSensorBank`) are not
    errors: the sample is skipped and counted in ``dropped_samples``.
    """

    def __init__(self, marker: RegionMarker, sensor, *, period: float,
                 jitter: float = 200e-6, seed: int = 0,
                 buffer_capacity: int | None = None,
                 faults: "object | None" = None):
        from repro_torch.core import faults as faults_mod
        self.marker = marker
        self.sensor = sensor
        # A banked sensor (``.domains``) reads one vector per sample; the
        # buffer stores it per channel and drains [n, D] power matrices.
        self.domains = tuple(getattr(sensor, "domains", ("total",)))
        self.period = period
        self.jitter = jitter
        self._rng = np.random.default_rng(seed)
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None
        self._buf = SampleBuffer(channels=len(self.domains),
                                 max_capacity=buffer_capacity)
        self._t0 = 0.0
        self._t1 = 0.0
        # Captured at construction: contextvars set by the caller are
        # invisible inside the control thread.
        self._faults = faults_mod.resolve_plan(faults)
        self._failure: BaseException | None = None
        self.dropped_samples = 0

    def _loop(self) -> None:
        try:
            self._loop_body()
        except BaseException as e:          # noqa: BLE001 — re-raised at drain
            self._failure = e

    def _loop_body(self) -> None:
        read = self.sensor.read
        append = self._buf.append
        marker = self.marker
        uniform = self._rng.uniform
        plan = self._faults
        taken = 0
        # Schedule against absolute deadlines: sleeping a fixed period
        # *after* read()/append() return would stretch the effective
        # period by the read cost every sample (systematic drift above
        # the configured rate). If a read overruns its deadline entirely,
        # rebase instead of bursting to catch up.
        scalar = not hasattr(self.sensor, "domains")
        next_t = time.monotonic()
        while not self._stop.is_set():
            if plan is not None and plan.sampler_should_fail(taken):
                raise RuntimeError(
                    f"injected sampler-thread fault after {taken} samples")
            v = float(read()) if scalar else read()
            taken += 1
            finite = np.isfinite(v) if scalar else bool(np.isfinite(v).all())
            if finite:
                append(marker.value, v)
            else:
                self.dropped_samples += 1
            next_t += self.period + float(uniform(0, self.jitter))
            delay = next_t - time.monotonic()
            if delay > 0:
                time.sleep(delay)
            else:
                next_t = time.monotonic()

    def _raise_failure(self) -> None:
        if self._failure is not None:
            failure, self._failure = self._failure, None
            raise failure

    def __enter__(self) -> "HostSampler":
        # CPython's default 5 ms GIL switch interval would let a CPU-bound
        # profiled region starve the control thread (the ptrace analogue
        # never has this problem since it runs in another process). Tighten
        # it for the session; restored on exit.
        self._old_switch = sys.getswitchinterval()
        sys.setswitchinterval(min(self._old_switch, self.period / 4.0))
        self._t0 = time.monotonic()
        self._thread = threading.Thread(target=self._loop, daemon=True,
                                        name="alea-control")
        self._thread.start()
        return self

    def __exit__(self, *exc) -> None:
        self._t1 = time.monotonic()
        self._stop.set()
        assert self._thread is not None
        self._thread.join(timeout=5.0)
        sys.setswitchinterval(self._old_switch)
        # Surface a control-thread death even from sessions that never
        # drain — but never mask an exception already unwinding the body.
        if not any(exc):
            self._raise_failure()

    def drain(self) -> tuple[np.ndarray, np.ndarray]:
        """New (region_ids, powers) since the last drain (streaming use).

        Empties the buffer — a session either drains periodically into a
        streaming aggregator or collects everything for :meth:`stream`;
        after any drain, ``stream()`` only covers the undrained tail.

        Raises the control thread's captured exception, if it died since
        the last call (each failure is raised exactly once).
        """
        self._raise_failure()
        return self._buf.drain()

    @property
    def buffer_overruns(self) -> int:
        """Samples dropped because the bounded buffer was full at append
        time (see :class:`SampleBuffer`). Always 0 when unbounded."""
        return self._buf.overruns

    @property
    def elapsed(self) -> float:
        """Session wall time so far (final once the sampler exits)."""
        end = self._t1 if self._t1 > self._t0 else time.monotonic()
        return end - self._t0

    def stream(self) -> SampleStream:
        self._raise_failure()
        if not len(self._buf):
            raise RuntimeError("no samples collected")
        rids, pows = self._buf.view()
        return SampleStream(region_ids=rids, powers=pows,
                            t_exec=self._t1 - self._t0, n=len(rids))
