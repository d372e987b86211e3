"""Power sensors with realistic sampling semantics (paper §3, §4.5).

Two families:

* **Trace sensors** read a synthesized :class:`~repro_torch.core.timeline.Timeline`
  with the *exact semantics of the paper's instruments*:

  - :class:`RaplTraceSensor` — integrating energy counter (Sandy Bridge
    RAPL): a sample at time t returns (E(t) − E(t_prev)) / (t − t_prev);
    counter contents update only every ``update_period`` (1 ms on SNB).
  - :class:`Ina231TraceSensor` — window-averaging power meter (Exynos
    INA231): a sample returns mean power over [t − window, t]; minimum
    feasible window 280 µs in the paper.
  - :class:`InstantTraceSensor` — oracle P(t) (for unit tests).

* **Host sensors** read the real machine while host-mode profiling runs:

  - :class:`RaplSensor` — Linux powercap energy_uj, when readable.
  - :class:`ProcessActivitySensor` — fallback for unprivileged containers:
    models power from process CPU utilization (idle + dynamic·util),
    keeping the host demo self-contained.

All sensors expose ``read(t) -> watts`` plus ``min_period`` so the profiler
can refuse sampling faster than the instrument supports.
"""

from __future__ import annotations

import dataclasses
import functools
import os
import time
from typing import Mapping, Sequence

import numpy as np

from repro_torch.core import faults as faults_mod
from repro_torch.core.faults import declare_site
from repro_torch.core.timeline import Timeline

# Injection seam this module owns (see faults.FAULT_SITES): per-rail
# dropout masks applied by the trace-sensor banks.
_SITE_TRACE_BANK = declare_site("sensors.trace_bank")

__all__ = [
    "SensorSpec", "DEFAULT_IDLE_POWER", "idle_channel",
    "InstantTraceSensor", "RaplTraceSensor", "Ina231TraceSensor",
    "FailoverTraceBank",
    "RaplSensor", "ProcessActivitySensor", "available_host_sensor",
    "HostSensorBank",
]

# Near-idle package power blended into suspended-sample readings (§4.7);
# shared by the host sampler and the device pipeline so both overhead
# models emulate the same machine.
DEFAULT_IDLE_POWER = 70.0


def idle_channel(domains: "tuple[str, ...]") -> int:
    """Rail index that absorbs §4.7 suspension idle power.

    A suspended chip burns near-idle power in the *package*, not on
    HBM/ICI rails — so the blend targets the rail named ``"package"``
    wherever it sits in the domain axis, falling back to channel 0 for
    axes without one (including the scalar ``("total",)``). Shared by
    the device pipeline, the numpy oracle and the host sampler so every
    overhead model emulates the same machine.
    """
    try:
        return domains.index("package")
    # audit: allow(no-silent-except) documented fallback: axes without a
    # "package" rail blend idle power into channel 0 by contract
    except ValueError:
        return 0


@dataclasses.dataclass(frozen=True)
class SensorSpec:
    """Declarative trace-sensor semantics (hashable jit-cache key).

    The device-resident pipeline (:mod:`repro_torch.core.device_pipeline`)
    re-implements each trace sensor as a *pure function* of the timeline's
    cumulative energy integral; this spec carries the parameters of that
    function without binding to a host-side Timeline. ``kind`` selects the
    emulation: ``instant`` (oracle P(t)), ``rapl`` (energy counter
    differenced between consecutive samples, quantized to
    ``update_period``), ``ina231`` (mean power over ``[t - window, t]``).

    A spec is a *bank* of synchronized channels, one per power-rail
    domain (RAPL exposes PKG and DRAM counters, PowerSensor3-class
    instruments several rails): ``domains`` names the channels and every
    channel applies the same kind/period semantics to its own rail's
    energy integral. ``min_periods`` optionally carries per-channel
    instrument floors (a DRAM counter can refresh slower than PKG);
    :meth:`effective_min_period` is the bank's binding constraint. The
    default single-channel ``("total",)`` spec is exactly the old scalar
    sensor.
    """

    kind: str                    # "instant" | "rapl" | "ina231"
    update_period: float = 0.0   # rapl counter quantum [s]
    window: float = 0.0          # ina231 averaging window [s]
    min_period: float = 0.0      # instrument's fastest supported period [s]
    domains: tuple[str, ...] = ("total",)   # channel (rail) names
    min_periods: tuple[float, ...] = ()     # optional per-channel floors

    def __post_init__(self):
        if self.min_periods and len(self.min_periods) != len(self.domains):
            raise ValueError(
                f"min_periods has {len(self.min_periods)} entries for "
                f"{len(self.domains)} domains")

    @property
    def num_domains(self) -> int:
        return len(self.domains)

    def effective_min_period(self) -> float:
        """Fastest period every channel of the bank supports."""
        return max((self.min_period, *self.min_periods))


class _TraceSensorBase:
    """Common precomputation for trace sensors.

    Multi-channel support: ``domains`` mirrors the timeline's rail axis
    and ``_energy_rails_at`` is the per-rail twin of ``_energy_at`` —
    for scalar (D=1) timelines its single column is bit-identical to the
    scalar integral, which is what keeps the multi-channel code paths
    output-compatible with the pre-rail sensors.
    """

    def __init__(self, timeline: Timeline):
        self.tl = timeline
        self.domains = timeline.domain_names
        self._ends = timeline.ends
        self._E = np.concatenate([[0.0], timeline.energy_integral()])
        self._bounds = np.concatenate([[0.0], self._ends])

    @functools.cached_property
    def _ER(self) -> np.ndarray:
        # Built on first read_rails/_energy_rails_at use only: scalar
        # consumers of read/read_many never pay the O(m·D) table.
        return np.concatenate([np.zeros((1, self.tl.num_domains)),
                               self.tl.rail_energy_integral()])

    def _energy_at(self, t: np.ndarray) -> np.ndarray:
        """Exact cumulative energy E(t) for piecewise-constant power."""
        t = np.clip(np.asarray(t, dtype=np.float64), 0.0, self._bounds[-1])
        idx = np.searchsorted(self._bounds, t, side="right") - 1
        idx = np.clip(idx, 0, len(self.tl.powers) - 1)
        return self._E[idx] + (t - self._bounds[idx]) * self.tl.powers[idx]

    def _energy_rails_at(self, t: np.ndarray) -> np.ndarray:
        """Per-rail cumulative energy E_d(t), [n, D]."""
        t = np.clip(np.asarray(t, dtype=np.float64), 0.0, self._bounds[-1])
        idx = np.searchsorted(self._bounds, t, side="right") - 1
        idx = np.clip(idx, 0, len(self.tl.powers) - 1)
        return (self._ER[idx]
                + (t - self._bounds[idx])[..., None] * self.tl.rails()[idx])


class InstantTraceSensor(_TraceSensorBase):
    min_period = 0.0

    def read(self, t):
        return self.tl.power_at(t)

    def read_rails(self, times: np.ndarray) -> np.ndarray:
        """Per-channel readings [n, D] (oracle rail powers at t)."""
        idx = np.searchsorted(self._ends, np.asarray(times), side="right")
        idx = np.clip(idx, 0, len(self.tl.powers) - 1)
        return self.tl.rails()[idx]

    @classmethod
    def make_spec(cls, *, domains: tuple[str, ...] = ("total",),
                  min_periods: tuple[float, ...] = ()) -> SensorSpec:
        return SensorSpec(kind="instant", domains=tuple(domains),
                          min_periods=tuple(min_periods))

    def spec(self) -> SensorSpec:
        return self.make_spec(domains=self.domains)


class RaplTraceSensor(_TraceSensorBase):
    """Integrating energy counter, differenced between consecutive samples.

    Matches §4.5: 'we measure power ... by dividing the energy consumed
    since the last sample by the length of the sampling period', with the
    counter updating once per ``update_period`` (1 ms on Sandy Bridge).
    """

    DEFAULT_UPDATE_PERIOD = 1e-3    # Sandy Bridge counter refresh (§4.5)

    def __init__(self, timeline: Timeline,
                 update_period: float = DEFAULT_UPDATE_PERIOD):
        super().__init__(timeline)
        self.update_period = update_period
        self.min_period = update_period

    @classmethod
    def make_spec(cls, update_period: float | None = None, *,
                  domains: tuple[str, ...] = ("total",),
                  min_periods: tuple[float, ...] = ()) -> SensorSpec:
        if update_period is None:
            update_period = cls.DEFAULT_UPDATE_PERIOD
        return SensorSpec(kind="rapl", update_period=update_period,
                          min_period=update_period, domains=tuple(domains),
                          min_periods=tuple(min_periods))

    def spec(self) -> SensorSpec:
        return self.make_spec(self.update_period, domains=self.domains)

    def _quantized(self, times: np.ndarray):
        times = np.asarray(times, dtype=np.float64)
        # Counter is quantized to its internal update period. The 1e-6
        # epsilon (in units of the period) keeps exact-boundary sample times
        # from flooring down a whole period due to fp division error.
        tq = np.floor(times / self.update_period + 1e-6) * self.update_period
        prev_t = np.concatenate([[max(tq[0] - self.update_period, 0.0)],
                                 tq[:-1]])
        dt = np.maximum(tq - prev_t, self.update_period)
        return tq, prev_t, dt

    def read_many(self, times: np.ndarray) -> np.ndarray:
        """Vectorized differencing over an increasing sample-time array."""
        tq, prev_t, dt = self._quantized(times)
        return (self._energy_at(tq) - self._energy_at(prev_t)) / dt

    def read_rails(self, times: np.ndarray) -> np.ndarray:
        """Per-channel RAPL differencing [n, D] (PKG/DRAM-style bank)."""
        tq, prev_t, dt = self._quantized(times)
        de = self._energy_rails_at(tq) - self._energy_rails_at(prev_t)
        return de / dt[:, None]


class Ina231TraceSensor(_TraceSensorBase):
    """Window-averaged power meter (TI INA231 semantics, §4.5)."""

    DEFAULT_WINDOW = 280e-6         # minimum feasible INA231 window (§4.5)

    def __init__(self, timeline: Timeline, window: float = DEFAULT_WINDOW):
        super().__init__(timeline)
        self.window = window
        self.min_period = window

    @classmethod
    def make_spec(cls, window: float | None = None, *,
                  domains: tuple[str, ...] = ("total",),
                  min_periods: tuple[float, ...] = ()) -> SensorSpec:
        if window is None:
            window = cls.DEFAULT_WINDOW
        return SensorSpec(kind="ina231", window=window, min_period=window,
                          domains=tuple(domains),
                          min_periods=tuple(min_periods))

    def spec(self) -> SensorSpec:
        return self.make_spec(self.window, domains=self.domains)

    def read(self, t):
        t = np.asarray(t, dtype=np.float64)
        lo = np.maximum(t - self.window, 0.0)
        de = self._energy_at(t) - self._energy_at(lo)
        dt = np.maximum(t - lo, 1e-12)
        return de / dt

    def read_many(self, times: np.ndarray) -> np.ndarray:
        return self.read(times)

    def read_rails(self, times: np.ndarray) -> np.ndarray:
        """Per-channel windowed means [n, D] (multi-rail INA bank)."""
        t = np.asarray(times, dtype=np.float64)
        lo = np.maximum(t - self.window, 0.0)
        de = self._energy_rails_at(t) - self._energy_rails_at(lo)
        return de / np.maximum(t - lo, 1e-12)[:, None]


class FailoverTraceBank:
    """Per-channel failover over a multi-rail trace sensor.

    Production rails fail independently (a DRAM counter stalls while PKG
    keeps reporting), so the bank pairs the primary instrument with an
    optional *fallback* sensor per domain. A dropped-out channel —
    injected by the active :class:`~repro_torch.core.faults.FaultPlan`, or any
    NaN the primary itself reports — is repaired two ways:

    * a fallback exists for the domain → its (typically slower/noisier)
      readings substitute for exactly the dropped entries, and the CIs
      widen through that sensor's own variance;
    * no fallback → the entries stay NaN and the *sampler* voids those
      whole samples (see ``iter_sample_chunks``): fewer samples → larger
      standard error — the CI widens honestly, with no bias toward any
      rail, and nothing about the wire schema changes.

    Period arbitration reuses :meth:`SensorSpec.effective_min_period`:
    the bank's spec carries per-channel floors raised to each fallback's
    ``min_period``, so a session cannot sample faster than the slowest
    instrument that might have to serve a channel.
    """

    def __init__(self, primary,
                 fallbacks: Mapping[str, object] | None = None, *,
                 faults: "faults_mod.FaultPlan | None" = None):
        self.primary = primary
        self.domains = tuple(primary.domains)
        self.fallbacks = dict(fallbacks or {})
        unknown = set(self.fallbacks) - set(self.domains)
        if unknown:
            raise ValueError(f"fallback domains {sorted(unknown)} not in "
                             f"bank domains {self.domains}")
        # Captured once — samplers read from worker threads where the
        # installing context is invisible.
        self._faults = faults_mod.resolve_plan(faults)
        self.failover_reads = {d: 0 for d in self.domains}
        self.masked_samples = 0
        self.min_period = self.spec().effective_min_period()

    def spec(self) -> SensorSpec:
        base = self.primary.spec()
        floors = list(base.min_periods or (base.min_period,) * len(
            self.domains))
        for j, d in enumerate(self.domains):
            fb = self.fallbacks.get(d)
            if fb is not None:
                floors[j] = max(floors[j], getattr(fb, "min_period", 0.0))
        return dataclasses.replace(base, min_periods=tuple(floors))

    def effective_min_period(self) -> float:
        return self.spec().effective_min_period()

    def _fallback_column(self, fb, times: np.ndarray, j: int) -> np.ndarray:
        if hasattr(fb, "read_rails"):
            return np.asarray(fb.read_rails(times),
                              dtype=np.float64)[:, j]
        if hasattr(fb, "read_many"):
            return np.asarray(fb.read_many(times), dtype=np.float64)
        return np.asarray(fb.read(times), dtype=np.float64)

    def read_rails(self, times) -> np.ndarray:
        times = np.asarray(times, dtype=np.float64)
        pows = np.array(self.primary.read_rails(times), dtype=np.float64)
        if self._faults is not None:
            mask = self._faults.dropout_mask(self.domains, times)
            if mask is not None:
                pows[mask] = np.nan
        bad = np.isnan(pows)
        if not bad.any():
            return pows
        for j, d in enumerate(self.domains):
            col = bad[:, j]
            if not col.any():
                continue
            fb = self.fallbacks.get(d)
            if fb is None:
                continue                       # masked; sampler voids rows
            pows[col, j] = self._fallback_column(fb, times[col], j)
            self.failover_reads[d] += int(col.sum())
        self.masked_samples += int(np.isnan(pows).any(axis=1).sum())
        return pows

    def read_many(self, times) -> np.ndarray:
        if len(self.domains) != 1:
            raise ValueError("multi-rail bank: use read_rails")
        return self.read_rails(times)[:, 0]


# ---------------------------------------------------------------------------
# Host (real machine) sensors.
# ---------------------------------------------------------------------------

_RAPL_GLOB = "/sys/class/powercap/intel-rapl:0/energy_uj"


class RaplSensor:
    """Reads the Linux powercap RAPL energy counter (µJ), differenced."""

    min_period = 1e-3

    def __init__(self, path: str = _RAPL_GLOB):
        self.path = path
        self._last: tuple[float, float] | None = None
        with open(path) as f:       # raises if unreadable → caller falls back
            int(f.read())

    def read(self, t: float | None = None) -> float:
        now = time.monotonic() if t is None else t
        with open(self.path) as f:
            uj = int(f.read())
        if self._last is None:
            self._last = (now, uj)
            return 0.0
        t0, uj0 = self._last
        self._last = (now, uj)
        dt = max(now - t0, 1e-9)
        duj = uj - uj0
        if duj < 0:  # counter wrap
            return 0.0
        return duj * 1e-6 / dt


class ProcessActivitySensor:
    """Container-safe fallback: power modeled from process CPU utilization.

    P = p_idle + p_dyn · util, where util is the derivative of process CPU
    time. This keeps host-mode profiling honest (the 'sensor' responds to
    what the program actually does) without privileged counters.
    """

    min_period = 1e-4

    def __init__(self, p_idle: float = 35.0, p_dyn: float = 65.0):
        self.p_idle, self.p_dyn = p_idle, p_dyn
        self._last = (time.monotonic(), time.process_time())

    def read(self, t: float | None = None) -> float:
        now, cpu = time.monotonic(), time.process_time()
        t0, c0 = self._last
        self._last = (now, cpu)
        dt = max(now - t0, 1e-9)
        util = min(max((cpu - c0) / dt, 0.0), os.cpu_count() or 1)
        return self.p_idle + self.p_dyn * util


class HostSensorBank:
    """Synchronized multi-channel host sensor (one rail per domain).

    Wraps named scalar host sensors into one instrument whose ``read``
    returns a ``[D]`` vector — the host-mode analogue of a multi-channel
    :class:`SensorSpec` bank (e.g. RAPL PKG + DRAM powercap zones read
    back-to-back). ``min_period`` is the slowest member's floor: the bank
    samples no faster than its most constrained channel.

    ``fallbacks`` maps domain names to substitute sensors: the first
    time a channel's sensor raises (or returns a non-finite reading),
    the bank fails over to the substitute *permanently* (a dead powercap
    zone does not resurrect mid-session; sticky failover also keeps the
    channel's readings from interleaving two instruments' calibrations)
    and counts the event in ``failover_events``. A channel with no
    fallback reads NaN from then on — the sampler drops those samples
    (counted) so the CIs widen instead of silently averaging zeros.
    """

    def __init__(self, channels: Sequence[tuple[str, object]],
                 fallbacks: Mapping[str, object] | None = None):
        if not channels:
            raise ValueError("sensor bank needs at least one channel")
        self.domains = tuple(name for name, _ in channels)
        if len(set(self.domains)) != len(self.domains):
            raise ValueError(f"duplicate domain names: {self.domains}")
        self._sensors = [s for _, s in channels]
        self._fallbacks = dict(fallbacks or {})
        unknown = set(self._fallbacks) - set(self.domains)
        if unknown:
            raise ValueError(f"fallback domains {sorted(unknown)} not in "
                             f"bank domains {self.domains}")
        self._dead = [False] * len(self._sensors)
        self.failover_events: dict[str, int] = {}
        self.min_period = max(getattr(s, "min_period", 0.0)
                              for s in self._sensors)

    def effective_min_period(self) -> float:
        """Slowest floor across members *and* their potential fallbacks
        (same arbitration as :meth:`SensorSpec.effective_min_period`)."""
        return max(self.min_period,
                   *(getattr(s, "min_period", 0.0)
                     for s in self._fallbacks.values()), 0.0)

    def _fail_over(self, j: int) -> None:
        d = self.domains[j]
        self.failover_events[d] = self.failover_events.get(d, 0) + 1
        fb = self._fallbacks.pop(d, None)
        if fb is not None:
            self._sensors[j] = fb
        else:
            self._dead[j] = True

    def read(self, t: float | None = None) -> np.ndarray:
        out = np.empty(len(self._sensors), dtype=np.float64)
        for j, s in enumerate(self._sensors):
            if self._dead[j]:
                out[j] = np.nan
                continue
            try:
                v = float(s.read(t))
            except Exception:
                self._fail_over(j)
                s = self._sensors[j]
                if self._dead[j]:
                    out[j] = np.nan
                    continue
                v = float(s.read(t))
            if not np.isfinite(v):
                self._fail_over(j)
                v = (float(self._sensors[j].read(t))
                     if not self._dead[j] else np.nan)
            out[j] = v
        return out


def available_host_sensor():
    """Best host sensor the environment permits."""
    try:
        return RaplSensor()
    except Exception:
        return ProcessActivitySensor()
