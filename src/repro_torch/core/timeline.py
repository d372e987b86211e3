"""Region timelines: the 'ground truth' substrate ALEA samples.

A :class:`Timeline` is a piecewise-constant execution trace — a sequence of
(region_id, duration, power) intervals, exactly Figure 2 of the paper: a
program is a concatenation of basic-block instances whose per-instance
latency varies between iterations.

Two producers:
  * :func:`synthesize` — builds a timeline for a compiled TPU step from
    per-region roofline costs (FLOPs / HBM bytes / ICI bytes, sourced from
    the dry-run's ``cost_analysis`` + HLO collective parsing) through the
    activity power model. Per-instance latency gets multiplicative lognormal
    jitter, reproducing the paper's latency-varies-per-iteration premise.
  * host profiling (``profiler.HostSession``) — records a real timeline of
    region enter/exit timestamps for validation on CPU.

Ground truth per region is the exact integral over intervals — the stand-in
for the paper's direct RAPL measurements (§5 validation protocol).
"""

from __future__ import annotations

import dataclasses
from typing import Sequence

import numpy as np

from repro_torch.core.power_model import PowerModel

__all__ = ["RegionCost", "Timeline", "synthesize", "ground_truth"]


@dataclasses.dataclass(frozen=True)
class RegionCost:
    """Per-invocation cost of one region of a step (per chip unless noted).

    ``flops``/``hbm_bytes`` are whole-program per-invocation totals that will
    be divided across chips by the caller; ``ici_bytes`` is per-chip link
    traffic (torus collectives keep it ~chip-count invariant).
    """

    name: str
    flops: float
    hbm_bytes: float
    ici_bytes: float = 0.0
    invocations: int = 1    # instances of this region per step (e.g. layers)


@dataclasses.dataclass
class Timeline:
    """Piecewise-constant trace. Arrays share length m (interval count).

    ``rail_powers`` optionally decomposes each interval's scalar power
    into per-domain rails ([m, D], summing to ``powers`` row-wise —
    package vs HBM vs interconnect, cf.
    :data:`repro_torch.core.power_model.POWER_DOMAINS`); ``domains`` names the
    rail axis. Scalar timelines (``rail_powers=None``) behave exactly as
    before — every consumer treats them as D=1 with domain ``"total"``.
    """

    region_ids: np.ndarray   # int32 [m]
    durations: np.ndarray    # float64 [m] seconds
    powers: np.ndarray       # float64 [m] watts (per-chip)
    names: tuple[str, ...]   # region id → name
    rail_powers: np.ndarray | None = None   # float64 [m, D] or None
    domains: tuple[str, ...] | None = None  # rail axis names (None → scalar)

    def __post_init__(self):
        # Own copies, frozen: the lazy cumsum caches below assume the
        # interval arrays never change after construction, so in-place
        # mutation must fail loudly rather than silently serve stale
        # t_exec/region_at/energy_integral.
        self.region_ids = np.array(self.region_ids, dtype=np.int32)
        self.durations = np.array(self.durations, dtype=np.float64)
        self.powers = np.array(self.powers, dtype=np.float64)
        for arr in (self.region_ids, self.durations, self.powers):
            arr.flags.writeable = False
        if not (len(self.region_ids) == len(self.durations) == len(self.powers)):
            raise ValueError("timeline arrays must share length")
        if np.any(self.durations < 0):
            raise ValueError("negative durations")
        if (self.rail_powers is None) != (self.domains is None):
            raise ValueError("rail_powers and domains must be set together")
        if self.rail_powers is not None:
            self.rail_powers = np.array(self.rail_powers, dtype=np.float64)
            self.rail_powers.flags.writeable = False
            self.domains = tuple(self.domains)
            if self.rail_powers.shape != (len(self.powers),
                                          len(self.domains)):
                raise ValueError(
                    f"rail_powers shape {self.rail_powers.shape} != "
                    f"(m={len(self.powers)}, D={len(self.domains)})")
        # Lazy caches: region_at/power_at are called once per sample chunk,
        # so recomputing an O(m) prefix sum per call dominates long runs.
        self._ends_cache: np.ndarray | None = None
        self._eint_cache: np.ndarray | None = None
        self._rail_eint_cache: np.ndarray | None = None

    @property
    def num_domains(self) -> int:
        return 1 if self.domains is None else len(self.domains)

    @property
    def domain_names(self) -> tuple[str, ...]:
        """Rail axis names; scalar timelines report the one ``"total"``."""
        return ("total",) if self.domains is None else self.domains

    def rails(self) -> np.ndarray:
        """Per-domain interval powers [m, D] (scalar → [m, 1] view)."""
        if self.rail_powers is not None:
            return self.rail_powers
        return self.powers[:, None]

    @property
    def t_exec(self) -> float:
        return float(self.ends[-1]) if len(self.durations) else 0.0

    @property
    def starts(self) -> np.ndarray:
        return np.concatenate([[0.0], self.ends[:-1]])

    @property
    def ends(self) -> np.ndarray:
        if self._ends_cache is None:
            self._ends_cache = np.cumsum(self.durations)
        return self._ends_cache

    def energy_integral(self) -> np.ndarray:
        """Cumulative energy E(t) at interval ends (for sensor emulation)."""
        if self._eint_cache is None:
            self._eint_cache = np.cumsum(self.durations * self.powers)
        return self._eint_cache

    def rail_energy_integral(self) -> np.ndarray:
        """Per-domain cumulative energy at interval ends, [m, D].

        Scalar timelines return ``energy_integral()[:, None]`` so the
        D=1 column is bit-identical to the scalar integral (the
        compatibility contract every multi-channel sensor leans on).
        """
        if self._rail_eint_cache is None:
            if self.rail_powers is None:
                self._rail_eint_cache = self.energy_integral()[:, None]
            else:
                self._rail_eint_cache = np.cumsum(
                    self.durations[:, None] * self.rail_powers, axis=0)
        return self._rail_eint_cache

    def region_at(self, times: np.ndarray) -> np.ndarray:
        """Region id executing at each time point (vectorized PC sampling)."""
        idx = np.searchsorted(self.ends, np.asarray(times), side="right")
        idx = np.clip(idx, 0, len(self.region_ids) - 1)
        return self.region_ids[idx]

    def power_at(self, times: np.ndarray) -> np.ndarray:
        idx = np.searchsorted(self.ends, np.asarray(times), side="right")
        idx = np.clip(idx, 0, len(self.powers) - 1)
        return self.powers[idx]

    def tile(self, reps: int) -> "Timeline":
        """Concatenate ``reps`` identical steps (multi-step profiled run)."""
        return Timeline(np.tile(self.region_ids, reps),
                        np.tile(self.durations, reps),
                        np.tile(self.powers, reps), self.names,
                        rail_powers=None if self.rail_powers is None
                        else np.tile(self.rail_powers, (reps, 1)),
                        domains=self.domains)

    def to_device(self, device="cuda"):
        """Upload as a single-worker :class:`DeviceTimeline` substrate.

        Entry to the device-resident sampling pipeline
        (:mod:`repro_torch.core.device_pipeline`): interval ends, the
        cumulative energy integral, powers, and region ids become tensors
        on ``device`` (the GPU unless the caller passes ``"cpu"``) so an
        arbitrarily long sampling run never touches these host arrays
        again. Imported lazily so numpy-only consumers never import torch.
        """
        from repro_torch.core.device_pipeline import DeviceTimeline
        return DeviceTimeline.from_timelines([self], device=device)


def ground_truth(tl: Timeline) -> dict[str, dict[str, float]]:
    """Exact per-region time/energy/power (the 'direct measurement').

    Vectorized: one weighted bincount per statistic instead of a
    per-region boolean-mask pass over the interval arrays.
    """
    minlen = int(tl.region_ids.max()) + 1 if len(tl.region_ids) else 0
    t = np.bincount(tl.region_ids, weights=tl.durations, minlength=minlen)
    e = np.bincount(tl.region_ids, weights=tl.durations * tl.powers,
                    minlength=minlen)
    e_rails = None
    if tl.rail_powers is not None:
        e_rails = np.stack(
            [np.bincount(tl.region_ids,
                         weights=tl.durations * tl.rail_powers[:, d],
                         minlength=minlen)
             for d in range(len(tl.domains))], axis=1)
    present = np.bincount(tl.region_ids, minlength=minlen) > 0
    out = {}
    for rid in np.flatnonzero(present):
        row = {"time": float(t[rid]), "energy": float(e[rid]),
               "power": float(e[rid] / t[rid]) if t[rid] > 0 else 0.0}
        if e_rails is not None:
            row["energy_rails"] = {d: float(e_rails[rid, j])
                                   for j, d in enumerate(tl.domains)}
        out[tl.names[rid]] = row
    return out


def synthesize(costs: Sequence[RegionCost], *, steps: int = 1,
               chips: int = 1, model: PowerModel | None = None,
               freq_scale: float = 1.0, latency_noise: float = 0.08,
               power_noise: float = 0.02, efficiency: float = 0.85,
               seed: int = 0, domains: bool = False) -> Timeline:
    """Synthesize a device timeline from per-region roofline costs.

    Each step emits every region's invocations in order; per-instance
    duration is the roofline duration × lognormal(σ=latency_noise) jitter
    (paper Fig. 2: latency varies between iterations, e.g. with the memory
    level serving each load); per-instance power adds Gaussian sensor-scale
    noise on top of the activity model.

    ``domains=True`` additionally carries the power model's per-rail
    decomposition (:meth:`PowerModel.power_rails`) on every interval.
    The scalar ``powers`` stream is computed identically either way —
    same RNG consumption, same values — so ``domains=True`` only *adds*
    information; each instance's rails are scaled uniformly by its noise
    factor so they sum to the scalar power.
    """
    model = model or PowerModel()
    rng = np.random.default_rng(seed)
    names = tuple(c.name for c in costs)
    dom_names = model.domains if domains else None

    ids, durs, pows, rails = [], [], [], []
    for step in range(steps):
        for rid, c in enumerate(costs):
            base = model.region_duration(c.flops, c.hbm_bytes, c.ici_bytes,
                                         freq_scale=freq_scale, chips=chips,
                                         efficiency=efficiency)
            jit = rng.lognormal(mean=0.0, sigma=latency_noise,
                                size=c.invocations)
            d = base * jit
            u = model.utilizations(c.flops / chips, c.hbm_bytes / chips,
                                   c.ici_bytes, base, freq_scale)
            p = float(model.power(*u, freq_scale=freq_scale))
            pn = p * (1.0 + power_noise * rng.standard_normal(c.invocations))
            pn = np.maximum(pn, 1.0)
            ids.append(np.full(c.invocations, rid, dtype=np.int32))
            durs.append(d)
            pows.append(pn)
            if domains:
                r = model.power_rails(*u, freq_scale=freq_scale)
                rails.append(r[None, :] * (pn / r.sum())[:, None])
    return Timeline(np.concatenate(ids), np.concatenate(durs),
                    np.concatenate(pows), names,
                    rail_powers=np.concatenate(rails) if domains else None,
                    domains=dom_names)
