"""§7 engine: per-region energy optimization over TPU knobs.

The paper's use cases tune, *per basic block*: DVFS frequency, concurrency
(thread count), and compiler optimizations — and find that (a) the optimum
differs per block and per objective (time / energy / ED / ED²) and (b)
whole-program energy drops 33–37% vs the performance-tuned baseline.

TPU-native knob set per region:
  * ``freq_scale``  — modeled DVFS step (v5e-class chips expose SW clock caps),
  * ``chips``       — concurrency throttling = submesh size used for the region,
  * ``impl``        — compilation strategy: named implementation variants with
                      cost multipliers (e.g. Pallas flash attention halves HBM
                      traffic of naive attention; remat trades FLOPs for bytes).

Each region is evaluated through the activity power model; objectives follow
Table 2 (time, energy, ED, ED²). The search composes a whole-program plan and
reports savings vs a max-performance baseline — the Table 3 protocol.
"""

from __future__ import annotations

import dataclasses
import itertools
from typing import Mapping, Sequence

from repro_torch.core.power_model import PowerModel
from repro_torch.core.timeline import RegionCost

__all__ = ["ImplVariant", "KnobSpace", "RegionPlan", "ProgramPlan",
           "optimize_regions", "evaluate"]


@dataclasses.dataclass(frozen=True)
class ImplVariant:
    """A compilation strategy for a region, as cost multipliers.

    flop_mult/byte_mult scale the region's FLOPs / HBM bytes (e.g. flash
    attention: byte_mult ≪ 1; remat: flop_mult > 1, byte_mult < 1; unroll
     'hints': flop efficiency up). ici_mult scales collective traffic.
    """

    name: str
    flop_mult: float = 1.0
    byte_mult: float = 1.0
    ici_mult: float = 1.0
    efficiency: float = 0.85   # achievable fraction of roofline


@dataclasses.dataclass(frozen=True)
class KnobSpace:
    freq_scales: Sequence[float] = (1.0, 0.94, 0.88, 0.81, 0.75)
    chip_counts: Sequence[int] = (1, 2, 4, 8)
    impls: Sequence[ImplVariant] = (ImplVariant("default"),)


@dataclasses.dataclass(frozen=True)
class RegionPlan:
    region: str
    freq_scale: float
    chips: int
    impl: str
    time: float
    energy: float

    @property
    def power(self) -> float:
        return self.energy / self.time if self.time else 0.0


@dataclasses.dataclass(frozen=True)
class ProgramPlan:
    plans: tuple[RegionPlan, ...]
    objective: str

    @property
    def time(self) -> float:
        return sum(p.time for p in self.plans)

    @property
    def energy(self) -> float:
        return sum(p.energy for p in self.plans)

    def table(self) -> str:
        hdr = (f"{'region':24s} {'freq':>5s} {'chips':>5s} {'impl':>16s} "
               f"{'t [s]':>9s} {'E [J]':>10s}")
        lines = [hdr, "-" * len(hdr)]
        for p in self.plans:
            lines.append(f"{p.region:24s} {p.freq_scale:5.2f} {p.chips:5d} "
                         f"{p.impl:>16s} {p.time:9.4f} {p.energy:10.2f}")
        lines.append(f"{'PROGRAM':24s} {'':5s} {'':5s} {'':16s} "
                     f"{self.time:9.4f} {self.energy:10.2f}")
        return "\n".join(lines)


_OBJECTIVES = {
    "time": lambda t, e: t,
    "energy": lambda t, e: e,
    "ed": lambda t, e: e * t,
    "ed2": lambda t, e: e * t * t,
}


def evaluate(cost: RegionCost, *, freq_scale: float, chips: int,
             impl: ImplVariant, model: PowerModel,
             tp_comm_frac: float = 0.08) -> tuple[float, float]:
    """(time, energy) for one region under one knob setting.

    Energy counts *all* chips in the submesh (idle chips still burn static
    power — that is what makes concurrency throttling pay off when scaling
    is sublinear, the paper's thread-packing effect). Splitting a region
    over chips adds modeled TP/activation collective traffic
    (``tp_comm_frac`` of its memory bytes scaled by (chips−1)/chips) — the
    sublinearity that was cache contention on the paper's platforms.
    """
    flops = cost.flops * impl.flop_mult * cost.invocations
    hbm = cost.hbm_bytes * impl.byte_mult * cost.invocations
    ici = cost.ici_bytes * impl.ici_mult * cost.invocations
    if chips > 1:
        # Per-chip activation-collective traffic is ~chip-count-invariant
        # while per-chip compute shrinks → regions go collective-bound at
        # high TP width (sublinear scaling; paper's contention analogue).
        ici += tp_comm_frac * hbm * (chips - 1) / chips
    dur, pw, _ = model.region_energy(flops, hbm, ici, freq_scale=freq_scale,
                                     chips=chips, efficiency=impl.efficiency)
    energy = dur * pw * chips
    return dur, energy


def optimize_regions(costs: Sequence[RegionCost], space: KnobSpace,
                     *, objective: str = "energy",
                     model: PowerModel | None = None,
                     impl_space: Mapping[str, Sequence[ImplVariant]] | None = None,
                     baseline_chips: int | None = None,
                     max_slowdown: float | None = None) -> ProgramPlan:
    """Independent per-region knob search (the §7.2 campaign).

    ``impl_space`` optionally restricts/extends implementation variants per
    region name (e.g. only attention regions have a flash variant).
    ``max_slowdown`` bounds each region's time to that multiple of its
    baseline (max-freq, ``baseline_chips``) time — the paper's Table 3
    optima stay within modest slowdowns.
    """
    model = model or PowerModel()
    obj = _OBJECTIVES[objective]
    plans: list[RegionPlan] = []
    for cost in costs:
        impls = (impl_space or {}).get(cost.name, space.impls)
        t_budget = float("inf")
        if max_slowdown is not None:
            bc = baseline_chips or max(space.chip_counts)
            t_base, _ = evaluate(cost, freq_scale=1.0, chips=bc,
                                 impl=impls[0], model=model)
            t_budget = max_slowdown * t_base
        best: RegionPlan | None = None
        for fs, ch, impl in itertools.product(space.freq_scales,
                                              space.chip_counts, impls):
            t, e = evaluate(cost, freq_scale=fs, chips=ch, impl=impl,
                            model=model)
            if t > t_budget:
                continue
            if best is None or obj(t, e) < obj(best.time, best.energy):
                best = RegionPlan(cost.name, fs, ch, impl.name, t, e)
        assert best is not None
        plans.append(best)
    return ProgramPlan(tuple(plans), objective)


def baseline_plan(costs: Sequence[RegionCost], *, chips: int,
                  model: PowerModel | None = None,
                  impl: ImplVariant | None = None) -> ProgramPlan:
    """Max-performance baseline: all chips, max frequency, given impl."""
    model = model or PowerModel()
    impl = impl or ImplVariant("default")
    plans = []
    for cost in costs:
        t, e = evaluate(cost, freq_scale=1.0, chips=chips, impl=impl,
                        model=model)
        plans.append(RegionPlan(cost.name, 1.0, chips, impl.name, t, e))
    return ProgramPlan(tuple(plans), "baseline")
