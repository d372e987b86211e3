"""Traffic generator: the profiled program's timeline, built from a seed.

A frozen copy of the arithmetic of the port's ``core/timeline.synthesize``
and of the activity power model behind it (TPU v5e constants, the
program's default), so that later changes to the program cannot move the
inputs the benchmark hands it. Arrays only: the harness wraps them in the
program's ``Timeline`` objects, and the reference reads them as they are.

A timeline is ``steps`` repetitions of ``blocks`` basic blocks, each run
``invocations`` times in a row; a block's cost (FLOPs and HBM bytes) is
drawn log-uniform from the seed, each invocation's duration and power get
lognormal and Gaussian noise. The configuration samples at a fixed period
and takes ``samples_per_profile`` samples a profile, so the timeline's
durations are scaled by one factor to last that many periods: the same
program, run on that many times more work per block. Multi-worker traffic
is ``workers`` phase-shifted copies of one timeline: worker ``w`` leads
with a pad interval of ``w * shift_periods * period_s + pad_extra_s``
seconds in the first interval's region and power.
"""

from __future__ import annotations

import dataclasses

import numpy as np

# The activity power model's calibration and the TPU v5e peaks it divides
# by (the program's defaults; frozen here).
P_IDLE, E_FLOP, E_MEM, E_ICI = 70.0, 90.0, 55.0, 18.0
STATIC_FREQ_FRACTION = 0.35
PEAK_FLOPS = 197e12
HBM_BANDWIDTH = 819e9
RAILS = ("package", "hbm", "ici")


@dataclasses.dataclass(frozen=True)
class Arrays:
    """One worker's piecewise-constant trace: region id, duration [s],
    scalar power [W] and per-rail power [m, D] (None: scalar) per
    interval; ``names`` maps region ids to names."""

    region_ids: np.ndarray
    durations: np.ndarray
    powers: np.ndarray
    rail_powers: np.ndarray | None
    names: tuple[str, ...]

    @property
    def domains(self):
        return None if self.rail_powers is None else RAILS

    @property
    def t_exec(self) -> float:
        return float(np.cumsum(self.durations)[-1])


def seed_stream(seed: int, *path: int) -> np.random.Generator:
    """An independent generator for one use of the run's seed."""
    return np.random.default_rng(np.random.SeedSequence([seed, *path]))


def derived_seed(seed: int, *path: int) -> int:
    """A 63-bit integer seed for one use of the run's seed."""
    ss = np.random.SeedSequence([seed, *path])
    return int(ss.generate_state(1, np.uint64)[0] >> np.uint64(1))


def region_costs(traffic: dict, seed: int) -> tuple[np.ndarray, np.ndarray]:
    """(FLOPs [blocks], HBM bytes [blocks]) drawn log-uniform over the
    traffic's decades."""
    rng = seed_stream(seed, 0)
    n = int(traffic["blocks"])
    flops = 10 ** rng.uniform(*traffic["flops_log10"], n)
    hbm = 10 ** rng.uniform(*traffic["hbm_bytes_log10"], n)
    return flops, hbm


def _block_model(flops: float, hbm: float, efficiency: float):
    """(roofline duration, power, rails [D]) of one block at full frequency
    on one chip with no interconnect traffic. The model's factors that are
    1 or 0 there (frequency scale, contention, the link term) change no
    bit and are left out."""
    base = max(flops / PEAK_FLOPS, hbm / HBM_BANDWIDTH, 0.0) / efficiency
    u_f = min(flops / base / PEAK_FLOPS, 1.0)
    u_m = min(hbm / base / HBM_BANDWIDTH, 1.0)
    static = P_IDLE * ((1 - STATIC_FREQ_FRACTION) + STATIC_FREQ_FRACTION)
    power = static + (E_FLOP * u_f + E_MEM * u_m + E_ICI * 0.0)
    rails = np.array([static + E_FLOP * u_f, E_MEM * u_m, E_ICI * 0.0])
    return base, power, rails


def synthesize(flops, hbm, *, invocations: int, steps: int, seed: int,
               domains: bool, latency_noise: float = 0.08,
               power_noise: float = 0.02,
               efficiency: float = 0.85) -> Arrays:
    """The timeline of ``steps`` steps of the blocks whose costs are
    ``flops``/``hbm``: per step, every block's ``invocations`` in order,
    each duration the block's roofline time times lognormal noise, each
    power the model's plus Gaussian noise (at least 1 W), the rails scaled
    to sum to it. Draws as ``synthesize`` of the program does, in the same
    order, so equal inputs give equal arrays."""
    rng = np.random.default_rng(seed)
    n = len(flops)
    model = [_block_model(float(f), float(b), efficiency)
             for f, b in zip(flops, hbm)]
    ids, durs, pows, rails = [], [], [], []
    for _ in range(steps):
        for rid in range(n):
            base, p, r = model[rid]
            jit = rng.lognormal(mean=0.0, sigma=latency_noise,
                                size=invocations)
            pn = p * (1.0 + power_noise * rng.standard_normal(invocations))
            pn = np.maximum(pn, 1.0)
            ids.append(np.full(invocations, rid, dtype=np.int32))
            durs.append(base * jit)
            pows.append(pn)
            if domains:
                rails.append(r[None, :] * (pn / r.sum())[:, None])
    names = tuple(f"bb{i}" for i in range(n))
    return Arrays(np.concatenate(ids), np.concatenate(durs),
                  np.concatenate(pows),
                  np.concatenate(rails) if domains else None, names)


def cell_timeline(traffic: dict, config: dict, seed: int) -> Arrays:
    """The cell's base timeline (one worker) from the run's seed, lasting
    ``samples_per_profile`` sampling periods."""
    flops, hbm = region_costs(traffic, seed)
    base = synthesize(flops, hbm, invocations=int(traffic["invocations"]),
                      steps=int(traffic["steps"]),
                      seed=derived_seed(seed, 1),
                      domains=bool(config["rails"] > 1),
                      latency_noise=traffic["latency_noise"],
                      power_noise=traffic["power_noise"],
                      efficiency=traffic["efficiency"])
    horizon = float(config["samples_per_profile"]) * config["period_s"]
    return dataclasses.replace(
        base, durations=base.durations * (horizon / base.t_exec))


def workers(base: Arrays, config: dict) -> list[Arrays]:
    """``config["workers"]`` phase-shifted copies of ``base`` (one worker:
    ``base`` itself)."""
    n = int(config["workers"])
    if n == 1:
        return [base]
    out = []
    for w in range(n):
        off = (w * config["shift_periods"] * config["period_s"]
               + config["pad_extra_s"])
        out.append(Arrays(
            np.concatenate([base.region_ids[:1], base.region_ids]),
            np.concatenate([[off], base.durations]),
            np.concatenate([base.powers[:1], base.powers]),
            None if base.rail_powers is None else np.concatenate(
                [base.rail_powers[:1], base.rail_powers]),
            base.names))
    return out


def prefix(arrs: Arrays, m: int) -> Arrays:
    """The first ``m`` intervals of a worker's trace."""
    return Arrays(arrs.region_ids[:m], arrs.durations[:m], arrs.powers[:m],
                  None if arrs.rail_powers is None else arrs.rail_powers[:m],
                  arrs.names)
