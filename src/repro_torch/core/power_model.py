"""Activity-based TPU power model (+ DVFS / concurrency-throttling curves).

ALEA's platforms expose calibrated sensors (RAPL, INA231). A TPU pod exposes
coarse board telemetry; for the CPU-only container we *model* chip power from
the same activity signals the paper found dominant (§6: power tracks
memory-access intensity far more than instruction mix):

    P(chip) = P_idle
            + e_flop · (achieved FLOP/s / peak FLOP/s)        (MXU activity)
            + e_mem  · (achieved HBM B/s / peak HBM B/s)       (HBM activity)
            + e_ici  · (achieved ICI B/s / peak ICI B/s)       (link activity)

The utilization denominators are published TPU v5e peaks. The energy
coefficients are *calibration parameters* exactly as in the paper's
per-platform setup — centralize them here so a real deployment substitutes
measured values.

DVFS model (§7 analogue): dynamic power ∝ f·V² with V ∝ f → P_dyn ∝ s³ for
frequency scale s; compute-bound time ∝ 1/s, memory/ICI-bound time
unaffected. This reproduces the paper's finding that most regions are most
energy-efficient slightly below maximum frequency, with the optimum
depending on each region's arithmetic intensity.
"""

from __future__ import annotations

import dataclasses

import numpy as np

__all__ = ["HardwareSpec", "PowerModelParams", "PowerModel", "TPU_V5E",
           "POWER_DOMAINS"]

# The power-rail domain axis: the decomposition the activity model already
# computes internally (per-resource utilization terms) before summing to
# chip power. JetsonLEAP-style instruments measure these rails separately;
# threading them end-to-end gives per-block per-domain attribution.
#   package — static/leakage + MXU dynamic power (the PKG-rail analogue)
#   hbm     — HBM/DRAM dynamic power (the DRAM-rail analogue)
#   ici     — interconnect link power
POWER_DOMAINS = ("package", "hbm", "ici")


@dataclasses.dataclass(frozen=True)
class HardwareSpec:
    """Per-chip peaks used for both roofline terms and power utilization."""

    name: str
    peak_flops_bf16: float      # FLOP/s
    hbm_bandwidth: float        # B/s
    ici_bandwidth_per_link: float  # B/s (one direction)
    ici_links: int              # links per chip on a 2D torus
    vmem_bytes: int             # usable VMEM for Pallas BlockSpec sizing
    hbm_bytes: int              # HBM capacity per chip


TPU_V5E = HardwareSpec(
    name="tpu-v5e",
    peak_flops_bf16=197e12,
    hbm_bandwidth=819e9,
    ici_bandwidth_per_link=50e9,
    ici_links=4,
    vmem_bytes=16 * 1024 * 1024,
    hbm_bytes=16 * 1024**3,
)


@dataclasses.dataclass(frozen=True)
class PowerModelParams:
    """Calibration constants [W]. Modeled values for v5e-class chips."""

    p_idle: float = 70.0        # static + leakage at max frequency
    e_flop: float = 90.0        # marginal power at 100% MXU utilization
    e_mem: float = 55.0         # marginal power at 100% HBM utilization
    e_ici: float = 18.0         # marginal power at 100% ICI utilization
    # Contention (paper §6.2): shared-resource pressure raises power
    # superlinearly when multiple workers are memory-intensive at once.
    contention_coeff: float = 0.15
    # Fraction of static power that scales with voltage (DVFS leakage model).
    static_freq_fraction: float = 0.35


class PowerModel:
    """Maps region activity (utilizations) to chip power."""

    def __init__(self, params: PowerModelParams | None = None,
                 hw: HardwareSpec = TPU_V5E):
        self.params = params or PowerModelParams()
        self.hw = hw

    # -- utilization helpers -------------------------------------------------
    def utilizations(self, flops: float, hbm_bytes: float, ici_bytes: float,
                     duration_s: float, freq_scale: float = 1.0
                     ) -> tuple[float, float, float]:
        """Achieved-rate / peak-rate for a region of known cost & duration."""
        if duration_s <= 0:
            return (0.0, 0.0, 0.0)
        peak_f = self.hw.peak_flops_bf16 * freq_scale
        u_f = min(flops / duration_s / peak_f, 1.0)
        u_m = min(hbm_bytes / duration_s / self.hw.hbm_bandwidth, 1.0)
        u_i = min(
            ici_bytes / duration_s
            / (self.hw.ici_bandwidth_per_link * self.hw.ici_links), 1.0)
        return (u_f, u_m, u_i)

    def power(self, u_flop, u_mem, u_ici, *, freq_scale: float = 1.0,
              mem_contention: float = 0.0):
        """Chip power [W] at the given utilizations.

        Args:
          freq_scale: DVFS frequency scale s ∈ (0, 1]; dynamic ∝ s³.
          mem_contention: extra fractional HBM pressure from co-running
            workers (0 = standalone), paper §6.2's cache-contention analogue.
        """
        p = self.params
        s3 = freq_scale ** 3
        static = p.p_idle * ((1 - p.static_freq_fraction)
                             + p.static_freq_fraction * freq_scale**2)
        dyn = (p.e_flop * np.asarray(u_flop) * s3
               + p.e_mem * np.asarray(u_mem)
               * (1.0 + p.contention_coeff * mem_contention)
               + p.e_ici * np.asarray(u_ici))
        return static + dyn

    @property
    def domains(self) -> tuple[str, ...]:
        """Power-rail domain names, aligned with :meth:`power_rails`."""
        return POWER_DOMAINS

    def power_rails(self, u_flop, u_mem, u_ici, *, freq_scale: float = 1.0,
                    mem_contention: float = 0.0) -> np.ndarray:
        """Per-rail chip power [..., D] — the decomposition behind
        :meth:`power`.

        ``power_rails(...).sum(-1)`` equals :meth:`power` up to float64
        association (the rails are the model's own additive terms; static
        power rides on the package rail, as a real PKG counter reports it).
        """
        p = self.params
        s3 = freq_scale ** 3
        static = p.p_idle * ((1 - p.static_freq_fraction)
                             + p.static_freq_fraction * freq_scale**2)
        package = static + p.e_flop * np.asarray(u_flop, np.float64) * s3
        hbm = (p.e_mem * np.asarray(u_mem, np.float64)
               * (1.0 + p.contention_coeff * mem_contention))
        ici = p.e_ici * np.asarray(u_ici, np.float64)
        return np.stack(np.broadcast_arrays(package, hbm, ici), axis=-1)

    # -- region-level durations under DVFS ----------------------------------
    def region_duration(self, flops: float, hbm_bytes: float, ici_bytes: float,
                        *, freq_scale: float = 1.0, chips: int = 1,
                        efficiency: float = 0.85) -> float:
        """Roofline duration of a region spread over ``chips`` chips.

        max(compute, memory, collective) with compute scaled by DVFS. The
        collective term uses per-chip link bandwidth (ring/torus collectives
        keep per-chip traffic ~constant, so ici_bytes is per-chip already).
        """
        t_f = flops / chips / (self.hw.peak_flops_bf16 * freq_scale)
        t_m = hbm_bytes / chips / self.hw.hbm_bandwidth
        t_i = ici_bytes / (self.hw.ici_bandwidth_per_link * self.hw.ici_links)
        return max(t_f, t_m, t_i) / efficiency

    def region_energy(self, flops: float, hbm_bytes: float, ici_bytes: float,
                      *, freq_scale: float = 1.0, chips: int = 1,
                      efficiency: float = 0.85) -> tuple[float, float, float]:
        """(duration, chip_power, total_energy) for a region config."""
        dur = self.region_duration(flops, hbm_bytes, ici_bytes,
                                   freq_scale=freq_scale, chips=chips,
                                   efficiency=efficiency)
        u = self.utilizations(flops / chips, hbm_bytes / chips, ici_bytes,
                              dur, freq_scale)
        pw = float(self.power(*u, freq_scale=freq_scale))
        return dur, pw, dur * pw * chips
