"""Attribution reports: per-region energy tables + validation vs ground truth."""

from __future__ import annotations

import dataclasses
from typing import Mapping

import numpy as np

from repro_torch.core.estimator import EstimateSet

__all__ = ["AttributionReport", "ValidationResult", "validate"]


@dataclasses.dataclass(frozen=True)
class AttributionReport:
    """Human/CSV rendering of an EstimateSet."""

    estimates: EstimateSet

    def _coverage_lines(self) -> list[str]:
        """Degraded-gather disclosure: statistics merged from a partial
        fleet must say so in every human rendering (the numbers alone
        look identical to a complete gather's)."""
        cov = self.estimates.coverage
        if not cov or cov.get("complete"):
            return []
        return [f"COVERAGE (partial fleet): {cov.get('summary', cov)}"]

    def _tail_lines(self) -> list[str]:
        """Bounded-state disclosure (mirrors COVERAGE): a top-k + 'other'
        combination table coarsened tail identity, and every human
        rendering must say so — per-region totals stay exact, but the
        per-combination rows no longer enumerate the full key space."""
        tail = self.estimates.tail
        if not tail:
            return []
        return [f"TAIL (bounded combinations, k={tail.get('k')}): "
                f"{tail.get('tail_folds', 0)} fold event(s), "
                f"{tail.get('evictions', 0)} eviction(s) into "
                f"{tail.get('other_rows', 0)} per-region 'other' row(s); "
                f"per-region totals exact, tail identity coarsened"]

    def table(self, top: int | None = None) -> str:
        rows = sorted(self.estimates.regions, key=lambda r: -r.e_hat)
        if top:
            rows = rows[:top]
        hdr = (f"{'region':28s} {'n':>8s} {'t̂ [s]':>10s} {'t CI±':>8s} "
               f"{'p̂ow [W]':>9s} {'ê [J]':>11s} {'e CI':>21s}")
        lines = [hdr, "-" * len(hdr)]
        for r in rows:
            ci = f"[{r.e_lo:9.2f},{r.e_hi:9.2f}]"
            lines.append(
                f"{r.name:28s} {r.n_samples:8d} {r.t_hat:10.4f} "
                f"{r.t_ci_halfwidth:8.4f} {r.pow_hat:9.2f} {r.e_hat:11.2f} "
                f"{ci:>21s}")
        lines.append(f"{'TOTAL':28s} {self.estimates.n_total:8d} "
                     f"{self.estimates.total_time:10.4f} {'':8s} {'':9s} "
                     f"{self.estimates.total_energy:11.2f}")
        lines.extend(self._coverage_lines())
        lines.extend(self._tail_lines())
        return "\n".join(lines)

    def csv(self) -> str:
        lines = ["region,n,t_hat,t_lo,t_hi,pow_hat,pow_lo,pow_hi,e_hat,e_lo,e_hi"]
        for r in self.estimates.regions:
            lines.append(f"{r.name},{r.n_samples},{r.t_hat:.6g},{r.t_lo:.6g},"
                         f"{r.t_hi:.6g},{r.pow_hat:.6g},{r.pow_lo:.6g},"
                         f"{r.pow_hi:.6g},{r.e_hat:.6g},{r.e_lo:.6g},{r.e_hi:.6g}")
        return "\n".join(lines)

    def domain_table(self, top: int | None = None) -> str:
        """Per-block × per-domain energy breakdown (multi-rail runs).

        The §6 compute-vs-memory question answered directly: each row
        shows a region's energy split across measured power rails plus
        the share of its energy on each — no indirect memory_power
        inference needed.
        """
        tbl = self.estimates.table
        if tbl.domains is None:
            raise ValueError(
                "single-rail estimates have no domain breakdown; profile "
                "with a multi-domain timeline/sensor bank")
        order = np.argsort(-tbl.e_hat, kind="stable")
        if top:
            order = order[:top]
        hdr = f"{'region':28s} {'ê [J]':>11s}"
        for d in tbl.domains:
            hdr += f" {'ê_' + d + ' [J]':>14s} {'%':>5s}"
        lines = [hdr, "-" * len(hdr)]
        for i in order:
            i = int(i)
            row = f"{tbl.names[i]:28s} {tbl.e_hat[i]:11.2f}"
            for j in range(len(tbl.domains)):
                share = (tbl.e_rails[i, j] / tbl.e_hat[i] * 100.0
                         if tbl.e_hat[i] > 0 else 0.0)
                row += f" {tbl.e_rails[i, j]:14.2f} {share:5.1f}"
            lines.append(row)
        totals = self.estimates.energy_by_domain()
        tot = f"{'TOTAL':28s} {self.estimates.total_energy:11.2f}"
        te = self.estimates.total_energy
        for d in tbl.domains:
            share = totals[d] / te * 100.0 if te > 0 else 0.0
            tot += f" {totals[d]:14.2f} {share:5.1f}"
        lines.append(tot)
        lines.extend(self._coverage_lines())
        lines.extend(self._tail_lines())
        return "\n".join(lines)

    def domain_csv(self) -> str:
        """CSV of the per-block × per-domain energy decomposition."""
        tbl = self.estimates.table
        if tbl.domains is None:
            raise ValueError("single-rail estimates have no domain "
                             "breakdown")
        cols = []
        for d in tbl.domains:
            cols += [f"pow_{d}", f"e_{d}", f"e_{d}_lo", f"e_{d}_hi"]
        lines = ["region,n,e_hat," + ",".join(cols)]
        for i in range(len(tbl)):
            vals = []
            for j in range(len(tbl.domains)):
                vals += [f"{tbl.pow_rails[i, j]:.6g}",
                         f"{tbl.e_rails[i, j]:.6g}",
                         f"{tbl.e_rails_lo[i, j]:.6g}",
                         f"{tbl.e_rails_hi[i, j]:.6g}"]
            lines.append(f"{tbl.names[i]},{int(tbl.n_samples[i])},"
                         f"{tbl.e_hat[i]:.6g}," + ",".join(vals))
        return "\n".join(lines)


@dataclasses.dataclass(frozen=True)
class ValidationResult:
    """Paper-§5-style accuracy summary vs direct measurements."""

    per_region_time_err: Mapping[str, float]   # |t̂−t|/t
    per_region_energy_err: Mapping[str, float]
    mean_time_err: float
    mean_energy_err: float
    whole_time_err: float
    whole_energy_err: float
    ci_time_coverage: float     # fraction of regions whose CI contains truth
    ci_energy_coverage: float
    measured_time_fraction: float = 1.0   # paper's "81% of execution time"

    def summary(self) -> str:
        return (f"mean err: time {self.mean_time_err*100:.2f}% "
                f"energy {self.mean_energy_err*100:.2f}% | whole-program: "
                f"time {self.whole_time_err*100:.2f}% "
                f"energy {self.whole_energy_err*100:.2f}% | CI coverage: "
                f"time {self.ci_time_coverage*100:.0f}% "
                f"energy {self.ci_energy_coverage*100:.0f}% | "
                f"measured {self.measured_time_fraction*100:.0f}% of time")


def validate(est: EstimateSet, truth: Mapping[str, Mapping[str, float]],
             *, min_time_fraction: float = 0.002,
             spans: Mapping[str, float] | None = None,
             min_span: float = 0.0) -> ValidationResult:
    """Compare estimates to exact ground truth (direct-measurement analogue).

    Following the paper's §5 protocol, per-region errors are computed only
    over regions that direct measurement could resolve: contiguous
    execution span (one invocation run of the region — the 'enclosing
    loop') at least ``min_span`` (the sampling period), and at least
    ``min_time_fraction`` of total time. Excluded regions still count
    toward whole-program error. ``measured_time_fraction`` reports how
    much execution time the validated regions cover (the paper: 81%).
    """
    t_errs: dict[str, float] = {}
    e_errs: dict[str, float] = {}
    cov_t: list[bool] = []
    cov_e: list[bool] = []
    total_t = sum(v["time"] for v in truth.values())
    total_e = sum(v["energy"] for v in truth.values())
    by_name = est.by_name()
    measured_t = 0.0
    for name, gt in truth.items():
        r = by_name.get(name)
        if r is None or gt["time"] < min_time_fraction * total_t:
            continue
        if spans is not None and spans.get(name, 0.0) < min_span:
            continue
        measured_t += gt["time"]
        t_errs[name] = abs(r.t_hat - gt["time"]) / gt["time"]
        e_errs[name] = abs(r.e_hat - gt["energy"]) / max(gt["energy"], 1e-12)
        if r.ci_valid:
            cov_t.append(r.t_lo <= gt["time"] <= r.t_hi)
            cov_e.append(r.e_lo <= gt["energy"] <= r.e_hi)
    est_total_t = sum(r.t_hat for r in est.regions)
    est_total_e = sum(r.e_hat for r in est.regions)
    return ValidationResult(
        per_region_time_err=t_errs,
        per_region_energy_err=e_errs,
        mean_time_err=float(np.mean(list(t_errs.values()))) if t_errs else 0.0,
        mean_energy_err=float(np.mean(list(e_errs.values()))) if e_errs else 0.0,
        whole_time_err=abs(est_total_t - total_t) / total_t,
        whole_energy_err=abs(est_total_e - total_e) / total_e,
        ci_time_coverage=float(np.mean(cov_t)) if cov_t else 1.0,
        ci_energy_coverage=float(np.mean(cov_e)) if cov_e else 1.0,
        measured_time_fraction=measured_t / total_t if total_t else 0.0,
    )
