"""ALEA probabilistic estimators (paper §4.1-§4.4, Eqs. 2-16).

The estimator consumes a stream of simultaneous (region_id, power) samples
taken at a systematic period and produces, per region (paper: basic block):

  - execution-time estimate   t̂ = (n_bb / n) · t_exec          (Eq. 5)
  - mean-power estimate       p̂ow = mean(power samples of bb)  (Eq. 6)
  - energy estimate           ê = p̂ow · t̂                      (Eq. 7)
  - Wald confidence interval on the time proportion (Eqs. 8-10)
  - normal confidence interval on power (Eqs. 12-15)
  - product confidence interval on energy (Eq. 16)

Multi-worker profiling (§4.4) attributes time/energy to *combinations* of
regions sampled simultaneously across workers (threads in the paper; chips
or hosts here), because shared-resource contention makes per-worker
apportioning unsound.

Everything is vectorized end to end: the aggregation hot spot (counts /
power sums / power sums-of-squares per region) is pluggable so the CUDA
``kernels.sample_attr`` kernel can take over on the GPU for fleet-scale
sample streams, and estimate construction itself is pure numpy column math over an
:class:`EstimateTable` — :class:`RegionEstimate` rows are lazy views, so
10⁴–10⁵ multi-worker combinations cost array ops, not Python-loop time.

Two consumption modes share this module's math:

  * one-shot — :func:`estimate_regions` over in-memory arrays (this file);
  * streaming — :class:`repro_torch.core.streaming.StreamingAggregator` folds
    sample *chunks* into (counts, Σpow, Σpow²) accumulators behind the same
    ``AggregateFn`` seam and calls :func:`estimates_from_statistics` at the
    end, so fleet-scale runs never materialize the full stream.
"""

from __future__ import annotations

import dataclasses
import functools
import math
from typing import Callable, Mapping, Sequence

import numpy as np

__all__ = [
    "AggregateFn",
    "RegionEstimate",
    "EstimateTable",
    "EstimateSet",
    "aggregate_samples_np",
    "estimate_regions",
    "estimates_from_statistics",
    "estimate_combinations",
    "z_quantile",
]


def z_quantile(alpha: float) -> float:
    """``z_{alpha/2}``: the 1 - alpha/2 percentile of the standard normal.

    Uses the Acklam inverse-CDF approximation (|rel err| < 1.15e-9); avoids a
    scipy dependency and is exact enough for CI construction.
    """
    p = 1.0 - alpha / 2.0
    if not 0.0 < p < 1.0:
        raise ValueError(f"alpha must be in (0, 2); got alpha={alpha}")
    # Acklam's algorithm.
    a = (-3.969683028665376e+01, 2.209460984245205e+02, -2.759285104469687e+02,
         1.383577518672690e+02, -3.066479806614716e+01, 2.506628277459239e+00)
    b = (-5.447609879822406e+01, 1.615858368580409e+02, -1.556989798598866e+02,
         6.680131188771972e+01, -1.328068155288572e+01)
    c = (-7.784894002430293e-03, -3.223964580411365e-01, -2.400758277161838e+00,
         -2.549732539343734e+00, 4.374664141464968e+00, 2.938163982698783e+00)
    d = (7.784695709041462e-03, 3.224671290700398e-01, 2.445134137142996e+00,
         3.754408661907416e+00)
    plow, phigh = 0.02425, 1 - 0.02425
    if p < plow:
        q = math.sqrt(-2 * math.log(p))
        return (((((c[0] * q + c[1]) * q + c[2]) * q + c[3]) * q + c[4]) * q + c[5]) / \
               ((((d[0] * q + d[1]) * q + d[2]) * q + d[3]) * q + 1)
    if p <= phigh:
        q = p - 0.5
        r = q * q
        return (((((a[0] * r + a[1]) * r + a[2]) * r + a[3]) * r + a[4]) * r + a[5]) * q / \
               (((((b[0] * r + b[1]) * r + b[2]) * r + b[3]) * r + b[4]) * r + 1)
    q = math.sqrt(-2 * math.log(1 - p))
    return -(((((c[0] * q + c[1]) * q + c[2]) * q + c[3]) * q + c[4]) * q + c[5]) / \
           ((((d[0] * q + d[1]) * q + d[2]) * q + d[3]) * q + 1)


@dataclasses.dataclass(frozen=True)
class RegionEstimate:
    """Per-region (or per-combination) ALEA estimates with CIs.

    ``pow_rails``/``e_rails`` carry the per-domain decomposition (aligned
    with ``domains``) when the profiling run measured multiple power
    rails; single-rail runs leave them ``None`` — nothing else changes.
    """

    region_id: int
    name: str
    n_samples: int            # n_bb
    p_hat: float              # Eq. 4
    t_hat: float              # Eq. 5  [s]
    t_lo: float               # Eq. 11 lower
    t_hi: float               # Eq. 11 upper
    pow_hat: float            # Eq. 6  [W]
    pow_lo: float             # Eq. 13
    pow_hi: float             # Eq. 12
    e_hat: float              # Eq. 7  [J]
    e_lo: float               # Eq. 16 lower
    e_hi: float               # Eq. 16 upper
    ci_valid: bool            # Wald validity: n·p̂>5 and n·(1-p̂)>5 (§4.3)
    domains: tuple[str, ...] | None = None
    pow_rails: tuple[float, ...] | None = None   # Eq. 6 per rail [W]
    e_rails: tuple[float, ...] | None = None     # Eq. 7 per rail [J]

    @property
    def t_ci_halfwidth(self) -> float:
        return 0.5 * (self.t_hi - self.t_lo)

    def energy_by_domain(self) -> Mapping[str, float]:
        """Per-domain energy split of this region (empty if single-rail)."""
        if self.domains is None:
            return {}
        return dict(zip(self.domains, self.e_rails))


@dataclasses.dataclass(frozen=True)
class EstimateTable:
    """Columnar per-region estimates (one numpy array per statistic).

    The vectorized ``_build_estimates`` produces this directly; it is the
    storage format for fleet-scale runs where the combination table reaches
    10⁴–10⁵ rows. :class:`RegionEstimate` objects are materialized lazily
    per row via :meth:`row` / :meth:`rows`.
    """

    region_ids: np.ndarray    # int64 [k]
    names: tuple[str, ...]    # len k (aligned with rows, not global ids)
    n_samples: np.ndarray     # int64 [k]
    p_hat: np.ndarray         # float64 [k]
    t_hat: np.ndarray
    t_lo: np.ndarray
    t_hi: np.ndarray
    pow_hat: np.ndarray
    pow_lo: np.ndarray
    pow_hi: np.ndarray
    e_hat: np.ndarray
    e_lo: np.ndarray
    e_hi: np.ndarray
    ci_valid: np.ndarray      # bool [k]
    # Per-domain decomposition (multi-rail runs only; None otherwise).
    domains: tuple[str, ...] | None = None
    pow_rails: np.ndarray | None = None      # float64 [k, D]
    pow_rails_lo: np.ndarray | None = None   # per-rail power CI (Eq. 12-14)
    pow_rails_hi: np.ndarray | None = None
    e_rails: np.ndarray | None = None        # float64 [k, D]
    e_rails_lo: np.ndarray | None = None     # per-rail Eq. 16 product CI
    e_rails_hi: np.ndarray | None = None

    def __len__(self) -> int:
        return len(self.region_ids)

    def row(self, i: int) -> RegionEstimate:
        """Materialize one row as a RegionEstimate view."""
        rails = {}
        if self.domains is not None:
            rails = dict(
                domains=self.domains,
                pow_rails=tuple(float(x) for x in self.pow_rails[i]),
                e_rails=tuple(float(x) for x in self.e_rails[i]))
        return RegionEstimate(
            region_id=int(self.region_ids[i]), name=self.names[i],
            n_samples=int(self.n_samples[i]), p_hat=float(self.p_hat[i]),
            t_hat=float(self.t_hat[i]), t_lo=float(self.t_lo[i]),
            t_hi=float(self.t_hi[i]), pow_hat=float(self.pow_hat[i]),
            pow_lo=float(self.pow_lo[i]), pow_hi=float(self.pow_hi[i]),
            e_hat=float(self.e_hat[i]), e_lo=float(self.e_lo[i]),
            e_hi=float(self.e_hi[i]), ci_valid=bool(self.ci_valid[i]),
            **rails)

    def rows(self) -> tuple[RegionEstimate, ...]:
        return tuple(self.row(i) for i in range(len(self)))

    @classmethod
    def from_rows(cls, rows: Sequence[RegionEstimate]) -> "EstimateTable":
        def col(attr, dtype):
            return np.array([getattr(r, attr) for r in rows], dtype=dtype)
        return cls(
            region_ids=col("region_id", np.int64),
            names=tuple(r.name for r in rows),
            n_samples=col("n_samples", np.int64),
            p_hat=col("p_hat", np.float64), t_hat=col("t_hat", np.float64),
            t_lo=col("t_lo", np.float64), t_hi=col("t_hi", np.float64),
            pow_hat=col("pow_hat", np.float64),
            pow_lo=col("pow_lo", np.float64),
            pow_hi=col("pow_hi", np.float64),
            e_hat=col("e_hat", np.float64), e_lo=col("e_lo", np.float64),
            e_hi=col("e_hi", np.float64), ci_valid=col("ci_valid", bool))


@dataclasses.dataclass(frozen=True)
class EstimateSet:
    """All region estimates from one profiling pass.

    Backed by a columnar :class:`EstimateTable`; ``regions`` is a lazily
    cached tuple of per-row views, so existing consumers keep iterating
    RegionEstimate objects while array consumers read ``table`` columns.
    """

    table: EstimateTable
    n_total: int
    t_exec: float
    alpha: float
    # Fleet-coverage provenance of a degraded gather (the
    # ``GatherResult.coverage()`` dict of :mod:`repro_torch.core.exchange`):
    # which hosts merged at which epoch, which were missing / stale /
    # quarantined. None means the statistics were not fleet-gathered or
    # the gather was strict (all-or-nothing), i.e. coverage is total.
    coverage: Mapping | None = None
    # Bounded-state (heavy-hitters) disclosure: when the combination
    # table ran with a top-k + per-region ``other`` tier, this carries
    # the fold counters ({"k", "resident", "other_rows", "tail_folds",
    # "evictions"}) that back the report's TAIL line. None for exact
    # tables — per-row identity is complete.
    tail: Mapping | None = None

    @classmethod
    def from_regions(cls, regions: Sequence[RegionEstimate], n_total: int,
                     t_exec: float, alpha: float) -> "EstimateSet":
        return cls(table=EstimateTable.from_rows(tuple(regions)),
                   n_total=n_total, t_exec=t_exec, alpha=alpha)

    @property
    def complete_coverage(self) -> bool:
        """False only when attached gather provenance says hosts are
        missing, stale or quarantined."""
        return self.coverage is None or bool(self.coverage.get("complete"))

    @functools.cached_property
    def regions(self) -> tuple[RegionEstimate, ...]:
        return self.table.rows()

    def by_name(self) -> Mapping[str, RegionEstimate]:
        return {r.name: r for r in self.regions}

    @property
    def total_energy(self) -> float:
        return float(self.table.e_hat.sum())

    @property
    def total_time(self) -> float:
        return float(self.table.t_hat.sum())

    @property
    def domains(self) -> tuple[str, ...] | None:
        """Power-rail domain names of a multi-rail run, else None."""
        return self.table.domains

    def energy_by_domain(self) -> Mapping[str, float]:
        """Whole-run energy per power rail (empty for single-rail runs)."""
        if self.table.domains is None:
            return {}
        return {d: float(self.table.e_rails[:, j].sum())
                for j, d in enumerate(self.table.domains)}

    def dominant(self, k: int = 1) -> tuple[RegionEstimate, ...]:
        """Top-k regions by estimated energy (hotspot analysis, §7.1)."""
        idx = np.argsort(-self.table.e_hat, kind="stable")[:k]
        return tuple(self.table.row(int(i)) for i in idx)


AggregateFn = Callable[[np.ndarray, np.ndarray, int],
                       tuple[np.ndarray, np.ndarray, np.ndarray]]


def aggregate_samples_np(region_ids: np.ndarray, powers: np.ndarray,
                         num_regions: int) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Reference aggregation: per-region sample counts, Σpow, Σpow².

    This is the tool's aggregation hot spot (one entry per sample; fleets
    collect billions). ``kernels/sample_attr`` provides the CUDA
    equivalent (``ops.as_aggregate_fn``); both must match this exactly.
    """
    region_ids = np.asarray(region_ids)
    powers = np.asarray(powers, dtype=np.float64)
    counts = np.bincount(region_ids, minlength=num_regions).astype(np.int64)
    psum = np.bincount(region_ids, weights=powers, minlength=num_regions)
    psumsq = np.bincount(region_ids, weights=powers * powers, minlength=num_regions)
    return counts, psum, psumsq


def _build_estimates(counts: np.ndarray, psum: np.ndarray, psumsq: np.ndarray,
                     names: Sequence[str], t_exec: float, alpha: float,
                     drop_empty: bool, rail_psum: np.ndarray | None = None,
                     rail_psumsq: np.ndarray | None = None,
                     domains: Sequence[str] | None = None,
                     coverage: Mapping | None = None,
                     tail: Mapping | None = None) -> EstimateSet:
    """Vectorized Eq. 4-16 over the per-region sufficient statistics.

    Pure numpy column math — no per-region Python loop — so multi-worker
    runs with 10⁴–10⁵ combinations build in array time. Returns an
    EstimateSet backed by a columnar EstimateTable. ``rail_psum``/
    ``rail_psumsq`` [R, D] extend the table with the per-domain
    decomposition: the same Eq. 6/7/12-16 column math applies per rail
    (the time proportion — and so the Wald interval — is shared, since
    all rails ride one sample clock).
    """
    counts = np.asarray(counts, dtype=np.int64)
    psum = np.asarray(psum, dtype=np.float64)
    psumsq = np.asarray(psumsq, dtype=np.float64)
    n = int(counts.sum())
    if n == 0:
        raise ValueError("no samples collected; cannot estimate")
    z = z_quantile(alpha)

    rids = np.arange(len(counts), dtype=np.int64)
    if drop_empty:
        keep = counts > 0
        rids, counts = rids[keep], counts[keep]
        psum, psumsq = psum[keep], psumsq[keep]
        if rail_psum is not None:
            rail_psum = rail_psum[keep]
            rail_psumsq = rail_psumsq[keep]

    p_hat = counts / n
    # Eq. 8/9: Wald interval on the Bernoulli proportion.
    se_p = np.sqrt(np.maximum(p_hat * (1.0 - p_hat), 0.0) / n)
    p_lo = np.maximum(p_hat - z * se_p, 0.0)
    p_hi = np.minimum(p_hat + z * se_p, 1.0)
    t_hat = p_hat * t_exec

    def power_ci(s, sq, cnt):
        """Eq. 6 and 12-14 column math (shared by total and rails)."""
        nz = cnt > 0
        hat = np.divide(s, cnt, out=np.zeros_like(s), where=nz)
        gt1 = cnt > 1
        var = np.divide(sq - cnt * hat * hat, np.maximum(cnt - 1, 1),
                        out=np.zeros_like(s), where=gt1)
        se = np.sqrt(np.maximum(var, 0.0) / np.maximum(cnt, 1))
        return hat, hat - z * se, hat + z * se

    pow_hat, pow_lo, pow_hi = power_ci(psum, psumsq,
                                       counts.astype(np.float64))
    e_hat = pow_hat * t_hat                      # Eq. 7
    rails = {}
    if rail_psum is not None:
        cnt_d = counts.astype(np.float64)[:, None]
        pr_hat, pr_lo, pr_hi = power_ci(
            np.asarray(rail_psum, np.float64),
            np.asarray(rail_psumsq, np.float64), cnt_d)
        rails = dict(
            domains=tuple(domains),
            pow_rails=pr_hat, pow_rails_lo=pr_lo, pow_rails_hi=pr_hi,
            e_rails=pr_hat * t_hat[:, None],
            e_rails_lo=(p_lo * t_exec)[:, None] * pr_lo,   # Eq. 16 per rail
            e_rails_hi=(p_hi * t_exec)[:, None] * pr_hi)
    n_names = len(names)
    table = EstimateTable(
        region_ids=rids,
        names=tuple(names[r] if r < n_names else f"region_{r}"
                    for r in rids),
        n_samples=counts,
        p_hat=p_hat,
        t_hat=t_hat,
        t_lo=p_lo * t_exec,
        t_hi=p_hi * t_exec,
        pow_hat=pow_hat,
        pow_lo=pow_lo,
        pow_hi=pow_hi,
        e_hat=e_hat,
        e_lo=p_lo * t_exec * pow_lo,             # Eq. 16
        e_hi=p_hi * t_exec * pow_hi,
        ci_valid=(n * p_hat > 5.0) & (n * (1.0 - p_hat) > 5.0),
        **rails,
    )
    return EstimateSet(table=table, n_total=n, t_exec=float(t_exec),
                       alpha=alpha, coverage=coverage, tail=tail)


def estimates_from_statistics(counts: np.ndarray, psum: np.ndarray,
                              psumsq: np.ndarray, t_exec: float,
                              names: Sequence[str], *, alpha: float = 0.05,
                              drop_empty: bool = True,
                              rail_psum: np.ndarray | None = None,
                              rail_psumsq: np.ndarray | None = None,
                              domains: Sequence[str] | None = None,
                              coverage: Mapping | None = None,
                              tail: Mapping | None = None
                              ) -> EstimateSet:
    """Build estimates directly from pre-aggregated sufficient statistics.

    Entry point for the streaming path: a
    :class:`repro_torch.core.streaming.StreamingAggregator` (or any multi-host
    shard reduction) hands its merged (counts, Σpow, Σpow²) here without
    ever materializing the raw sample stream. ``rail_psum``/``rail_psumsq``
    + ``domains`` add the per-domain columns for multi-rail runs;
    ``coverage`` attaches a degraded gather's provenance so reports can
    disclose partial fleets.
    """
    if not (rail_psum is None) == (rail_psumsq is None) == (domains is None):
        raise ValueError("rail_psum, rail_psumsq and domains must be "
                         "passed together")
    return _build_estimates(np.asarray(counts), np.asarray(psum),
                            np.asarray(psumsq), list(names), t_exec, alpha,
                            drop_empty,
                            rail_psum=None if rail_psum is None
                            else np.asarray(rail_psum),
                            rail_psumsq=None if rail_psumsq is None
                            else np.asarray(rail_psumsq), domains=domains,
                            coverage=coverage, tail=tail)


def estimate_regions(region_ids: np.ndarray, powers: np.ndarray,
                     t_exec: float, names: Sequence[str],
                     *, alpha: float = 0.05, drop_empty: bool = True,
                     aggregate_fn: AggregateFn | None = None) -> EstimateSet:
    """One-pass ALEA estimation over a (region_id, power) sample stream.

    Args:
      region_ids: int array [n] of sampled region ids (PC → basic block map).
      powers: float array [n] of simultaneous sensor readings [W].
      t_exec: measured total execution time [s] of the profiled run.
      names: region id → human name.
      alpha: 1 - confidence level (paper uses 95% → alpha=0.05).
      aggregate_fn: optional replacement aggregation (e.g. the CUDA kernel op).
    """
    num_regions = len(names)
    agg = aggregate_fn or aggregate_samples_np
    counts, psum, psumsq = (np.asarray(x) for x in
                            agg(np.asarray(region_ids), np.asarray(powers),
                                num_regions))
    return _build_estimates(counts, psum, psumsq, list(names), t_exec, alpha,
                            drop_empty)


def encode_combinations(region_id_matrix: np.ndarray
                        ) -> tuple[np.ndarray, list[tuple[int, ...]]]:
    """Map per-sample region-id vectors (one per worker) to combination ids.

    Paper §4.4 / Eq. 19: ``comb = (bb_thread_1, ..., bb_thread_l)``.

    One-shot variant: sorts the full matrix via ``np.unique`` (combos come
    out in lexicographic order). For chunked streams use
    :class:`repro_torch.core.streaming.CombinationInterner`, which interns rows
    incrementally in first-appearance order with O(chunk + distinct) memory.

    Args:
      region_id_matrix: int array [n, workers].
    Returns:
      (comb_ids [n], list of combination tuples indexed by comb id).
    """
    mat = np.asarray(region_id_matrix)
    if mat.ndim != 2:
        raise ValueError(f"expected [n, workers]; got shape {mat.shape}")
    uniq, inverse = np.unique(mat, axis=0, return_inverse=True)
    combos = [tuple(int(v) for v in row) for row in uniq]
    return inverse.astype(np.int64), combos


def _combo_field_name(r: int, names: Sequence[str], n_names: int) -> str:
    """One combination field → display name. Negative ids are the
    bounded-mode tail sentinel (``sketch.OTHER``): render ``other``, never
    ``names[-1]`` (Python's end-indexing would silently alias the last
    region)."""
    if r < 0:
        return "other"
    return names[r] if r < n_names else f"r{r}"


def combination_names(combos: Sequence[tuple[int, ...]],
                      names: Sequence[str]) -> list[str]:
    """Human names for combination tuples (shared by one-shot + streaming)."""
    n_names = len(names)
    return ["+".join(_combo_field_name(r, names, n_names) for r in c)
            for c in combos]


def combination_names_from_matrix(combo_matrix: np.ndarray,
                                  names: Sequence[str]) -> list[str]:
    """Human names for a serialized combination key table [k, workers].

    The exchange wire format (:mod:`repro_torch.core.exchange`) carries
    combination id spaces as int64 matrices rather than tuple lists; a
    merged table is named directly from the matrix so finalization never
    reconstructs Python tuples.
    """
    mat = np.asarray(combo_matrix)
    if mat.ndim != 2:
        raise ValueError(f"expected [k, workers]; got shape {mat.shape}")
    n_names = len(names)
    return ["+".join(_combo_field_name(r, names, n_names) for r in row)
            for row in mat.tolist()]


def estimate_combinations(region_id_matrix: np.ndarray, powers: np.ndarray,
                          t_exec: float, names: Sequence[str],
                          *, alpha: float = 0.05) -> tuple[EstimateSet, list[tuple[int, ...]]]:
    """Multi-worker estimation over region combinations (Eqs. 17-19)."""
    comb_ids, combos = encode_combinations(region_id_matrix)
    est = estimate_regions(comb_ids, powers, t_exec,
                           combination_names(combos, names), alpha=alpha)
    return est, combos


def marginalize_worker(est: EstimateSet, combos: list[tuple[int, ...]],
                       names: Sequence[str]) -> EstimateSet:
    """Collapse combination estimates back to per-region marginals.

    A region's marginal time is the sum over combinations containing it;
    its power is the time-weighted mean of combination powers. Useful for
    hotspot ranking while the combination table retains contention detail.
    """
    by_comb = {c: r for c, r in zip(combos, est.regions)}
    num_regions = len(names)
    t = np.zeros(num_regions)
    e = np.zeros(num_regions)
    ns = np.zeros(num_regions, dtype=np.int64)
    for c, r in by_comb.items():
        for rid in set(c):
            t[rid] += r.t_hat
            e[rid] += r.e_hat
            ns[rid] += r.n_samples
    out = []
    for rid in range(num_regions):
        if ns[rid] == 0:
            continue
        pw = e[rid] / t[rid] if t[rid] > 0 else 0.0
        out.append(RegionEstimate(
            region_id=rid, name=names[rid], n_samples=int(ns[rid]),
            p_hat=t[rid] / est.t_exec if est.t_exec else 0.0,
            t_hat=float(t[rid]), t_lo=float("nan"), t_hi=float("nan"),
            pow_hat=float(pw), pow_lo=float("nan"), pow_hi=float("nan"),
            e_hat=float(e[rid]), e_lo=float("nan"), e_hi=float("nan"),
            ci_valid=False))
    return EstimateSet.from_regions(out, n_total=est.n_total,
                                    t_exec=est.t_exec, alpha=est.alpha)
