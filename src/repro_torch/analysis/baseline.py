"""Ratcheted baselines for both auditor layers.

Layer 1 (:mod:`repro.analysis.passes`) pins pre-existing findings in
``baseline.json``: a count per finding *key* (``pass:path:ident`` —
deliberately line-free, so unrelated edits that shift code don't churn
the file). A check fails only on findings in excess of the pinned count;
keys whose findings were fixed are reported as stale so the baseline
shrinks over time.

Layer 2 (:mod:`repro.analysis.jaxpr_audit`) pins per-hot-path metric
counts in ``x64_budget.json`` (f64 ops, widenings, host callbacks, and
the donation-aliasing contract). Metrics are a one-way ratchet: a check
fails when any count *exceeds* its budget, and ``--update-baseline``
refuses to raise a committed f64 budget unless forced
(``allow_increase``) — the ROADMAP item-2 mechanism for driving the
fused chunk step x64-free without regressions sneaking back in.
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import Mapping, Sequence

from repro_torch.analysis.passes import Finding

__all__ = [
    "load_counts", "save_counts", "finding_counts", "RatchetResult",
    "check_findings", "load_budget", "save_budget", "BudgetViolation",
    "check_budget", "merge_budget",
]


# -- layer 1: finding-count baseline ------------------------------------------

def load_counts(path: str) -> dict[str, int]:
    """Baseline key -> pinned count; missing file means empty baseline."""
    if not os.path.exists(path):
        return {}
    with open(path) as f:
        data = json.load(f)
    counts = data.get("counts", {}) if isinstance(data, dict) else {}
    return {str(k): int(v) for k, v in counts.items()}


def save_counts(counts: Mapping[str, int], path: str) -> None:
    payload = {
        "_comment": ("Pinned pre-existing contract findings "
                     "(repro.analysis layer 1). Regenerate with "
                     "`python -m repro.analysis --update-baseline`; "
                     "counts should only shrink."),
        "counts": {k: counts[k] for k in sorted(counts)},
    }
    with open(path, "w") as f:
        json.dump(payload, f, indent=2, sort_keys=False)
        f.write("\n")


def finding_counts(findings: Sequence[Finding]) -> dict[str, int]:
    counts: dict[str, int] = {}
    for f in findings:
        counts[f.key] = counts.get(f.key, 0) + 1
    return counts


@dataclasses.dataclass
class RatchetResult:
    new: list[Finding]           # findings in excess of the baseline
    baselined: list[Finding]     # findings absorbed by the baseline
    stale_keys: list[str]        # baseline keys with no current finding

    @property
    def ok(self) -> bool:
        return not self.new


def check_findings(findings: Sequence[Finding],
                   baseline: Mapping[str, int]) -> RatchetResult:
    """Split findings into new vs baselined; report stale baseline keys.

    Within one key, the *first* ``baseline[key]`` findings (source
    order) are absorbed — which ones is arbitrary but stable, and the
    failure message always shows concrete file:line rows.
    """
    by_key: dict[str, list[Finding]] = {}
    for f in findings:
        by_key.setdefault(f.key, []).append(f)
    new: list[Finding] = []
    baselined: list[Finding] = []
    for key, group in by_key.items():
        allowed = int(baseline.get(key, 0))
        baselined.extend(group[:allowed])
        new.extend(group[allowed:])
    stale = [k for k in baseline if len(by_key.get(k, ())) < baseline[k]]
    new.sort(key=lambda f: (f.path, f.line, f.pass_name))
    return RatchetResult(new=new, baselined=baselined,
                         stale_keys=sorted(stale))


# -- layer 2: per-path metric budget ------------------------------------------

# Metrics that ratchet (current must be <= budget). Donation is checked
# absolutely by the auditor itself — an unaliased donated arg is a bug
# at any count, not a budget line.
RATCHET_METRICS = ("f64_ops", "f64_widenings", "host_callbacks")


def load_budget(path: str) -> dict[str, dict]:
    if not os.path.exists(path):
        return {}
    with open(path) as f:
        data = json.load(f)
    paths = data.get("paths", {}) if isinstance(data, dict) else {}
    return {str(k): dict(v) for k, v in paths.items()}


def save_budget(paths: Mapping[str, dict], path: str) -> None:
    payload = {
        "_comment": ("Committed per-hot-path budgets (repro.analysis "
                     "layer 2): f64 op counts may only go down "
                     "(ROADMAP item 2 ratchet). Regenerate with "
                     "`python -m repro.analysis --update-baseline`."),
        "paths": {k: paths[k] for k in sorted(paths)},
    }
    with open(path, "w") as f:
        json.dump(payload, f, indent=2, sort_keys=False)
        f.write("\n")


@dataclasses.dataclass(frozen=True)
class BudgetViolation:
    path_name: str
    message: str

    def render(self) -> str:
        return f"{self.path_name}: {self.message}"


def check_budget(reports: Sequence, budget: Mapping[str, dict]
                 ) -> list[BudgetViolation]:
    """Compare :class:`jaxpr_audit.PathReport` rows against the budget."""
    out: list[BudgetViolation] = []
    for r in reports:
        entry = budget.get(r.name)
        if entry is None:
            out.append(BudgetViolation(
                r.name,
                "hot path not in x64_budget.json — run "
                "`python -m repro.analysis --update-baseline`"))
            continue
        for metric in RATCHET_METRICS:
            cur = int(getattr(r, metric))
            cap = int(entry.get(metric, 0))
            if cur > cap:
                out.append(BudgetViolation(
                    r.name,
                    f"{metric} grew: {cur} > budget {cap} "
                    f"(the ratchet only goes down)"))
        if r.donated_expected and r.donated_aliased < r.donated_expected:
            out.append(BudgetViolation(
                r.name,
                f"donation broken: {r.donated_aliased}/"
                f"{r.donated_expected} donated args aliased to outputs"))
    return out


def merge_budget(reports: Sequence, existing: Mapping[str, dict], *,
                 allow_increase: bool = False) -> dict[str, dict]:
    """New budget file contents from fresh reports.

    Raises ``ValueError`` on an attempt to raise a committed f64 count
    without ``allow_increase`` — updating the baseline must not be a
    back door around the ratchet.
    """
    out: dict[str, dict] = {}
    for r in reports:
        entry = {
            "f64_ops": int(r.f64_ops),
            "f64_widenings": int(r.f64_widenings),
            "host_callbacks": int(r.host_callbacks),
            "donated_expected": int(r.donated_expected),
            "donated_aliased": int(r.donated_aliased),
        }
        prev = existing.get(r.name)
        if prev is not None and not allow_increase:
            for metric in RATCHET_METRICS:
                if entry[metric] > int(prev.get(metric, 0)):
                    raise ValueError(
                        f"{r.name}: refusing to raise {metric} budget "
                        f"{prev.get(metric, 0)} -> {entry[metric]} "
                        f"(pass allow_increase to force)")
        out[r.name] = entry
    return out
