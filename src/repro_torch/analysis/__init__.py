"""Contract auditor: static enforcement of the port's invariants.

Port of ``src/repro/analysis``. Two layers (see ``README.md`` in this
package):

* **Layer 1** — AST passes over ``src/repro_torch`` (:mod:`.passes`, the
  reference's text, plus :mod:`.torch_passes`): determinism hygiene,
  typed spill errors, no silent excepts, fault-site registry discipline,
  scoped ``enable_x64`` and scoped default dtype/device flips.
  Pre-existing findings are pinned in ``baseline.json``; only new ones
  fail.
* **Layer 2** — op audits of the hot paths (:mod:`.op_audit`): each path
  runs once under a ``TorchDispatchMode`` that records its aten ops; the
  float64-op inventory and host waits are ratcheted by
  ``x64_budget.json``, and the carry's in-place updates are verified.

Entry point: ``python -m repro_torch.analysis
[--check|--report|--update-baseline]``.
"""

from __future__ import annotations

import dataclasses
import os

from repro_torch.analysis import baseline as baseline_mod
from repro_torch.analysis import torch_passes  # noqa: F401  (registers)
from repro_torch.analysis.passes import (ContractPass, FileUnit, Finding,
                                         PASS_REGISTRY, all_passes,
                                         parse_unit, run_passes)

__all__ = [
    "Finding", "FileUnit", "ContractPass", "PASS_REGISTRY",
    "all_passes", "parse_unit", "run_passes",
    "REPO_ROOT", "SCAN_ROOT", "BASELINE_PATH", "BUDGET_PATH",
    "scan_repo", "AuditResult", "run_audit",
]

_PKG_DIR = os.path.dirname(os.path.abspath(__file__))
REPO_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(_PKG_DIR)))
SCAN_ROOT = os.path.join(REPO_ROOT, "src", "repro_torch")
BASELINE_PATH = os.path.join(_PKG_DIR, "baseline.json")
BUDGET_PATH = os.path.join(_PKG_DIR, "x64_budget.json")


def scan_repo(scan_root: str | None = None) -> list[FileUnit]:
    """Parse every ``.py`` under the scan root (default:
    ``src/repro_torch``)."""
    root = scan_root or SCAN_ROOT
    units: list[FileUnit] = []
    for dirpath, dirnames, filenames in os.walk(root):
        dirnames[:] = sorted(d for d in dirnames
                             if d not in ("__pycache__",))
        for fname in sorted(filenames):
            if not fname.endswith(".py"):
                continue
            full = os.path.join(dirpath, fname)
            modpath = os.path.relpath(full, root).replace(os.sep, "/")
            display = os.path.relpath(full, REPO_ROOT).replace(os.sep, "/")
            with open(full) as f:
                source = f.read()
            units.append(parse_unit(display, modpath, source))
    return units


@dataclasses.dataclass
class AuditResult:
    """Everything one full audit run produced, pre-ratchet-checked."""
    findings: list                   # all layer-1 findings (pre-baseline)
    ratchet: "baseline_mod.RatchetResult"
    reports: list                    # layer-2 PathReports ([] if skipped)
    budget_violations: list          # layer-2 ratchet failures

    @property
    def ok(self) -> bool:
        return self.ratchet.ok and not self.budget_violations


def run_audit(*, op_audit: bool = True,
              baseline_path: str | None = None,
              budget_path: str | None = None) -> AuditResult:
    """One full audit: scan + passes + baseline check (+ the op audit of
    the hot paths against the budget). The budget is pinned on the CPU,
    so the hot paths run there; ``op_audit.audit_hot_paths(device=...)``
    runs them on the GPU."""
    units = scan_repo()
    findings = run_passes(units)
    ratchet = baseline_mod.check_findings(
        findings, baseline_mod.load_counts(baseline_path or BASELINE_PATH))
    reports: list = []
    violations: list = []
    if op_audit:
        from repro_torch.analysis.op_audit import audit_hot_paths
        reports = audit_hot_paths(device="cpu")
        violations = baseline_mod.check_budget(
            reports, baseline_mod.load_budget(budget_path or BUDGET_PATH))
    return AuditResult(findings=findings, ratchet=ratchet,
                       reports=reports, budget_violations=violations)
