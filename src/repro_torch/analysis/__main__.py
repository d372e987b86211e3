"""CLI for the contract auditor.

Modes (mutually exclusive; ``--check`` is the default):

* ``--check``           fail (exit 1) on any finding not absorbed by
                        ``baseline.json`` or any hot-path metric over
                        its ``x64_budget.json`` budget.
* ``--report``          print everything — baselined findings included,
                        per-path f64 inventories — and exit 0.
* ``--update-baseline`` regenerate both baseline files from the current
                        tree. Refuses to *raise* a committed f64 budget
                        unless ``--allow-increase`` is also given.

``--no-op-audit`` (the reference's ``--no-jaxpr``) skips layer 2 (no
model is built, no hot path runs) for fast lint-loop iterations on the
AST passes alone. Layer 2 runs the hot paths on the CPU, where the
committed budget is pinned.
"""

from __future__ import annotations

import argparse
import sys

from repro_torch.analysis import (BASELINE_PATH, BUDGET_PATH, run_audit,
                                  run_passes, scan_repo)
from repro_torch.analysis import baseline as baseline_mod


def _print_findings(findings, label: str) -> None:
    if not findings:
        return
    print(f"-- {label} ({len(findings)}) --")
    for f in findings:
        print(f"  {f.render()}")


def _cmd_check(args) -> int:
    result = run_audit(op_audit=not args.no_op_audit)
    _print_findings(result.ratchet.new, "new contract findings")
    for v in result.budget_violations:
        print(f"  [op-audit] {v.render()}")
    if result.ratchet.stale_keys:
        print(f"note: {len(result.ratchet.stale_keys)} baseline entries "
              f"are stale (fixed findings) — run --update-baseline to "
              f"shrink the pin file")
    if not result.ok:
        n = len(result.ratchet.new) + len(result.budget_violations)
        print(f"contract audit FAILED: {n} violation(s)")
        return 1
    n_base = len(result.ratchet.baselined)
    suffix = f" ({n_base} baselined)" if n_base else ""
    print(f"contract audit OK: {len(result.findings)} finding(s) "
          f"absorbed{suffix}, "
          f"{len(result.reports)} hot path(s) within budget")
    return 0


def _cmd_report(args) -> int:
    result = run_audit(op_audit=not args.no_op_audit)
    _print_findings(result.ratchet.new, "new contract findings")
    _print_findings(result.ratchet.baselined, "baselined findings")
    if result.ratchet.stale_keys:
        print(f"-- stale baseline keys ({len(result.ratchet.stale_keys)}) --")
        for k in result.ratchet.stale_keys:
            print(f"  {k}")
    if result.reports:
        print("-- hot-path audit --")
        for r in result.reports:
            print(f"  {r.render()}")
    for v in result.budget_violations:
        print(f"  [op-audit] {v.render()}")
    return 0


def _cmd_update(args) -> int:
    units = scan_repo()
    findings = run_passes(units)
    baseline_mod.save_counts(baseline_mod.finding_counts(findings),
                             BASELINE_PATH)
    print(f"wrote {BASELINE_PATH} ({len(findings)} finding(s) pinned)")
    if not args.no_op_audit:
        from repro_torch.analysis.op_audit import audit_hot_paths
        reports = audit_hot_paths(device="cpu")
        try:
            merged = baseline_mod.merge_budget(
                reports, baseline_mod.load_budget(BUDGET_PATH),
                allow_increase=args.allow_increase)
        except ValueError as e:
            print(f"refusing to update x64 budget: {e}")
            return 1
        baseline_mod.save_budget(merged, BUDGET_PATH)
        print(f"wrote {BUDGET_PATH} ({len(reports)} hot path(s))")
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.analysis",
        description="contract auditor: AST passes + hot-path op audits")
    mode = ap.add_mutually_exclusive_group()
    mode.add_argument("--check", action="store_true",
                      help="fail on new findings / budget overruns "
                           "(default)")
    mode.add_argument("--report", action="store_true",
                      help="print the full audit, never fail")
    mode.add_argument("--update-baseline", action="store_true",
                      help="regenerate baseline.json + x64_budget.json")
    ap.add_argument("--allow-increase", action="store_true",
                    help="with --update-baseline: permit a committed f64 "
                         "budget to grow")
    ap.add_argument("--no-op-audit", action="store_true",
                    help="layer 1 only (skip the hot-path op audit)")
    args = ap.parse_args(argv)
    if args.update_baseline:
        return _cmd_update(args)
    if args.report:
        return _cmd_report(args)
    return _cmd_check(args)


if __name__ == "__main__":
    sys.exit(main())
