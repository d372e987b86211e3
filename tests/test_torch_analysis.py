"""The port's contract auditor (``repro_torch.analysis``).

Layer 1 is the reference's: its AST-pass cases (``tests/test_analysis.py``)
run here against the port's package, whose ``passes.py`` is the
reference's file byte for byte and whose ``baseline.py`` differs only in
its import; the port's own ``default-dtype-scoping`` pass is held to a
bare and a scoped flip. Layer 2 runs paths under a dispatch mode: a
float64 leak and a widening are flagged, float32 code is clean, ops in a
Python loop are all counted, a step that rebinds its carry is not in
place, ``.item()`` is a host wait, and an lru cache's entries are
counted; the budget ratchets as the reference's. The committed tree
audits clean: layer 1 over ``src/repro_torch``, the 20 hot paths against
``x64_budget.json`` (the reference's keys; every serve row 0 float64
ops, 0 widenings, 0 host waits in both files; the combination step one
host wait a chunk, the region step none; every carry leaf in place), and
``python -m repro_torch.analysis --check`` in a subprocess, which never
imports JAX.
"""

import functools
import json
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import pytest
import torch

from repro_torch.analysis import BUDGET_PATH, run_audit, scan_repo
from repro_torch.analysis import baseline as bl
from repro_torch.analysis.op_audit import (PathReport, audit_hot_paths,
                                           audit_ops, donation_in_place,
                                           jit_cache_size)
from repro_torch.analysis.passes import (FaultSiteHygienePass,
                                         NoSilentExceptPass, NoWallclockPass,
                                         TypedSpillErrorsPass, X64ScopingPass,
                                         parse_unit, run_passes)
from repro_torch.analysis.torch_passes import (DefaultDtypeScopingPass,
                                               NoSpanReadsPass)

ROOT = Path(__file__).resolve().parents[1]
REF_ANALYSIS = ROOT / "src" / "repro" / "analysis"
PORT_ANALYSIS = ROOT / "src" / "repro_torch" / "analysis"


def _scan(src, modpath="core/device_pipeline.py", passes=None, extra=()):
    unit = parse_unit(f"src/repro_torch/{modpath}", modpath,
                      textwrap.dedent(src))
    return run_passes([unit, *extra], passes)


# ---------------------------------------------------------------------------
# pass (a): no-wallclock
# ---------------------------------------------------------------------------

def test_wallclock_fixture_caught():
    bad = """\
        import time
        import numpy as np
        import random
        from datetime import datetime

        def f():
            t = time.time()
            r = random.random()
            x = np.random.rand(3)
            g = np.random.default_rng()
            d = datetime.now()
            return t, r, x, g, d
    """
    idents = {f.ident for f in _scan(bad, passes=[NoWallclockPass()])}
    assert idents == {"time.time", "random.random", "np.random.rand",
                      "np.random.default_rng", "datetime.datetime.now"}


def test_wallclock_clean_code_passes():
    clean = """\
        import time
        import numpy as np
        import jax

        def f(seed):
            time.sleep(0.1)                      # spends time, reads none
            rng = np.random.default_rng(seed)    # explicit seed
            key = jax.random.PRNGKey(seed)
            return rng, jax.random.uniform(key, (3,))
    """
    assert _scan(clean, passes=[NoWallclockPass()]) == []


def test_wallclock_only_in_critical_modules():
    bad = "import time\nt = time.time()\n"
    assert _scan(bad, modpath="core/report.py",
                 passes=[NoWallclockPass()]) == []
    assert len(_scan(bad, modpath="kernels/sample_attr/ops.py",
                     passes=[NoWallclockPass()])) == 1


def test_wallclock_sees_through_aliases():
    bad = "import time as t\nx = t.monotonic()\n"
    (f,) = _scan(bad, passes=[NoWallclockPass()])
    assert f.ident == "time.monotonic"


# ---------------------------------------------------------------------------
# pass (b): typed-spill-errors
# ---------------------------------------------------------------------------

def test_builtin_oserror_raise_caught():
    bad = """\
        def publish(path):
            raise IOError(f"spill failed: {path}")
    """
    (f,) = _scan(bad, modpath="core/exchange.py",
                 passes=[TypedSpillErrorsPass()])
    assert f.ident == "IOError" and f.line == 2


def test_typed_spill_raise_passes():
    clean = """\
        from repro_torch.core.faults import CorruptShardError

        def publish(path):
            raise CorruptShardError(f"bad crc: {path}")
    """
    assert _scan(clean, modpath="checkpoint/ckpt.py",
                 passes=[TypedSpillErrorsPass()]) == []


def test_bare_reraise_passes():
    clean = """\
        def f():
            try:
                g()
            except IOError:
                raise
    """
    assert _scan(clean, modpath="core/exchange.py",
                 passes=[TypedSpillErrorsPass()]) == []


# ---------------------------------------------------------------------------
# pass (c): no-silent-except
# ---------------------------------------------------------------------------

def test_silent_except_variants_caught():
    bad = """\
        def f():
            try:
                g()
            except ValueError:
                pass
            try:
                g()
            except IOError:
                return None
            for _ in range(3):
                try:
                    g()
                except Exception:
                    print("oops")   # log-and-continue, no counter
    """
    found = _scan(bad, modpath="serve/engine.py",
                  passes=[NoSilentExceptPass()])
    assert len(found) == 3


def test_handled_except_passes():
    clean = """\
        def f(stats):
            try:
                g()
            except IOError as e:
                stats["errors"] += 1
            try:
                g()
            except ValueError as e:
                raise RuntimeError("ctx") from e
    """
    assert _scan(clean, modpath="core/exchange.py",
                 passes=[NoSilentExceptPass()]) == []


def test_pragma_suppresses_with_reason_block():
    ok = """\
        def f():
            try:
                g()
            # audit: allow(no-silent-except) absence means empty here —
            # callers treat a missing dir as no durable state
            except FileNotFoundError:
                return None
    """
    assert _scan(ok, modpath="core/exchange.py",
                 passes=[NoSilentExceptPass()]) == []


def test_pragma_is_per_pass():
    wrong_pass = """\
        def f():
            try:
                g()
            # audit: allow(no-wallclock) wrong pass name
            except FileNotFoundError:
                return None
    """
    assert len(_scan(wrong_pass, modpath="core/exchange.py",
                     passes=[NoSilentExceptPass()])) == 1


# ---------------------------------------------------------------------------
# pass (d): fault-site-hygiene
# ---------------------------------------------------------------------------

def _registry_unit(sites='("a.x", "b.y")'):
    return parse_unit("src/repro_torch/core/faults.py", "core/faults.py",
                      f"FAULT_SITES = {sites}\n")


def test_fault_sites_clean():
    decls = 'from repro_torch.core.faults import declare_site\n' \
            '_A = declare_site("a.x")\n_B = declare_site("b.y")\n'
    assert _scan(decls, modpath="core/seam.py",
                 passes=[FaultSiteHygienePass()],
                 extra=[_registry_unit()]) == []


def test_unregistered_site_caught():
    decls = '_C = declare_site("c.z")\n_A = declare_site("a.x")\n' \
            '_B = declare_site("b.y")\n'
    idents = {f.ident for f in _scan(decls, modpath="core/seam.py",
                                     passes=[FaultSiteHygienePass()],
                                     extra=[_registry_unit()])}
    assert idents == {"unregistered:c.z"}


def test_duplicate_and_undeclared_sites_caught():
    decls = '_A1 = declare_site("a.x")\n_A2 = declare_site("a.x")\n'
    idents = {f.ident for f in _scan(decls, modpath="core/seam.py",
                                     passes=[FaultSiteHygienePass()],
                                     extra=[_registry_unit()])}
    assert idents == {"duplicate:a.x", "undeclared:b.y"}


def test_non_literal_site_caught():
    decls = 'NAME = "a.x"\n_A = declare_site(NAME)\n' \
            '_B = declare_site("b.y")\n'
    idents = {f.ident for f in _scan(decls, modpath="core/seam.py",
                                     passes=[FaultSiteHygienePass()],
                                     extra=[_registry_unit()])}
    assert "<non-literal>" in idents


def test_runtime_registry_matches_static_declarations():
    """The live FAULT_SITES registry and the declared-site map agree:
    every site the static pass expects is declared at import time by
    the module the comments say owns it."""
    import repro_torch.checkpoint.ckpt   # noqa: F401  (declares ckpt.*)
    import repro_torch.core.exchange     # noqa: F401
    import repro_torch.core.sampler      # noqa: F401
    import repro_torch.core.sensors      # noqa: F401
    import repro_torch.serve.engine      # noqa: F401  (declares serve.*)
    import repro_torch.serve.recovery    # noqa: F401
    import repro_torch.serve.scheduler   # noqa: F401
    from repro_torch.core.faults import FAULT_SITES, declared_sites
    assert set(declared_sites()) == set(FAULT_SITES)


def test_runtime_declare_rejects_unknown_and_cross_module_dup():
    from repro_torch.core import faults
    with pytest.raises(ValueError, match="unregistered fault site"):
        faults.declare_site("nope.nope", module="m1")
    faults.declare_site("spiller.publish",
                        module="repro_torch.core.exchange")     # idempotent
    with pytest.raises(ValueError, match="already declared"):
        faults.declare_site("spiller.publish", module="somewhere.else")


# ---------------------------------------------------------------------------
# pass (e): x64-scoping
# ---------------------------------------------------------------------------

def test_unscoped_x64_caught():
    bad = """\
        import jax
        from jax.experimental import enable_x64

        enable_x64()                                  # never entered
        jax.config.update("jax_enable_x64", True)     # global flip
    """
    idents = {f.ident for f in _scan(bad, modpath="core/anything.py",
                                     passes=[X64ScopingPass()])}
    assert idents == {"enable_x64-unscoped", "jax_enable_x64-global"}


def test_scoped_x64_passes():
    clean = """\
        from jax.experimental import enable_x64

        def f():
            with enable_x64():
                return 1
    """
    assert _scan(clean, modpath="core/anything.py",
                 passes=[X64ScopingPass()]) == []


# ---------------------------------------------------------------------------
# baseline ratchet (layer 1)
# ---------------------------------------------------------------------------

def _bad_unit():
    return parse_unit("src/repro_torch/core/exchange.py", "core/exchange.py",
                      'def f():\n    raise IOError("x")\n')


def test_baseline_absorbs_pinned_and_fails_new(tmp_path):
    findings = run_passes([_bad_unit()], [TypedSpillErrorsPass()])
    assert len(findings) == 1

    # Unbaselined: the finding is new.
    res = bl.check_findings(findings, {})
    assert not res.ok and len(res.new) == 1

    # Pin it; same findings now absorb. Round-trip through the file.
    path = str(tmp_path / "baseline.json")
    bl.save_counts(bl.finding_counts(findings), path)
    res = bl.check_findings(findings, bl.load_counts(path))
    assert res.ok and len(res.baselined) == 1 and not res.stale_keys

    # A second identical violation exceeds the pinned count.
    two = parse_unit(
        "src/repro_torch/core/exchange.py", "core/exchange.py",
        'def f():\n    raise IOError("x")\n'
        'def g():\n    raise IOError("y")\n')
    findings2 = run_passes([two], [TypedSpillErrorsPass()])
    res = bl.check_findings(findings2, bl.load_counts(path))
    assert not res.ok and len(res.new) == 1 and len(res.baselined) == 1


def test_baseline_reports_stale_keys(tmp_path):
    findings = run_passes([_bad_unit()], [TypedSpillErrorsPass()])
    path = str(tmp_path / "baseline.json")
    bl.save_counts(bl.finding_counts(findings), path)
    res = bl.check_findings([], bl.load_counts(path))
    assert res.ok and len(res.stale_keys) == 1


# ---------------------------------------------------------------------------
# the port's files against the reference's
# ---------------------------------------------------------------------------

def test_passes_is_the_references_file():
    assert (PORT_ANALYSIS / "passes.py").read_bytes() == \
        (REF_ANALYSIS / "passes.py").read_bytes()


def test_baseline_differs_only_in_its_import():
    ref = (REF_ANALYSIS / "baseline.py").read_text().splitlines()
    port = (PORT_ANALYSIS / "baseline.py").read_text().splitlines()
    assert len(ref) == len(port)
    differ = [(r, p) for r, p in zip(ref, port) if r != p]
    assert differ == [("from repro.analysis.passes import Finding",
                       "from repro_torch.analysis.passes import Finding")]


# ---------------------------------------------------------------------------
# pass (f): default-dtype-scoping (the port's x64-scoping)
# ---------------------------------------------------------------------------

def test_unscoped_default_dtype_caught():
    bad = """\
        import torch
        from torch import set_default_device

        torch.set_default_dtype(torch.float64)
        torch.set_default_tensor_type(torch.DoubleTensor)
        set_default_device("cuda")
    """
    idents = {f.ident for f in _scan(bad, modpath="core/anything.py",
                                     passes=[DefaultDtypeScopingPass()])}
    assert idents == {"torch.set_default_dtype",
                      "torch.set_default_tensor_type",
                      "torch.set_default_device"}


def test_scoped_default_dtype_passes():
    clean = """\
        import contextlib
        import torch

        @contextlib.contextmanager
        def float64_default():
            old = torch.get_default_dtype()
            torch.set_default_dtype(torch.float64)
            try:
                yield
            finally:
                torch.set_default_dtype(old)

        def f():
            with float64_default(), torch.device("cpu"):
                return torch.zeros(3)
    """
    assert _scan(clean, modpath="core/anything.py",
                 passes=[DefaultDtypeScopingPass()]) == []


def test_default_dtype_pass_is_registered():
    from repro_torch.analysis import PASS_REGISTRY
    assert "default-dtype-scoping" in PASS_REGISTRY
    assert "x64-scoping" in PASS_REGISTRY


# ---------------------------------------------------------------------------
# pass (g): no-span-reads (the profile record's clock stays write-only)
# ---------------------------------------------------------------------------

def test_span_reads_caught():
    bad = """\
        from repro_torch.core import spans
        from repro_torch.core.spans import recent
        import repro_torch.core.spans as sp

        def run(prof, stats):
            with spans.record("region", seed=0, workers=1,
                              chunk_size=8) as trace:
                pass
            stats["s"] = trace.seconds("alea.miss")
            last = recent()[-1]
            cur = sp._current.get()
            if prof.last_trace.counters["chunks"]:
                return spans.ProfileTrace
    """
    idents = [f.ident for f in _scan(bad, passes=[NoSpanReadsPass()])]
    assert sorted(idents) == sorted([
        "repro_torch.core.spans.record", "repro_torch.core.spans.recent",
        "repro_torch.core.spans._current", "last_trace",
        "repro_torch.core.spans.ProfileTrace"])
    # Only determinism-critical modules are held to it.
    assert _scan(bad, modpath="core/profiler.py",
                 passes=[NoSpanReadsPass()]) == []


def test_span_writes_pass():
    clean = """\
        from repro_torch.core import spans

        def run(stats, n):
            with spans.record("combination", seed=0, workers=2,
                              chunk_size=8), \\
                    spans.fill_stats(stats, counters=("chunks",)), \\
                    spans.span("alea.pipeline", ranged=False):
                for _ in range(n):
                    spans.count("chunks")
                    with spans.span("alea.clock"):
                        pass
    """
    assert _scan(clean, passes=[NoSpanReadsPass()]) == []


def test_no_span_reads_pass_is_registered():
    from repro_torch.analysis import PASS_REGISTRY
    assert PASS_REGISTRY["no-span-reads"] is NoSpanReadsPass


# ---------------------------------------------------------------------------
# op audit (layer 2)
# ---------------------------------------------------------------------------

def test_f64_leak_flagged():
    def leaky(x):
        return x.to(torch.float64) * 2.0 + 1.0
    stats = audit_ops(leaky, torch.ones(4, dtype=torch.float32))
    assert stats.f64_ops >= 3
    assert stats.f64_widenings == 1
    assert stats.f64_by_prim["aten._to_copy.default"] == 1


def test_f32_code_not_flagged():
    def fine(x):
        return x * 2.0 + 1.0
    stats = audit_ops(fine, torch.ones(4, dtype=torch.float32))
    assert stats.eqn_count == 2
    assert stats.f64_ops == 0 and stats.f64_widenings == 0
    assert stats.host_callbacks == 0


def test_audit_counts_every_iteration_of_a_loop():
    def looped(x):
        for _ in range(3):
            x = x + 1.5
        return x
    stats = audit_ops(looped, torch.zeros((), dtype=torch.float64))
    assert stats.f64_by_prim == {"aten.add.Tensor": 3}
    assert stats.f64_widenings == 0


def test_a_step_that_rebinds_its_carry_is_not_in_place():
    carry = (torch.zeros(8), torch.zeros((), dtype=torch.int64))

    def rebinds(c):
        return tuple(t + 1 for t in c)

    def in_place(c):
        for t in c:
            t += 1
        return c, "aux"
    assert donation_in_place(rebinds, carry) == (2, 0)
    assert donation_in_place(in_place, carry) == (2, 2)


def test_host_waits_detected():
    def chatty(x):
        n = int(x.sum().item())
        return x[x > 0], n
    stats = audit_ops(chatty, torch.ones(3))
    assert stats.callback_prims == ["_local_scalar_dense",
                                    "index by a boolean mask"]
    quiet = audit_ops(lambda x: torch.where(x > 0, x, 0.0).sum(),
                      torch.ones(3))
    assert quiet.host_callbacks == 0


def test_jit_cache_size_counts_cache_keys():
    @functools.lru_cache(maxsize=None)
    def f(n):
        return n * 2
    assert jit_cache_size(f) == 0
    f(4)
    f(4)             # same key: cached
    assert jit_cache_size(f) == 1
    f(5)             # a new key: one more entry
    assert jit_cache_size(f) == 2


# ---------------------------------------------------------------------------
# x64 budget ratchet (layer 2)
# ---------------------------------------------------------------------------

def _report(name="p", f64=5, widen=1, cb=0, don=(0, 0)):
    return PathReport(name=name, eqn_count=10, f64_ops=f64,
                      f64_by_prim={"aten.mul.Tensor": f64},
                      f64_widenings=widen, host_callbacks=cb,
                      callback_prims=(), donated_expected=don[0],
                      donated_aliased=don[1])


def test_budget_over_and_under():
    budget = {"p": {"f64_ops": 5, "f64_widenings": 1, "host_callbacks": 0}}
    assert bl.check_budget([_report()], budget) == []
    assert bl.check_budget([_report(f64=4)], budget) == []   # ratchet down ok
    over = bl.check_budget([_report(f64=6)], budget)
    assert len(over) == 1 and "f64_ops grew" in over[0].message
    waits = bl.check_budget([_report(cb=1)], budget)
    assert len(waits) == 1 and "host_callbacks grew" in waits[0].message


def test_budget_unknown_path_fails():
    (v,) = bl.check_budget([_report()], {})
    assert "not in x64_budget.json" in v.message


def test_budget_donation_is_absolute():
    budget = {"p": {"f64_ops": 5, "f64_widenings": 1, "host_callbacks": 0}}
    (v,) = bl.check_budget([_report(don=(4, 3))], budget)
    assert "donation broken" in v.message
    assert bl.check_budget([_report(don=(4, 4))], budget) == []


def test_budget_update_refuses_increase(tmp_path):
    path = str(tmp_path / "budget.json")
    bl.save_budget(bl.merge_budget([_report(f64=5)], {}), path)
    existing = bl.load_budget(path)
    with pytest.raises(ValueError, match="refusing to raise"):
        bl.merge_budget([_report(f64=6)], existing)
    merged = bl.merge_budget([_report(f64=6)], existing,
                             allow_increase=True)
    assert merged["p"]["f64_ops"] == 6
    # Ratcheting down needs no force and rewrites the lower count.
    merged = bl.merge_budget([_report(f64=3)], existing)
    assert merged["p"]["f64_ops"] == 3


# ---------------------------------------------------------------------------
# the committed tree audits clean against its committed baseline
# ---------------------------------------------------------------------------

def test_repo_layer1_clean():
    result = run_audit(op_audit=False)
    assert result.ratchet.ok, "\n".join(
        f.render() for f in result.ratchet.new)
    assert not result.ratchet.stale_keys
    assert "src/repro_torch/core/device_pipeline.py" in {
        u.path for u in scan_repo()}


def test_baseline_pins_nothing():
    assert json.loads((PORT_ANALYSIS / "baseline.json").read_text())[
        "counts"] == {}


def _budget(path):
    return json.loads(Path(path).read_text())["paths"]


def test_budget_keys_are_the_references():
    assert sorted(_budget(BUDGET_PATH)) == sorted(
        _budget(REF_ANALYSIS / "x64_budget.json"))


def test_serve_rows_are_zero_in_both_budgets():
    for path in (BUDGET_PATH, REF_ANALYSIS / "x64_budget.json"):
        rows = {k: v for k, v in _budget(path).items()
                if k.startswith("serve/")}
        assert len(rows) == 12
        for name, row in rows.items():
            assert (row["f64_ops"], row["f64_widenings"],
                    row["host_callbacks"]) == (0, 0, 0), (path, name)


@pytest.fixture(scope="module")
def reports():
    return {r.name: r for r in audit_hot_paths(device="cpu")}


def test_hot_paths_within_budget(reports):
    assert sorted(reports) == sorted(_budget(BUDGET_PATH))
    assert bl.check_budget(list(reports.values()),
                           bl.load_budget(BUDGET_PATH)) == []


@pytest.mark.parametrize("which", ["decode", "draft", "verify"])
@pytest.mark.parametrize("family", ["dense", "moe", "ssm", "hybrid"])
def test_serve_paths_have_no_f64_and_no_host_wait(reports, which, family):
    r = reports[f"serve/{which}/{family}"]
    assert r.eqn_count > 0
    assert (r.f64_ops, r.f64_widenings, r.host_callbacks) == (0, 0, 0), \
        r.render()


@pytest.mark.parametrize("d", ["d1", "d3"])
def test_chunk_steps_wait_only_for_the_miss_flag(reports, d):
    region = reports[f"device_pipeline/region_run/{d}"]
    combo = reports[f"device_pipeline/combo_step/{d}"]
    fold = reports[f"device_pipeline/combo_fold/{d}"]
    assert region.host_callbacks == 0 and fold.host_callbacks == 0
    assert combo.callback_prims == ("_local_scalar_dense",)
    for r in (region, combo, fold):
        assert (r.donated_expected, r.donated_aliased) == (4, 4), r.render()
        assert r.launches == {}       # the CPU runs the plain fold


def test_collectives_leave_no_process_group(reports):
    import torch.distributed as dist
    assert reports["exchange/collective/region_allreduce"].eqn_count > 0
    assert reports["exchange/collective/combo_allgather"].eqn_count > 0
    assert not dist.is_initialized()


def test_cli_check_exits_clean_without_jax():
    code = textwrap.dedent("""
        import sys
        from repro_torch.analysis.__main__ import main
        rc = main(["--check"])
        assert "jax" not in sys.modules, "the auditor imported jax"
        sys.exit(rc)
    """)
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stdout + out.stderr
    assert "contract audit OK" in out.stdout
    assert "20 hot path(s) within budget" in out.stdout
