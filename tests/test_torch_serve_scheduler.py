"""Port parity: ``repro_torch.serve.scheduler`` against the JAX package's.

The module is a copy (only its ``faults`` import differs): the first test
holds the text to the reference's. Each case of the reference's
``tests/test_serve_scheduler.py`` then runs the same operation sequence
through both modules, keeps the reference's assertions on the port, and
requires equal admission and shed orders and byte-equal ``ServeReport``
JSON.
"""

import json
from pathlib import Path

import numpy as np
import pytest

try:
    from hypothesis import given, settings
    from hypothesis import strategies as st
except ImportError:                                   # pragma: no cover
    from _hypothesis_fallback import given, settings, st

from _torch_serve_pkgs import PORT, REF

ROOT = Path(__file__).resolve().parents[1]


class _Req:
    """Duck-typed stand-in for engine.Request at the scheduler seam."""

    def __init__(self, rid, priority=0, deadline=None):
        self.rid = rid
        self.priority = priority
        self.deadline = deadline
        self.status = "queued"
        self.submit_step = 0


def _both(scenario):
    """Run ``scenario(scheduler module, faults module)`` in both packages;
    the two results must be equal. Returns the port's."""
    want = scenario(REF.scheduler, REF.faults)
    got = scenario(PORT.scheduler, PORT.faults)
    assert got == want
    return got


def _report_bytes(report) -> str:
    return json.dumps(report.to_json(), sort_keys=True)


def _sched(S, cap=4, bp=None, shed=None, widen=None, **kw):
    bp = bp if bp is not None else max(1, cap // 2)
    shed = shed if shed is not None else max(bp, cap - 1)
    widen = widen if widen is not None else cap
    return S.ServeScheduler(S.OverloadPolicy(
        queue_capacity=cap, backpressure_at=bp, shed_at=shed,
        widen_at=widen), **kw)


def test_scheduler_is_the_references_copy():
    port = (ROOT / "src/repro_torch/serve/scheduler.py").read_text()
    ref = (ROOT / "src/repro/serve/scheduler.py").read_text()
    assert port.replace("repro_torch.", "repro.") == ref
    assert port.count("repro_torch.") == 1


# -- queue order ---------------------------------------------------------------

def test_pop_best_priority_then_fifo():
    def run(S, F):
        q = S.AdmissionQueue(8)
        q.push(0, 0, "a")
        q.push(2, 1, "b")
        q.push(2, 2, "c")
        q.push(1, 3, "d")
        return [q.pop_best() for _ in range(5)]
    assert _both(run) == ["b", "c", "d", "a", None]


def test_shed_worst_lowest_priority_youngest_first():
    def run(S, F):
        q = S.AdmissionQueue(8)
        q.push(1, 0, "old-low")
        q.push(1, 1, "new-low")
        q.push(5, 2, "high")
        return [q.shed_worst() for _ in range(3)]
    assert _both(run) == ["new-low", "old-low", "high"]


def test_queue_capacity_enforced():
    def run(S, F):
        q = S.AdmissionQueue(2)
        q.push(0, 0, "a")
        q.push(0, 1, "b")
        with pytest.raises(S.QueueFullError) as ei:
            q.push(9, 2, "c")
        return str(ei.value)
    _both(run)


@settings(max_examples=25, deadline=None)
@given(n=st.integers(min_value=1, max_value=30),
       seed=st.integers(min_value=0, max_value=10_000))
def test_admission_order_deterministic_under_equal_priorities(n, seed):
    def run(S, F):
        rng = np.random.default_rng(seed)
        prio = int(rng.integers(0, 3))
        q = S.AdmissionQueue(n)
        for s in range(n):
            q.push(prio, s, s)
        return [q.pop_best() for _ in range(n)]
    assert _both(run) == list(range(n))


# -- policy validation ---------------------------------------------------------

@pytest.mark.parametrize("kw", [
    dict(queue_capacity=8, backpressure_at=4, shed_at=2, widen_at=6),
    dict(queue_capacity=4, backpressure_at=1, shed_at=2, widen_at=8),
    dict(widen_factor=0.5)])
def test_policy_threshold_ordering_validated(kw):
    def run(S, F):
        with pytest.raises(ValueError) as ei:
            S.OverloadPolicy(**kw)
        return str(ei.value)
    _both(run)


# -- scheduler semantics -------------------------------------------------------

def test_queue_full_rejection_is_counted_and_typed():
    def run(S, F):
        s = _sched(S, cap=2)
        s.submit(_Req(0), 0)
        s.submit(_Req(1), 0)
        with pytest.raises(S.QueueFullError):
            s.submit(_Req(2), 0)
        assert s.report.rejected_full == 1
        assert s.report.request(2).status == "shed"
        assert s.report.request(2).reason == "queue_full"
        return _report_bytes(s.report)
    _both(run)


def test_higher_priority_displaces_queued_lowest():
    def run(S, F):
        s = _sched(S, cap=2)
        s.submit(_Req(0, priority=0), 0)
        s.submit(_Req(1, priority=1), 0)
        s.submit(_Req(2, priority=5), 1)      # displaces rid 0
        assert s.report.request(0).status == "shed"
        assert s.report.shed == 1
        order = [s.admit(1).rid, s.admit(1).rid]
        return order, _report_bytes(s.report)
    assert _both(run)[0] == [2, 1]


def test_deadline_expires_in_queue():
    def run(S, F):
        s = _sched(S)
        s.submit(_Req(0, deadline=2), 0)
        s.submit(_Req(1), 0)
        first = s.admit(5).rid                # rid 0 expired waiting
        assert s.report.request(0).status == "aborted_deadline"
        assert s.report.aborted_deadline == 1
        with pytest.raises(S.DeadlineExceededError):
            s.submit(_Req(2, deadline=0), 5)
        return first, _report_bytes(s.report)
    assert _both(run)[0] == 1


def test_ladder_sheds_and_records_transitions():
    def run(S, F):
        widened = []
        s = _sched(S, cap=6, bp=2, shed=4, widen=5)
        for rid in range(5):
            s.submit(_Req(rid, priority=rid), 0)
        s.tick(0, widen_fn=widened.append,
               unwiden_fn=lambda: widened.append(0))
        assert s.report.shed == 3
        shed = [r.rid for r in s.report.requests if r.status == "shed"]
        assert widened == [s.policy.widen_factor]
        admitted = []
        while (r := s.admit(1)) is not None:
            admitted.append(r.rid)
        s.tick(1, widen_fn=widened.append,
               unwiden_fn=lambda: widened.append(0))
        assert widened[-1] == 0
        levels = [(t[1], t[2]) for t in s.report.transitions]
        assert levels[0][1] == "degraded"
        assert levels[-1][1] == "normal"
        return shed, admitted, widened, _report_bytes(s.report)
    shed, admitted, _, _ = _both(run)
    assert shed == [0, 1, 2] and admitted == [4, 3]


def test_injected_admission_fault_is_counted():
    def run(S, F):
        s = _sched(S, faults=F.FaultPlan(seed=0, admission_faults=(1,)))
        s.submit(_Req(0), 0)
        with pytest.raises(S.AdmissionError):
            s.submit(_Req(1), 0)              # submit seq 1 faulted
        assert s.report.admission_faults == 1
        s.submit(_Req(2), 0)                  # transient: next submit fine
        assert len(s.queue) == 2
        return _report_bytes(s.report)
    _both(run)


def test_duplicate_rid_rejected():
    def run(S, F):
        s = _sched(S)
        s.submit(_Req(7), 0)
        with pytest.raises(ValueError) as ei:
            s.submit(_Req(7), 1)
        return str(ei.value), _report_bytes(s.report)
    _both(run)


# -- report provenance ---------------------------------------------------------

def test_report_round_trips_json():
    def run(S, F):
        s = _sched(S, cap=2)
        s.submit(_Req(0), 0)
        s.submit(_Req(1, priority=3), 0)
        with pytest.raises(S.QueueFullError):
            s.submit(_Req(2), 1)
        s.report.transition(1, "normal", "backpressure", "depth 2")
        blob = s.report.to_json()
        back = S.ServeReport.from_json(blob)
        assert back.to_json() == blob
        assert back.rejected_full == 1
        assert back.request(1).priority == 3
        cov = back.coverage()
        assert cov["counters"]["rejected_full"] == 1
        assert "2" in cov["requests"]
        return _report_bytes(back), json.dumps(cov, sort_keys=True)
    _both(run)


def test_reports_load_across_packages():
    """A report (and a scheduler's state) written by one package loads
    in the other and writes the same bytes back."""
    for src, dst in ((REF, PORT), (PORT, REF)):
        s = _sched(src.scheduler, cap=3)
        for rid in range(3):
            s.submit(_Req(rid, priority=rid % 2, deadline=4), 0)
        s.admit(2)
        s.tick(2, widen_fn=lambda f: None, unwiden_fn=lambda: None)
        blob = s.report.to_json()
        assert dst.scheduler.ServeReport.from_json(blob).to_json() == blob
        state = s.state_json()
        t = dst.scheduler.ServeScheduler()
        t.load_state(state)
        assert json.dumps(t.state_json(), sort_keys=True) == \
            json.dumps(state, sort_keys=True)


def test_unknown_status_rejected():
    def run(S, F):
        rep = S.ServeReport()
        rep.open(0, status="queued", step=0)
        with pytest.raises(ValueError) as ei:
            rep.set_status(0, "vanished")
        return str(ei.value)
    _both(run)


def test_record_statuses_cover_contract():
    def run(S, F):
        out = []
        for status in ("admitted", "completed", "shed", "aborted_deadline",
                       "aborted_budget", "recovered"):
            rep = S.ServeReport()
            rep.open(0, status="queued", step=0)
            rep.set_status(0, status, step=1)
            out.append(_report_bytes(rep))
        rec = S.RequestRecord(rid=0, status="queued")
        assert rec.to_json()["rid"] == 0
        return out
    _both(run)
