"""Admission control, deadlines, energy budgets and overload shedding
for the serving engine — the serving half of the ROADMAP failure model.

The profiling fleet got a *may-lose / never-corrupt* contract in PR 6;
this module gives the thing being profiled the same discipline. Every
quantity here is measured in the deterministic **engine step clock**
(``Engine.step_count``), never wall clock: a chaos scenario that kills
and restores an engine replays bit-exactly, and the ``no-wallclock``
static pass covers this module.

Pieces:

* A typed rejection hierarchy rooted at :class:`AdmissionError` —
  :class:`QueueFullError`, :class:`DeadlineExceededError`,
  :class:`EnergyBudgetExceededError` — plus :class:`ServeTimeoutError`
  for a drain loop that runs out of steps with work still in flight.
  Every rejection/abort is counted in the :class:`ServeReport`, never
  silent.

* A bounded :class:`AdmissionQueue` with priorities: admission order is
  (priority desc, submit sequence asc) — deterministic under equal
  priorities — and shedding takes the *lowest* priority, *youngest*
  submission first (oldest work is preserved).

* A :class:`ServeScheduler` owning the queue, the per-request
  :class:`ServeReport` provenance (mirroring the exchange layer's
  ``GatherResult``/``HostReport`` contract), and the overload
  degradation ladder: ``normal`` → ``backpressure`` (submitters are
  signalled to slow down) → ``shed`` (lowest-priority queued requests
  are dropped, counted) → ``degraded`` (the energy accountant's
  sampling period is widened so the monitor itself stops competing for
  the overloaded host — the PAPERS.md RAPL-overhead critique). Every
  transition, both up and down, is recorded with its step and reason.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Iterable

from repro_torch.core.faults import FaultPlan, declare_site, resolve_plan

__all__ = [
    "ServeError", "AdmissionError", "QueueFullError",
    "DeadlineExceededError", "EnergyBudgetExceededError",
    "ServeTimeoutError", "PriceSignalUnavailableError", "OverloadPolicy",
    "AdmissionQueue", "RequestRecord", "ServeReport", "ServeScheduler",
    "LADDER",
]

# Injection seam this module owns (see faults.FAULT_SITES): transient
# submit-time admission faults (counted, typed, never silent).
_SITE_ADMISSION = declare_site("serve.admission")

# The overload degradation ladder, in escalation order.
LADDER = ("normal", "backpressure", "shed", "degraded")


# -- typed serving failures ---------------------------------------------------

class ServeError(RuntimeError):
    """Base for typed serving-layer failures."""


class AdmissionError(ServeError):
    """A request could not be (or stay) admitted. Subclasses say why;
    every raise is preceded by a ServeReport count — rejections are
    load-shedding decisions, not silent drops."""


class QueueFullError(AdmissionError):
    """The bounded admission queue is full and the submitted request
    does not outrank anything sheddable."""


class DeadlineExceededError(AdmissionError):
    """The request's step-clock deadline elapsed (in queue or mid-run)."""


class EnergyBudgetExceededError(AdmissionError):
    """The request's measured/charged energy crossed its budget."""


class ServeTimeoutError(ServeError):
    """``run_until_drained`` ran out of steps with requests still
    pending or in flight. Carries the undrained request ids so the
    caller knows exactly which work was abandoned."""

    def __init__(self, msg: str, undrained: Iterable[int] = ()):
        super().__init__(msg)
        self.undrained = tuple(undrained)


class PriceSignalUnavailableError(ServeError):
    """``Engine.current_joules_per_token`` cannot quote yet: no
    accountant / no tokens / no drained decode-phase samples, the Wald
    CI is invalid (estimator normality guard), or the CI is wider than
    the caller's quoting threshold. Admission price tiers must treat
    this as "no signal", never as a free tier — a silent zero-J quote
    would price overload exactly backwards."""


# -- policy -------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class OverloadPolicy:
    """Thresholds (queued-request depths) of the degradation ladder.

    ``backpressure_at <= shed_at <= widen_at <= queue_capacity``; each
    level engages while the queue depth is at or above its threshold
    and releases below it. ``shed`` drops lowest-priority queued
    requests until the depth falls back to ``backpressure_at``;
    ``degraded`` multiplies the accountant's sampling period by
    ``widen_factor`` (restored on de-escalation).
    """
    queue_capacity: int = 64
    backpressure_at: int = 8
    shed_at: int = 16
    widen_at: int = 32
    widen_factor: float = 4.0

    def __post_init__(self):
        if self.queue_capacity < 1:
            raise ValueError(
                f"queue_capacity must be >= 1; got {self.queue_capacity}")
        if not (1 <= self.backpressure_at <= self.shed_at
                <= self.widen_at <= self.queue_capacity):
            raise ValueError(
                "ladder thresholds must satisfy 1 <= backpressure_at <= "
                f"shed_at <= widen_at <= queue_capacity; got "
                f"{self.backpressure_at}/{self.shed_at}/{self.widen_at}"
                f"/{self.queue_capacity}")
        if self.widen_factor < 1.0:
            raise ValueError(
                f"widen_factor must be >= 1; got {self.widen_factor}")

    def level_for(self, depth: int) -> int:
        """Ladder level index for a queue depth (pure, step-clocked)."""
        if depth >= self.widen_at:
            return 3
        if depth >= self.shed_at:
            return 2
        if depth >= self.backpressure_at:
            return 1
        return 0


# -- bounded priority queue ---------------------------------------------------

class AdmissionQueue:
    """Bounded priority queue with deterministic order.

    Entries are ``(priority, seq, request)``. :meth:`pop_best` returns
    the highest priority, then lowest submit sequence (FIFO within a
    priority class — admission order is a pure function of the submit
    order, never of hashes or arrival wall time). :meth:`shed_worst`
    removes the lowest priority, then *highest* sequence (the youngest
    of the least-important work dies first).
    """

    def __init__(self, capacity: int):
        if capacity < 1:
            raise ValueError(f"capacity must be >= 1; got {capacity}")
        self.capacity = capacity
        self._items: list[tuple[int, int, object]] = []

    def __len__(self) -> int:
        return len(self._items)

    @property
    def full(self) -> bool:
        return len(self._items) >= self.capacity

    def push(self, priority: int, seq: int, req) -> None:
        if self.full:
            raise QueueFullError(
                f"admission queue at capacity {self.capacity}")
        self._items.append((priority, seq, req))

    def min_priority(self) -> int | None:
        """Lowest queued priority, or None when empty."""
        if not self._items:
            return None
        return min(p for p, _, _ in self._items)

    def pop_best(self):
        if not self._items:
            return None
        best = max(range(len(self._items)),
                   key=lambda i: (self._items[i][0], -self._items[i][1]))
        return self._items.pop(best)[2]

    def shed_worst(self):
        if not self._items:
            return None
        worst = min(range(len(self._items)),
                    key=lambda i: (self._items[i][0], -self._items[i][1]))
        return self._items.pop(worst)[2]

    def remove_expired(self, expired: Callable[[object], bool]) -> list:
        """Pop every queued request for which ``expired`` holds
        (deterministic submit-sequence order)."""
        hit = [(p, s, r) for (p, s, r) in self._items if expired(r)]
        if hit:
            self._items = [e for e in self._items if not expired(e[2])]
        return [r for _, _, r in sorted(hit, key=lambda e: e[1])]

    def snapshot(self) -> list[tuple[int, int, object]]:
        """Queued entries in submit order (for durable snapshots)."""
        return sorted(self._items, key=lambda e: e[1])


# -- per-request provenance ---------------------------------------------------

_STATUSES = ("queued", "admitted", "completed", "shed",
             "aborted_deadline", "aborted_budget", "recovered")


@dataclasses.dataclass
class RequestRecord:
    """One request's provenance through the serving layer.

    ``status`` is one of:

    * ``"queued"``           — submitted, waiting for a slot.
    * ``"admitted"``         — holds a slot, decoding.
    * ``"completed"``        — finished normally (EOS / token budget).
    * ``"shed"``             — dropped by overload control before it
      ever ran (``reason`` says whether at submit time or by the
      shed rung of the ladder).
    * ``"aborted_deadline"`` — step-clock deadline elapsed; any tokens
      generated so far were returned as partial output.
    * ``"aborted_budget"``   — energy budget exhausted mid-decode;
      partial output returned.
    * ``"recovered"``        — restored from a durable snapshot and
      re-admitted; moves on to ``completed``/aborted as usual, with
      :attr:`recovered` staying True for provenance.
    """
    rid: int
    status: str
    priority: int = 0
    submit_step: int = 0
    admit_step: int | None = None
    finish_step: int | None = None
    tokens_out: int = 0
    energy_j: float = 0.0
    recovered: bool = False
    reason: str | None = None
    error: str | None = None
    # Self-speculative decoding provenance: draft tokens proposed for /
    # accepted by this request's slot (0/0 when speculation is off).
    spec_drafted: int = 0
    spec_accepted: int = 0

    @property
    def acceptance_rate(self) -> float | None:
        """Accepted / drafted for this request, or None when no window
        ever covered it (speculation off, or only fallback steps)."""
        if self.spec_drafted == 0:
            return None
        return self.spec_accepted / self.spec_drafted

    def to_json(self) -> dict:
        d = dataclasses.asdict(self)
        d["acceptance_rate"] = self.acceptance_rate
        return d

    @classmethod
    def from_json(cls, d: dict) -> "RequestRecord":
        d = dict(d)
        d.pop("acceptance_rate", None)   # derived, not a field
        return cls(**d)


class ServeReport:
    """Fleet-style provenance for one serving run.

    Mirrors ``exchange.GatherResult``: every request that ever touched
    the engine gets a :class:`RequestRecord`; overload-ladder
    transitions are logged with their step and reason; and the typed
    rejection counters make every loss observable. Nothing is dropped
    without a record saying so.
    """

    def __init__(self):
        self._records: dict[int, RequestRecord] = {}
        self.transitions: list[tuple[int, str, str, str]] = []
        # `shed` counts every request that ended with status "shed";
        # `rejected_full` is the subset refused at submit time with a
        # QueueFullError (the rest were dropped from the queue by the
        # ladder or displaced by higher priority). Conservation:
        # completed + shed + aborted_* covers every terminal request.
        self.rejected_full = 0
        self.shed = 0
        self.aborted_deadline = 0
        self.aborted_budget = 0
        self.completed = 0
        self.recovered = 0
        self.admission_faults = 0
        self.buffer_overruns = 0
        # Self-speculative decoding counters. Conservation per window:
        # drafted = accepted + rejected for every slot; `rollbacks`
        # counts windows that discarded at least one draft (the
        # KV-rewind / checkpoint-replay events).
        self.drafted = 0
        self.accepted = 0
        self.rejected = 0
        self.rollbacks = 0
        # Interner pressure of the accountant's per-request combination
        # table (engine-maintained; None without track_requests):
        # distinct/miss/growth counters plus, in bounded mode, the
        # k/resident/tail-fold block — how close attribution state is
        # to its cap, and what the tail cost so far.
        self.attribution: dict | None = None

    # -- records --------------------------------------------------------------
    def open(self, rid: int, *, status: str, step: int,
             priority: int = 0) -> RequestRecord:
        if rid in self._records:
            raise ValueError(f"request {rid} already tracked "
                             f"({self._records[rid].status})")
        rec = RequestRecord(rid=rid, status=status, priority=priority,
                            submit_step=step)
        self._records[rid] = rec
        return rec

    def request(self, rid: int) -> RequestRecord:
        return self._records[rid]

    def __contains__(self, rid: int) -> bool:
        return rid in self._records

    @property
    def requests(self) -> tuple[RequestRecord, ...]:
        return tuple(self._records[r] for r in sorted(self._records))

    def set_status(self, rid: int, status: str, *, step: int | None = None,
                   reason: str | None = None,
                   error: str | None = None) -> RequestRecord:
        if status not in _STATUSES:
            raise ValueError(f"unknown request status {status!r}")
        rec = self._records[rid]
        rec.status = status
        if status == "recovered":
            rec.recovered = True
            self.recovered += 1
        if reason is not None:
            rec.reason = reason
        if error is not None:
            rec.error = error
        if status in ("completed", "shed", "aborted_deadline",
                      "aborted_budget"):
            rec.finish_step = step
            if status == "completed":
                self.completed += 1
            elif status == "shed":
                self.shed += 1
            elif status == "aborted_deadline":
                self.aborted_deadline += 1
            else:
                self.aborted_budget += 1
        return rec

    # -- ladder ---------------------------------------------------------------
    def transition(self, step: int, frm: str, to: str, reason: str) -> None:
        self.transitions.append((step, frm, to, reason))

    # -- rendering ------------------------------------------------------------
    def by_status(self) -> dict[str, list[int]]:
        out: dict[str, list[int]] = {}
        for rec in self.requests:
            out.setdefault(rec.status, []).append(rec.rid)
        return out

    def coverage(self) -> dict:
        """JSON-able run provenance (the serving analogue of
        ``GatherResult.coverage``)."""
        by = self.by_status()
        n = len(self._records)
        done = len(by.get("completed", ()))
        parts = [f"completed {done}/{n} requests"]
        for label in ("shed", "aborted_deadline", "aborted_budget",
                      "queued", "admitted"):
            if by.get(label):
                parts.append(f"{label}: {by[label]}")
        if self.drafted:
            # ACCEPTANCE disclosure (mirrors COVERAGE/TAIL): speculation
            # quality is reported whenever any window ran, so a
            # regression to 0% acceptance is visible, not silent.
            rate = 100.0 * self.accepted / self.drafted
            parts.append(
                f"ACCEPTANCE {self.accepted}/{self.drafted} drafted "
                f"tokens accepted ({rate:.1f}%), "
                f"{self.rollbacks} rollbacks")
        out = {
            "requests": {str(r.rid): r.to_json() for r in self.requests},
            "by_status": by,
            "transitions": [list(t) for t in self.transitions],
            "counters": {
                "rejected_full": self.rejected_full,
                "shed": self.shed,
                "aborted_deadline": self.aborted_deadline,
                "aborted_budget": self.aborted_budget,
                "completed": self.completed,
                "recovered": self.recovered,
                "admission_faults": self.admission_faults,
                "buffer_overruns": self.buffer_overruns,
                "drafted": self.drafted,
                "accepted": self.accepted,
                "rejected": self.rejected,
                "rollbacks": self.rollbacks,
            },
            "summary": "; ".join(parts),
        }
        if self.attribution is not None:
            out["attribution"] = dict(self.attribution)
        return out

    # -- durable snapshot round-trip ------------------------------------------
    def to_json(self) -> dict:
        out = {
            "records": [r.to_json() for r in self.requests],
            "transitions": [list(t) for t in self.transitions],
            "counters": [self.rejected_full, self.shed,
                         self.aborted_deadline, self.aborted_budget,
                         self.completed, self.recovered,
                         self.admission_faults, self.buffer_overruns,
                         self.drafted, self.accepted, self.rejected,
                         self.rollbacks],
        }
        if self.attribution is not None:
            out["attribution"] = dict(self.attribution)
        return out

    @classmethod
    def from_json(cls, d: dict) -> "ServeReport":
        rep = cls()
        for rj in d["records"]:
            rec = RequestRecord.from_json(rj)
            rep._records[rec.rid] = rec
        rep.transitions = [tuple(t) for t in d["transitions"]]
        # Pre-speculation snapshots carry 8 counters; pad with zeros so
        # old snapshots restore cleanly (same discipline as the
        # attribution key below).
        counters = list(d["counters"]) + [0] * (12 - len(d["counters"]))
        (rep.rejected_full, rep.shed, rep.aborted_deadline,
         rep.aborted_budget, rep.completed, rep.recovered,
         rep.admission_faults, rep.buffer_overruns,
         rep.drafted, rep.accepted, rep.rejected,
         rep.rollbacks) = counters
        # Pre-bounded snapshots have no attribution key; .get keeps the
        # round-trip backward compatible.
        rep.attribution = d.get("attribution")
        return rep


# -- the scheduler ------------------------------------------------------------

class ServeScheduler:
    """Admission queue + overload ladder + provenance, step-clocked.

    The engine drives it: :meth:`submit` at the edge, :meth:`admit`
    when slots free up, :meth:`tick` once per engine step. All decisions
    are pure functions of (submit order, step clock, queue state), so a
    killed-and-restored engine — the queue rides in the snapshot —
    reproduces the exact same admission/shed schedule.
    """

    def __init__(self, policy: OverloadPolicy | None = None, *,
                 faults: FaultPlan | None = None):
        self.policy = policy or OverloadPolicy()
        self.queue = AdmissionQueue(self.policy.queue_capacity)
        self.report = ServeReport()
        self.level = 0
        self._seq = 0
        self._faults = resolve_plan(faults)
        # set while the ladder sits at `degraded`; cleared (and the
        # widen undone via the callback) on de-escalation.
        self._widened = False

    # -- edge -----------------------------------------------------------------
    @property
    def backpressure(self) -> bool:
        """True while the ladder is at or above ``backpressure`` —
        submitters should slow down (the signal is advisory; the shed
        rung is the enforcement)."""
        return self.level >= 1

    @property
    def widened(self) -> bool:
        """True while the degraded rung's widen hook is engaged. The
        engine derives its effective speculation length from this flag
        (``degraded_spec_len`` while True), so de-escalation restores L
        through the same single unwiden edge that restores the sampling
        period — the flag rides in :meth:`state_json`, making the
        derived knobs snapshot-consistent for free."""
        return self._widened

    def submit(self, req, step: int) -> None:
        """Enqueue ``req`` at engine step ``step``.

        Raises typed admission errors; every raise is counted in the
        report first. A full queue sheds its worst entry when the new
        request outranks it (strictly higher priority), else rejects
        the new request with :class:`QueueFullError`.
        """
        seq = self._seq
        self._seq += 1
        plan = self._faults
        if plan is not None and plan.admission_fails(seq):
            self.report.admission_faults += 1
            raise AdmissionError(
                f"injected admission fault at submit #{seq} "
                f"(request {req.rid})")
        priority = getattr(req, "priority", 0)
        if req.rid in self.report:
            raise ValueError(f"request id {req.rid} already submitted")
        rec = self.report.open(req.rid, status="queued", step=step,
                               priority=priority)
        if req.deadline is not None and req.deadline <= 0:
            self.report.set_status(req.rid, "aborted_deadline", step=step,
                                   error="deadline <= 0 at submit")
            raise DeadlineExceededError(
                f"request {req.rid}: non-positive deadline {req.deadline}")
        if self.queue.full:
            worst = self.queue.min_priority()
            if worst is not None and priority > worst:
                victim = self.queue.shed_worst()
                self._shed(victim, step, "displaced by higher priority")
            else:
                self.report.rejected_full += 1
                self.report.set_status(req.rid, "shed", step=step,
                                       reason="queue_full")
                raise QueueFullError(
                    f"request {req.rid}: queue at capacity "
                    f"{self.queue.capacity} and priority {priority} does "
                    f"not outrank any queued request")
        req.submit_step = step
        self.queue.push(priority, seq, req)
        rec.submit_step = step

    # -- engine side ----------------------------------------------------------
    def admit(self, step: int):
        """Next request for a free slot, or None. Queue-expired
        deadlines are aborted here (counted), never handed to a slot."""
        self._drop_expired(step)
        req = self.queue.pop_best()
        if req is None:
            return None
        self.report.set_status(req.rid, "admitted")
        rec = self.report.request(req.rid)
        rec.admit_step = step
        return req

    def _drop_expired(self, step: int) -> None:
        def expired(r) -> bool:
            return (r.deadline is not None
                    and step - r.submit_step >= r.deadline)
        for req in self.queue.remove_expired(expired):
            req.status = "aborted_deadline"
            self.report.set_status(
                req.rid, "aborted_deadline", step=step,
                error=f"deadline {req.deadline} elapsed in queue")

    def tick(self, step: int, *,
             widen_fn: Callable[[float], None] | None = None,
             unwiden_fn: Callable[[], None] | None = None) -> None:
        """Evaluate the overload ladder once per engine step."""
        self._drop_expired(step)
        target = self.policy.level_for(len(self.queue))
        if target >= 2:
            # Shed rung: drop lowest-priority queued work until the
            # depth is back at the backpressure threshold.
            while len(self.queue) > self.policy.backpressure_at:
                victim = self.queue.shed_worst()
                if victim is None:
                    break
                self._shed(victim, step, "load_shed")
        hooks = ""
        if target >= 3 and not self._widened:
            if widen_fn is not None:
                widen_fn(self.policy.widen_factor)
            self._widened = True
            hooks = ("; degraded hooks engaged (sampling widened, "
                     "speculation shrunk)")
        elif target < 3 and self._widened:
            # The single de-escalation reset edge: one unwiden call
            # restores the sampling period, and clearing the flag
            # restores the effective speculation length (derived from
            # it) — recorded on the same transition below so neither
            # knob can stay degraded silently.
            if unwiden_fn is not None:
                unwiden_fn()
            self._widened = False
            hooks = ("; degraded hooks reset (sampling period and "
                     "speculation length restored)")
        if target != self.level:
            self.report.transition(
                step, LADDER[self.level], LADDER[target],
                f"queue depth {len(self.queue)}"
                + (" after shedding" if target >= 2 else "") + hooks)
            self.level = target

    def _shed(self, req, step: int, reason: str) -> None:
        req.status = "shed"
        self.report.set_status(req.rid, "shed", step=step, reason=reason)

    # -- durable state --------------------------------------------------------
    def state_json(self) -> dict:
        """Scheduler state for the engine snapshot (queue entries are
        serialized by the snapshot writer, which owns the arrays)."""
        return {"seq": self._seq, "level": self.level,
                "widened": self._widened,
                "report": self.report.to_json()}

    def load_state(self, d: dict) -> None:
        self._seq = int(d["seq"])
        self.level = int(d["level"])
        self._widened = bool(d["widened"])
        self.report = ServeReport.from_json(d["report"])

    def requeue(self, req, priority: int, seq: int) -> None:
        """Re-enter a snapshot's queued request after a restore (its
        record already exists; identity — priority and submit order —
        is preserved so the replayed schedule is bit-identical)."""
        self.queue.push(priority, seq, req)
