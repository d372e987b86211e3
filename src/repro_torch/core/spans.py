"""Spans and counters of the profiler's device pipeline (port only).

Every profile through the device pipeline keeps one :class:`ProfileTrace`
in memory: for each span name and the name of the span that encloses it,
the nanoseconds (``time.perf_counter_ns``) and calls it took, and the
profile's counters. The record stays as small as its stages, however
many chunks the profile has. A record opens in the profiler's entries
when they take the device pipeline (``EnergyProfiler.last_trace`` holds
it afterwards) and in ``run_region_pipeline`` / ``run_combo_pipeline``
when they are called with no record open; :func:`recent` keeps the
newest :data:`RECENT` records. The open record is held per thread (a
``contextvars`` variable). A span or a counter with no record open is
not kept and costs one variable read.

While a torch profiler records (one that was recording when the record
opened), every span but ``alea.profile`` and ``alea.pipeline`` also opens
a profiler range of its name, so a device trace names its idle gaps after
the stage that was running. The range is an operator-scope
``RecordFunction`` (``torch._C._profiler._RecordFunctionFast``), not a
``torch.profiler.record_function``: a user-scope range is also drawn on
the device's timeline, as an annotation spanning its kernels, which a
reader of device activity would count as the device being busy. With no
profiler recording, a span costs two clock reads and a table update. No
span or counter reads a tensor or waits for the device.

The spans, by parent:

- ``alea.profile``: the entry's call (no range);
- ``alea.upload`` (``.build``: the host arrays and the grid; ``.copy``:
  the copies to the device);
- ``alea.pipeline``: the body of ``run_*_pipeline`` (no range), whose
  chunk stages are ``alea.clock``, ``alea.lookup``, ``alea.sensor``,
  ``alea.search`` (pack + search and the miss masks), ``alea.fold``,
  ``alea.miss_flag`` (the combination chunk's one wait for the device),
  ``alea.miss`` (the miss path; a replay's clock, lookup, sensor and fold
  nest in it) and ``alea.readback`` (the final drain and copies);
- ``alea.estimate``: the aggregator and its estimates (on the combination
  path ``from_table`` runs inside ``run_combo_pipeline``, under
  ``alea.pipeline``).

Counters: ``chunks``, ``miss_chunks``, ``miss_rows`` (rows the miss path
brings to the host: with ``miss_chunks``, the rows of one miss),
``tail_folds``, ``upload_bytes`` (with ``alea.upload.copy``, the
upload's copy rate), ``lookup_lanes`` (worker-lanes looked up in the
timeline's intervals) and ``sensor_lanes`` (worker-lanes the RAPL or
INA231 sensor read, W · c a chunk). The record's ``lookup_window`` is the timeline's
grid window ``grid_k``: the most ends one grid cell holds, the compares
a lookup makes (0: the binary search).

The determinism-critical modules only write records (:func:`span`,
:func:`count`, :func:`record` without binding it, :func:`fill_stats`);
the auditor's ``no-span-reads`` pass holds them to it, so no time read
here can reach a sample.
"""

from __future__ import annotations

import collections
import contextlib
import contextvars
import itertools
from time import perf_counter_ns

import torch
from torch._C._profiler import _RecordFunctionFast as record_range

__all__ = ["RECENT", "ProfileTrace", "count", "fill_stats", "recent",
           "record", "span"]

RECENT = 8

_current: contextvars.ContextVar[ProfileTrace | None] = \
    contextvars.ContextVar("alea_profile_trace", default=None)
_recent: collections.deque = collections.deque(maxlen=RECENT)
_ids = itertools.count(1)


def _profiling() -> bool:
    """Whether a torch profiler records on this thread."""
    return torch._C._autograd._profiler_enabled()


class ProfileTrace:
    """The spans and counters of one profile. ``table`` maps ``(name,
    parent name)`` (None for a span with no enclosing span) to ``[ns,
    calls]``."""

    def __init__(self, path: str, *, seed: int, workers: int,
                 chunk_size: int):
        self.id = next(_ids)
        self.path = path                 # "region" | "combination"
        self.seed = seed
        self.workers = workers
        self.chunk_size = chunk_size
        self.lookup_window: int | None = None   # the timeline's grid_k
        self.profiled = _profiling()     # a torch profiler was recording
        self.table: dict[tuple[str, str | None], list[int]] = {}
        self.counters: dict[str, int] = {}
        self._open: list[str] = []       # names of the open spans

    def _ns(self, name: str, parent: str | None) -> int:
        return sum(ns for (n, up), (ns, _) in self.table.items()
                   if n == name and (parent is None or up == parent))

    def seconds(self, name: str, parent: str | None = None) -> float:
        """Inclusive seconds of the spans called ``name`` (only those whose
        parent is called ``parent``, if given)."""
        return self._ns(name, parent) * 1e-9

    def by_name(self) -> dict[str, dict]:
        """Per span name: inclusive ``seconds``, ``calls``, and
        ``self_seconds`` (the durations less what their children cover)."""
        ns: dict[str, list[int]] = {}
        for (name, _), (t, calls) in self.table.items():
            acc = ns.setdefault(name, [0, 0, 0])
            acc[0] += t
            acc[1] += calls
            acc[2] += t
        for (_, parent), (t, _) in self.table.items():
            if parent is not None:
                ns[parent][2] -= t
        return {name: dict(seconds=t * 1e-9, calls=calls,
                           self_seconds=own * 1e-9)
                for name, (t, calls, own) in ns.items()}

    def __repr__(self) -> str:
        return (f"ProfileTrace(id={self.id}, path={self.path!r}, "
                f"seed={self.seed}, workers={self.workers}, "
                f"lookup_window={self.lookup_window}, "
                f"entries={len(self.table)}, counters={self.counters})")


@contextlib.contextmanager
def record(path: str, *, seed: int, workers: int, chunk_size: int,
           lookup_window: int | None = None):
    """Yield this thread's open record, or open one for one profile; a
    record opened here is kept by :func:`recent` when it closes. A
    ``lookup_window`` given is set on the record either way."""
    trace = _current.get()
    if trace is not None:
        if lookup_window is not None:
            trace.lookup_window = lookup_window
        yield trace
        return
    trace = ProfileTrace(path, seed=seed, workers=workers,
                         chunk_size=chunk_size)
    trace.lookup_window = lookup_window
    token = _current.set(trace)
    try:
        yield trace
    finally:
        _current.reset(token)
        _recent.append(trace)


class span:
    """``with span(name):`` adds one stage's nanoseconds and one call to
    the open record, under its name and the name of the span open around
    it. With ``ranged`` (the default) it also opens a profiler range of its
    name (:func:`record_range`) while a torch profiler records."""

    __slots__ = ("name", "ranged", "_trace", "_range", "_start")

    def __init__(self, name: str, *, ranged: bool = True):
        self.name = name
        self.ranged = ranged

    def __enter__(self):
        trace = self._trace = _current.get()
        if trace is None:
            return self
        self._range = None
        if self.ranged and trace.profiled and _profiling():
            self._range = record_range(self.name)
            self._range.__enter__()
        trace._open.append(self.name)
        self._start = perf_counter_ns()
        return self

    def __exit__(self, *exc):
        trace = self._trace
        if trace is None:
            return False
        ns = perf_counter_ns() - self._start
        opened = trace._open
        opened.pop()
        key = (self.name, opened[-1] if opened else None)
        acc = trace.table.get(key)
        if acc is None:
            trace.table[key] = [ns, 1]
        else:
            acc[0] += ns
            acc[1] += 1
        self._trace = None
        if self._range is not None:
            self._range.__exit__(*exc)
            self._range = None
        return False


def count(name: str, n: int = 1) -> None:
    """Add ``n`` to the open record's counter ``name``."""
    trace = _current.get()
    if trace is not None:
        trace.counters[name] = trace.counters.get(name, 0) + n


@contextlib.contextmanager
def fill_stats(stats: dict | None, *, counters: tuple[str, ...] = (),
               seconds: dict[str, str] | None = None):
    """When the block ends, set in ``stats`` what the block added to the
    open record: each counter of ``counters`` under its own name, and for
    each ``key: span name`` of ``seconds`` the span's inclusive seconds.
    Only this block's share, so calls under one enclosing record each get
    their own. Nothing is set if ``stats`` is None or no record is open."""
    trace = _current.get()
    if stats is None or trace is None:
        yield
        return
    seconds = seconds or {}
    c0 = {k: trace.counters.get(k, 0) for k in counters}
    ns0 = {k: trace._ns(name, None) for k, name in seconds.items()}
    yield
    for k in counters:
        stats[k] = trace.counters.get(k, 0) - c0[k]
    for k, name in seconds.items():
        stats[k] = (trace._ns(name, None) - ns0[k]) * 1e-9


def recent() -> list[ProfileTrace]:
    """The newest :data:`RECENT` records, oldest first."""
    return list(_recent)
