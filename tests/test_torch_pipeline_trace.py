"""The device pipeline's own spans and counters (``core/spans.py``): one
record per profile, its table of spans by parent and its counters,
``stats`` read from it (per call, also under an enclosing record),
profiler ranges only while a torch profiler records, and the ring of
recent records. On the CPU; no reference involved."""

import threading

import numpy as np
import pytest
import torch
from torch.autograd import DeviceType

from repro_torch.core import device_pipeline as dp
from repro_torch.core import sensors, spans
from repro_torch.core.profiler import EnergyProfiler
from repro_torch.core.timeline import RegionCost, synthesize

PERIOD, JITTER, CHUNK = 1e-3, 2e-4, 512

REGION_SPANS = {"alea.profile", "alea.upload", "alea.upload.build",
                "alea.upload.copy", "alea.pipeline", "alea.clock",
                "alea.lookup", "alea.sensor", "alea.fold", "alea.readback",
                "alea.estimate"}
COMBO_SPANS = REGION_SPANS | {"alea.search", "alea.miss_flag", "alea.miss"}
# The parent each span may have (None: the record's root).
PARENTS = {
    "alea.profile": {None},
    "alea.upload": {"alea.profile"},
    "alea.upload.build": {"alea.upload"},
    "alea.upload.copy": {"alea.upload"},
    "alea.pipeline": {"alea.profile"},
    "alea.clock": {"alea.pipeline", "alea.miss"},
    "alea.lookup": {"alea.pipeline", "alea.miss"},
    "alea.sensor": {"alea.pipeline", "alea.miss"},
    "alea.search": {"alea.pipeline"},
    "alea.fold": {"alea.pipeline", "alea.miss"},
    "alea.miss_flag": {"alea.pipeline"},
    "alea.miss": {"alea.pipeline"},
    "alea.readback": {"alea.pipeline"},
    "alea.estimate": {"alea.profile", "alea.pipeline"},
}
RANGED = {"alea.clock", "alea.lookup", "alea.sensor", "alea.fold"}


def _timeline(seed=0):
    costs = [RegionCost(f"r{i}", flops=2e11 * (i + 1), hbm_bytes=4e10,
                        invocations=3) for i in range(5)]
    return synthesize(costs, steps=8, seed=seed, domains=True)


@pytest.fixture(scope="module")
def timelines():
    return [_timeline(s) for s in range(3)]


def _profile(path, tls, **kw):
    """One profile through the entry's device pipeline; (profiler,
    estimates)."""
    prof = EnergyProfiler(period=PERIOD, jitter=JITTER, seed=3, device="cpu")
    if path == "region":
        est = prof.profile_timeline_streaming(
            tls[0], sensor="rapl", chunk_size=CHUNK, pipeline="device", **kw)
    else:
        est = prof.profile_multiworker_streaming(
            tls, sensor="rapl", chunk_size=CHUNK, pipeline="device", **kw)
    return prof, est


@pytest.mark.parametrize("path", ["region", "combination"])
def test_a_profile_leaves_one_record(path, timelines):
    before = {t.id for t in spans.recent()}
    prof, _ = _profile(path, timelines)
    trace = prof.last_trace
    assert [t for t in spans.recent() if t.id not in before] == [trace]
    assert trace.path == path and not trace.profiled
    assert trace.workers == (1 if path == "region" else len(timelines))
    assert trace.seed == 3 and trace.chunk_size == CHUNK
    names = {name for name, _ in trace.table}
    assert names == (REGION_SPANS if path == "region" else COMBO_SPANS)
    for (name, parent), (ns, calls) in trace.table.items():
        assert parent in PARENTS[name], name
        assert parent is None or parent in names
        assert ns >= 0 and calls >= 1
    per = trace.by_name()
    assert all(d["self_seconds"] >= 0 for d in per.values())
    assert per["alea.profile"]["calls"] == per["alea.pipeline"]["calls"] == 1
    t_end = min(tl.t_exec for tl in timelines[:trace.workers])
    chunks = dp.num_chunks(t_end, PERIOD, CHUNK)
    assert trace.counters["chunks"] == chunks
    assert trace.seconds("alea.clock", parent="alea.pipeline") > 0
    assert per["alea.fold"]["calls"] == chunks + trace.counters.get(
        "miss_chunks", 0)
    assert trace.counters["upload_bytes"] > 0
    # The stages under the pipeline cover it: its self time is the loop.
    pipe = per["alea.pipeline"]
    assert pipe["self_seconds"] <= 0.2 * pipe["seconds"]
    if path == "combination":
        assert trace.counters["miss_chunks"] >= 1
        assert trace.counters["miss_rows"] >= trace.counters["miss_chunks"]
        assert per["alea.miss_flag"]["calls"] == chunks


@pytest.mark.parametrize("path", ["region", "combination"])
@pytest.mark.parametrize("sensor,full", [("instant", 1), ("rapl", 2),
                                         ("ina231", 2)])
def test_the_record_holds_the_lookup_window_and_lanes(path, sensor, full,
                                                      timelines):
    """``lookup_window`` is the uploaded timeline's grid window, set on the
    record the entry opened before the upload; ``lookup_lanes`` counts
    every worker-lane looked up: the sensor's full-chunk lookups on every
    pass over a chunk (misses replay theirs) and RAPL's one-lane lookup
    of the sample before the chunk."""
    tls = timelines[:1] if path == "region" else timelines
    prof = EnergyProfiler(period=PERIOD, jitter=JITTER, seed=3, device="cpu")
    kw = dict(sensor=sensor, chunk_size=CHUNK, pipeline="device")
    if path == "region":
        prof.profile_timeline_streaming(tls[0], **kw)
    else:
        prof.profile_multiworker_streaming(tls, **kw)
    trace = prof.last_trace
    W = len(tls)
    assert trace.lookup_window == dp.DeviceTimeline.from_timelines(
        tls, device="cpu").grid_k > 0
    passes = trace.counters["chunks"] + trace.counters.get("miss_chunks", 0)
    head = W if sensor == "rapl" else 0
    assert trace.counters["lookup_lanes"] == passes * (full * W * CHUNK
                                                       + head)
    assert f"lookup_window={trace.lookup_window}" in repr(trace)


def test_stats_are_read_from_the_record(timelines):
    """``run_combo_pipeline(stats=...)``, called with no record open,
    opens its own and fills ``stats`` from it."""
    dtl = dp.DeviceTimeline.from_timelines(timelines, device="cpu")
    spec = sensors.RaplTraceSensor.make_spec(domains=dtl.domains)
    kw = dict(period=PERIOD, jitter=JITTER, seed=5, chunk_size=CHUNK)
    exact, _ = dp.run_combo_pipeline(dtl, spec, **kw)
    stats = {}
    agg, _ = dp.run_combo_pipeline(
        dtl, spec, max_combinations=max(2, len(exact.interner) // 3),
        stats=stats, **kw)
    trace = spans.recent()[-1]
    assert {name for name, up in trace.table if up is None} == \
        {"alea.pipeline"}
    assert stats == dict(chunks=trace.counters["chunks"],
                         miss_chunks=trace.counters["miss_chunks"],
                         miss_seconds=trace.seconds("alea.miss"),
                         tail_folds=trace.counters["tail_folds"])
    assert stats["miss_seconds"] > 0 and stats["tail_folds"] > 0
    assert agg.tail_folds == stats["tail_folds"]


def test_spans_with_no_record_open_are_not_kept(timelines):
    before = [t.id for t in spans.recent()]
    with spans.span("alea.upload"):
        spans.count("chunks")
    dp.DeviceTimeline.from_timelines(timelines[:1], device="cpu")
    assert [t.id for t in spans.recent()] == before


def test_no_profiler_range_while_no_profiler_records(timelines,
                                                     monkeypatch):
    opened = []
    real = spans.record_range

    def counted(name):
        opened.append(name)
        return real(name)
    monkeypatch.setattr(spans, "record_range", counted)
    for path in ("region", "combination"):
        _profile(path, timelines)
    assert opened == []
    with torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CPU]):
        _profile("region", timelines)
    assert set(opened) == REGION_SPANS - {"alea.profile", "alea.pipeline"}


@pytest.mark.parametrize("path", ["region", "combination"])
def test_profiler_ranges_name_the_stages(path, timelines):
    """Under ``torch.profiler`` every stage but the two that enclose
    whole stage sequences is a range of the trace, of an operator's scope
    (a user-scope range, as ``record_function`` opens, would also be
    drawn on the device timeline as busy); the estimates are the
    untraced profile's, bit for bit."""
    _, plain = _profile(path, timelines)
    with torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CPU]) as prof:
        tprof, traced = _profile(path, timelines)
        with torch.profiler.record_function("user"):
            pass
    assert tprof.last_trace.profiled
    ranges = {e.name() for e in prof.profiler.kineto_results.events()
              if e.device_type() == DeviceType.CPU
              and e.name().startswith("alea.")}
    scope = {e.name: e.scope for e in prof.events()
             if e.name.startswith("alea.") or e.name == "user"}
    assert scope["alea.clock"] != scope["user"]
    want = RANGED | ({"alea.search", "alea.miss_flag", "alea.miss"}
                     if path == "combination" else set())
    assert want <= ranges
    assert not {"alea.profile", "alea.pipeline"} & ranges
    if path == "combination":
        (traced, rows), (plain, plain_rows) = traced, plain
        np.testing.assert_array_equal(rows, plain_rows)
    for col in ("n_samples", "pow_hat", "pow_lo", "pow_hi", "e_hat"):
        np.testing.assert_array_equal(getattr(traced.table, col),
                                      getattr(plain.table, col))


def test_records_are_per_thread(timelines):
    """A profile on another thread keeps its own record while this
    thread has one open."""
    got = {}

    def work():
        got["prof"], _ = _profile("region", timelines)
    with spans.record("region", seed=0, workers=1, chunk_size=8) as mine:
        t = threading.Thread(target=work)
        t.start()
        t.join(timeout=60)
    assert not t.is_alive()
    assert got["prof"].last_trace is not mine
    assert got["prof"].last_trace.counters["chunks"] > 0
    assert mine.table == {} and mine.counters == {}


def test_recent_keeps_the_newest_eight():
    made = []
    for i in range(spans.RECENT + 3):
        with spans.record("region", seed=i, workers=1, chunk_size=8) as t:
            made.append(t)
    assert len(spans.recent()) == spans.RECENT
    assert spans.recent() == made[-spans.RECENT:]


def test_stats_are_per_call_under_one_record(timelines):
    """Two pipeline calls under one enclosing record: each call's ``stats``
    hold its own share, and the record holds both."""
    dtl = dp.DeviceTimeline.from_timelines(timelines, device="cpu")
    spec = sensors.RaplTraceSensor.make_spec(domains=dtl.domains)
    kw = dict(period=PERIOD, jitter=JITTER, seed=5, chunk_size=CHUNK)
    alone = {}
    dp.run_combo_pipeline(dtl, spec, stats=alone, **kw)
    first, second = {}, {}
    with spans.record("combination", seed=5, workers=dtl.num_workers,
                      chunk_size=CHUNK) as trace:
        dp.run_combo_pipeline(dtl, spec, stats=first, **kw)
        dp.run_combo_pipeline(dtl, spec, stats=second, **kw)
    for got in (first, second):
        assert got["chunks"] == alone["chunks"]
        assert got["miss_chunks"] == alone["miss_chunks"] >= 1
        assert 0 < got["miss_seconds"] < trace.seconds("alea.miss")
    assert trace.counters["chunks"] == 2 * alone["chunks"]
    assert first["miss_seconds"] + second["miss_seconds"] == \
        pytest.approx(trace.seconds("alea.miss"))


def test_a_record_stays_as_small_as_its_stages():
    def chunks(n):
        with spans.record("region", seed=0, workers=1, chunk_size=8) as t:
            with spans.span("alea.pipeline", ranged=False):
                for _ in range(n):
                    spans.count("chunks")
                    with spans.span("alea.clock"):
                        pass
        return t
    few, many = chunks(3), chunks(3000)
    assert few.table.keys() == many.table.keys()
    assert many.table["alea.clock", "alea.pipeline"][1] == 3000
    assert many.counters == {"chunks": 3000}


def test_self_seconds_leave_out_the_children(monkeypatch):
    clock = iter([0, 1_000, 4_000, 5_000, 6_000, 10_000])
    monkeypatch.setattr(spans, "perf_counter_ns", lambda: next(clock))
    with spans.record("region", seed=0, workers=1, chunk_size=8) as trace:
        with spans.span("alea.pipeline", ranged=False):
            with spans.span("alea.clock"):
                pass
            with spans.span("alea.fold"):
                pass
    per = trace.by_name()
    assert per["alea.pipeline"]["seconds"] == pytest.approx(1e-5)
    assert per["alea.pipeline"]["self_seconds"] == pytest.approx(6e-6)
    assert per["alea.clock"]["self_seconds"] == pytest.approx(3e-6)
    assert trace.seconds("alea.clock", parent="alea.pipeline") == \
        pytest.approx(3e-6)
    assert trace.seconds("alea.clock", parent="alea.miss") == 0
