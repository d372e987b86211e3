"""Port parity: repro_torch's host-mode sessions (``EnergyProfiler.
host_session``, ``HostSession``) and the region marking they rely on
(``profiling_session(jit_marking=)``, ``mark_in_jit``), beside the JAX
reference's. Sessions sample real wall-clock time, so their checks are as
loose as the reference's own (tests/test_sampler_profiler.py)."""

import time

import pytest

from repro.core import regions as rregions
from repro.core.sampler import RegionMarker as RRegionMarker
from repro_torch.core import regions
from repro_torch.core.profiler import EnergyProfiler, HostSession
from repro_torch.core.sampler import RegionMarker
from repro_torch.core.sensors import HostSensorBank


def _spin(seconds):
    t0 = time.monotonic()
    while time.monotonic() - t0 < seconds:
        pass


def test_host_session_smoke():
    """Counterpart of the reference's test: the control thread samples
    regions executed by this process (loose thresholds: a loaded host
    stretches the sampler's sleeps)."""
    prof = EnergyProfiler(period=1e-3, jitter=1e-4, device="cpu")
    t0 = time.monotonic()
    with prof.host_session() as sess:
        assert isinstance(sess, HostSession)
        for _ in range(120):
            with regions.region("busy"):
                _spin(2e-3)
            with regions.region("idle"):
                time.sleep(0.5e-3)
    wall = time.monotonic() - t0
    est = sess.estimates()
    assert "busy" in {r.name for r in est.regions}
    busy = est.by_name()["busy"]
    assert busy.n_samples >= 5
    assert busy.p_hat > 0.2
    assert sum(r.t_hat for r in est.regions) == pytest.approx(est.t_exec,
                                                              rel=1e-6)
    assert 0.0 < est.t_exec <= wall


def test_host_session_with_sensor_bank_reports_rails():
    """Counterpart of the reference's test: a multi-rail bank threads
    through the session; the rails sum to the scalar total and split as
    the configured constant powers."""

    class Const:
        min_period = 0.0

        def __init__(self, v):
            self.v = v

        def read(self, t=None):
            return self.v

    bank = HostSensorBank([("pkg", Const(50.0)), ("dram", Const(10.0))])
    prof = EnergyProfiler(period=1e-3, jitter=1e-4, device="cpu")
    with prof.host_session(sensor=bank) as sess:
        for _ in range(60):
            with regions.region("railwork"):
                _spin(2e-3)
    est = sess.estimates()
    tbl = est.table
    assert tbl.domains == ("pkg", "dram")
    row = est.by_name()["railwork"]
    assert row.n_samples >= 3
    i = list(tbl.names).index("railwork")
    assert tbl.e_rails[i].sum() == pytest.approx(tbl.e_hat[i], rel=1e-6)
    assert tbl.e_rails[i, 0] == pytest.approx(tbl.e_hat[i] * 50.0 / 60.0,
                                              rel=1e-6)


def test_host_session_rejects_period_below_sensor_floor():
    class Slow:
        min_period = 5e-3

        def read(self, t=None):
            return 1.0

    with pytest.raises(ValueError, match="floor"):
        EnergyProfiler(period=1e-3, device="cpu").host_session(sensor=Slow())


@pytest.mark.parametrize("mod,marker_cls", [(regions, RegionMarker),
                                            (rregions, RRegionMarker)],
                         ids=["port", "reference"])
@pytest.mark.parametrize("jit_marking", [False, True])
def test_region_marks_only_without_jit_marking(mod, marker_cls, jit_marking):
    """As in the reference: ``region`` stores the marker in a plain
    session and leaves it to in-graph markers under ``jit_marking``."""
    marker = marker_cls()
    with mod.profiling_session(marker, jit_marking=jit_marking):
        with mod.region("outer") as rid:
            inside = marker.value
        after = marker.value
    assert (inside, after) == ((0, 0) if jit_marking else (rid, 0))


def test_mark_in_jit_stores_only_under_jit_marking():
    dep = object()
    rid = regions.registry.intern("marked")
    assert regions.mark_in_jit("marked", dep) is dep   # no session
    marker = RegionMarker()
    with regions.profiling_session(marker):
        assert regions.mark_in_jit("marked", dep) is dep
        assert marker.value == 0
    with regions.profiling_session(marker, jit_marking=True):
        assert regions.mark_in_jit("marked", dep) is dep
        assert marker.value == rid
        assert regions.mark_in_jit("<other>") is None
        assert marker.value == 0
    regions.mark_in_jit("marked")
    assert marker.value == 0          # the session has ended


def test_host_session_with_jit_marking_samples_marked_regions():
    prof = EnergyProfiler(period=1e-3, jitter=1e-4, device="cpu")
    with prof.host_session(jit_marking=True) as sess:
        for _ in range(100):
            with regions.region("unmarked"):
                regions.mark_in_jit("jitbusy")
                _spin(2e-3)
                regions.mark_in_jit("<other>")
                time.sleep(0.5e-3)
    est = sess.estimates()
    names = {r.name for r in est.regions if r.n_samples}
    assert "jitbusy" in names
    assert "unmarked" not in names
    assert est.by_name()["jitbusy"].n_samples >= 5


# ---------------------------------------------------------------------------
# mark_in_jit in CUDA stream order (StreamMarker). The library and the card
# are absent here: a stand-in for the C library records what would be
# queued; chip_smoke's host-session phase holds the real one on the GPU.
# ---------------------------------------------------------------------------

class _FakeLibrary:
    """The C library's entry points over a dict: ``sm_mark`` queues a store
    that :meth:`drain` applies, as the stream would when it got there."""

    def __init__(self, err=0):
        self.slots, self.queue, self.err, self.released = {}, [], err, []

    def sm_slot_new(self):
        self.slots[7] = 0
        return 7

    def sm_slot_get(self, slot):
        return self.slots[slot]

    def sm_slot_set(self, slot, value):
        self.slots[slot] = value

    def sm_slot_release(self, slot):
        self.released.append(slot)

    def sm_mark(self, slot, value, stream, device):
        if self.err:
            return self.err
        self.queue.append((slot, value, stream, device))
        return 0

    def sm_error_string(self, err):
        return b"invalid resource handle"

    def drain(self):
        for slot, value, _, _ in self.queue:
            self.slots[slot] = value
        self.queue.clear()


@pytest.fixture
def fake_stream(monkeypatch):
    import types

    import torch

    from repro_torch.core import stream_marker
    lib = _FakeLibrary()
    lib.real = stream_marker._library
    monkeypatch.setattr(stream_marker, "_library", lambda: lib)
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda index=None: types.SimpleNamespace(
                            cuda_stream=0xBEEF))
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
    return lib


def test_mark_in_jit_queues_the_store_on_the_stream(fake_stream):
    """Under a StreamMarker the store waits for the stream: the marker
    keeps its region until the queued store fires."""
    from repro_torch.core.stream_marker import StreamMarker
    marker = StreamMarker("cuda:0")
    rid = regions.registry.intern("gpu_long")
    with regions.profiling_session(marker, jit_marking=True):
        regions.mark_in_jit("gpu_long")
        assert marker.value == 0                 # queued, not stored
        assert fake_stream.queue == [(7, rid, 0xBEEF, 0)]
        fake_stream.drain()
        assert marker.value == rid
        regions.mark_in_jit("<other>")
        assert marker.value == rid
        fake_stream.drain()
        assert marker.value == 0
    assert marker.queued == 2
    marker.set(5)                                # host order, at once
    assert marker.value == 5
    del marker
    assert fake_stream.released == [7]


def test_stream_marker_failures_raise_and_never_fall_back(fake_stream,
                                                         monkeypatch):
    """A store CUDA refuses raises, leaving the marker as it was; a library
    that does not build raises when the marker is made."""
    from repro_torch.core import stream_marker
    from repro_torch.kernels import _build
    marker = stream_marker.StreamMarker("cuda:0")
    fake_stream.err = 400
    with regions.profiling_session(marker, jit_marking=True):
        with pytest.raises(RuntimeError, match="cudaLaunchHostFunc"):
            regions.mark_in_jit("refused")
    assert marker.value == 0 and marker.queued == 0
    with pytest.raises(ValueError, match="CUDA"):
        stream_marker.StreamMarker("cpu")

    def no_build(name):
        raise RuntimeError(f"kernel build failed: {name}")
    monkeypatch.setattr(stream_marker, "_library",
                        fake_stream.real.__wrapped__)
    monkeypatch.setattr(_build, "load", no_build)
    with pytest.raises(RuntimeError, match="stream_marker"):
        stream_marker.StreamMarker("cuda:0")


def test_cpu_session_keeps_the_immediate_marker():
    prof = EnergyProfiler(period=1e-3, device="cpu")
    for jit_marking in (False, True):
        assert type(prof.host_session(jit_marking=jit_marking).marker) \
            is RegionMarker
