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
