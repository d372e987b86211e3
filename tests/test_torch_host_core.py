"""Port parity: the numpy modules repro_torch keeps its own copies of
(power model, timeline, faults, sensors, sampler, estimator, sketch,
streaming, attribution) give byte-equal outputs to the JAX reference's
on the same seeds. None of these needs the reference's device pipeline,
so this file imports the reference as it is."""

import dataclasses

import numpy as np
import pytest

from repro.core import attribution as r_attribution
from repro.core import estimator as r_estimator
from repro.core import faults as r_faults
from repro.core import power_model as r_power_model
from repro.core import sampler as r_sampler
from repro.core import sensors as r_sensors
from repro.core import sketch as r_sketch
from repro.core import streaming as r_streaming
from repro.core import timeline as r_timeline
from repro_torch.core import (attribution, estimator, faults, power_model,
                              sampler, sensors, sketch, streaming, timeline)


def _costs(mod):
    return [mod.RegionCost("mem", flops=1e10, hbm_bytes=5e10, invocations=4),
            mod.RegionCost("alu", flops=6e11, hbm_bytes=2e9, invocations=4),
            mod.RegionCost("comm", flops=2e9, hbm_bytes=2e8, ici_bytes=6e8,
                           invocations=2)]


def _tl(mod, domains=False, seed=0, steps=40):
    return mod.synthesize(_costs(mod), steps=steps, seed=seed,
                          domains=domains)


def _equal(a, b):
    """Byte equality through nests of arrays, tuples, lists, dicts and
    dataclasses (estimate tables, reports, sample streams)."""
    if dataclasses.is_dataclass(a) and not isinstance(a, type):
        assert type(a).__name__ == type(b).__name__
        for f in dataclasses.fields(a):
            _equal(getattr(a, f.name), getattr(b, f.name))
    elif isinstance(a, np.ndarray):
        assert a.dtype == b.dtype and a.shape == b.shape
        assert a.tobytes() == np.asarray(b).tobytes()
    elif isinstance(a, dict):
        assert a.keys() == b.keys()
        for k in a:
            _equal(a[k], b[k])
    elif isinstance(a, list | tuple):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            _equal(x, y)
    elif isinstance(a, float) and np.isnan(a):
        assert np.isnan(b)
    else:
        assert a == b


@pytest.mark.parametrize("domains", [False, True], ids=["d1", "d3"])
@pytest.mark.parametrize("seed", [0, 3])
def test_timeline_synthesis_byte_equal(seed, domains):
    a, b = _tl(timeline, domains, seed), _tl(r_timeline, domains, seed)
    for f in ("region_ids", "durations", "powers", "ends"):
        _equal(getattr(a, f), getattr(b, f))
    _equal(a.energy_integral(), b.energy_integral())
    _equal(a.rails(), b.rails())
    _equal(a.rail_energy_integral(), b.rail_energy_integral())
    _equal(timeline.ground_truth(a), r_timeline.ground_truth(b))
    t = np.random.default_rng(seed).uniform(0, a.t_exec, 5000)
    _equal(a.region_at(t), b.region_at(t))
    _equal(a.tile(3).ends, b.tile(3).ends)
    assert a.t_exec == b.t_exec and a.domain_names == b.domain_names


def test_power_model_byte_equal():
    pm, rpm = power_model.PowerModel(), r_power_model.PowerModel()
    for flops, hbm, ici in [(1e10, 5e10, 0.0), (6e11, 2e9, 1e8),
                            (2e9, 2e8, 6e8)]:
        for fs in (0.6, 1.0):
            d = pm.region_duration(flops, hbm, ici, freq_scale=fs)
            assert d == rpm.region_duration(flops, hbm, ici, freq_scale=fs)
            u = pm.utilizations(flops, hbm, ici, d, fs)
            _equal(np.asarray(u), np.asarray(
                rpm.utilizations(flops, hbm, ici, d, fs)))
            assert pm.power(*u, freq_scale=fs) == rpm.power(*u,
                                                            freq_scale=fs)
            _equal(pm.power_rails(*u, freq_scale=fs),
                   rpm.power_rails(*u, freq_scale=fs))
    assert pm.domains == rpm.domains


@pytest.mark.parametrize("domains", [False, True], ids=["d1", "d3"])
@pytest.mark.parametrize("sensor", ["InstantTraceSensor", "RaplTraceSensor",
                                    "Ina231TraceSensor"])
def test_trace_sensors_byte_equal(sensor, domains):
    a, b = _tl(timeline, domains), _tl(r_timeline, domains)
    sa, sb = getattr(sensors, sensor)(a), getattr(r_sensors, sensor)(b)
    t = np.sort(np.random.default_rng(1).uniform(0, a.t_exec, 3000))
    _equal(sa.read_rails(t), sb.read_rails(t))
    spec = getattr(sensors, sensor).make_spec(domains=a.domain_names)
    rspec = getattr(r_sensors, sensor).make_spec(domains=b.domain_names)
    _equal(dataclasses.asdict(spec), dataclasses.asdict(rspec))
    assert sensors.idle_channel(a.domain_names) == \
        r_sensors.idle_channel(b.domain_names)


def test_failover_bank_and_fault_plan_byte_equal():
    a, b = _tl(timeline, True), _tl(r_timeline, True)
    plan = faults.FaultPlan(seed=5, dropouts=(
        faults.ChannelDropout("hbm", 1.0, 3.0),))
    rplan = r_faults.FaultPlan(seed=5, dropouts=(
        r_faults.ChannelDropout("hbm", 1.0, 3.0),))
    t = np.linspace(0.0, a.t_exec, 4000, endpoint=False)
    _equal(plan.dropout_mask(a.domain_names, t),
           rplan.dropout_mask(b.domain_names, t))
    bank = sensors.FailoverTraceBank(sensors.InstantTraceSensor(a),
                                     faults=plan)
    rbank = r_sensors.FailoverTraceBank(r_sensors.InstantTraceSensor(b),
                                        faults=rplan)
    _equal(bank.read_rails(t), rbank.read_rails(t))
    for host, epoch in [(0, 1), (3, 7)]:
        assert plan.crash_at(host, epoch) == rplan.crash_at(host, epoch)
    data = bytes(range(200))
    assert faults._mix64(1, 2, 3) == r_faults._mix64(1, 2, 3)
    assert plan.corrupt_bytes("x/leaf.npy", data, "write") == \
        rplan.corrupt_bytes("x/leaf.npy", data, "write")


@pytest.mark.parametrize("domains", [False, True], ids=["d1", "d3"])
def test_sampler_byte_equal(domains):
    a, b = _tl(timeline, domains), _tl(r_timeline, domains)
    kw = dict(period=2e-3, jitter=2e-4, seed=7)
    _equal(sampler.sample_timeline(a, sensors.RaplTraceSensor(a), **kw),
           r_sampler.sample_timeline(b, r_sensors.RaplTraceSensor(b), **kw))
    got = list(sampler.iter_sample_chunks(
        a, sensors.Ina231TraceSensor(a), chunk_size=700, **kw))
    want = list(r_sampler.iter_sample_chunks(
        b, r_sensors.Ina231TraceSensor(b), chunk_size=700, **kw))
    _equal(got, want)
    tls = [_tl(timeline, domains, s) for s in (0, 1)]
    rtls = [_tl(r_timeline, domains, s) for s in (0, 1)]
    _equal(sampler.sample_timeline_multiworker(
               tls, sensors.InstantTraceSensor, **kw),
           r_sampler.sample_timeline_multiworker(
               rtls, r_sensors.InstantTraceSensor, **kw))


def test_estimator_and_report_byte_equal():
    a, b = _tl(timeline), _tl(r_timeline)
    kw = dict(period=1e-3, jitter=2e-4, seed=2)
    s = sampler.sample_timeline(a, sensors.InstantTraceSensor(a), **kw)
    est = estimator.estimate_regions(s.region_ids, s.powers, s.t_exec,
                                     a.names)
    rest = r_estimator.estimate_regions(s.region_ids, s.powers, s.t_exec,
                                        b.names)
    _equal(est.table, rest.table)
    _equal(estimator.aggregate_samples_np(s.region_ids, s.powers, 3),
           r_estimator.aggregate_samples_np(s.region_ids, s.powers, 3))
    rep, rrep = (attribution.AttributionReport(est),
                 r_attribution.AttributionReport(rest))
    assert rep.table() == rrep.table() and rep.csv() == rrep.csv()
    v = attribution.validate(est, timeline.ground_truth(a))
    rv = r_attribution.validate(rest, r_timeline.ground_truth(b))
    assert v.summary() == rv.summary()
    mat = np.random.default_rng(0).integers(0, 3, (4000, 2))
    pw = 100.0 + np.random.default_rng(1).random(4000)
    _equal(estimator.estimate_combinations(mat, pw, 4.0, a.names),
           r_estimator.estimate_combinations(mat, pw, 4.0, b.names))


def test_sketch_byte_equal():
    mat = np.random.default_rng(4).integers(0, 50, (1000, 3))
    _equal(sketch.combo_hashes(mat), r_sketch.combo_hashes(mat))
    assert [r.as_tuple() for r in sketch.HashRange.split(5)] == \
        [r.as_tuple() for r in r_sketch.HashRange.split(5)]
    assert sketch.other_row(3, 4) == r_sketch.other_row(3, 4)


@pytest.mark.parametrize("k", [None, 6])
def test_streaming_aggregators_byte_equal(k):
    rng = np.random.default_rng(9)
    chunks = [(rng.integers(0, 4, (800, 2)), 50 + rng.random((800, 3)))
              for _ in range(4)]
    dom = ("package", "hbm", "ici")
    got = streaming.StreamingCombinationAggregator(domains=dom, k=k)
    want = r_streaming.StreamingCombinationAggregator(domains=dom, k=k)
    for mat, pw in chunks:
        got.update(mat, pw)
        want.update(mat, pw)
    _equal(got.estimates(3.0, ["a", "b", "c", "d"]),
           want.estimates(3.0, ["a", "b", "c", "d"]))
    ra = streaming.StreamingAggregator(4, domains=dom)
    rb = r_streaming.StreamingAggregator(4, domains=dom)
    for mat, pw in chunks:
        ra.update(mat[:, 0], pw)
        rb.update(mat[:, 0], pw)
    _equal(ra.channel_statistics(), rb.channel_statistics())
    _equal(ra.estimates(3.0, "abcd"), rb.estimates(3.0, "abcd"))
    assert streaming.channels_for(3) == r_streaming.channels_for(3)
