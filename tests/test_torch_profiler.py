"""Port parity: repro_torch's EnergyProfiler (on the CPU) against the JAX
reference's — device and host branches of the streaming profile, the
one-shot numpy paths, and the port's device rule."""

import contextlib
import dataclasses
import sys

import jax
import numpy as np
import pytest
import torch


@contextlib.contextmanager
def _reference_x64():
    """Let the JAX reference's device pipeline import under JAX 0.9.

    The reference does ``from jax.experimental import enable_x64``, which
    JAX 0.9 moved to ``jax.enable_x64``. The alias exists only inside this
    block, and ``repro.core.device_pipeline`` is taken back out of
    ``sys.modules`` on exit, so the reference's own test files see the
    JAX install exactly as they do without the port's tests.
    """
    import jax.experimental as jexp
    import repro.core as rcore
    name = "repro.core.device_pipeline"
    had_alias = "enable_x64" in vars(jexp)
    had_mod = name in sys.modules
    if not had_alias:
        jexp.enable_x64 = jax.enable_x64
    if not had_mod and name in _KEPT:
        sys.modules[name] = rcore.device_pipeline = _KEPT[name]
    try:
        yield
    finally:
        if name in sys.modules:
            _KEPT[name] = sys.modules[name]
        if not had_alias:
            del jexp.enable_x64
        if not had_mod:
            sys.modules.pop(name, None)
            vars(rcore).pop("device_pipeline", None)


_KEPT: dict = {}

with _reference_x64():
    import repro.core.device_pipeline  # noqa: F401

from repro.core import profiler as rprofiler  # noqa: E402
from repro.core import timeline as rtimeline  # noqa: E402
from repro_torch.core.profiler import EnergyProfiler  # noqa: E402
from repro_torch.core.timeline import RegionCost, synthesize  # noqa: E402


def _costs(cls):
    return [cls("mem", flops=1e10, hbm_bytes=5e10, invocations=4),
            cls("alu", flops=6e11, hbm_bytes=2e9, invocations=4),
            cls("opt", flops=2e10, hbm_bytes=4e10, invocations=1)]


def _pair(domains=False, steps=60, seed=0):
    return (synthesize(_costs(RegionCost), steps=steps, seed=seed,
                       domains=domains),
            rtimeline.synthesize(_costs(rtimeline.RegionCost), steps=steps,
                                 seed=seed, domains=domains))


def _assert_estimates_close(got, want, rtol):
    assert got.n_total == want.n_total
    assert got.t_exec == want.t_exec
    for f in dataclasses.fields(got.table):
        a, b = getattr(got.table, f.name), getattr(want.table, f.name)
        if a is None or b is None:
            assert a is None and b is None, f.name
        elif isinstance(a, np.ndarray) and a.dtype.kind == "f":
            np.testing.assert_allclose(a, b, rtol=rtol, err_msg=f.name)
        elif isinstance(a, np.ndarray):
            np.testing.assert_array_equal(a, b, err_msg=f.name)
        else:
            assert a == b, f.name


# ---------------------------------------------------------------------------
# profile_timeline_streaming: device branch ≡ reference device branch.
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("domains", [False, True], ids=["d1", "d3"])
@pytest.mark.parametrize("sensor", ["instant", "rapl", "ina231"])
def test_streaming_device_branch_matches_reference(sensor, domains):
    tl, rtl = _pair(domains=domains)
    kw = dict(sensor=sensor, chunk_size=2048, pipeline="device")
    got = EnergyProfiler(period=5e-3, seed=4, device="cpu") \
        .profile_timeline_streaming(tl, **kw)
    with _reference_x64():
        want = rprofiler.EnergyProfiler(period=5e-3, seed=4) \
            .profile_timeline_streaming(rtl, **kw)
    _assert_estimates_close(got, want, rtol=1e-9)


def test_streaming_auto_takes_the_device_branch():
    tl, _ = _pair()
    prof = EnergyProfiler(period=5e-3, seed=4, device="cpu")
    auto = prof.profile_timeline_streaming(tl, chunk_size=2048)
    dev = prof.profile_timeline_streaming(tl, chunk_size=2048,
                                          pipeline="device")
    _assert_estimates_close(auto, dev, rtol=0.0)


# ---------------------------------------------------------------------------
# Host branches and one-shot paths (numpy copies) ≡ reference, exactly.
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("domains", [False, True], ids=["d1", "d3"])
def test_streaming_host_branch_matches_reference(domains):
    tl, rtl = _pair(domains=domains)
    kw = dict(sensor="rapl", chunk_size=1000, pipeline="host",
              overhead_per_sample=1e-4)
    got = EnergyProfiler(period=5e-3, seed=2, device="cpu") \
        .profile_timeline_streaming(tl, **kw)
    want = rprofiler.EnergyProfiler(period=5e-3, seed=2) \
        .profile_timeline_streaming(rtl, **kw)
    _assert_estimates_close(got, want, rtol=0.0)


def test_profile_timeline_matches_reference():
    tl, rtl = _pair()
    got = EnergyProfiler(period=2e-3, seed=8, device="cpu") \
        .profile_timeline(tl, sensor="ina231")
    want = rprofiler.EnergyProfiler(period=2e-3, seed=8) \
        .profile_timeline(rtl, sensor="ina231")
    _assert_estimates_close(got, want, rtol=0.0)
    prof = EnergyProfiler(device="cpu")
    assert prof.report(got).table() == \
        rprofiler.EnergyProfiler().report(want).table()


def test_multiworker_host_matches_reference():
    pairs = [_pair(seed=s) for s in (0, 1)]
    kw = dict(sensor="instant")
    (got, got_rows) = EnergyProfiler(period=5e-3, seed=1, device="cpu") \
        .profile_multiworker([p for p, _ in pairs], **kw)
    (want, want_rows) = rprofiler.EnergyProfiler(period=5e-3, seed=1) \
        .profile_multiworker([r for _, r in pairs], **kw)
    _assert_estimates_close(got, want, rtol=0.0)
    assert got_rows == want_rows
    (got, got_rows) = EnergyProfiler(period=5e-3, seed=1, device="cpu") \
        .profile_multiworker_streaming([p for p, _ in pairs],
                                       chunk_size=500, pipeline="host", **kw)
    (want, want_rows) = rprofiler.EnergyProfiler(period=5e-3, seed=1) \
        .profile_multiworker_streaming([r for _, r in pairs],
                                       chunk_size=500, pipeline="host", **kw)
    _assert_estimates_close(got, want, rtol=0.0)
    assert got_rows == want_rows


@pytest.mark.parametrize("pipeline", ["auto", "device"])
def test_multiworker_device_matches_reference(pipeline):
    """The default (auto) and the explicit device pipeline both run the
    combination pipeline and match the reference's device branch."""
    pairs = [_pair(seed=s) for s in (0, 1, 2)]
    kw = dict(sensor="rapl", chunk_size=512)
    (got, got_rows) = EnergyProfiler(period=5e-3, seed=3, device="cpu") \
        .profile_multiworker_streaming([p for p, _ in pairs],
                                       pipeline=pipeline, **kw)
    with _reference_x64():
        (want, want_rows) = rprofiler.EnergyProfiler(period=5e-3, seed=3) \
            .profile_multiworker_streaming([r for _, r in pairs],
                                           pipeline="device", **kw)
    assert got_rows == want_rows
    _assert_estimates_close(got, want, rtol=1e-9)


def test_multiworker_exchange_is_not_ported_yet():
    tls = [p for p, _ in (_pair(seed=0), _pair(seed=1))]
    prof = EnergyProfiler(period=5e-3, device="cpu")
    for pipeline in ("device", "host"):
        with pytest.raises(NotImplementedError, match="A5"):
            prof.profile_multiworker_streaming(tls, pipeline=pipeline,
                                               exchange=object())


# ---------------------------------------------------------------------------
# Pipeline selection and the device rule.
# ---------------------------------------------------------------------------

def test_resolve_pipeline_rules():
    prof = EnergyProfiler(period=1e-3, device="cpu")
    assert prof._resolve_pipeline("auto", None) is True
    assert prof._resolve_pipeline("host", None) is False
    assert prof._resolve_pipeline("auto", lambda *a: None) is False
    with pytest.raises(ValueError):
        prof._resolve_pipeline("device", lambda *a: None)
    with pytest.raises(ValueError):
        prof._resolve_pipeline("gpu", None)
    jittery = EnergyProfiler(period=1e-3, jitter=2e-3, device="cpu")
    assert jittery._resolve_pipeline("auto", None) is False


def test_profiler_defaults_to_the_gpu():
    assert EnergyProfiler(device="cpu").device == torch.device("cpu")
    if torch.cuda.is_available():
        pytest.skip("a GPU is present; the default device is usable")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        EnergyProfiler()
    tl, _ = _pair()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tl.to_device()
