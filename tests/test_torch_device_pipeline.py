"""Port parity: repro_torch's device pipeline (run on the CPU) against the
JAX reference — the sample clock bit for bit, the timeline substrate
array for array, and the region pipeline's statistics for every sensor
at D=1 and D=3."""

import contextlib
import dataclasses
import sys

import jax
import jax.numpy as jnp
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
    from repro.core import device_pipeline as rdp

from repro.core import sensors as rsensors  # noqa: E402
from repro.core import timeline as rtimeline  # noqa: E402
from repro_torch.convert import tree_to_torch  # noqa: E402
from repro_torch.core import device_pipeline as dp  # noqa: E402
from repro_torch.core import sensors, threefry  # noqa: E402
from repro_torch.core.timeline import (RegionCost, Timeline,  # noqa: E402
                                       synthesize)

_SENSORS = ("instant", "rapl", "ina231")
_SPEC = {"instant": "InstantTraceSensor", "rapl": "RaplTraceSensor",
         "ina231": "Ina231TraceSensor"}


def _costs(cls):
    # The timelines of tests/test_device_pipeline.py.
    return [cls("mem", flops=1e10, hbm_bytes=5e10, invocations=4),
            cls("alu", flops=6e11, hbm_bytes=2e9, invocations=4),
            cls("opt", flops=2e10, hbm_bytes=4e10, invocations=1)]


def _pair(domains=False, steps=60, seed=0):
    """The same timeline built by the port and by the reference."""
    return (synthesize(_costs(RegionCost), steps=steps, seed=seed,
                       domains=domains),
            rtimeline.synthesize(_costs(rtimeline.RegionCost), steps=steps,
                                 seed=seed, domains=domains))


def _specs(sensor, domains):
    return (getattr(sensors, _SPEC[sensor]).make_spec(domains=domains),
            getattr(rsensors, _SPEC[sensor]).make_spec(domains=domains))


def _assert_result_close(got, want, rtol=1e-9):
    assert got.n == want.n
    assert got.t_exec == want.t_exec
    assert got.domains == want.domains
    np.testing.assert_array_equal(got.counts, want.counts)
    for f in ("psum", "psumsq", "rail_psum", "rail_psumsq"):
        np.testing.assert_allclose(getattr(got, f), getattr(want, f),
                                   rtol=rtol)


# ---------------------------------------------------------------------------
# The sample clock is JAX's, bit for bit.
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("seed,k,c", [(0, 0, 1024), (3, 7, 4096),
                                      (11, 0, 65536), (2 ** 33 + 5, 2, 777),
                                      (1, 40000, 65536),
                                      (5, 2 ** 24, 65536)])
def test_chunk_sample_times_bit_equal_to_jax(seed, k, c):
    """Large k puts t·1e9 near 2^53, where the reference's fused
    multiply-adds change a sizeable share of the quantized times."""
    period, jitter = 1e-3, 2e-4
    got = dp.chunk_sample_times(threefry.PRNGKey(seed), k, period, jitter,
                                chunk_size=c, device="cpu").numpy()
    with jax.enable_x64(True):
        want = np.asarray(rdp.chunk_sample_times(
            jax.random.PRNGKey(seed), jnp.int32(k), jnp.float64(period),
            jnp.float64(jitter), chunk_size=c))
    assert got.dtype == want.dtype == np.float64
    np.testing.assert_array_equal(got.view(np.int64), want.view(np.int64))


@pytest.mark.parametrize("seed", [0, 7, 2 ** 40 + 3])
def test_threefry_primitives_bit_equal_to_jax(seed):
    with jax.enable_x64(True):
        root = jax.random.PRNGKey(seed)
        assert tuple(int(v) for v in root) == threefry.PRNGKey(seed)
        for data in (0, 1, 9, 2 ** 31 + 1):
            key = jax.random.fold_in(root, data)
            mine = threefry.fold_in(threefry.PRNGKey(seed), data)
            assert tuple(int(v) for v in key) == mine
            want = np.asarray(jax.random.uniform(key, (333,), jnp.float64,
                                                 0.0, 5e-3))
            got = threefry.uniform(mine, 333, 0.0, 5e-3, device="cpu")
            np.testing.assert_array_equal(got.numpy().view(np.int64),
                                          want.view(np.int64))
            assert threefry.uniform_scalar(mine, 0.0, 0.01) == float(
                jax.random.uniform(key, (), jnp.float64, 0.0, 0.01))


def test_chunk_sample_times_default_to_the_gpu():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present; the default device is usable")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        dp.chunk_sample_times(threefry.PRNGKey(0), 0, 1e-3, 1e-4,
                              chunk_size=16)


# ---------------------------------------------------------------------------
# The substrate is the reference's, array for array.
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("case", ["d1", "d3", "ragged_w2"])
def test_device_timeline_arrays_equal_reference(case):
    if case == "ragged_w2":
        pairs = [_pair(steps=60, seed=0), _pair(steps=45, seed=1)]
    else:
        pairs = [_pair(domains=case == "d3")]
    got = dp.DeviceTimeline.from_timelines([p for p, _ in pairs],
                                           device="cpu")
    with _reference_x64():
        ref = rdp.DeviceTimeline.from_timelines([r for _, r in pairs])
    want = tree_to_torch([np.asarray(a) for a in ref.arrays()], "cpu")
    for g, w in zip(got.arrays(), want):
        assert g.dtype == w.dtype and g.shape == w.shape
        assert torch.equal(g, w)
    assert (got.grid_k, got.t_end, got.num_regions, got.names,
            got.domains) == (ref.grid_k, ref.t_end, ref.num_regions,
                             ref.names, ref.domains)


def test_tree_to_torch_keeps_structure_and_dtypes():
    @dataclasses.dataclass(frozen=True)
    class Carry:
        counts: np.ndarray
        n: np.integer
        note: str

    tree = {"a": [np.arange(3, dtype=np.int32), (np.zeros(2),)],
            "c": Carry(np.ones(4, np.int64), np.int64(7), "x"), "k": 5}
    out = tree_to_torch(tree, "cpu")
    assert out["a"][0].dtype == torch.int32
    assert isinstance(out["a"][1], tuple)
    assert out["a"][1][0].dtype == torch.float64
    assert isinstance(out["c"], Carry) and out["c"].note == "x"
    assert out["c"].counts.dtype == torch.int64
    assert out["c"].n.shape == () and int(out["c"].n) == 7
    assert out["k"] == 5


# ---------------------------------------------------------------------------
# Region pipeline ≡ the reference's device run and numpy oracle.
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("domains", [False, True], ids=["d1", "d3"])
@pytest.mark.parametrize("sensor", _SENSORS)
def test_region_pipeline_matches_reference(sensor, domains):
    tl, rtl = _pair(domains=domains)
    spec, rspec = _specs(sensor, tl.domain_names)
    kw = dict(period=10e-3, jitter=200e-6, seed=3, chunk_size=1024)
    got = dp.run_region_pipeline(tl.to_device(device="cpu"), spec, **kw)
    with _reference_x64():
        want = rdp.run_region_pipeline(rtl.to_device(), rspec, **kw)
    _assert_result_close(got, want)
    oracle = dp.reference_region_pipeline(tl, spec, **kw)
    _assert_result_close(got, oracle)
    _assert_result_close(oracle, rdp.reference_region_pipeline(
        rtl, rspec, **kw), rtol=0.0)


@pytest.mark.parametrize("domains", [False, True], ids=["d1", "d3"])
def test_region_pipeline_overhead_blending_matches_reference(domains):
    tl, rtl = _pair(domains=domains)
    spec, rspec = _specs("instant", tl.domain_names)
    kw = dict(period=5e-3, jitter=100e-6, seed=9, chunk_size=512,
              overhead_per_sample=1e-3, idle_power=55.0)
    got = dp.run_region_pipeline(tl.to_device(device="cpu"), spec, **kw)
    with _reference_x64():
        want = rdp.run_region_pipeline(rtl.to_device(), rspec, **kw)
    _assert_result_close(got, want)
    _assert_result_close(got, dp.reference_region_pipeline(tl, spec, **kw))


def test_region_pipeline_heavy_tail_search_route_matches_reference():
    """One long interval among many short ones overflows the grid window
    (grid_k = 0): lookups take the binary search, still exact."""
    rng = np.random.default_rng(4)
    n = 4000
    durs = np.concatenate([[2.0], rng.uniform(1e-6, 2e-6, n - 1)])
    ids = rng.integers(0, 5, n).astype(np.int32)
    pows = 100.0 + 50.0 * rng.random(n)
    names = tuple(f"r{i}" for i in range(5))
    tl = Timeline(ids, durs, pows, names)
    rtl = rtimeline.Timeline(ids, durs, pows, names)
    dtl = tl.to_device(device="cpu")
    assert dtl.grid_k == 0
    spec, rspec = _specs("rapl", tl.domain_names)
    kw = dict(period=1e-3, jitter=1e-4, seed=5, chunk_size=1024)
    got = dp.run_region_pipeline(dtl, spec, **kw)
    with _reference_x64():
        want = rdp.run_region_pipeline(rtl.to_device(), rspec, **kw)
    _assert_result_close(got, want)


def test_region_pipeline_deterministic_and_chunk_grid_keyed():
    """Statistics are a pure function of (seed, chunk grid): identical
    across runs at the same chunk size (rtol=0)."""
    tl, _ = _pair()
    spec = sensors.RaplTraceSensor.make_spec()
    runs = [dp.run_region_pipeline(tl.to_device(device="cpu"), spec,
                                   period=10e-3, seed=1, chunk_size=768)
            for _ in range(2)]
    _assert_result_close(runs[0], runs[1], rtol=0.0)
    other = dp.run_region_pipeline(tl.to_device(device="cpu"), spec,
                                   period=10e-3, seed=1, chunk_size=2048)
    assert other.n == pytest.approx(runs[0].n, rel=0.02)


def test_region_pipeline_validates_args():
    tl, _ = _pair()
    dtl = tl.to_device(device="cpu")
    with pytest.raises(ValueError):   # period below sensor minimum
        dp.run_region_pipeline(
            dtl, sensors.Ina231TraceSensor.make_spec(window=280e-6),
            period=100e-6)
    with pytest.raises(ValueError):   # jitter > period: non-monotone clock
        dp.run_region_pipeline(dtl, sensors.InstantTraceSensor.make_spec(),
                               period=1e-3, jitter=5e-3)
    with pytest.raises(ValueError):   # multi-worker is the combo pipeline
        dp.run_region_pipeline(
            dp.DeviceTimeline.from_timelines([tl, tl], device="cpu"),
            sensors.InstantTraceSensor.make_spec(), period=1e-3)
    with pytest.raises(ValueError):   # rail count mismatch
        dp.run_region_pipeline(
            dtl, sensors.InstantTraceSensor.make_spec(
                domains=("package", "hbm", "ici")), period=1e-3)
