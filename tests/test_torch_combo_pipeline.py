"""Port parity: repro_torch's multi-worker combination pipeline (run on
the CPU) against the JAX reference's — the W-batched chunk step, the
packed-key table and its search, the miss path through the host
interner, bounded admission, and the numpy oracle."""

import contextlib
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode


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
from repro.core import streaming as rstreaming  # noqa: E402
from repro.core import timeline as rtimeline  # noqa: E402
from repro_torch.core import device_pipeline as dp  # noqa: E402
from repro_torch.core import sensors, threefry  # noqa: E402
from repro_torch.core.faults import SketchConfigError  # noqa: E402
from repro_torch.core.streaming import CombinationInterner  # noqa: E402
from repro_torch.core.timeline import (RegionCost, Timeline,  # noqa: E402
                                       synthesize)

_SENSORS = ("instant", "rapl", "ina231")
_SPEC = {"instant": "InstantTraceSensor", "rapl": "RaplTraceSensor",
         "ina231": "Ina231TraceSensor"}
_INT64_MAX = np.iinfo(np.int64).max


def _costs(cls):
    # The timelines of tests/test_device_pipeline.py.
    return [cls("mem", flops=1e10, hbm_bytes=5e10, invocations=4),
            cls("alu", flops=6e11, hbm_bytes=2e9, invocations=4),
            cls("opt", flops=2e10, hbm_bytes=4e10, invocations=1)]


def _workers(w, steps=60, domains=False):
    """W workers (seeds 0..W-1) built by the port and by the reference."""
    return ([synthesize(_costs(RegionCost), steps=steps, seed=s,
                        domains=domains) for s in range(w)],
            [rtimeline.synthesize(_costs(rtimeline.RegionCost), steps=steps,
                                  seed=s, domains=domains)
             for s in range(w)])


def _specs(sensor, domains):
    return (getattr(sensors, _SPEC[sensor]).make_spec(domains=domains),
            getattr(rsensors, _SPEC[sensor]).make_spec(domains=domains))


def _dtl(tls):
    return dp.DeviceTimeline.from_timelines(tls, device="cpu")


def _assert_agg_close(got, want, rtol=1e-9):
    """Same combinations in the same order, equal counts, sums to rtol
    (every channel, and the scalar totals)."""
    assert got.interner.combos == want.interner.combos
    g, w = got.agg, want.agg
    np.testing.assert_array_equal(g.counts, w.counts)
    for a, b in ((g.psum, w.psum), (g.psumsq, w.psumsq)):
        np.testing.assert_allclose(a, b, rtol=rtol)
    for a, b in zip(g.channel_statistics()[1:], w.channel_statistics()[1:]):
        np.testing.assert_allclose(a, b, rtol=rtol)


def _assert_agg_equal(got, want):
    assert got.interner.combos == want.interner.combos
    for a, b in zip(got.agg.channel_statistics(),
                    want.agg.channel_statistics()):
        np.testing.assert_array_equal(a, b)


# ---------------------------------------------------------------------------
# run_combo_pipeline ≡ the reference's device run and both numpy oracles.
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("domains", [False, True], ids=["d1", "d3"])
@pytest.mark.parametrize("sensor", _SENSORS)
@pytest.mark.parametrize("w", [1, 4])
def test_combo_pipeline_matches_reference(w, sensor, domains):
    tls, rtls = _workers(w, domains=domains)
    spec, rspec = _specs(sensor, tls[0].domain_names)
    kw = dict(period=10e-3, jitter=200e-6, seed=7, chunk_size=512)
    stats = {}
    agg, n = dp.run_combo_pipeline(_dtl(tls), spec, stats=stats, **kw)
    with _reference_x64():
        ragg, rn = rdp.run_combo_pipeline(
            rdp.DeviceTimeline.from_timelines(rtls), rspec, **kw)
    assert n == rn
    _assert_agg_close(agg, ragg)
    oracle, on = dp.reference_combo_pipeline(tls, lambda tl: spec, **kw)
    assert on == n
    _assert_agg_close(agg, oracle)
    roracle, _ = rdp.reference_combo_pipeline(rtls, lambda tl: rspec, **kw)
    _assert_agg_close(oracle, roracle, rtol=0.0)
    assert stats["chunks"] == dp.num_chunks(min(t.t_exec for t in tls),
                                            10e-3, 512)
    assert 1 <= stats["miss_chunks"] <= stats["chunks"]


def _multiword_workers(mod, w=8, R=300, m=50):
    """W·bits > 62 forces the multi-word packed-key path: R=300 (9 bits)
    across W=8 workers packs to 2 int64 words a row. Phase-shifted copies
    of one tiled structure, built as in tests/test_device_pipeline.py."""
    rng = np.random.default_rng(23)
    names = tuple(f"bb_{i}" for i in range(R))
    base = mod.Timeline(rng.integers(0, R, m).astype(np.int32),
                        rng.uniform(5e-3, 15e-3, m),
                        50.0 + 150.0 * rng.random(m), names).tile(8)
    return [mod.Timeline(
        np.concatenate([[base.region_ids[0]], base.region_ids]),
        np.concatenate([[i * 2e-4 + 1e-9], base.durations]),
        np.concatenate([[base.powers[0]], base.powers]), names)
        for i in range(w)]


def test_combo_pipeline_multiword_keys_match_reference():
    from repro_torch.core import timeline as ptimeline
    tls = _multiword_workers(ptimeline)
    rtls = _multiword_workers(rtimeline)
    assert dp._pack_spec(300, 8)[2] >= 2
    spec, rspec = _specs("rapl", ("total",))
    kw = dict(period=2e-3, jitter=100e-6, seed=5, chunk_size=256)
    stats = {}
    agg, n = dp.run_combo_pipeline(_dtl(tls), spec, stats=stats, **kw)
    assert stats["miss_chunks"] < stats["chunks"]   # table folds happened
    with _reference_x64():
        ragg, rn = rdp.run_combo_pipeline(
            rdp.DeviceTimeline.from_timelines(rtls), rspec, **kw)
    assert n == rn
    _assert_agg_close(agg, ragg)
    oracle, _ = dp.reference_combo_pipeline(tls, lambda tl: spec, **kw)
    _assert_agg_close(agg, oracle)


def test_combo_pipeline_steady_state_stops_missing():
    """Once the table holds every combination, chunks fold through the
    table: misses stop long before the run does."""
    tls, _ = _workers(2, steps=120)
    stats = {}
    agg, n = dp.run_combo_pipeline(
        _dtl(tls), sensors.InstantTraceSensor.make_spec(), period=5e-3,
        seed=0, chunk_size=256, stats=stats)
    assert n > 0
    assert stats["chunks"] >= 10
    assert stats["miss_chunks"] < stats["chunks"] / 2
    assert stats["miss_chunks"] <= len(agg.interner)


def test_combo_pipeline_is_deterministic():
    tls, _ = _workers(4, domains=True)
    spec = sensors.RaplTraceSensor.make_spec(domains=tls[0].domain_names)
    kw = dict(period=10e-3, seed=3, chunk_size=384)
    a, na = dp.run_combo_pipeline(_dtl(tls), spec, **kw)
    b, nb = dp.run_combo_pipeline(_dtl(tls), spec, **kw)
    assert na == nb
    _assert_agg_equal(a, b)


# ---------------------------------------------------------------------------
# Bounded admission (heavy-hitters tier) ≡ the reference's.
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("share", [3, 1])
def test_combo_pipeline_bounded_matches_reference(share):
    """``share`` = 3: k = distinct // 3 folds a tail; 1: k = distinct
    admits everything and equals the unbounded run."""
    tls, rtls = _workers(3)
    spec, rspec = _specs("instant", ("total",))
    kw = dict(period=10e-3, jitter=200e-6, seed=7, chunk_size=512)
    exact, n0 = dp.run_combo_pipeline(_dtl(tls), spec, **kw)
    k = max(2, len(exact.interner) // share)
    stats = {}
    got, n = dp.run_combo_pipeline(_dtl(tls), spec, max_combinations=k,
                                   stats=stats, **kw)
    with _reference_x64():
        rstats = {}
        want, rn = rdp.run_combo_pipeline(
            rdp.DeviceTimeline.from_timelines(rtls), rspec,
            max_combinations=k, stats=rstats, **kw)
    assert n == rn == n0
    assert stats.pop("miss_seconds") > 0.0
    assert stats == rstats
    assert got.tail_folds == want.tail_folds == stats["tail_folds"]
    assert got.resident == want.resident <= k
    assert len(got.interner) <= k + len(tls[0].names)
    _assert_agg_close(got, want)
    region_counts = np.bincount(
        np.asarray(got.interner.combos)[:, 0], weights=got.agg.counts,
        minlength=3)
    exact_counts = np.bincount(
        np.asarray(exact.interner.combos)[:, 0], weights=exact.agg.counts,
        minlength=3)
    np.testing.assert_array_equal(region_counts, exact_counts)
    if share == 1:
        assert stats["tail_folds"] == 0
        _assert_agg_equal(got, exact)
    else:
        assert stats["tail_folds"] > 0


def test_combo_pipeline_validates_args():
    tls, _ = _workers(2)
    dtl = _dtl(tls)
    inst = sensors.InstantTraceSensor.make_spec()
    with pytest.raises(ValueError, match="max_combinations"):
        dp.run_combo_pipeline(dtl, inst, period=1e-2, max_combinations=0)
    with pytest.raises(SketchConfigError):
        dp.run_combo_pipeline(_dtl(tls[:1]), inst, period=1e-2,
                              max_combinations=4)
    blip = Timeline(np.array([0]), np.array([1e-9]), np.array([50.0]),
                    ("a",))
    with pytest.raises(ValueError, match="too short"):
        dp.run_combo_pipeline(_dtl([blip, blip]), inst, period=1e-2)
    with pytest.raises(ValueError):   # period below the sensor minimum
        dp.run_combo_pipeline(
            dtl, sensors.Ina231TraceSensor.make_spec(window=280e-6),
            period=100e-6)
    with pytest.raises(ValueError):   # jitter > period
        dp.run_combo_pipeline(dtl, inst, period=1e-3, jitter=5e-3)
    with pytest.raises(ValueError):   # rail count mismatch
        dp.run_combo_pipeline(
            dtl, sensors.InstantTraceSensor.make_spec(
                domains=("package", "hbm", "ici")), period=1e-3)


# ---------------------------------------------------------------------------
# Packed keys, the table and its search ≡ the reference's.
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("R,W", [(3, 4), (300, 8), (4096, 16), (2, 70)])
def test_pack_rows_match_reference(R, W):
    pack = dp._pack_spec(R, W)
    assert pack == rdp._pack_spec(R, W)
    mat = np.random.default_rng(R + W).integers(0, R, (500, W))
    want = rdp._pack_rows_np(mat, pack)
    np.testing.assert_array_equal(dp._pack_rows_np(mat, pack), want)
    got = dp._pack_rows(torch.from_numpy(mat.T.astype(np.int32)), pack)
    assert got.dtype == torch.int64 and got.is_contiguous()
    np.testing.assert_array_equal(got.numpy(), want)
    with jax.enable_x64(True):
        ref = np.asarray(rdp._pack_rows(jnp.asarray(mat.T, jnp.int32), pack))
    np.testing.assert_array_equal(ref, want)
    assert want.max() < 2 ** 62


@pytest.mark.parametrize("words,n_rows,cap", [(1, 40, 64), (2, 100, 128),
                                              (4, 1000, 1024), (3, 0, 64),
                                              (4, 64, 64)])
def test_lex_search_matches_reference(words, n_rows, cap):
    """Random sorted tables padded with int64-max; queries half present,
    half absent (between, below and above the table's keys)."""
    rng = np.random.default_rng(words * 1000 + n_rows)
    keys = np.unique(rng.integers(0, 50, (3 * n_rows + 1, words)), axis=0)
    keys = keys[rng.permutation(len(keys))[:n_rows]]
    keys = keys[np.lexsort(keys.T[::-1])]
    table = np.full((cap, words), _INT64_MAX, np.int64)
    table[:len(keys)] = keys
    probe = rng.integers(0, 52, (300, words))
    if len(keys):
        probe[::2] = keys[rng.integers(0, len(keys), 150)]
    pos, found = dp._lex_search(torch.from_numpy(table), len(keys),
                                torch.from_numpy(probe))
    with jax.enable_x64(True):
        rpos, rfound = rdp._lex_search(jnp.asarray(table),
                                       jnp.int32(len(keys)),
                                       jnp.asarray(probe))
    np.testing.assert_array_equal(pos.numpy(), np.asarray(rpos))
    np.testing.assert_array_equal(found.numpy(), np.asarray(rfound))
    want = {tuple(r) for r in keys}
    assert found.numpy().tolist() == [tuple(r) in want for r in probe]
    less = dp._lex_less(torch.from_numpy(probe[:-1]),
                        torch.from_numpy(probe[1:]),
                        dp._word_weights(words, "cpu")).numpy()
    with jax.enable_x64(True):
        rless = np.asarray(rdp._lex_less(jnp.asarray(probe[:-1]),
                                         jnp.asarray(probe[1:])))
    np.testing.assert_array_equal(less, rless)


def test_build_table_matches_reference():
    rows = np.random.default_rng(2).integers(0, 300, (90, 8))
    pack = dp._pack_spec(300, 8)
    interner = CombinationInterner()
    interner.encode(rows)
    rinterner = rstreaming.CombinationInterner()
    rinterner.encode(rows)
    table = dp._build_table(interner, 128, pack, "cpu")
    with _reference_x64(), jax.enable_x64(True):
        rtable, rids, rn = rdp._build_table(rinterner, 128, 8, pack)
        rtable, rids, rn = np.asarray(rtable), np.asarray(rids), int(rn)
    assert table.n_rows == rn == len(interner)
    assert table.ids.dtype == torch.int32
    np.testing.assert_array_equal(table.keys.numpy(), rtable)
    np.testing.assert_array_equal(table.ids.numpy(), rids)
    assert (table.keys.numpy()[rn:] == _INT64_MAX).all()
    # Every interned row is found at its interner id; new rows are not.
    got, found = table.lookup(torch.from_numpy(rows.T.astype(np.int32)))
    assert bool(found.all())
    np.testing.assert_array_equal(got.numpy(), interner.encode(rows))
    _, found = table.lookup(torch.from_numpy(
        (rows[:5].T + 1).astype(np.int32) % 300))
    assert found.numpy().tolist() == [
        interner.find_row((r + 1) % 300) is not None for r in rows[:5]]
    assert dp._table_cap(1) == dp._table_cap(64) == 64
    assert dp._table_cap(65) == 128 and dp._table_cap(65536) == 65536


# ---------------------------------------------------------------------------
# The W-batched chunk step.
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("domains", [False, True], ids=["d1", "d3"])
@pytest.mark.parametrize("sensor", _SENSORS)
def test_batched_chunk_rows_equal_single_worker_chunks(sensor, domains):
    """Each worker's row of the batched step is bitwise the single-worker
    step of that worker (ragged lengths included), and the batched
    channels are the worker sum."""
    tls, _ = _workers(3, domains=domains)
    tls[1] = synthesize(_costs(RegionCost), steps=45, seed=9,
                        domains=domains)
    spec, _ = _specs(sensor, tls[0].domain_names)
    root = threefry.PRNGKey(4)
    period = 10e-3
    u0 = dp._phase(root, period)
    prev = torch.full((), -1.0, dtype=torch.float64)
    batched = _dtl(tls)
    arrs = batched.arrays()
    t_raw = dp._raw_chunk_times(root, u0, 2, 512, period, 2e-4, "cpu")
    valid = t_raw < batched.t_end
    t = torch.clamp_max(t_raw, batched.t_end)
    cnt = dp._count_le(arrs[0], arrs[6], arrs[7], t, batched.grid_k)
    pows, _ = dp._sensor_powers(spec, arrs, t, cnt, valid, prev,
                                batched.grid_k)
    rid_mat, chan, _, _ = dp._chunk_samples(batched, spec, root, u0, 2, 512,
                                            period, 2e-4, prev)
    for w, tl in enumerate(tls):
        one = _dtl([tl])
        oa = one.arrays()
        ocnt = dp._count_le(oa[0], oa[6], oa[7], t, one.grid_k)
        assert torch.equal(ocnt[0], cnt[w])
        opows, _ = dp._sensor_powers(spec, oa, t, ocnt, valid, prev,
                                     one.grid_k)
        assert torch.equal(opows[0], pows[w])
        np.testing.assert_array_equal(
            rid_mat[w].numpy()[valid.numpy()],
            tl.region_at(t.numpy())[valid.numpy()])
    total = pows.sum(dim=0)
    if total.ndim == 2:
        total = torch.cat([total, total.sum(dim=0, keepdim=True)])
    assert torch.equal(chan, total)


class _CountOps(TorchDispatchMode):
    """Counts the torch operations that compute something (views and
    reshapes excluded): on the GPU each one is a kernel launch."""

    _VIEWS = {"alias", "as_strided", "detach", "expand", "permute",
              "reshape", "select", "slice", "squeeze", "t", "transpose",
              "unbind", "unsqueeze", "view", "_unsafe_view"}

    def __init__(self):
        super().__init__()
        self.n = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if func.__name__.split(".")[0] not in self._VIEWS:
            self.n += 1
        return func(*args, **(kwargs or {}))


def _chunk_ops(tls, sensor):
    dtl = _dtl(tls)
    spec, _ = _specs(sensor, tls[0].domain_names)
    root = threefry.PRNGKey(3)
    u0 = dp._phase(root, 10e-3)
    prev = torch.full((), -1.0, dtype=torch.float64)
    with _CountOps() as c:
        dp._chunk_samples(dtl, spec, root, u0, 1, 1024, 10e-3, 2e-4, prev)
    return c.n


@pytest.mark.parametrize("domains", [False, True], ids=["d1", "d3"])
@pytest.mark.parametrize("sensor", _SENSORS)
def test_chunk_operations_do_not_grow_with_workers(sensor, domains):
    """No Python loop over workers: W=4 issues the W=1 step's operations
    plus the one sum over workers."""
    tls, _ = _workers(4, domains=domains)
    assert _chunk_ops(tls, sensor) == _chunk_ops(tls[:1], sensor) + 1


@pytest.mark.parametrize("domains", [False, True], ids=["d1", "d3"])
@pytest.mark.parametrize("sensor", _SENSORS)
def test_w1_combo_pipeline_bit_equal_to_region_pipeline(sensor, domains):
    """At W=1 every combination is one region: the combination statistics,
    reordered by region, are the region pipeline's bit for bit (the same
    chunk step, folded in the same lane order)."""
    (tl,), _ = _workers(1, domains=domains)
    spec, _ = _specs(sensor, tl.domain_names)
    kw = dict(period=10e-3, jitter=200e-6, seed=2, chunk_size=512)
    agg, n = dp.run_combo_pipeline(_dtl([tl]), spec, **kw)
    res = dp.run_region_pipeline(_dtl([tl]), spec, **kw)
    assert n == res.n
    order = np.asarray(agg.interner.combos)[:, 0]
    counts, psum, psumsq = agg.agg.channel_statistics()
    np.testing.assert_array_equal(counts, res.counts[order])
    chan_psum = (res.psum if res.rail_psum.shape[1] == 1 else
                 np.concatenate([res.rail_psum, res.psum[:, None]], axis=1))
    chan_psumsq = (res.psumsq if res.rail_psumsq.shape[1] == 1 else
                   np.concatenate([res.rail_psumsq, res.psumsq[:, None]],
                                  axis=1))
    np.testing.assert_array_equal(psum.reshape(chan_psum[order].shape),
                                  chan_psum[order])
    np.testing.assert_array_equal(psumsq.reshape(chan_psumsq[order].shape),
                                  chan_psumsq[order])
