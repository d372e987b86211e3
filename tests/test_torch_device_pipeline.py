"""Port parity: repro_torch's device pipeline (run on the CPU) against the
JAX reference — the sample clock bit for bit, the timeline substrate
array for array, and the region pipeline's statistics for every sensor
at D=1 and D=3. The clock's CUDA kernel: its C signature, its host-side
arguments and its arithmetic (emulated here) against the CPU route, the
CPU route never loading it, and, on a machine with a GPU, its times
against the CPU's bit for bit."""

import contextlib
import ctypes
import dataclasses
import math
import re
import struct
import sys
from fractions import Fraction
from pathlib import Path

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
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels.count_le import ops as count_le_ops  # noqa: E402
from repro_torch.kernels.count_le.ref import count_le_ref  # noqa: E402
from repro_torch.kernels.sample_clock import ops as clock_ops  # noqa: E402
from repro_torch.kernels.sample_clock.ref import (  # noqa: E402
    sample_clock_ref)
from _torch_count_le_cases import lookup_case  # noqa: E402

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
# The sample_clock kernel: one launch a chunk on a CUDA device, the CPU's
# torch operations bit for bit.
# ---------------------------------------------------------------------------

_MASK32 = 0xFFFFFFFF
# (seed, k, c, jitter): the cases above, a lane count that is no multiple
# of the kernel's block, k·c past 2^32, and no jitter.
_KERNEL_CASES = [(0, 0, 1024, 2e-4), (3, 7, 4096, 2e-4), (11, 0, 65536, 2e-4),
                 (2 ** 33 + 5, 2, 777, 2e-4), (1, 40000, 65536, 2e-4),
                 (5, 2 ** 24, 65536, 2e-4), (9, 70000, 65613, 2e-4),
                 (4, 3, 1000, 0.0), (2 ** 40 + 3, 2 ** 24, 65536, 0.0)]


def _fma_exact(a: float, b: float, c: float) -> float:
    """``a·b + c`` rounded once: exact rationals, then Python's correctly
    rounded int division."""
    return float(Fraction(a) * Fraction(b) + Fraction(c))


def _threefry_u32(k0, k1, x0, x1):
    """Threefry-2x32 as ``sample_clock.cu`` writes it: uint32 words whose
    sums wrap, the key schedule in an array, ``i + 1`` added to the
    second word after every four rounds."""
    def add(*words):
        return sum(words) & _MASK32

    ks = (k0, k1, k0 ^ k1 ^ 0x1BD11BDA)
    rot = ((13, 15, 26, 6), (17, 29, 16, 24))
    x0, x1 = add(x0, ks[0]), add(x1, ks[1])
    for i in range(5):
        for r in rot[i % 2]:
            x0 = add(x0, x1)
            x1 = (((x1 << r) & _MASK32) | (x1 >> (32 - r))) ^ x0
        x0 = add(x0, ks[(i + 1) % 3])
        x1 = add(x1, ks[(i + 2) % 3], i + 1)
    return x0, x1


def _kernel_lane(args, i: int):
    """Lane ``i`` of ``sc_clock`` on the wrapper's arguments, step by step
    as the kernel rounds: (raw time, fused valid, fused time)."""
    k0, k1, base, c, period, u0, lo, span, t_end = args
    b1, b2 = _threefry_u32(k0, k1, i >> 32, i & _MASK32)
    m = (b1 << 20) | (b2 >> 12)
    f = struct.unpack("<d", struct.pack("<Q", m | 0x3FF0000000000000))[0]
    f = f - 1.0
    u = f * span + lo
    u = lo if u < lo else u
    s = _fma_exact(float(base + i), period, u0) + u
    q = math.floor(_fma_exact(s, 1e9, 0.5)) * 1e-9
    return q, q < t_end, (t_end if q > t_end else q)


def _bits(x: float) -> int:
    return struct.unpack("<q", struct.pack("<d", x))[0]


@pytest.mark.parametrize("seed,k,c,jitter", _KERNEL_CASES)
def test_kernel_arithmetic_equals_the_cpu_route(seed, k, c, jitter):
    """The kernel's lane arithmetic on the wrapper's own arguments, emulated
    with uint32 words and exact fused multiply-adds, gives the CPU route's
    times bit for bit, raw and with the fused tail, on the first, last and
    scattered lanes."""
    root = threefry.PRNGKey(seed)
    period = 1e-3
    u0 = dp._phase(root, period)
    raw = sample_clock_ref(root, k, c, period, u0, jitter, device="cpu")
    t_end = float(raw.median())
    t, valid = sample_clock_ref(root, k, c, period, u0, jitter, t_end,
                                device="cpu")
    args = clock_ops.clock_args(root, k, c, period, u0, jitter, t_end)
    rng = np.random.default_rng(seed % 2 ** 32)
    lanes = sorted({*range(min(c, 48)), *range(max(c - 48, 0), c),
                    *rng.integers(0, c, 64).tolist()})
    for i in lanes:
        q, v, tq = _kernel_lane(args, i)
        assert _bits(q) == raw[i].view(torch.int64).item(), i
        assert v == bool(valid[i]) and _bits(tq) == t[i].view(
            torch.int64).item(), i


@pytest.mark.parametrize("seed,k,c", [(0, 0, 1024), (2 ** 33 + 5, 2, 777),
                                      (5, 2 ** 24, 65536),
                                      (7, 2 ** 31 - 2, 65536)])
def test_clock_args_match_fold_in_and_the_int64_index(seed, k, c):
    """The key words are JAX's ``fold_in(PRNGKey(seed), k + 1)``, lane 0's
    index is ``k·c`` split into int64 words without a wrap, the jitter
    draw is ``uniform(key, c, 0.0, jitter)``'s offset and width, and
    every argument reaches C unchanged through its declared type."""
    root = threefry.PRNGKey(seed)
    args = clock_ops.clock_args(root, k, c, 1e-3, 3.25e-4, 2e-4)
    with jax.enable_x64(True):
        key = jax.random.fold_in(jax.random.PRNGKey(seed), k + 1)
        assert args[:2] == tuple(int(v) for v in key)
    assert args[:2] == threefry.fold_in(root, k + 1)
    base = args[2]
    assert base == k * c and (base >> 32, base & _MASK32) == divmod(
        k * c, 2 ** 32)
    assert args[3:] == (c, 1e-3, 3.25e-4, 0.0, 2e-4, math.inf)
    assert clock_ops.clock_args(root, k, c, 1e-3, 0.0, 2e-4, 5.0)[-1] == 5.0
    for t, v in zip(clock_ops._ARGTYPES, args):
        assert t(v).value == v


def test_clock_args_refuse_indices_past_int64():
    with pytest.raises(ValueError, match="int64"):
        clock_ops.clock_args((0, 0), 2 ** 47, 2 ** 16, 1e-3, 0.0, 0.0)
    with pytest.raises(ValueError, match="int64"):
        clock_ops.clock_args((0, 0), -1, 16, 1e-3, 0.0, 0.0)


def test_clock_c_signature_matches_declared_argtypes():
    """ctypes passes arguments by the declared types alone: a mismatch with
    the C signature would corrupt the call silently."""
    src = Path(clock_ops.__file__).with_name("sample_clock.cu").read_text()
    m = re.search(r"int sample_clock\(([^)]*)\)", src)
    scalars = {"int": ctypes.c_int, "int64_t": ctypes.c_int64,
               "uint32_t": ctypes.c_uint32, "double": ctypes.c_double}
    got = tuple(ctypes.c_void_p if "*" in p else
                scalars[" ".join(p.split()).rsplit(" ", 1)[0]]
                for p in m.group(1).split(","))
    assert got == clock_ops._ARGTYPES


@pytest.mark.parametrize("path", ["region", "combo"])
def test_cpu_pipelines_never_load_the_clock_library(monkeypatch, path):
    """On CPU tensors the pipelines run the clock's torch operations: the
    kernel library is never built or loaded, and nothing is launched."""
    real = _build.load

    def refuse(name):
        if name == "sample_clock":
            raise AssertionError("the CPU route loaded sample_clock")
        return real(name)

    monkeypatch.setattr(_build, "load", refuse)
    clock_ops._kernel.cache_clear()
    before = clock_ops.sample_clock.launches
    tl, _ = _pair(steps=20)
    kw = dict(period=10e-3, jitter=200e-6, seed=3, chunk_size=512)
    if path == "region":
        dtl = tl.to_device(device="cpu")
        got = dp.run_region_pipeline(
            dtl, sensors.RaplTraceSensor.make_spec(), **kw)
        assert got.n > 0
    else:
        other, _ = _pair(steps=20, seed=1)
        dtl = dp.DeviceTimeline.from_timelines([tl, other], device="cpu")
        _, n = dp.run_combo_pipeline(
            dtl, sensors.RaplTraceSensor.make_spec(), **kw)
        assert n > 0
    assert clock_ops.sample_clock.launches == before
    assert clock_ops._kernel.cache_info().currsize == 0


def test_sample_clock_refuses_other_devices():
    with pytest.raises(ValueError, match="unsupported device"):
        clock_ops.sample_clock((0, 0), 0, 16, 1e-3, 0.0, 1e-4,
                               device="meta")


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("the sample_clock kernel runs only on a CUDA device")
    return torch.device("cuda")


@pytest.mark.parametrize("seed,k,c,jitter", _KERNEL_CASES)
def test_sample_clock_kernel_bit_equal_to_cpu(cuda_device, seed, k, c,
                                              jitter):
    """The kernel's times against the CPU route's, compared as int64 bits,
    raw and with the fused tail; the tail also against the torch
    expressions on the kernel's raw times. One launch a call."""
    period = 1e-3
    root = threefry.PRNGKey(seed)
    u0 = dp._phase(root, period)
    want = dp._raw_chunk_times(root, u0, k, c, period, jitter, "cpu")
    before = clock_ops.sample_clock.launches
    got = dp._raw_chunk_times(root, u0, k, c, period, jitter, cuda_device)
    assert torch.equal(got.cpu().view(torch.int64), want.view(torch.int64))
    t_end = float(want.median())
    wt, wv = dp._raw_chunk_times(root, u0, k, c, period, jitter, "cpu",
                                 t_end)
    gt, gv = dp._raw_chunk_times(root, u0, k, c, period, jitter,
                                 cuda_device, t_end)
    assert clock_ops.sample_clock.launches - before == 2
    assert torch.equal(gt.cpu().view(torch.int64), wt.view(torch.int64))
    assert torch.equal(gv.cpu(), wv)
    assert torch.equal(gv, got < t_end)
    assert torch.equal(gt, torch.clamp_max(got, t_end))


# ---------------------------------------------------------------------------
# The interval lookup: the grid route's torch operations (count_le's ref.py)
# are searchsorted(side="right"); on the CPU _count_le runs them unchanged.
# ---------------------------------------------------------------------------

def _searchsorted(dtl, t):
    W = dtl.num_workers
    return torch.searchsorted(dtl.ends, t.expand(W, -1).contiguous(),
                              right=True)


@pytest.mark.parametrize("k", [1, 2, 3, 4, 5])
def test_count_le_ref_equals_searchsorted(k):
    """Windows of 1 to 5 ends a grid cell, three ragged workers, times on
    ends, beside them and on grid points."""
    dtl, t = lookup_case(3, k, seed=k)
    assert dtl.grid_k == k
    got = count_le_ref(dtl.ends, dtl.grid, dtl.cell, t, dtl.grid_k)
    assert got.dtype == torch.int64 and got.shape == (3, t.numel())
    assert torch.equal(got, _searchsorted(dtl, t))


@pytest.mark.parametrize("workers", [1, 3, 4, 16])
@pytest.mark.parametrize("k", [1, 2, 3, 4, 5])
def test_count_le_ref_equals_jax(workers, k):
    """ref.py's counts against the JAX reference's ``_count_le``, worker by
    worker, on the inputs the card's kernel test takes
    (``tests/test_torch_count_le.py``: the same seed; its 4096 times are
    the first of these 4099), so the kernel, bit-equal to ref.py there,
    is held to the reference here."""
    dtl, t = lookup_case(workers, k, n=4099, seed=workers * 10 + k)
    assert dtl.grid_k == k
    got = count_le_ref(dtl.ends, dtl.grid, dtl.cell, t, dtl.grid_k)
    with jax.enable_x64(True):
        tj = jnp.asarray(t.numpy())
        want = np.stack([np.asarray(rdp._count_le(
            jnp.asarray(dtl.ends[w].numpy()), jnp.asarray(dtl.grid[w].numpy()),
            jnp.float64(float(dtl.cell[w])), tj, dtl.grid_k))
            for w in range(workers)])
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("rails", [False, True], ids=["d1", "d3"])
def test_trace_sensor_ref_quantises_as_jax(rails):
    """RAPL's quantised time in the trace sensor's ref.py against the JAX
    reference's jitted ``_sensor_powers``, bit for bit, at 128 times just
    before a counter update (near 2·10^4 s) where a true division
    ``t / up`` and the product ``t * (1 / up)`` quantise apart. Each time
    is a chunk of one valid lane, so the chunk's carry is its quantised
    time; the JAX chunks run batched under one ``vmap``. The JAX
    reference's constant divisor is compiled to a product with its
    reciprocal, as ref.py writes it, and the true division is shown to
    differ at every one of these times. The readings are compared to a
    tolerance: XLA orders and fuses the energy arithmetic its own way."""
    from _torch_trace_sensor_cases import (UP, edge_times, sensor_args,
                                           sensor_timeline)
    from repro_torch.kernels.trace_sensor.ref import trace_sensor_ref
    dtl = sensor_timeline(4, rails, False, scale=2.5e5, seed=4)
    t = edge_times(2e4, 2.1e4)[:128]
    assert len(t) == 128 and t[-1] < dtl.t_end
    prevs = np.floor((t - 7 * UP) / UP + 1e-6) * UP
    got, carry = [], []
    for ti, pi in zip(t, prevs):
        pows, c = trace_sensor_ref(*sensor_args("rapl", dtl, ti[None], pi))
        got.append(pows[..., 0].numpy())
        carry.append(float(c))
    got, carry = np.stack(got), np.array(carry)
    _, _, tt, cnt, _, _, ends, bounds, eint, powers, m_true, grid, cell, \
        k = sensor_args("rapl", dtl, t, 0.0)
    spec = rsensors.SensorSpec(
        "rapl", update_period=UP,
        domains=("package", "hbm", "ici") if rails else ("total",))
    with jax.enable_x64(True):
        arrs = tuple(jnp.asarray(a.numpy()) for a in (ends, bounds, eint,
                                                      powers)) \
            + (jnp.zeros(ends.shape, jnp.int32),) \
            + tuple(jnp.asarray(a.numpy()) for a in (m_true, grid, cell))
        one = jax.jit(jax.vmap(
            lambda x, n, v, p: rdp._sensor_powers(spec, arrs, x, n, v, p, k),
            in_axes=(0, 1, 0, 0)))
        want, want_carry = one(jnp.asarray(tt.numpy())[:, None],
                               jnp.asarray(cnt.numpy())[:, :, None],
                               jnp.ones((len(t), 1), bool), jnp.asarray(prevs))
    want, want_carry = np.asarray(want)[..., 0], np.asarray(want_carry)
    np.testing.assert_array_equal(carry.view(np.int64),
                                  want_carry.view(np.int64))
    assert (np.floor(t / UP + 1e-6) * UP != want_carry).all()
    assert got.shape == want.shape == ((128, 4, 3) if rails else (128, 4))
    np.testing.assert_allclose(got, want, rtol=1e-8)


def test_count_le_cpu_route_is_the_ref_and_loads_no_library(monkeypatch):
    """On the CPU, _count_le with a grid window is ref.py's operations,
    bit for bit: no library is built or loaded and nothing is launched."""
    real = _build.load

    def refuse(name):
        if name == "count_le":
            raise AssertionError("the CPU route loaded count_le")
        return real(name)

    monkeypatch.setattr(_build, "load", refuse)
    count_le_ops._kernel.cache_clear()
    before = count_le_ops.count_le.launches
    dtl, t = lookup_case(4, 5, seed=9)
    got = dp._count_le(dtl.ends, dtl.grid, dtl.cell, t, dtl.grid_k)
    assert torch.equal(got, count_le_ref(dtl.ends, dtl.grid, dtl.cell, t,
                                         dtl.grid_k))
    assert torch.equal(got, _searchsorted(dtl, t))
    assert count_le_ops.count_le.launches == before
    assert count_le_ops._kernel.cache_info().currsize == 0


def test_count_le_search_route_is_untouched(monkeypatch):
    """k_max = 0 (heavy-tailed durations) takes torch.searchsorted, inside
    count_le, and never the grid route (whose gathers are refused)."""
    searched = []
    search = torch.searchsorted

    def spy(*a, **kw):
        searched.append(a[1].shape)
        return search(*a, **kw)

    def refuse(*a, **kw):
        raise AssertionError("the search route went through the grid")

    dtl, t = lookup_case(2, 3, seed=4)
    want = _searchsorted(dtl, t)
    before = count_le_ops.count_le.launches
    monkeypatch.setattr(torch, "searchsorted", spy)
    monkeypatch.setattr(torch, "gather", refuse)
    got = dp._count_le(dtl.ends, dtl.grid, dtl.cell, t, 0)
    monkeypatch.undo()
    assert torch.equal(got, want)
    assert searched == [(2, t.numel())]
    assert count_le_ops.count_le.launches == before


def test_count_le_refuses_other_devices():
    dtl, t = lookup_case(1, 1)
    with pytest.raises(ValueError, match="unsupported device"):
        count_le_ops.count_le(dtl.ends, dtl.grid, dtl.cell,
                              t.to("meta"), 1)


def test_count_le_c_signature_matches_declared_argtypes():
    src = Path(count_le_ops.__file__).with_name("count_le.cu").read_text()
    m = re.search(r"int count_le\(([^)]*)\)", src)
    scalars = {"int64_t": ctypes.c_int64, "int": ctypes.c_int}
    got = tuple(ctypes.c_void_p if "*" in p else
                scalars[" ".join(p.split()).rsplit(" ", 1)[0]]
                for p in m.group(1).split(","))
    assert got == count_le_ops._ARGTYPES


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
