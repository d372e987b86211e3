"""The trace sensor's kernel (``kernels/trace_sensor``) and its plain
version. On the CPU: ``ref.py`` runs the torch operations the sensor stage
ran before the kernel, with RAPL's ``t / up`` taken as PyTorch's CUDA
kernels take it, and the wrapper refuses what the kernel does not take.
On the card (``python -m pytest -m gpu tests/test_torch_trace_sensor.py``):
the kernel's readings and RAPL carry equal ``ref.py``'s bit for bit, and
the chunk loops launch it once a chunk."""

import ctypes
import re
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.core.profiler import EnergyProfiler
from repro_torch.kernels.count_le import ops as count_ops
from repro_torch.kernels.trace_sensor import ops
from repro_torch.kernels.trace_sensor.ref import trace_sensor_ref
from _torch_count_le_cases import burst_timelines
from _torch_trace_sensor_cases import (STARTS, UP, bits, chunk_case,
                                       edge_times, parent_sensor_powers,
                                       scaled, sensor_timeline)

CHUNK = 512
_ROUTES = pytest.mark.parametrize("search", [False, True],
                                  ids=["grid", "search"])
_SHAPES = pytest.mark.parametrize("workers,rails", [
    (1, False), (1, True), (4, False), (4, True), (16, False), (16, True)],
    ids=["w1d1", "w1d3", "w4d1", "w4d3", "w16d1", "w16d3"])
_KINDS = pytest.mark.parametrize("kind", ["rapl", "ina231"])


def _cases(kind, workers, rails, search, device="cpu"):
    dtl = sensor_timeline(workers, rails, search, seed=workers)
    for start in STARTS:
        yield start, chunk_case(kind, dtl, start, c=CHUNK,
                                seed=workers * 7 + int(10 * start),
                                device=device)


@_KINDS
@_SHAPES
@_ROUTES
def test_ref_is_the_torch_route_it_replaces(kind, workers, rails, search):
    """``ref.py`` equals the frozen torch operations bit for bit, readings
    and carry, with ``t / up`` as the card's torch kernels take it; against
    the CPU's true division it differs only where the two quantise a time
    apart (and in the lane after it), and the cases hold such times."""
    apart = 0
    for start, args in _cases(kind, workers, rails, search):
        got, carry = trace_sensor_ref(*args)
        want, want_carry = parent_sensor_powers(*args, quotient="card")
        assert got.shape == want.shape == (
            (workers, 3, CHUNK) if rails else (workers, CHUNK))
        assert torch.equal(bits(got), bits(want)), start
        assert torch.equal(bits(carry), bits(want_carry)), start
        cpu, cpu_carry = parent_sensor_powers(*args, quotient="cpu")
        t = args[2].numpy()
        moved = np.floor(t / UP + 1e-6) != np.floor(t * (1.0 / UP) + 1e-6)
        if kind == "ina231" or not moved.any():
            assert torch.equal(bits(got), bits(cpu))
            continue
        apart += int(moved.sum())
        near = torch.from_numpy(moved | np.roll(moved, 1))
        same = (bits(got) == bits(cpu)).reshape(-1, CHUNK).all(dim=0)
        assert bool(same[~near].all()), start
    assert kind == "ina231" or apart > 0


def test_rapl_carry_without_valid_lanes_is_kept():
    """A chunk wholly past the horizon reads but keeps RAPL's carry; a
    chunk inside it carries its largest valid quantised time."""
    dtl = sensor_timeline(4, False, False)
    past = chunk_case("rapl", dtl, 1.2, c=CHUNK, seed=1)
    _, carry = trace_sensor_ref(*past)
    assert not bool(past[4].any()) and float(carry) == float(past[5])
    inside = chunk_case("rapl", dtl, 0.4, c=CHUNK, seed=1)
    _, carry = trace_sensor_ref(*inside)
    t = inside[2]
    assert float(carry) == float(torch.floor(t[-1] * (1.0 / UP) + 1e-6)
                                 * UP) > float(inside[5])


def _valid_args():
    return list(chunk_case("rapl", sensor_timeline(4, True, False), 0.0,
                           c=64, seed=0))


def _refusal(edit):
    args = _valid_args()
    edit(args)
    return args


@pytest.mark.parametrize("edit,match", [
    (lambda a: a.__setitem__(0, "instant"), "kind"),
    (lambda a: a.__setitem__(2, a[2].float()), "t must be"),
    (lambda a: a.__setitem__(3, a[3].int()), "cnt must be"),
    (lambda a: a.__setitem__(4, a[4].int()), "valid must be"),
    (lambda a: a.__setitem__(5, a[5].reshape(1)), "prev must have"),
    (lambda a: a.__setitem__(3, a[3][:, :-1]), "cnt must have"),
    (lambda a: a.__setitem__(8, a[8][..., :-1]), "eint must have"),
    (lambda a: a.__setitem__(9, a[9].transpose(0, 1).contiguous()
                             .transpose(0, 1)), "powers must be contig"),
    (lambda a: a.__setitem__(10, a[10].long()), "m_true must be"),
    (lambda a: a.__setitem__(11, a[11][:2]), "grid must have"),
    (lambda a: a.__setitem__(12, a[12].to("meta")), "cell must be"),
    (lambda a: a.__setitem__(13, -1), "k_max"),
], ids=["kind", "t-dtype", "cnt-dtype", "valid-dtype", "prev-shape",
        "cnt-shape", "eint-shape", "powers-layout", "m_true-dtype",
        "grid-workers", "cell-device", "k_max"])
def test_check_refuses_what_the_kernel_does_not_take(edit, match):
    """``_check`` (run before every launch) refuses other sensors, dtypes,
    shapes, layouts and devices; the valid arguments pass it."""
    args = _valid_args()
    kind, _, *arrays, k_max = args
    assert ops._check(kind, *arrays, k_max) == (4, 3, args[6].shape[1], 64)
    kind, _, *arrays, k_max = _refusal(edit)
    with pytest.raises(ValueError, match=match):
        ops._check(kind, *arrays, k_max)


def test_other_devices_are_refused():
    args = _valid_args()
    args[2] = args[2].to("meta")
    with pytest.raises(ValueError, match="unsupported device"):
        ops.trace_sensor(*args)


def test_c_signature_matches_declared_argtypes():
    """``ops._ARGTYPES`` is the C entry's parameter list, type for type."""
    src = Path(ops.__file__).with_name("trace_sensor.cu").read_text()
    m = re.search(r"int trace_sensor\(([^)]*)\)", src)
    scalars = {"int64_t": ctypes.c_int64, "int": ctypes.c_int,
               "double": ctypes.c_double}
    got = tuple(ctypes.c_void_p if "*" in p else
                scalars[" ".join(p.split()).rsplit(" ", 1)[0]]
                for p in m.group(1).split(","))
    assert got == ops._ARGTYPES


def _small_timelines(workers: int, rails: bool):
    """``workers`` timelines of ~300 intervals of ~5 ms (grid window 3)."""
    return scaled(burst_timelines(workers, 3, m=300, seed=5), 5.0, rails)


@_KINDS
def test_the_record_counts_the_sensor_lanes(kind):
    """``sensor_lanes`` counts every worker-lane the sensor reads: W · c a
    chunk."""
    prof = EnergyProfiler(period=5e-3, jitter=1e-3, seed=3, device="cpu")
    prof.profile_timeline_streaming(_small_timelines(1, False)[0],
                                    sensor=kind, chunk_size=CHUNK,
                                    pipeline="device")
    counters = prof.last_trace.counters
    assert counters["sensor_lanes"] == counters["chunks"] * CHUNK


# -- on the card ---------------------------------------------------------------


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("the trace_sensor kernel runs only on a CUDA device")
    return torch.device("cuda")


@pytest.mark.gpu
@_KINDS
@_SHAPES
@_ROUTES
def test_kernel_bit_equal_to_ref(cuda_device, kind, workers, rails, search):
    """The kernel's readings and RAPL carry equal ``ref.py``'s on the CPU
    bit for bit (int64 views), in every case; one launch a call, and the
    input carry is not written."""
    for start, args in _cases(kind, workers, rails, search):
        want, want_carry = trace_sensor_ref(*args)
        gpu = [a.to(cuda_device) if torch.is_tensor(a) else a for a in args]
        prev = gpu[5].clone()
        before = ops.trace_sensor.launches
        got, carry = ops.trace_sensor(*gpu)
        torch.cuda.synchronize()
        assert ops.trace_sensor.launches - before == 1
        assert torch.equal(bits(got), bits(want)), start
        assert torch.equal(bits(carry), bits(want_carry)), start
        assert torch.equal(bits(gpu[5]), bits(prev))
        assert (carry is gpu[5]) == (kind == "ina231")


@pytest.mark.gpu
def test_the_cards_torch_divides_by_a_scalar_as_ref_does(cuda_device):
    """On the times just before a counter update where a true division and
    a product with the reciprocal quantise apart, torch's CUDA ``t / up``
    (the benchmark's reference and the torch route before the kernel)
    quantises as ``ref.py``'s ``t * (1 / up)``."""
    t = torch.from_numpy(edge_times(1e3, 3e4))
    assert t.numel() > 1000
    card = torch.floor(t.to(cuda_device) / UP + 1e-6).cpu()
    assert torch.equal(card, torch.floor(t * (1.0 / UP) + 1e-6))
    assert not torch.equal(card, torch.floor(t / UP + 1e-6))


@pytest.mark.gpu
@pytest.mark.parametrize("kind", ["rapl", "ina231"])
@pytest.mark.parametrize("path", ["region", "combination"])
def test_one_launch_a_chunk(cuda_device, kind, path):
    """The chunk loops launch the kernel once a chunk and once a miss
    replay, and count_le once (the sample times) for each."""
    tls = _small_timelines(3, True)
    prof = EnergyProfiler(period=5e-3, jitter=1e-3, seed=3,
                          device=cuda_device)
    kw = dict(sensor=kind, chunk_size=CHUNK, pipeline="device")
    sensor0, lookup0 = ops.trace_sensor.launches, count_ops.count_le.launches
    if path == "region":
        prof.profile_timeline_streaming(tls[0], **kw)
    else:
        prof.profile_multiworker_streaming(tls, **kw)
    torch.cuda.synchronize()
    counters = prof.last_trace.counters
    passes = counters["chunks"] + counters.get("miss_chunks", 0)
    assert path == "region" or counters.get("miss_chunks", 0) > 0
    assert ops.trace_sensor.launches - sensor0 == passes
    assert count_ops.count_le.launches - lookup0 == passes
