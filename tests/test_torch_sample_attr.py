"""Port parity: repro_torch's sample_attr (plain PyTorch path on the CPU)
against the JAX reference's kernel in interpret mode and its
carry-update seam (neither needs the reference's device pipeline, so
this file imports the reference as it is)."""

import ctypes
import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.estimator import estimate_regions
from repro.kernels.sample_attr import ops as rops
from repro_torch.kernels.sample_attr import ops, ref


def _stream(n, R, seed, *, channels=None, pad=False):
    rng = np.random.default_rng(seed)
    lo, hi = (-2, R + 2) if pad else (0, R)
    ids = rng.integers(lo, hi, n).astype(np.int32)
    shape = (n,) if channels is None else (channels, n)
    pw = 50.0 + rng.random(shape) * 150.0
    valid = rng.random(n) < 0.85
    return ids, pw, valid


# ---------------------------------------------------------------------------
# One-shot sample_attr ≡ the reference kernel (interpret mode).
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n,R", [(16, 3), (1000, 7), (4096, 128),
                                 (5000, 37), (100, 1), (3000, 300)])
def test_sample_attr_matches_reference_kernel(n, R):
    ids, pw, _ = _stream(n, R, n + R)
    pw32 = pw.astype(np.float32)
    c, s, sq = ops.sample_attr(torch.from_numpy(ids),
                               torch.from_numpy(pw32.astype(np.float64)), R)
    cr, sr, sqr = rops.sample_attr(jnp.asarray(ids), jnp.asarray(pw32), R,
                                   True)
    np.testing.assert_allclose(c.numpy(), np.asarray(cr), rtol=1e-6)
    np.testing.assert_allclose(s.numpy(), np.asarray(sr), rtol=1e-5)
    np.testing.assert_allclose(sq.numpy(), np.asarray(sqr), rtol=1e-5)
    assert c.dtype == torch.int64 and s.dtype == torch.float64


def test_sample_attr_padding_matches_nothing():
    """``-1`` pads and ids past R contribute nothing, as on the TPU."""
    ids, pw, _ = _stream(2000, 9, 5, pad=True)
    c, s, sq = ops.sample_attr(torch.from_numpy(ids), torch.from_numpy(pw),
                               9)
    keep = (ids >= 0) & (ids < 9)
    assert int(c.sum()) == int(keep.sum())
    np.testing.assert_allclose(
        s.numpy(), np.bincount(ids[keep], weights=pw[keep], minlength=9),
        rtol=1e-12)
    np.testing.assert_allclose(
        sq.numpy(),
        np.bincount(ids[keep], weights=pw[keep] ** 2, minlength=9),
        rtol=1e-12)


# ---------------------------------------------------------------------------
# make_carry_update ≡ the reference's carry fold (use_pallas=False).
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("channels", [None, 4])
@pytest.mark.parametrize("R", [16, 128, 300])
def test_carry_update_matches_reference(R, channels):
    rng = np.random.default_rng(R)
    stat = (R,) if channels is None else (R, channels)
    c0 = rng.integers(0, 50, R).astype(np.int64)
    s0 = rng.random(stat) * 1e3
    q0 = rng.random(stat) * 1e5
    got = (torch.from_numpy(c0.copy()), torch.from_numpy(s0.copy()),
           torch.from_numpy(q0.copy()))
    update = ops.make_carry_update(R)
    with jax.enable_x64(True):
        rupdate = jax.jit(rops.make_carry_update(R, use_pallas=False))
        want = (jnp.asarray(c0), jnp.asarray(s0), jnp.asarray(q0))
        for k in range(3):
            ids, pw, valid = _stream(2048, R, 10 * R + k, channels=channels)
            update(*got, torch.from_numpy(ids), torch.from_numpy(pw),
                   torch.from_numpy(valid))
            want = rupdate(*want, jnp.asarray(ids), jnp.asarray(pw),
                           jnp.asarray(valid))
        want = [np.asarray(w) for w in want]
    np.testing.assert_array_equal(got[0].numpy(), want[0])
    np.testing.assert_allclose(got[1].numpy(), want[1], rtol=1e-9)
    np.testing.assert_allclose(got[2].numpy(), want[2], rtol=1e-9)


def test_carry_update_is_in_place_and_masks_nonfinite_lanes():
    """The fold updates the carry tensors themselves (the port's
    counterpart of the reference's donated carry), and a masked lane's
    non-finite power never reaches the sums."""
    ids = torch.tensor([0, 1, 1, 2], dtype=torch.int32)
    pw = torch.tensor([1.0, 2.0, float("nan"), 4.0], dtype=torch.float64)
    valid = torch.tensor([True, True, False, True])
    carry = (torch.zeros(3, dtype=torch.int64),
             torch.zeros(3, dtype=torch.float64),
             torch.zeros(3, dtype=torch.float64))
    out = ops.make_carry_update(3)(*carry, ids, pw, valid)
    assert all(a is b for a, b in zip(out, carry))
    assert carry[0].tolist() == [1, 1, 1]
    assert carry[1].tolist() == [1.0, 2.0, 4.0]
    assert carry[2].tolist() == [1.0, 4.0, 16.0]
    with pytest.raises(ValueError):
        ops.make_carry_update(4)(*carry, ids, pw, valid)


def test_fold_ref_is_the_cpu_path():
    ids, pw, valid = _stream(3000, 50, 1, channels=3, pad=True)
    args = (torch.from_numpy(ids), torch.from_numpy(pw),
            torch.from_numpy(valid))
    a = [torch.zeros(50, dtype=torch.int64),
         torch.zeros(50, 3, dtype=torch.float64),
         torch.zeros(50, 3, dtype=torch.float64)]
    b = [x.clone() for x in a]
    ops.sample_attr_fold(*a, *args)
    ref.sample_attr_fold_ref(*b, *args)
    for x, y in zip(a, b):
        assert torch.equal(x, y)


# ---------------------------------------------------------------------------
# The wrapper's checks (run before every kernel launch on the GPU).
# ---------------------------------------------------------------------------

def _carry(R, C=None, ids_dtype=torch.int32):
    stat = (R,) if C is None else (R, C)
    c = 64
    pw = (c,) if C is None else (C, c)
    return [torch.zeros(R, dtype=torch.int64),
            torch.zeros(stat, dtype=torch.float64),
            torch.zeros(stat, dtype=torch.float64),
            torch.zeros(c, dtype=ids_dtype),
            torch.zeros(pw, dtype=torch.float64),
            torch.ones(c, dtype=torch.bool)]


def test_wrapper_checks_accept_both_layouts():
    assert ops._check(*_carry(10)) == (10, 64, 1)
    assert ops._check(*_carry(10, 4)) == (10, 64, 4)


@pytest.mark.parametrize("breakage", ["ids_dtype", "pows_shape",
                                      "carry_shape", "noncontiguous",
                                      "valid_shape"])
def test_wrapper_checks_reject(breakage):
    args = _carry(10, 4)
    if breakage == "ids_dtype":
        args[3] = args[3].to(torch.int64)
    elif breakage == "pows_shape":
        args[4] = torch.zeros(3, 64, dtype=torch.float64)
    elif breakage == "carry_shape":
        args[1] = torch.zeros(10, 3, dtype=torch.float64)
    elif breakage == "noncontiguous":
        args[4] = torch.zeros(64, 4, dtype=torch.float64).T
    else:
        args[5] = torch.ones(63, dtype=torch.bool)
    with pytest.raises((TypeError, ValueError)):
        ops._check(*args)


# ---------------------------------------------------------------------------
# Estimator plug.
# ---------------------------------------------------------------------------

def test_as_aggregate_fn_plugs_into_estimator():
    rng = np.random.default_rng(3)
    ids = rng.integers(0, 4, 20000).astype(np.int32)
    pw = 100 + 10 * rng.random(20000)
    names = ["a", "b", "c", "d"]
    est_np = estimate_regions(ids, pw, 10.0, names)
    est_k = estimate_regions(ids, pw, 10.0, names,
                             aggregate_fn=ops.as_aggregate_fn(device="cpu"))
    for r1, r2 in zip(est_np.regions, est_k.regions):
        assert r1.n_samples == r2.n_samples
        assert r1.e_hat == pytest.approx(r2.e_hat, rel=1e-12)


def test_as_aggregate_fn_defaults_to_the_gpu():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present; the default device is usable")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ops.as_aggregate_fn()


# ---------------------------------------------------------------------------
# The C interface and the wrapper's scratch (nothing here builds a kernel).
# ---------------------------------------------------------------------------

def _c_argtypes(src: str, fn: str):
    """ctypes types of ``fn``'s parameters as declared in the source: every
    pointer is a ``c_void_p``."""
    m = re.search(rf"int {fn}\(([^)]*)\)", src)
    assert m, f"{fn} not found"
    scalars = {"int": ctypes.c_int, "int64_t": ctypes.c_int64,
               "float": ctypes.c_float}
    out = []
    for p in m.group(1).split(","):
        decl = " ".join(p.split()).rsplit(" ", 1)[0]
        out.append(ctypes.c_void_p if decl.endswith("*") else scalars[decl])
    return tuple(out)


def test_c_signature_matches_declared_argtypes():
    """ctypes passes arguments by the declared types alone: a mismatch with
    the C signature would corrupt the call silently."""
    src = Path(ops.__file__).with_name("sample_attr.cu").read_text()
    assert _c_argtypes(src, "sample_attr_fold") == ops._ARGTYPES


@pytest.mark.parametrize("c,C,want", [(65536, 4, (256, 65536 * 8)),
                                      (1, 1, (1, 512)),
                                      (257, 2, (2, 2048))])
def test_scratch_sizes(c, C, want):
    assert ops._scratch_sizes(c, C, 256) == want


def test_scratch_is_reused_and_grows(monkeypatch):
    """The scratch of one (device, stream) is allocated once and reused;
    a larger c or C grows it (never shrinks it); another stream gets its
    own."""
    monkeypatch.setattr(ops, "_SCRATCH", {})
    cpu = torch.device("cpu")
    a = ops._scratch(cpu, 7, 65536, 4, 256)
    assert ops._scratch(cpu, 7, 65536, 4, 256) is a
    assert ops._scratch(cpu, 7, 1000, 1, 256) is a          # smaller: reused
    assert a.tbl_id.numel() == a.tbl_cnt.numel() == 65536
    assert a.tbl_val.numel() == 65536 * 8 and a.tbl_head.numel() == 256 * 4
    b = ops._scratch(cpu, 7, 65536, 8, 256)                  # more channels
    assert b is not a and b.tbl_val.numel() == 65536 * 16
    d = ops._scratch(cpu, 7, 70000, 1, 256)                  # more samples
    assert d is not b and d.tables == 274
    assert d.vals == 65536 * 16                               # kept C=8 room
    assert ops._scratch(cpu, 7, 65536, 8, 256) is d
    assert ops._scratch(cpu, 8, 1000, 1, 256) is not d       # other stream
    assert len(ops._SCRATCH) == 2


# ---------------------------------------------------------------------------
# The kernel's summation order (ref.sample_attr_fold_emulated) against the
# reference kernel and the plain fold.
# ---------------------------------------------------------------------------

def _runs(n, R, seed, *, channels=None, mean_run=1000):
    """A run-structured id stream like the profiler's chunks: runs of one
    region with lengths drawn around ``mean_run``, some lanes masked."""
    rng = np.random.default_rng(seed)
    k = n // (mean_run // 2) + 2
    lens = rng.integers(mean_run // 2, 3 * mean_run // 2, k)
    ids = np.repeat(rng.integers(0, R, k), lens)[:n].astype(np.int32)
    shape = (n,) if channels is None else (channels, n)
    pw = 50.0 + rng.random(shape) * 150.0
    valid = rng.random(n) < 0.97
    return ids, pw, valid


def _fold_both(ids, pw, valid, R, channels):
    stat = (R,) if channels is None else (R, channels)
    a = [torch.zeros(R, dtype=torch.int64),
         torch.zeros(stat, dtype=torch.float64),
         torch.zeros(stat, dtype=torch.float64)]
    b = [x.clone() for x in a]
    args = (torch.from_numpy(ids), torch.from_numpy(pw),
            None if valid is None else torch.from_numpy(valid))
    ref.sample_attr_fold_emulated(*a, *args)
    ref.sample_attr_fold_ref(*b, *args)
    return a, b


@pytest.mark.parametrize("stream", ["uniform", "runs"])
@pytest.mark.parametrize("n,R,channels", [(65536, 4096, 4), (70000, 300, None),
                                          (5000, 16, 2), (300, 7, 8)])
def test_emulated_order_matches_plain_fold(stream, n, R, channels):
    """Tolerance rtol 1e-10 (as on the card): both sum in float64, only the
    order differs. 70 000 samples span two batches of 256 tables."""
    make = _stream if stream == "uniform" else _runs
    kw = dict(pad=True) if stream == "uniform" else {}
    ids, pw, valid = make(n, R, n + R, channels=channels, **kw)
    got, want = _fold_both(ids, pw, valid, R, channels)
    assert torch.equal(got[0], want[0])
    for g, w in zip(got[1:], want[1:]):
        torch.testing.assert_close(g, w, rtol=1e-10, atol=0.0)


@pytest.mark.parametrize("stream", ["uniform", "runs"])
def test_emulated_order_matches_reference_kernel(stream):
    """Against the reference's Pallas kernel in interpret mode, which sums
    float32 powers in float32: the reference's own limit (rtol 1e-5)."""
    n, R = 8192, 64
    if stream == "uniform":
        ids, pw, _ = _stream(n, R, 11)
    else:
        ids, pw, _ = _runs(n, R, 11)
    pw32 = pw.astype(np.float32)
    got = [torch.zeros(R, dtype=torch.int64),
           torch.zeros(R, dtype=torch.float64),
           torch.zeros(R, dtype=torch.float64)]
    ref.sample_attr_fold_emulated(*got, torch.from_numpy(ids),
                                  torch.from_numpy(pw32.astype(np.float64)))
    cr, sr, sqr = rops.sample_attr(jnp.asarray(ids), jnp.asarray(pw32), R,
                                   True)
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(cr))
    np.testing.assert_allclose(got[1].numpy(), np.asarray(sr), rtol=1e-5)
    np.testing.assert_allclose(got[2].numpy(), np.asarray(sqr), rtol=1e-5)


def test_emulated_fold_is_in_place_and_masks_nonfinite_lanes():
    ids = torch.tensor([0, 1, 1, 2, 1], dtype=torch.int32)
    pw = torch.tensor([1.0, 2.0, float("nan"), 4.0, 3.0], dtype=torch.float64)
    valid = torch.tensor([True, True, False, True, True])
    carry = (torch.ones(3, dtype=torch.int64),
             torch.ones(3, dtype=torch.float64),
             torch.ones(3, dtype=torch.float64))
    out = ref.sample_attr_fold_emulated(*carry, ids, pw, valid)
    assert all(a is b for a, b in zip(out, carry))
    assert carry[0].tolist() == [2, 3, 2]
    assert carry[1].tolist() == [2.0, 6.0, 5.0]
    assert carry[2].tolist() == [2.0, 14.0, 17.0]


# ---------------------------------------------------------------------------
# Host-seam chunk reducers ≡ the reference's (interpret mode).
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n,R", [(300, 5), (1024, 64), (2500, 37),
                                 (700, 100)],
                         ids=["short", "exact", "oversized", "r_rounded"])
def test_chunked_aggregate_fn_matches_reference(n, R):
    """A short chunk (topped up with -1), one of exactly the capacity, an
    oversized one (three slices) and an R that rounds up to 128, at the
    reference's kernel limits (its sums are float32)."""
    ids, pw, _ = _stream(n, R, n + R)
    pw32 = pw.astype(np.float32)
    got = ops.chunked_aggregate_fn(1024, device="cpu")(
        ids, pw32.astype(np.float64), R)
    want = rops.chunked_aggregate_fn(1024, block_n=256, interpret=True)(
        ids, pw32, R)
    assert [a.shape for a in got] == [(R,)] * 3
    assert got[0].dtype == np.int64 and got[1].dtype == np.float64
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_allclose(got[1], want[1], rtol=1e-5)
    np.testing.assert_allclose(got[2], want[2], rtol=1e-5)


def test_sample_attr_chunk_matches_reference():
    ids, pw, _ = _stream(512, 40, 8, pad=True)
    pw32 = pw.astype(np.float32)
    fold = ops.sample_attr_chunk(64, "cpu")
    got = fold(torch.from_numpy(ids), torch.from_numpy(
        pw32.astype(np.float64)))
    assert got is fold.carry
    want = rops.sample_attr_chunk(256, None, 64, True)(jnp.asarray(ids),
                                                      jnp.asarray(pw32))
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
    np.testing.assert_allclose(got[1].numpy(), np.asarray(want[1]),
                               rtol=1e-5)
    np.testing.assert_allclose(got[2].numpy(), np.asarray(want[2]),
                               rtol=1e-5)
    fold.reset()
    assert not any(bool(t.any()) for t in fold.carry)


def test_chunked_aggregate_fn_reuses_its_buffers(monkeypatch):
    """Every slice of every call stages into the same two buffers and
    folds into one carry per rounded R: nothing is allocated per chunk,
    and a result does not change when the next call reuses the carry."""
    seen = []
    fold = ops.sample_attr_fold

    def spy(counts, psum, psumsq, ids, pows, valid=None):
        seen.append((counts.shape[0], counts.data_ptr(), ids.data_ptr(),
                     pows.data_ptr()))
        return fold(counts, psum, psumsq, ids, pows, valid)
    monkeypatch.setattr(ops, "sample_attr_fold", spy)
    agg = ops.chunked_aggregate_fn(256, device="cpu")
    ids, pw, _ = _stream(1000, 30, 3)
    first = agg(ids, pw, 30)
    again = agg(ids[:100], pw[:100], 50)
    agg(ids, pw, 70)
    assert len(seen) == 4 + 1 + 4
    assert len({s[2:] for s in seen}) == 1
    assert len({s[:2] for s in seen}) == 2        # R 30, 50 → 64; 70 → 128
    np.testing.assert_array_equal(first[0], np.bincount(ids, minlength=30))
    np.testing.assert_array_equal(again[0],
                                  np.bincount(ids[:100], minlength=50))


def test_chunked_aggregate_fn_plugs_into_streaming_aggregators():
    from repro_torch.core.streaming import (StreamingAggregator,
                                            StreamingCombinationAggregator)
    rng = np.random.default_rng(6)
    mat = rng.integers(0, 5, (3000, 3))
    pw = 80.0 + 40.0 * rng.random(3000)
    plain = StreamingCombinationAggregator()
    kern = StreamingCombinationAggregator(
        aggregate_fn=ops.chunked_aggregate_fn(512, device="cpu"))
    region = StreamingAggregator(
        5, aggregate_fn=ops.chunked_aggregate_fn(512, device="cpu"))
    for lo in range(0, 3000, 700):
        plain.update(mat[lo:lo + 700], pw[lo:lo + 700])
        kern.update(mat[lo:lo + 700], pw[lo:lo + 700])
        region.update(mat[lo:lo + 700, 0], pw[lo:lo + 700])
    assert kern.interner.combos == plain.interner.combos
    np.testing.assert_array_equal(kern.agg.counts, plain.agg.counts)
    np.testing.assert_allclose(kern.agg.psum, plain.agg.psum, rtol=1e-12)
    np.testing.assert_array_equal(region.counts,
                                  np.bincount(mat[:, 0], minlength=5))


def test_chunked_aggregate_fn_defaults_to_the_gpu():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present; the default device is usable")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ops.chunked_aggregate_fn()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ops.sample_attr_chunk(64)
